"""Port parity: the fleet layer (repro_torch.cluster vs repro.cluster).

The cluster is numpy above the engine's sim path, so on the same seeds the
two packages must agree exactly: ``summary()`` is equal, and so is every
request's outcome (state, steps, finish time). Each scenario's workload is
cut to its first seconds of arrivals, the same way on both sides, so that a
case runs in a few seconds. The last tests cover what only the port has:
its device rule, and a fleet whose replicas run the real tensor step."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.cluster as jcl  # noqa: E402
import repro_torch.cluster as tcl  # noqa: E402
from benchmarks.common import make_cluster as j_make_cluster  # noqa: E402
from repro.cluster import simtools as jsim  # noqa: E402
from repro.core.patching import split as jsplit  # noqa: E402
from repro.models import diffusion as jdm  # noqa: E402
from repro.models import sampler as jsam  # noqa: E402
from repro_torch.convert import diffusion_params_from_numpy  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.cluster import simtools as tsim  # noqa: E402
from repro_torch.core.latency_model import CacheHitModel as TCacheHitModel  # noqa: E402
from repro_torch.models import diffusion as tdm  # noqa: E402
from repro_torch.models import sampler as tsam  # noqa: E402

RES = [(16, 16), (24, 24), (32, 32)]
TINY = dict(kind="unet", width=16, levels=2, blocks_per_level=1, n_heads=2, groups=4,
            d_text=8, n_text=2)
SKEW = (0.2, 0.2, 0.6)
MIX_A, MIX_B = (0.6, 0.3, 0.1), (0.1, 0.3, 0.6)
POLICIES = ("round_robin", "join_shortest_queue", "least_slack", "resolution_affinity",
            "zone_spread", "cache_affinity", "cache_affinity_spread",
            "resolution_affinity_spread", "cascade")


def t_make_cluster(n_replicas=3, policy="round_robin", autoscaler=None,
                   steps=10, scale=1.0, record_timeseries=True,
                   initial_mix=None, repartition=None, cache=None,
                   failures=None, checkpoint=None, cache_tier=None,
                   trace=None, batcher=None, tiers=None, monitor=None):
    """The port's twin of ``benchmarks.common.make_cluster``: synthetic
    sim engines on the CPU over the benchmark ladder."""
    if cache is True:
        cache = TCacheHitModel()
    factory = tsim.sim_engine_factory(RES, steps=steps, scale=scale, cache=cache or None,
                                      device="cpu")
    return tcl.Cluster(factory, RES, tcl.ClusterConfig(
        n_replicas=n_replicas, policy=policy, autoscaler=autoscaler,
        initial_mix=initial_mix, repartition=repartition, failures=failures,
        checkpoint=checkpoint, cache_tier=cache_tier, trace=trace, monitor=monitor,
        batcher=batcher, tiers=tiers, record_timeseries=record_timeseries))


SIDES = {"jax": (jcl, jsim, j_make_cluster), "torch": (tcl, tsim, t_make_cluster)}


def _canon(x):
    """Exact, order-keeping form of a summary: NaN equals NaN, and any value
    that is not a plain number, string or container (a tensor, say) fails."""
    if isinstance(x, dict):
        return ("dict", [(k, _canon(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_canon(v) for v in x])
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    assert x is None or isinstance(x, (bool, int, float, str, np.integer, np.floating)), type(x)
    return x


def _outcomes(wl):
    return [(r.rid, r.resolution, r.state, r.steps_done, r.finish, r.arrival, r.slo,
             r.difficulty) for r in wl]


def _cut(wl, seconds):
    return [r for r in wl if r.arrival < seconds]


def _run_both(build):
    """``build(cl_mod, sim_mod, make_cluster) -> (cluster, workload)`` on each
    side; runs both and checks that their summaries and outcomes are equal."""
    out = {}
    for side, mods in SIDES.items():
        cl, wl = build(*mods)
        m = cl.run(wl)
        out[side] = (cl, m, wl)
    (jc, jm, jw), (tc, tm, tw) = out["jax"], out["torch"]
    assert len(tw) == len(jw) and len(tw) > 0
    assert _canon(tm.summary(full_timeseries=True)) == _canon(jm.summary(full_timeseries=True))
    assert _canon(tm.summary()) == _canon(jm.summary())
    assert _outcomes(tw) == _outcomes(jw)
    assert tm.completed + tm.dropped >= 1
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_router_policies_summary_equal(policy):
    def build(cl_mod, sim, make_cluster):
        kw = dict(tiers={"lite": 2, "base": 1}) if policy == "cascade" else {}
        cl = make_cluster(n_replicas=3, policy=policy, cache=True, **kw)
        return cl, sim.cluster_workload(qps=60.0, duration=6.0, mix=SKEW, seed=1)
    _run_both(build)


@pytest.mark.parametrize("predictive", [False, True])
def test_autoscaler_on_updown_knots_summary_equal(predictive):
    def build(cl_mod, sim, make_cluster):
        cfg = cl_mod.AutoscalerConfig(min_replicas=2, max_replicas=8, cold_start=5.0,
                                      cooldown=2.0, predictive=predictive,
                                      predictive_down=predictive, service_rate=24.0)
        cl = make_cluster(n_replicas=2, policy="join_shortest_queue", autoscaler=cfg)
        return cl, _cut(sim.piecewise_rate_workload(sim.UPDOWN_KNOTS, seed=3), 22.0)
    out = _run_both(build)
    assert out["torch"][0].autoscaler.actions == out["jax"][0].autoscaler.actions


def test_drift_triggered_repartition_summary_equal():
    def build(cl_mod, sim, make_cluster):
        cl = make_cluster(n_replicas=4, policy="resolution_affinity", cache=True,
                          initial_mix=MIX_A, repartition=cl_mod.RepartitionConfig(),
                          record_timeseries=False)
        return cl, sim.phased_workload([(6.0, 128.0, MIX_A), (6.0, 128.0, MIX_B)], seed=1)
    out = _run_both(build)
    assert out["torch"][1].repartitions == out["jax"][1].repartitions
    assert len(out["torch"][1].repartitions) >= 1


@pytest.mark.parametrize("checkpoint", [False, True])
def test_crash_faults_summary_equal(checkpoint):
    def build(cl_mod, sim, make_cluster):
        sc = sim.CRASH_FAULTS
        cl = make_cluster(
            n_replicas=sc["n_replicas"], policy="join_shortest_queue", steps=sc["steps"],
            failures=cl_mod.FailureConfig(mtbf=sc["mtbf"], recover=True,
                                          cold_start=sc["cold_start"], seed=7),
            checkpoint=cl_mod.CheckpointConfig() if checkpoint else None,
            record_timeseries=False)
        return cl, sim.cluster_workload(qps=sc["qps"], duration=12.0, steps=sc["steps"],
                                        slo_scale=sc["slo_scale"], seed=7)
    out = _run_both(build)
    assert out["torch"][1].replicas_failed == out["jax"][1].replicas_failed >= 1
    assert (out["torch"][1].steps_resumed > 0) == checkpoint


def test_zone_faults_summary_equal():
    def build(cl_mod, sim, make_cluster):
        sc = sim.ZONE_FAULTS
        cl = make_cluster(
            n_replicas=sc["n_replicas"], policy="zone_spread",
            failures=cl_mod.FailureConfig(mtbf=None, recover=True,
                                          cold_start=sc["cold_start"], zones=sc["zones"],
                                          zone_mtbf=4.0, zone_downtime=3.0, seed=7),
            record_timeseries=False)
        return cl, sim.cluster_workload(qps=sc["qps"], duration=8.0, seed=7)
    out = _run_both(build)
    assert out["torch"][1].replicas_failed == out["jax"][1].replicas_failed >= 1


SCENARIO_ARMS = [(name, arm, seconds)
                 for name, arms, seconds in (("CACHE_TIER", ("no_tier", "tier"), 4.0),
                                             ("FLASH_CROWD", ("cold", "noprefetch", "warm"), 11.0),
                                             ("BATCH_MIX", ("per_request", "nowait", "gang"), 5.0),
                                             ("CASCADE_MIX", ("cascade", "always_cheap",
                                                              "always_base", "always_big"), 6.0))
                 for arm in arms]


@pytest.mark.parametrize("name,arm,seconds", SCENARIO_ARMS)
def test_scenario_arm_summary_equal(name, arm, seconds):
    def build(cl_mod, sim, make_cluster):
        sc = getattr(sim, name)
        return make_cluster(**sc.cluster_kwargs(arm)), _cut(sc.workload(sc.seeds[0]), seconds)
    assert tsim.CACHE_TIER.arms == jsim.CACHE_TIER.arms
    _run_both(build)


def test_traced_run_summary_and_jsonl_equal(tmp_path):
    def build(cl_mod, sim, make_cluster):
        sc = sim.CRASH_FAULTS
        cl = make_cluster(n_replicas=3, policy="least_slack", cache=True,
                          trace=cl_mod.TraceConfig(),
                          failures=cl_mod.FailureConfig(mtbf=4.0, recover=True,
                                                        cold_start=1.0, seed=3))
        return cl, sim.cluster_workload(qps=40.0, duration=6.0, steps=sc["steps"], seed=3)
    out = _run_both(build)
    lines = {}
    for side, (cl, _, _) in out.items():
        path = tmp_path / f"{side}.jsonl"
        assert cl.tracer.write_jsonl(path) > 1
        lines[side] = path.read_text().splitlines()
    assert lines["torch"] == lines["jax"]
    assert json.loads(lines["torch"][0])["kind"] == "trace_meta"
    assert out["torch"][0].tracer.conservation_errors() == \
        out["jax"][0].tracer.conservation_errors()


def test_monitored_run_summary_and_alerts_equal():
    def build(cl_mod, sim, make_cluster):
        sc = sim.CRASH_FAULTS
        cl = make_cluster(n_replicas=sc["n_replicas"], policy="join_shortest_queue",
                          steps=sc["steps"], monitor=sim.monitor_config(),
                          failures=cl_mod.FailureConfig(mtbf=sc["mtbf"], recover=True,
                                                        cold_start=sc["cold_start"], seed=2),
                          record_timeseries=False)
        return cl, sim.cluster_workload(qps=sc["qps"], duration=20.0, steps=sc["steps"],
                                        slo_scale=sc["slo_scale"], seed=2)
    out = _run_both(build)
    t_alerts, j_alerts = out["torch"][0].monitor.alerts, out["jax"][0].monitor.alerts
    assert t_alerts == j_alerts
    assert out["torch"][0].monitor.prometheus_text() == out["jax"][0].monitor.prometheus_text()


# ---------------- what only the port has ----------------

def test_null_tracer_is_inert():
    """Any method with any arguments is a no-op; a dunder name the object
    lacks raises AttributeError, so protocols that probe for one (copy,
    pickle) see a plain object."""
    nt = tcl.NullTracer()
    assert nt.enabled is False
    assert nt.submit(None) is None
    assert nt.anything(1, 2, k=3) is None
    with pytest.raises(AttributeError):
        nt.__no_such_dunder__
    assert not hasattr(nt, "__array_interface__")
    assert tcl.NULL_TRACER.emit("x", t=0.0) is None


def test_sim_engine_factory_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule under test is the one for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.sim_engine_factory()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.sim_engine_factory(synthetic=False)
    eng = tsim.sim_engine_factory(device="cpu")(RES)
    assert eng.device.type == "cpu"


def test_affinity_replica_step_matches_reference(side=24, n=2):
    """The step an affinity replica runs: every request of one resolution,
    so the GCD patch is the latent itself (one patch a request, no
    neighbours; level 1 halves it), here a side that is not a power of two. The port's sampler step against the
    reference's on the same converted params, fp32 at 1e-4."""
    jcfg = jdm.DiffusionConfig(use_kernels=False, **TINY)
    jparams = jdm.init_diffusion(jcfg, jax.random.PRNGKey(0))
    tparams = diffusion_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                          device="cpu")
    rng = np.random.default_rng(side)
    imgs = [rng.normal(size=(side, side, 4)).astype(np.float32) for _ in range(n)]
    text = rng.normal(size=(n, TINY["n_text"], TINY["d_text"])).astype(np.float32)
    steps = np.array([40, 47][:n])
    jc, jp = jsplit([jnp.asarray(i) for i in imgs])
    tc, tp = tsplit([torch.from_numpy(i) for i in imgs])
    assert tc.patch == jc.patch == side and tp.shape[0] == n
    want = np.asarray(jsam.sampler_step(jcfg, jparams, jc, jp, jnp.asarray(steps), 50,
                                        jnp.asarray(text)))
    got = tsam.sampler_step(tdm.DiffusionConfig(use_kernels=False, **TINY), tparams, tc, tp,
                            torch.from_numpy(steps), 50, torch.from_numpy(text))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _tensor_fleet(policy, synthetic):
    cfg = tdm.DiffusionConfig(use_kernels=False, **TINY)
    params = tdm.init_diffusion(cfg, torch.Generator().manual_seed(0), device="cpu")
    factory = tsim.sim_engine_factory(RES, steps=4, synthetic=synthetic,
                                      model_builder=lambda: (cfg, params), device="cpu")
    cl = tcl.Cluster(factory, RES, tcl.ClusterConfig(n_replicas=3, policy=policy))
    wl = tsim.cluster_workload(qps=3.0, duration=2.0, steps=4, slo_scale=10.0, seed=2)
    return cl, cl.run(wl), wl, params


@pytest.mark.parametrize("policy,patches", [("resolution_affinity", [16, 24, 32]),
                                            ("round_robin", [8, 8, 8])])
def test_tensor_fleet_on_the_cpu_completes_with_finite_images(policy, patches):
    """Replicas that run the real tensor step of the tiny UNet under the
    fleet's sim clock: every request is accounted for, every image is finite
    and of the right shape, the replicas share one set of weights, and the
    fleet's metrics equal those of the same fleet with synthetic engines
    (the sim clock does not depend on the tensor path)."""
    cl, m, wl, params = _tensor_fleet(policy, synthetic=False)
    assert m.completed + m.dropped == len(wl) and m.completed >= 1
    assert sorted(r.engine.patch for r in cl.replicas) == patches
    by_rid = {r.rid: r for r in wl}
    images = {rid: img for rep in cl.replicas for rid, img in rep.engine.outputs.items()}
    assert len(images) == m.completed
    for rid, img in images.items():
        h, w = by_rid[rid].resolution
        assert img.shape == (8 * h, 8 * w, 3) and np.all(np.isfinite(img))
    assert all(r.engine.params["temb_w1"].data_ptr() == params["temb_w1"].data_ptr()
               for r in cl.replicas)
    _, synth, swl, _ = _tensor_fleet(policy, synthetic=True)
    assert _canon(m.summary(full_timeseries=True)) == _canon(synth.summary(full_timeseries=True))
    assert _outcomes(wl) == _outcomes(swl)
