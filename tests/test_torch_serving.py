"""Port parity: the serving engine (repro_torch vs repro), its device rule,
the patch cache, and the port's freedom from JAX."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import serving as jsrv  # noqa: E402
from repro.core.latency_model import analytic_step_latency as j_analytic  # noqa: E402
from repro.core.requests import Request as JRequest  # noqa: E402
from repro.core.requests import poisson_workload as j_workload  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.models import diffusion as jdm  # noqa: E402
from repro_torch.convert import diffusion_params_from_numpy, vae_params_from_numpy  # noqa: E402
from repro_torch.core import latency_model as tlat  # noqa: E402
from repro_torch.core import serving as tsrv  # noqa: E402
from repro_torch.core.cache import PatchCache, bucket_size, masked_block_apply  # noqa: E402
from repro_torch.core.cache_predictor import ThresholdPredictor  # noqa: E402
from repro_torch.core.requests import Request as TRequest  # noqa: E402
from repro_torch.core.requests import poisson_workload as t_workload  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig as TSchedulerConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import diffusion as tdm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RES = [(16, 16), (24, 24), (32, 32)]
TINY = dict(kind="unet", width=16, levels=2, blocks_per_level=1, n_heads=2, groups=4,
            d_text=8, n_text=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sim_engines(policy, use_cache):
    jcfg = jdm.DiffusionConfig(use_kernels=False, **TINY)
    tcfg = tdm.DiffusionConfig(**TINY)
    tparams = tdm.init_diffusion(tcfg, torch.Generator().manual_seed(0), device="cpu")
    out = []
    for mod, cfg, params, sched, kw in (
            (jsrv, jcfg, None, JSchedulerConfig, {}),
            (tsrv, tcfg, tparams, TSchedulerConfig, {"device": "cpu"})):
        ecfg = mod.EngineConfig(clock="sim", sim_synthetic=True, use_cache=use_cache,
                                scheduler=sched(policy=policy))
        eng = mod.PatchedServeEngine(cfg, params, ecfg, dict.fromkeys(RES, 1.0), RES, **kw)
        for res in eng.resolutions:
            eng.sa[res] = j_analytic([1 if r == res else 0 for r in eng.resolutions],
                                     eng.patches_per_res) * 10
        out.append(eng)
    return out


@pytest.mark.parametrize("policy,qps,seed", [("slo", 1.0, 0), ("slo", 25.0, 3),
                                             ("fcfs", 25.0, 3), ("slo", 60.0, 5)])
def test_sim_clock_metrics_identical(policy, qps, seed):
    jeng, teng = _sim_engines(policy, use_cache=False)
    assert teng.sa == jeng.sa
    jwl = j_workload(qps, 20.0, RES, 5.0, jeng.sa, steps=10, seed=seed)
    twl = t_workload(qps, 20.0, RES, 5.0, teng.sa, steps=10, seed=seed)
    assert [dataclasses.astuple(r) for r in twl] == [dataclasses.astuple(r) for r in jwl]
    jm, tm = jeng.run(jwl), teng.run(twl)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.completed + tm.dropped == len(twl) and tm.completed > 0


def test_latency_features_match_reference():
    from repro.core import latency_model as jlat
    for counts in ([1, 0, 0], [2, 1, 4], [0, 0, 12]):
        np.testing.assert_array_equal(tlat.make_features(counts, [4, 9, 16]),
                                      jlat.make_features(counts, [4, 9, 16]))
        assert tlat.analytic_step_latency(counts, [4, 9, 16]) == \
            jlat.analytic_step_latency(counts, [4, 9, 16])
        assert tlat.resolution_concentration(counts, [4, 9, 16]) == \
            jlat.resolution_concentration(counts, [4, 9, 16])


@pytest.fixture(scope="module")
def real_pair():
    """JAX and torch engines on the same params, VAE params and seed, with
    three requests stepped three times (cache off). The requests start late
    in a 50-step DDIM schedule: its first steps divide by sqrt(alpha-bar)
    ~ 0.006 and would amplify fp32 rounding far past the tolerance."""
    jcfg = jdm.DiffusionConfig(use_kernels=False, **TINY)
    jparams = jdm.init_diffusion(jcfg, jax.random.PRNGKey(0))
    ecfg = dict(clock="real", use_cache=False, seed=3)
    jeng = jsrv.PatchedServeEngine(jcfg, jparams, jsrv.EngineConfig(**ecfg),
                                   dict.fromkeys(RES, 1.0), RES)
    teng = tsrv.PatchedServeEngine(
        tdm.DiffusionConfig(**TINY), diffusion_params_from_numpy(_np_tree(jparams), "cpu"),
        tsrv.EngineConfig(**ecfg), dict.fromkeys(RES, 1.0), RES, device="cpu",
        vae_params=vae_params_from_numpy(_np_tree(jeng.vae), "cpu"))
    reqs = {}
    for name, eng, cls in (("jax", jeng, JRequest), ("torch", teng, TRequest)):
        rs = [cls(rid=i, resolution=res, arrival=0.0, slo=1e9, total_steps=50,
                  steps_done=40, prompt=f"prompt-{i}") for i, res in enumerate(RES)]
        for r in rs:
            eng._prepare(r)
        reqs[name] = rs
    initial = [r.latent.numpy().copy() for r in reqs["torch"]]
    for _ in range(3):
        jeng._denoise_step(reqs["jax"])
        teng._denoise_step(reqs["torch"])
    return jeng, teng, reqs, initial


def test_prepare_draws_identical_noise_and_text(real_pair):
    _, _, reqs, initial = real_pair
    jeng2 = jsrv.PatchedServeEngine(jdm.DiffusionConfig(use_kernels=False, **TINY), None,
                                    jsrv.EngineConfig(seed=3), dict.fromkeys(RES, 1.0), RES)
    for i, res in enumerate(RES):
        r = JRequest(rid=i, resolution=res, arrival=0.0, slo=1e9, total_steps=5,
                     prompt=f"prompt-{i}")
        jeng2._prepare(r)
        np.testing.assert_array_equal(initial[i], np.asarray(r.latent))
    for jr, tr in zip(reqs["jax"], reqs["torch"]):
        np.testing.assert_array_equal(tr.text.numpy(), np.asarray(jr.text))


def test_denoise_steps_match_reference(real_pair):
    _, _, reqs, _ = real_pair
    for jr, tr in zip(reqs["jax"], reqs["torch"]):
        assert tr.steps_done == jr.steps_done == 43
        np.testing.assert_allclose(tr.latent.numpy(), np.asarray(jr.latent),
                                   rtol=1e-4, atol=1e-4)


def test_postprocess_matches_reference(real_pair):
    jeng, teng, reqs, _ = real_pair
    for jr, tr in zip(reqs["jax"], reqs["torch"]):
        jeng._postprocess(jr)
        teng._postprocess(tr)
        h, w = tr.resolution
        assert teng.outputs[tr.rid].shape == (8 * h, 8 * w, 3)
        np.testing.assert_allclose(teng.outputs[tr.rid], jeng.outputs[jr.rid],
                                   rtol=1e-4, atol=1e-4)


def _real_engine(use_cache):
    cfg = tdm.DiffusionConfig(**TINY)
    params = tdm.init_diffusion(cfg, torch.Generator().manual_seed(0), device="cpu")
    ecfg = tsrv.EngineConfig(clock="real", use_cache=use_cache, cache_tau=0.05)
    return tsrv.PatchedServeEngine(cfg, params, ecfg, dict.fromkeys(RES, 1.0), RES,
                                   device="cpu")


@pytest.mark.parametrize("use_cache", [False, True])
def test_real_clock_cpu_run(use_cache):
    eng = _real_engine(use_cache)
    eng.calibrate(total_steps_hint=4)
    wl = t_workload(1.5, 2.0, RES, 30.0, eng.sa, steps=4, seed=2)
    assert wl
    m = eng.run(wl, max_wall=120)
    assert m.completed >= 1 and m.completed + m.dropped == len(wl)
    if use_cache:
        assert m.compute_savings and np.mean(m.compute_savings) > 0.0
    by_rid = {r.rid: r for r in wl}
    for rid, img in eng.outputs.items():
        h, w = by_rid[rid].resolution
        assert img.shape == (8 * h, 8 * w, 3) and np.all(np.isfinite(img))


def test_entry_points_default_to_cuda():
    """Without a card the engine and the launcher raise and name the CPU
    option instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tdm.DiffusionConfig(**TINY)
    params = tdm.init_diffusion(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsrv.PatchedServeEngine(cfg, params, tsrv.EngineConfig(), dict.fromkeys(RES, 1.0), RES)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tserve.main(["--clock", "sim"])


def test_serve_launcher_on_cpu(capsys):
    m = tserve.main(["--device", "cpu", "--clock", "sim", "--duration", "3"])
    assert m.completed > 0
    assert "device=cpu" in capsys.readouterr().out


def test_patch_cache_sets_reuse_and_update():
    """tests/test_cache.py on the port's PatchCache."""
    c = PatchCache(capacity=8)
    r1 = c.sync([1, 2, 3])
    assert (r1.n_new, r1.n_common, r1.n_expired) == (3, 0, 0)
    r2 = c.sync([2, 3, 4])
    assert (r2.n_new, r2.n_common, r2.n_expired) == (1, 2, 1)
    assert r2.slots[0] == r1.slots[1] and r2.slots[1] == r1.slots[2]
    assert c.sync([4, 5, 6, 7, 8, 9, 10, 11]).n_new == 7
    with pytest.raises(RuntimeError, match="capacity"):
        PatchCache(capacity=2).sync([1, 2, 3])

    c = PatchCache(capacity=4)
    pred = ThresholdPredictor(tau=1e-3)
    x = torch.ones(3, 2, 2, 1)
    s = c.sync([1, 2, 3])
    m = c.reuse_mask(x, s, pred)
    assert not m.any()
    c.update(s, x, x * 2, ~m)
    s2 = c.sync([1, 2, 3])
    assert c.reuse_mask(x, s2, pred).all()
    assert torch.equal(c.cached_outputs(s2), x * 2)
    x3 = x.clone()
    x3[1] += 1.0
    m3 = c.reuse_mask(x3, c.sync([1, 2, 3]), pred)
    assert m3.tolist() == [True, False, True]
    assert c.stats == {"hits": 0, "computed": 3, "expired": 0}

    # the cached input stays anchored at the last compute unless asked to follow
    for follow in (False, True):
        c = PatchCache(capacity=2, update_input_on_reuse=follow)
        s = c.sync([1])
        c.update(s, x[:1], x[:1], torch.tensor([True]))
        c.update(s, x[:1] + 1e-4, x[:1], torch.tensor([False]))
        assert torch.equal(c.cached_inputs(s), x[:1] + 1e-4 if follow else x[:1])


def test_bucket_size_and_masked_block_apply():
    for n in (0, 1, 2, 7, 8, 9, 63, 64, 65, 1023, 1024, 5000):
        b = bucket_size(n)
        assert b >= n and (n == 0 or b <= 2 * n or b <= 8)
    patches = torch.arange(12.0).reshape(6, 2, 1, 1)
    cached = torch.full((6, 2, 1, 1), -1.0)
    reuse = np.array([True, False, True, False, True, True])
    out, bucket = masked_block_apply(lambda x: x * 10, patches, reuse, cached)
    for i in range(6):
        want = cached[i] if reuse[i] else patches[i] * 10
        assert torch.equal(out[i], want)
    assert bucket >= 2 and torch.equal(cached, torch.full((6, 2, 1, 1), -1.0))


def test_port_imports_neither_jax_nor_the_reference():
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m in ('jax', 'repro', 'benchmarks') or
             m.startswith(('jax.', 'repro.', 'benchmarks.')))
assert not bad, bad
assert len(names) >= 20, names
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_step_clock_reads_follow_a_device_sync(monkeypatch):
    """On CUDA the step time must measure the work, not its enqueue: both
    clock reads around a step come right after a device synchronise."""
    eng = _real_engine(use_cache=False)
    events = []
    monkeypatch.setattr(eng, "_sync", lambda: events.append("sync"))
    ticks = iter(range(1000))
    monkeypatch.setattr(tsrv.time, "perf_counter", lambda: events.append("clock") or
                        float(next(ticks)))
    eng.calibrate(steps_per_probe=1, combos=[[1, 0, 0]])
    assert events == ["sync", "clock", "sync", "clock"]
    events.clear()
    eng.submit(TRequest(rid=0, resolution=RES[0], arrival=0.0, slo=1e9, total_steps=2))
    ev = eng.tick(0.0)
    assert ev.stepped and events == ["sync", "clock", "sync", "clock"]
