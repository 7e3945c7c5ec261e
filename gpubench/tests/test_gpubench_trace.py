"""The reduction of a traced stretch, and a traced run on the CPU; the
program's spans that a run keeps on each tick."""
import time

import pytest
import torch

from gpubench import cell, manifest, serve, trace
from gpubench_tiny import tiny_entry


def test_interval_arithmetic():
    u = trace.union([(3, 4), (0, 1), (0.5, 2), (4, 5)])
    assert u == [(0, 2), (3, 5)]
    assert trace.length(u) == 4
    assert trace.intersect(u, [(1, 3.5), (4.5, 9)]) == [(1, 2), (3, 3.5), (4.5, 5)]
    assert trace.complement(u, -1, 6) == [(-1, 0), (2, 3), (5, 6)]


@pytest.mark.parametrize("name,base", [
    ("void patch_attention_kernel<float, 48, 2, true>(float const*, float*)", "patch_attention_kernel"),
    ("(anonymous namespace)::patch_attention_kernel<float, 48, false>(float const*, fl",
     "patch_attention_kernel"),
    ("void at::native::elementwise_kernel<128, 4>(int)", "elementwise_kernel"),
    ("void gn_stitch_kernel<__nv_bfloat16>(...)", "gn_stitch_kernel"),
    ("patch_attention_combine", "patch_attention_combine"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32",
     "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32")])
def test_kernel_names_lose_their_templates(name, base):
    assert trace.kernel_base(name) == base


def test_a_traced_run_on_the_cpu_records_calls_ticks_and_per_layer_metrics():
    r = cell.run_cell(tiny_entry(rate=4.0), 5, 3.0, True, "cpu", time.perf_counter())
    assert r["correct"]
    assert set(r["metrics"]) <= {m["name"] for m in tiny_entry()["per_layer"]}
    assert {"engine_step_ms", "step_pred_err", "mfu"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    assert list(r)[-1] == "checks"


def _drive(entry, seconds, seed, tracer_at=None):
    """A finished ``serve.Run`` of ``entry`` on the CPU, traced over the
    window's last ``tracer_at`` seconds if given."""
    cfg, t = entry["cfg"], entry["traffic"]
    parts = serve.set_up(cfg, t, seconds, seed, "cpu")
    run = serve.Run(entry["name"], cfg, t, seconds, seed, 0.0)
    tracer = None
    if tracer_at:
        tracer = trace.Tracer(time.perf_counter() + t["lead_in_s"] + seconds - tracer_at, tracer_at)
    with torch.no_grad():
        serve.drive(parts["engine"], parts["arrivals"], parts["inputs"], run, tracer)
    run.profile = tracer.summary([t.events for t in run.ticks]) if tracer else None
    return run


def test_csp_ms_is_the_split_and_merge_spans_on_each_steps_tick_events():
    run = _drive(tiny_entry(rate=4.0), 2.0, 2 ** 31 + 21)
    assert all(t.events is not None and t.events.dt == t.dt for t in run.ticks)
    steps = run.window_ticks
    assert steps
    want = sum(s.end_ns - s.start_ns for t in steps for s in t.events.spans
               if s.name in ("tick.split", "tick.merge")) / len(steps) * 1e-6
    assert want > 0
    # the reader holds each end as wall-clock seconds, a double good to 0.25 us
    assert manifest.reader("csp_ms").read(run) == pytest.approx(want, abs=1e-3)


@pytest.mark.parametrize("per_call,agree", [(1, True), (2, False)], ids=["agree", "differ"])
def test_the_attention_recorder_checks_its_count_against_the_wrappers(monkeypatch, per_call,
                                                                      agree):
    """A stub of the wrapper's launch counter, counting each call once or
    twice: the counts of the traced stretch are both kept, and where they
    differ ``patch_attention_roofline`` reads nothing, even with the
    kernel's time present. The stretch's idle gaps are named by the
    program's innermost span."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.patch_attention import patch_attention as wrapper
    monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    real = ops.patch_attention

    def counted(q, k, v):
        wrapper.launches += per_call
        return real(q, k, v)

    monkeypatch.setattr(ops, "patch_attention", counted)
    run = _drive(tiny_entry(rate=4.0), 3.0, 2 ** 31 + 23, tracer_at=1.2)
    n = len(run.profile["attention_calls"])
    assert n > 0 and run.profile["call_counts"]["attention_calls"] == (n, per_call * n)
    run.profile["kernel_s"] = {"patch_attention_kernel": 1.0}
    assert (manifest.reader("patch_attention_roofline").read(run) is not None) == agree
    names = [g for g, _ in run.profile["idle_gaps"]]
    assert names and any(g.startswith("tick.") for g in names)
