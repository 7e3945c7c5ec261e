"""The reduction of a traced stretch, and a traced run on the CPU."""
import time

import pytest

from gpubench import cell, trace
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
