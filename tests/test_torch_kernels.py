"""Port parity: the kernels' CSP entry points and plain versions against the
JAX reference.

On the CPU the wrappers take their plain versions (their tensors lie on the
CPU), so these cases check the surrounding shapes, stats and layouts; the
kernels themselves are held against the plain versions in
``test_torch_kernels_cuda.py``, which needs a card.
Tolerances are the reference's: fp32 1e-4, bf16 2e-2 (GN-stitch) and 3e-2
(attention)."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import patched_ops as jops  # noqa: E402
from repro.core import stitcher as jst  # noqa: E402
from repro.core.patching import split as jsplit  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.patch_attention import patch_attention as jattn  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.core import patched_ops as tops  # noqa: E402
from repro_torch.core.csp_device import csp_device  # noqa: E402
from repro_torch.kernels import fp32_gemm as gemm  # noqa: E402
from repro_torch.kernels.fp32_gemm import fp32_gemm  # noqa: E402
from repro_torch.kernels.groupnorm_stitch import (  # noqa: E402
    gn_partials, gn_stitch, groupnorm_stitch)
from repro_torch.kernels.patch_attention import (  # noqa: E402
    SLICE_WIDTH, instance_width, patch_attention)

GN_SWEEP = [  # tests/test_kernels.py::test_groupnorm_stitch_sweep
    ([(16, 16)], 8, 4, "float32"),
    ([(16, 16), (32, 32)], 16, 4, "float32"),
    ([(24, 24), (16, 16), (32, 32)], 8, 2, "float32"),
    ([(16, 16), (24, 24)], 16, 8, "bfloat16"),
]
# the main path's three-request CSP (chip_smoke.py's 512/768/1024-pixel
# requests) at level 0 (p=32) and level 1 (p=16), at C=64 and G=8
CHIP_SWEEP = [
    ([(64, 64), (96, 96), (128, 128)], 64, 8, "float32"),
    ([(32, 32), (48, 48), (64, 64)], 64, 8, "float32"),
    ([(32, 32), (48, 48), (64, 64)], 64, 8, "bfloat16"),
]
ATTN_SWEEP = [  # tests/test_kernels.py::test_patch_attention_sweep
    (2, 100, 4, 32, "float32"),
    (1, 256, 2, 64, "float32"),
    (3, 65, 1, 16, "float32"),
    (2, 128, 2, 32, "bfloat16"),
    (1, 17, 3, 8, "float32"),
]


def _tol(dtype, bf16_tol):
    return bf16_tol if dtype == "bfloat16" else 1e-4


def _gn_inputs(res, C, dtype, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(h, w, C)).astype(np.float32) for h, w in res]
    scale = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    jc, jp = jsplit([jnp.asarray(i, getattr(jnp, dtype)) for i in imgs])
    tc, tp = tsplit([torch.from_numpy(i).to(getattr(torch, dtype)) for i in imgs])
    return jc, jp, tc, tp, scale, bias


@pytest.mark.parametrize("res,C,G,dtype", GN_SWEEP + CHIP_SWEEP)
@pytest.mark.parametrize("exact", [True, False])
def test_fused_groupnorm_stitch_matches_reference(res, C, G, dtype, exact):
    """The port's entry point against the reference's plain composite
    (patched_groupnorm + gather_halo); the Pallas kernel does not run under
    the installed jax."""
    jc, jp, tc, tp, scale, bias = _gn_inputs(res, C, dtype)
    got = ops.fused_groupnorm_stitch(tc, tp, torch.from_numpy(scale),
                                     torch.from_numpy(bias), G, exact=exact)
    want = jst.gather_halo(jops.patched_groupnorm(jc, jp, jnp.asarray(scale),
                                                  jnp.asarray(bias), G, exact=exact),
                           jc.neighbors)
    assert got.dtype == tp.dtype and got.shape == want.shape
    tol = _tol(dtype, 2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("res,C,G,dtype", GN_SWEEP + CHIP_SWEEP)
@pytest.mark.parametrize("exact", [True, False])
def test_plain_partials_and_finalize_match_reference_stats(res, C, G, dtype, exact):
    """Partials then finalise, as the two kernels split the statistics,
    against the reference's per-patch mean and rstd: csp_group_stats of the
    patch's request (exact), or the patch's own mean and population variance
    (exact=False, as ops.fused_groupnorm_stitch makes them)."""
    jc, jp, tc, tp, _, _ = _gn_inputs(res, C, dtype, seed=3)
    P, p = tp.shape[0], tp.shape[1]
    if exact:
        jmean, jvar = jops.csp_group_stats(jc, jp, G)
        seg = np.asarray(jc.patch_req)
        jmean, jvar = np.asarray(jmean)[seg], np.asarray(jvar)[seg]
    else:
        x = jp.astype(jnp.float32).reshape(P, p * p, G, C // G)
        jmean = np.asarray(jnp.mean(x, axis=(1, 3)))
        jvar = np.asarray(jnp.mean(jnp.square(x - jmean[:, None, :, None]), axis=(1, 3)))
    meta = csp_device(tc, "cpu")
    part = ref.ref_gn_partials(tp, G)
    assert part.shape == (P, G, 2) and part.dtype == torch.float32
    mean, rstd = ref.ref_gn_finalize(part, meta.patch_req_i32, meta.request_offset_i32, p, C,
                                     1e-5, exact)
    tol = _tol(dtype, 2e-2)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=tol, atol=tol)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(jvar + 1e-5), rtol=tol, atol=tol)


def test_ref_groupnorm_stitch_matches_reference():
    rng = np.random.default_rng(2)
    imgs = [rng.normal(size=(h, w, 8)).astype(np.float32) for h, w in [(16, 16), (32, 32)]]
    jc, jp = jsplit([jnp.asarray(i) for i in imgs])
    tc, tp = tsplit([torch.from_numpy(i) for i in imgs])
    P, C = tp.shape[0], tp.shape[-1]
    mean_c = rng.normal(size=(P, C)).astype(np.float32)
    rstd_c = (np.abs(rng.normal(size=(P, C))) + 0.5).astype(np.float32)
    scale = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    want = jref.ref_groupnorm_stitch(jp, jc.neighbors, jnp.asarray(mean_c),
                                     jnp.asarray(rstd_c), jnp.asarray(scale),
                                     jnp.asarray(bias))
    got = ref.ref_groupnorm_stitch(tp, tc.neighbors, *map(torch.from_numpy,
                                                          (mean_c, rstd_c, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,H,D,dtype", ATTN_SWEEP)
def test_grouped_attention_matches_pallas_interpret(B, S, H, D, dtype):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    want = jattn(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), interpret=True)
    got = ops.grouped_attention_kernel(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    tol = _tol(dtype, 3e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_launch_counters_stay_zero_on_cpu():
    counted = (gn_partials, gn_stitch, groupnorm_stitch, patch_attention, fp32_gemm)
    for fn in counted:
        fn.launches = 0
    fp32_gemm.launches_by_route = dict.fromkeys(gemm.ROUTES, 0)
    jc, jp, tc, tp, scale, bias = _gn_inputs([(16, 16)], 8, "float32")
    ops.fused_groupnorm_stitch(tc, tp, torch.from_numpy(scale), torch.from_numpy(bias), 4)
    q = torch.randn(1, 16, 2, 8)
    ops.grouped_attention_kernel(q, q, q)
    a, w = torch.randn(512, 256), torch.randn(256, 256)
    fp32_gemm(a, w)
    tops.matmul(a, w, use_kernels=True)
    assert [fn.launches for fn in counted] == [0, 0, 0, 0, 0]
    assert fp32_gemm.launches_by_route == dict.fromkeys(gemm.ROUTES, 0)


def test_launcher_signatures_match_sources():
    """Every extern "C" launcher in csrc/ has a declared ctypes signature
    with one argument per C parameter."""
    found = {}
    for src in build.sources():
        text = src.read_text()
        for name, params in re.findall(r'extern "C" cudaError_t (\w+)\(([^)]*)\)', text):
            found[name] = len(params.split(","))
    assert {s.name for s in build.sources()} == {"groupnorm_stitch.cu",
                                                 "patch_attention.cu", "fp32_gemm.cu"}
    assert found == {name: len(args) for name, args in build.SIGNATURES.items()}
    assert {f"ps_gn_{kind}_{t}" for kind in ("partials", "stitch")
            for t in ("f32", "bf16", "f16")} <= set(found)
    # the attention launchers take the head dim at run time and pick the
    # instance themselves (instance_width): one launcher per dtype, not per D
    text = (build.CSRC / "patch_attention.cu").read_text()
    attn = {name: params for name, params in re.findall(
        r'extern "C" cudaError_t (ps_patch_attention\w*)\(([^)]*)\)', text)}
    assert set(attn) == {"ps_patch_attention_f32", "ps_patch_attention_bf16",
                         "ps_patch_attention_f16", "ps_patch_attention_block_q"}
    assert all(re.search(r"\bint D\b", params) for params in attn.values())


def test_build_hash_covers_sources(tmp_path, monkeypatch):
    """An edit to a source or to a header it includes rebuilds the library;
    only the sources are compiled."""
    base = build.source_hash()
    src = tmp_path / "k.cu"
    src.write_text('#include "k.cuh"')
    hdr = tmp_path / "k.cuh"
    hdr.write_text("// a header")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.source_hash()
    src.write_text('#include "k.cuh"  // an edited kernel')
    second = build.source_hash()
    hdr.write_text("// an edited header")
    assert len({base, first, second, build.source_hash()}) == 4
    assert build.sources() == [src]


def test_ptxas_summary_reports_every_entry_function():
    """chip_smoke.py's register report names every kernel instance of every
    source, whatever its template arguments."""
    import sys
    sys.path.insert(0, str(build.BUILD_ROOT.parents[1]))
    import chip_smoke
    log = "\n".join(  # names and lines as nvcc 12 on sm_90a prints them
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers"
        for name, regs, spill in (
            ("_ZN51_GLOBAL__N__0d2c3d6d_18_patch_attention_cu_219643da22patch_attention_"
             "kernelIfLi32EEEvPKT_S3_S3_PS1_PfS5_iiiNS_7StridesEf", 157, 0),
            ("_ZN51_GLOBAL__N__0d2c3d6d_18_patch_attention_cu_219643da23patch_attention_"
             "combineI13__nv_bfloat16EEvPKfS3_PT_xii", 32, 0),
            ("_ZN52_GLOBAL__N__5f7f384f_19_groupnorm_stitch_cu_984ee8c716gn_stitch_"
             "kernelIfLi4EEEvPKT_PKiPKfS7_S7_S7_PS1_iii", 32, 8)))
    lines = chip_smoke.ptxas_summary(log)
    assert len(lines) == 3
    for line, (name, regs) in zip(lines, (("patch_attention_kernel", 157),
                                           ("patch_attention_combine", 32),
                                           ("gn_stitch_kernel", 32))):
        assert name in line and f"Used {regs} registers" in line
    assert "8 bytes spill stores" in lines[2]


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    """Only a CPU tensor takes the plain version; any other device either
    launches the kernel (CUDA) or raises."""
    x = torch.empty(2, 4, 4, 8, device="meta")
    nb = torch.empty(2, 8, dtype=torch.int32, device="meta")
    req = torch.empty(2, dtype=torch.int32, device="meta")
    off = torch.empty(2, dtype=torch.int32, device="meta")
    part = torch.empty(2, 4, 2, device="meta")
    vec = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        groupnorm_stitch(x, nb, req, off, vec, vec, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        gn_partials(x, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        gn_stitch(x, part, nb, req, off, vec, vec)
    # the device decides before the head dim and the key length: any D, a
    # public one or one past the widest instance, and keys of another length
    # than the queries, raise the same off the CPU and off CUDA
    for D in (8, 72, SLICE_WIDTH + 1, 1024):
        q = torch.empty(1, 16, 2, D, device="meta")
        k = torch.empty(1, 77, 2, D, device="meta")
        for args in ((q, q, q), (q, k, k)):
            with pytest.raises(ValueError, match="unsupported device"):
                patch_attention(*args)
    with pytest.raises(ValueError, match=f"not in 1..{SLICE_WIDTH}"):
        instance_width(SLICE_WIDTH + 1)
    a, w = torch.empty(512, 256, device="meta"), torch.empty(256, 256, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        fp32_gemm(a, w)
    assert groupnorm_stitch.launches == 0 and patch_attention.launches == 0
    assert gn_partials.launches == 0 and gn_stitch.launches == 0 and fp32_gemm.launches == 0


# the cells' K: PixArt-alpha's 1152, 4096 (its text) and 4608, SD 1.5's 320
# and 1280
GEMM_K = (320, 1152, 1280, 4096, 4608)


def _rms_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("K", GEMM_K)
@pytest.mark.parametrize("bits,within", [(10, True), (7, False)], ids=["3xtf32", "3xbf16"])
def test_emulated_split_product_against_fp64(K, bits, within):
    """Three TF32 passes (``ref.emulated_tf32x3_matmul``, the fp32 GEMM
    kernel's arithmetic) keep the RMS error of an fp32 product against fp64
    within 2x; three bf16 passes (the attention kernel's) do not."""
    gen = torch.Generator().manual_seed(K)
    a, b = torch.randn(256, K, generator=gen), torch.randn(K, 256, generator=gen)
    exact = a.double() @ b.double()
    plain = _rms_rel(a @ b, exact)
    got = ref.emulated_tf32x3_matmul(a, b) if bits == 10 else ref.split_matmul(a, b, bits, 3)
    assert (_rms_rel(got, exact) <= 2 * plain) == within


GEMM_ROUTE_CASES = [  # (dtype, device, M, N, K) -> route
    ("float32", "cuda", 4096, 1152, 1152, "wgmma_3xtf32"),      # PixArt-alpha's projections
    ("float32", "cuda", 4096, 4608, 1152, "wgmma_3xtf32"),      # its feed-forward
    ("float32", "cuda", 1920, 1152, 4096, "wgmma_3xtf32"),      # its text K/V
    ("float32", "cuda", 16384, 320, 320, "wgmma_3xtf32"),       # SD 1.5's level 0
    ("bfloat16", "cuda", 4096, 1152, 1152, "torch"),
    ("float32", "cpu", 4096, 1152, 1152, "torch"),
    ("float32", "cuda", 4096, 1152, 4, "torch"),                # tok_in
    ("float32", "cuda", 4096, 4, 1152, "torch"),                # tok_out
    ("float32", "cuda", 12, 3456, 256, "torch"),                # adaLN: a row a request
    ("float32", "cuda", gemm.MIN_M - 1, 1152, 1152, "torch"),
    ("float32", "cuda", 4096, gemm.MIN_N - 2, 1152, "torch"),
    ("float32", "cuda", 4096, 1152, gemm.MIN_K - 4, "torch"),
    ("float32", "cuda", 4096, 1152, 1150, "torch"),             # K not whole 16 bytes
    ("float32", "cuda", 4096, 1151, 1152, "torch"),             # odd N
]


@pytest.mark.parametrize("dtype,device,M,N,K,want", GEMM_ROUTE_CASES)
def test_gemm_route_reads_dtype_device_and_shape(dtype, device, M, N, K, want):
    assert gemm.route(getattr(torch, dtype), torch.device(device), M, N, K) == want


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("a_dtype,b_dtype", [("float32", "float32"), ("float32", "bfloat16")])
def test_matmul_on_cpu_is_a_at_b_bit_for_bit(use_kernels, a_dtype, b_dtype):
    """On CPU tensors ``patched_ops.matmul`` is ``a @ b`` after jnp's
    promotion whatever ``use_kernels`` says, and counts nothing."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(2, 300, 256, generator=gen).to(getattr(torch, a_dtype))
    b = torch.randn(256, 320, generator=gen).to(getattr(torch, b_dtype))
    before = dict(fp32_gemm.launches_by_route)
    assert torch.equal(tops.matmul(a, b, use_kernels), a @ b.float())
    assert fp32_gemm.launches_by_route == before


def test_weight_halves_split_once_per_weight_and_version():
    """A weight's TF32 halves: K-major, big + small equal to it within
    2^-22, TF32 values (13 low bits zero), computed once, shared by views of
    one base, and computed again after an in-place change."""
    w = torch.randn(1, 1, 96, 40, generator=torch.Generator().manual_seed(5))
    big, small = gemm.weight_halves(w[0, 0])
    assert big.shape == small.shape == (40, 96) and big.is_contiguous()
    assert torch.all(big.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(small.view(torch.int32) & 0x1FFF == 0)
    t = w[0, 0].t()
    assert torch.all((big + small - t).abs() <= t.abs() * 2.0 ** -22)
    again = gemm.weight_halves(w[0, 0])
    assert again[0] is big and again[1] is small
    w.mul_(2)
    big2, _ = gemm.weight_halves(w[0, 0])
    assert big2 is not big and torch.equal(big2, 2 * big)


def test_fp32_gemm_plain_version_is_its_emulation():
    gen = torch.Generator().manual_seed(7)
    a, w = torch.randn(130, 64, generator=gen), torch.randn(64, 72, generator=gen)
    assert torch.equal(fp32_gemm(a, w), ref.emulated_tf32x3_matmul(a, w))


@pytest.mark.parametrize("M,N,want", [(4096, 1152, 128), (1024, 1152, 128), (16384, 320, 128),
                                      (4096, 4608, 128), (1024, 640, 64), (1920, 1152, 128)])
def test_gemm_tile_width_fills_the_card_in_whole_waves(M, N, want):
    """The tile width at the cells' shapes on 132 SMs (``tile_n``): the
    narrow tile only where its tiles fit in one wave and the wide one's do
    not fill it much better."""
    assert gemm.tile_n(M, N, 132) == want
