"""The CUDA kernels against their plain versions on the card, at small
shapes; ``chip_smoke.py`` repeats this at the main path's shapes. Imports no
JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Each case skips itself where ``torch.cuda.is_available()`` is false.
Tolerances are the reference's: fp32 1e-4, bf16 2e-2 (GN-stitch) and 3e-2
(attention); fp16 takes bf16's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import patched_ops as tops  # noqa: E402
from repro_torch.core import stitcher as tst  # noqa: E402
from repro_torch.core.csp_device import csp_device  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import fp32_gemm as gemm  # noqa: E402
from repro_torch.kernels.fp32_gemm import fp32_gemm  # noqa: E402
from repro_torch.kernels.groupnorm_stitch import (  # noqa: E402
    gn_partials, gn_stitch, groupnorm_stitch)
from repro_torch.kernels.patch_attention import (  # noqa: E402
    INSTANCE_WIDTHS, ROUTES, SLICE_WIDTH, block_q, column_slices, instance_width,
    patch_attention, route, split_kv)

ATTN_SWEEP = [  # tests/test_kernels.py::test_patch_attention_sweep, plus a main-path S
    (2, 100, 4, 32, "float32"),
    (1, 256, 2, 64, "float32"),
    (3, 65, 1, 16, "float32"),
    (2, 128, 2, 32, "bfloat16"),
    (1, 17, 3, 8, "float32"),
    (2, 1024, 4, 32, "float32"),
    (1, 1024, 4, 32, "float32"),      # split-KV: 64 query tiles on 132 SMs
    (2, 4096, 4, 32, "float32"),
    (2, 1024, 4, 32, "bfloat16"),
    (1, 65, 2, 8, "bfloat16"),        # D=8 padded to the MMA depth, ragged tail
    (1, 1024, 4, 16, "float32"),      # SD3-lite's own heads: fp32 also at dtype="bfloat16"
    (1, 4096, 4, 16, "float32"),
] + [  # public head dims, both dtypes, with split-KV (B=1, S=1024) and without (B=2, S=4096)
    (B, S, 4, D, dtype) for D in (12, 24, 40, 72, 80, 128, 160, 256)
    for B, S in ((1, 1024), (2, 4096)) for dtype in ("float32", "bfloat16")] + [
    # fp16 at the main path's D = 32 and at PixArt-α's 72 and SD 1.5's 40
    (2, 1024, 4, 32, "float16"), (1, 1024, 4, 32, "float16"), (2, 4096, 4, 32, "float16"),
    (1, 1024, 16, 72, "float16"), (1, 1024, 8, 40, "float16"), (1, 65, 2, 8, "float16")]
# queries and keys of different lengths (B, Sq, Sk, H, D): PixArt-α's and SD
# 1.5's text lengths (120, 77) under image queries, the reverse, one key, one
# query, and keys of less than one tile
ATTN_CROSS = [(1, 4096, 120, 16, 72), (1, 4096, 77, 8, 40), (1, 77, 4096, 8, 40),
              (2, 64, 77, 2, 32), (1, 32, 120, 2, 16), (1, 100, 1, 2, 16), (1, 1, 300, 2, 64),
              (2, 300, 33, 2, 160), (1, 200, 77, 2, 320)]
# head dims past the widest instance (B, Sq, Sk, H, D): column slices, ragged
# last slices, split-KV (B=1) and not
ATTN_WIDE = [(1, 100, 100, 2, D) for D in (257, 300, 320, 512, 640, 1024)] + [
    (2, 1024, 1024, 4, 512), (1, 4096, 4096, 2, 320), (1, 65, 130, 1, 1000)]
# query rows per block of each instance (csrc/patch_attention.cu): the fp32
# route's two warpgroups of 64 rows (kWgRows); on the mma.sync route 4 warps x
# 16 rows x the m16 tiles a warp owns (Route::kM), which past the widest
# instance runs every dtype's column slices at the widest's rows
INSTANCE_BLOCK_Q = {**{("float32", w): 128 for w in INSTANCE_WIDTHS},
                    **{(t, w): 128 if w <= 64 else 64 for w in INSTANCE_WIDTHS
                       for t in ("bfloat16", "float16")}}
SLICE_BLOCK_Q = 64
# the fp32 route at the benchmark cells' shapes (B, Sq, Sk, H, D), Sk None for
# Sq keys: SD 1.5's D = 40 / 80 / 160 at its levels' sequences, PixArt-α's D =
# 72, the text keys under image queries, a ragged S, split-KV groups (S = 65
# and 256 over 2 heads, B = 3 over 4) and a batch
WG_CELL_SHAPES = [(1, 16384, None, 8, 40), (1, 9216, None, 8, 40), (1, 4096, None, 8, 80),
                  (1, 1024, None, 8, 160), (1, 4096, None, 16, 72), (1, 2304, None, 16, 72),
                  (1, 4096, 77, 8, 40), (1, 4096, 120, 16, 72), (1, 65, None, 2, 40),
                  (1, 256, None, 2, 72), (3, 1024, None, 4, 80)]
DTYPES = ["float32", "bfloat16", "float16"]
# (M, N, K) of the cells' fp32 products: PixArt-α's projections at 4096 tokens,
# its feed-forward at 1024 and 2048, its text K/V (16 patches x 120 tokens of
# 4096), SD 1.5's level-0 projections and level-2 feed-forward; a ragged M, N
# and K, and a ragged M and N at K = 4096
GEMM_CELL_SHAPES = [(4096, 1152, 1152), (1024, 4608, 1152), (2048, 1152, 4608),
                    (1920, 1152, 4096), (4096, 320, 320), (1856, 1280, 5120),
                    (1000, 1150, 1148), (1337, 642, 4096)]


def _tol(dtype, bf16_tol):
    return 1e-4 if dtype == "float32" else bf16_tol


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _gn_case(res, C, dtype, patch=None, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [torch.from_numpy(rng.normal(size=(h, w, C)).astype(np.float32))
            for h, w in res]
    tc, tp = tsplit([i.to("cuda", getattr(torch, dtype)) for i in imgs], patch=patch)
    scale, bias = (torch.from_numpy(rng.normal(size=(C,)).astype(np.float32)).cuda()
                   for _ in range(2))
    return tc, tp, scale, bias


def _plain_composite(csp, patches, scale, bias, G, exact):
    return tst.gather_halo(tops.patched_groupnorm(csp, patches, scale, bias, G, exact=exact),
                           csp_device(csp, patches.device).neighbors)


GN_CUDA_CASES = [  # res, C, G, patch
    ([(32, 32), (48, 48), (64, 64)], 64, 8, None),     # the test's usual CSP (p=16)
    ([(32, 32), (64, 64), (96, 96)], 64, 8, 32),       # a request of one patch
    ([(16, 16), (24, 24)], 12, 3, 8),                  # C % 4 != 0: the VEC=1 path
    ([(16, 16), (32, 32)], 8, 4, 8),                   # groups of 2 channels inside a vector
    ([(16, 16)], 2048, 32, 16),                        # more channel vectors than threads
    # groups past the stitch's shared memory (512): per-channel statistics at
    # SD 1.5's widths, two partials chunks of 768 groups, and a G of 2-channel
    # groups whose C is not whole 16-byte vectors
    ([(16, 16), (32, 32)], 640, 640, 8),
    ([(16, 16), (24, 24)], 1280, 1280, 8),
    ([(16, 16)], 2048, 1024, 8),
    ([(16, 16), (24, 24)], 1026, 513, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("exact", [True, False])
def test_groupnorm_stitch_kernel_matches_plain_on_cuda(dtype, exact):
    """The launch that chip_smoke.py's phase 2 repeats at full size: two
    kernels for one counted call."""
    _need_cuda()
    tc, tp, scale, bias = _gn_case([(32, 32), (48, 48), (64, 64)], 64, dtype)
    before = [fn.launches for fn in (gn_partials, gn_stitch, groupnorm_stitch)]
    got = ops.fused_groupnorm_stitch(tc, tp, scale, bias, 8, exact=exact)
    torch.cuda.synchronize()
    after = [fn.launches for fn in (gn_partials, gn_stitch, groupnorm_stitch)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    tol = _tol(dtype, 2e-2)
    torch.testing.assert_close(got.float(), _plain_composite(tc, tp, scale, bias, 8,
                                                             exact).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("res,C,G,patch", GN_CUDA_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gn_partials_kernel_matches_plain_on_cuda(res, C, G, patch, dtype):
    _need_cuda()
    _, tp, _, _ = _gn_case(res, C, dtype, patch)
    got = gn_partials(tp, G)
    want = ref.ref_gn_partials(tp, G)
    torch.cuda.synchronize()
    # sums of up to p*p*C/G terms in another order, fp32 either way
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("res,C,G,patch", GN_CUDA_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("exact", [True, False])
def test_groupnorm_stitch_shapes_match_plain_on_cuda(res, C, G, patch, dtype, exact):
    """The whole call against the plain composite (patched_groupnorm +
    gather_halo), and the stitch kernel alone against the plain finalise +
    stitch on the same partials."""
    _need_cuda()
    tc, tp, scale, bias = _gn_case(res, C, dtype, patch)
    got = ops.fused_groupnorm_stitch(tc, tp, scale, bias, G, exact=exact)
    meta = csp_device(tc, tp.device)
    part = ref.ref_gn_partials(tp, G)
    alone = gn_stitch(tp, part, meta.neighbors_i32, meta.patch_req_i32,
                      meta.request_offset_i32, scale, bias, exact=exact)
    mean, rstd = ref.ref_gn_finalize(part, meta.patch_req_i32, meta.request_offset_i32,
                                     tp.shape[1], C, 1e-5, exact)
    plain = ref.ref_groupnorm_stitch(tp, meta.neighbors_i32,
                                     mean.repeat_interleave(C // G, dim=-1),
                                     rstd.repeat_interleave(C // G, dim=-1), scale, bias)
    torch.cuda.synchronize()
    tol = _tol(dtype, 2e-2)
    torch.testing.assert_close(got.float(), _plain_composite(tc, tp, scale, bias, G,
                                                             exact).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(alone.float(), plain.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_groupnorm_stitch_is_captured_in_a_cuda_graph(exact):
    """The whole call, captured: a host copy or a synchronise inside it would
    fail the capture. The CSP's metadata is uploaded by the warm-up call."""
    _need_cuda()
    tc, tp, scale, bias = _gn_case([(32, 32), (48, 48), (64, 64)], 64, "float32")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = ops.fused_groupnorm_stitch(tc, tp, scale, bias, 8, exact=exact)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.fused_groupnorm_stitch(tc, tp, scale, bias, 8, exact=exact)
    tp.add_(torch.rand_like(tp))       # new data in the captured input
    graph.replay()
    torch.cuda.synchronize()
    again = ops.fused_groupnorm_stitch(tc, tp, scale, bias, 8, exact=exact)
    torch.testing.assert_close(got, again, rtol=1e-4, atol=1e-4)
    assert not torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,dtype", ATTN_SWEEP)
def test_patch_attention_kernel_matches_plain_on_cuda(B, S, H, D, dtype):
    _need_cuda()
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, S, 3, H, D, generator=gen).to("cuda", getattr(torch, dtype))
    q, k, v = qkv.unbind(dim=2)           # strided views, as the projections give
    before = patch_attention.launches
    got = patch_attention(q, k, v)
    torch.cuda.synchronize()
    assert patch_attention.launches == before + 1
    tol = _tol(dtype, 3e-2)
    torch.testing.assert_close(got.float(), ref.ref_attention(q, k, v).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 72])
def test_patch_attention_rejects_misaligned_views_on_cuda(D):
    """The kernel copies 16-byte chunks: a base pointer or stride off 16 bytes
    raises before anything is launched."""
    _need_cuda()
    B, S, H = 1, 64, 2
    flat = torch.randn(B * S * H * D + 1, device="cuda")
    shifted = flat[1:].view(B, S, H, D)                       # base off by 4 bytes
    padded = torch.randn(B, S, H * D + 1, device="cuda")[..., :H * D].view(B, S, H, D)
    ok = torch.randn(B, S, H, D, device="cuda")
    before = patch_attention.launches
    for q, k, v in ((shifted, ok, ok), (ok, padded, ok), (ok, ok, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            patch_attention(q, k, v)
    assert patch_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,D", ATTN_CROSS + ATTN_WIDE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_patch_attention_takes_other_key_lengths_and_wide_heads_on_cuda(B, Sq, Sk, H, D, dtype):
    """Keys of another length than the queries, and head dims past the
    widest instance (in column slices), against the plain version."""
    _need_cuda()
    gen = torch.Generator().manual_seed(Sq * 7 + Sk + D)
    t = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, D, generator=gen).to("cuda", t)
    k, v = torch.randn(B, Sk, 2, H, D, generator=gen).to("cuda", t).unbind(dim=2)
    before = patch_attention.launches
    got = patch_attention(q, k, v)
    torch.cuda.synchronize()
    assert patch_attention.launches == before + 1
    assert got.shape == (B, Sq, H, D) and got.dtype == t and got.is_contiguous()
    tol = _tol(dtype, 3e-2)
    torch.testing.assert_close(got.float(), ref.ref_attention(q, k, v).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_patch_attention_takes_head_dims_past_the_widest_instance_on_cuda(dtype):
    """Past the widest instance D runs in column slices; only D = 0 raises."""
    _need_cuda()
    t = getattr(torch, dtype)
    before = patch_attention.launches
    x = torch.zeros(1, 16, 2, 0, device="cuda", dtype=t)
    with pytest.raises(ValueError, match="head dim 0 < 1"):
        patch_attention(x, x, x)
    assert patch_attention.launches == before
    q, k, v = torch.randn(3, 1, 16, 2, SLICE_WIDTH + 1, device="cuda").to(t).unbind(dim=0)
    got = patch_attention(q, k, v)
    assert patch_attention.launches == before + 1 and column_slices(SLICE_WIDTH + 1) == 2
    tol = _tol(dtype, 3e-2)
    torch.testing.assert_close(got.float(), ref.ref_attention(q, k, v).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_instance_reports_its_block_rows_on_cuda(dtype):
    """The rows the split rule counts: the library's per instance, the same
    for every head dim the instance runs, the widest's past it."""
    _need_cuda()
    t = getattr(torch, dtype)
    for D in range(1, 4 * SLICE_WIDTH + 1):
        want = (INSTANCE_BLOCK_Q[(dtype, instance_width(D))] if D <= SLICE_WIDTH
                else SLICE_BLOCK_Q)
        assert block_q(t, D) == want, D


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_head_dim_matches_plain_on_cuda(dtype):
    """D = 1..512 at a small shape that takes the split-KV path, unaligned
    rows (padded in a copy) and column slices included."""
    _need_cuda()
    gen = torch.Generator().manual_seed(1)
    t = getattr(torch, dtype)
    for D in range(1, 2 * SLICE_WIDTH + 1):
        q, k, v = torch.randn(1, 100, 3, 2, D, generator=gen).to("cuda", t).unbind(dim=2)
        assert split_kv(1, 100, 2, torch.cuda.get_device_properties(0).multi_processor_count,
                        block_q(t, D), slices=column_slices(D)) == 2
        got = patch_attention(q, k, v)
        torch.cuda.synchronize()
        assert got.shape == (1, 100, 2, D) and got.is_contiguous()
        tol = _tol(dtype, 3e-2)
        torch.testing.assert_close(got.float(), ref.ref_attention(q, k, v).float(),
                                   rtol=tol, atol=tol, msg=lambda m: f"D={D}: {m}")


def _per_head(fn, q, k, v):
    """``fn`` over one head at a time, so that the (Sq, Sk) scores of the
    largest shapes are made one head's at a time."""
    return torch.cat([fn(q[:, :, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1])
                      for h in range(q.shape[2])], dim=2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,D", WG_CELL_SHAPES)
def test_fp32_route_matches_its_emulation_at_the_cells_shapes_on_cuda(B, Sq, Sk, H, D):
    """The wgmma route against ``ref.emulated_attention`` (its own 3xbf16
    rounding) and plain attention, fp32 1e-4, each call counted on it."""
    _need_cuda()
    gen = torch.Generator().manual_seed(Sq + D)
    if Sk is None:    # strided views of one projection, as the models make them
        q, k, v = torch.randn(B, Sq, 3, H, D, generator=gen).cuda().unbind(dim=2)
    else:
        q = torch.randn(B, Sq, H, D, generator=gen).cuda()
        k, v = torch.randn(B, Sk, 2, H, D, generator=gen).cuda().unbind(dim=2)
    before = dict(patch_attention.launches_by_route)
    got = patch_attention(q, k, v)
    torch.cuda.synchronize()
    assert route(torch.float32, D) == "wgmma_3xbf16"
    assert patch_attention.launches_by_route["wgmma_3xbf16"] == before["wgmma_3xbf16"] + 1
    assert patch_attention.launches_by_route["mma_sync"] == before["mma_sync"]
    for want in (_per_head(ref.emulated_attention, q, k, v), _per_head(ref.ref_attention, q, k, v)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("float32", 40), ("float32", 256), ("float32", 257),
                                     ("float32", 13), ("bfloat16", 40), ("bfloat16", 512),
                                     ("float16", 72)])
def test_launches_by_route_counts_each_call_on_its_route_on_cuda(dtype, D):
    """fp32 up to the widest instance runs the wgmma route, bf16, fp16 and
    any D past it the mma.sync route; each call counts once, on its route."""
    _need_cuda()
    t = getattr(torch, dtype)
    q, k, v = torch.randn(3, 1, 100, 2, D, generator=torch.Generator().manual_seed(D)).to(
        "cuda", t).unbind(dim=0)
    before = dict(patch_attention.launches_by_route)
    got = patch_attention(q, k, v)
    torch.cuda.synchronize()
    want = route(t, D)
    assert want == ("wgmma_3xbf16" if dtype == "float32" and D <= SLICE_WIDTH else "mma_sync")
    assert {r: patch_attention.launches_by_route[r] - before[r] for r in ROUTES} == {
        r: int(r == want) for r in ROUTES}
    tol = _tol(dtype, 3e-2)
    torch.testing.assert_close(got.float(), ref.ref_attention(q, k, v).float(),
                               rtol=tol, atol=tol)


def _gemm_errors(got, exact):
    """(RMS error over the RMS of ``exact``, max abs error) against fp64."""
    d = got.double() - exact
    return float(d.pow(2).mean().sqrt() / exact.pow(2).mean().sqrt()), float(d.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", GEMM_CELL_SHAPES)
@pytest.mark.parametrize("tile", [64, 128])
def test_fp32_gemm_against_fp64_at_the_cells_shapes_on_cuda(M, N, K, tile, monkeypatch):
    """The kernel at each tile width against an fp64 product: its RMS and
    max errors at most 2x those of torch.matmul in fp32 (TF32 off), each
    call one launch on the kernel's route."""
    _need_cuda()
    monkeypatch.setattr(gemm, "tile_n", lambda *_: tile)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=gen).cuda()
    w = (torch.randn(K, N, generator=gen) * K ** -0.5).cuda()
    exact = a.double() @ w.double()
    before = (fp32_gemm.launches, dict(fp32_gemm.launches_by_route))
    got = fp32_gemm(a, w)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == torch.float32 and got.is_contiguous()
    assert fp32_gemm.launches == before[0] + 1
    assert fp32_gemm.launches_by_route == {**before[1],
                                           "wgmma_3xtf32": before[1]["wgmma_3xtf32"] + 1}
    rms, mx = _gemm_errors(got, exact)
    t_rms, t_mx = _gemm_errors(a @ w, exact)
    assert rms <= 2 * t_rms and mx <= 2 * t_mx, (rms, t_rms, mx, t_mx)


@pytest.mark.cuda
def test_weight_matmul_counts_each_call_on_its_route_on_cuda():
    """Under use_kernels a product of CUDA tensors counts once on its route:
    the kernel at the cells' shapes, torch.matmul for a product of a row a
    request (adaLN); without use_kernels it is ``a @ b`` bit for bit and
    counts nothing."""
    _need_cuda()
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 1024, 1152, generator=gen).cuda()
    w = (torch.randn(1152, 1152, generator=gen) / 34).cuda()
    t = torch.randn(12, 256, generator=gen).cuda()
    wt = torch.randn(256, 3456, generator=gen).cuda()
    before = dict(fp32_gemm.launches_by_route)
    got = tops.matmul(x, w, use_kernels=True)
    small = tops.matmul(t, wt, use_kernels=True)
    assert {r: fp32_gemm.launches_by_route[r] - before[r] for r in gemm.ROUTES} == {
        "wgmma_3xtf32": 1, "torch": 1}
    assert got.shape == (2, 1024, 1152) and torch.equal(small, t @ wt)
    torch.testing.assert_close(got, x @ w, rtol=1e-4, atol=1e-4)
    assert torch.equal(tops.matmul(x, w), x @ w)
    assert {r: fp32_gemm.launches_by_route[r] - before[r] for r in gemm.ROUTES} == {
        "wgmma_3xtf32": 1, "torch": 1}


@pytest.mark.cuda
def test_fp32_gemm_refuses_what_it_does_not_take_on_cuda():
    """A launch the kernel does not take raises, in the wrapper or from the
    library's own check, and launches nothing: no fallback."""
    _need_cuda()
    a = torch.randn(1024, 1160, device="cuda")
    w = torch.randn(1152, 1152, device="cuda")
    before = fp32_gemm.launches
    for args, what in (((a[:, :1150], torch.randn(1150, 1152, device="cuda")), "multiple of 4"),
                       ((a[:, :1152], torch.randn(1152, 1151, device="cuda")), "N even"),
                       ((a[:, 1:1153], w), "16-byte aligned"),
                       ((a[:, :1152].half(), w), "fp32 a"),
                       ((a[:, :1152], w.cpu()), "one CUDA device")):
        with pytest.raises(ValueError, match=what):
            fp32_gemm(*args)
    big, small = gemm.weight_halves(w)
    out = torch.empty(1024, 1152, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="cudaError_t"):   # a tile width it has no instance of
        build.check(build.library().ps_fp32_gemm(a.data_ptr(), big.data_ptr(), small.data_ptr(),
                                                  out.data_ptr(), 1024, 1152, 1152, 1160, 96,
                                                  72, stream), "fp32_gemm")
    assert fp32_gemm.launches == before
