"""The CUDA kernels against their plain versions on the card, at small
shapes; ``chip_smoke.py`` repeats this at the main path's shapes. Imports no
JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Each case skips itself where ``torch.cuda.is_available()`` is false.
Tolerances are the reference's: fp32 1e-4, bf16 2e-2 (GN-stitch) and 3e-2
(attention)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import patched_ops as tops  # noqa: E402
from repro_torch.core import stitcher as tst  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.groupnorm_stitch import groupnorm_stitch  # noqa: E402
from repro_torch.kernels.patch_attention import patch_attention  # noqa: E402

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
]


def _tol(dtype, bf16_tol):
    return bf16_tol if dtype == "bfloat16" else 1e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exact", [True, False])
def test_groupnorm_stitch_kernel_matches_plain_on_cuda(dtype, exact):
    """The launch that chip_smoke.py's phase 2 repeats at full size."""
    _need_cuda()
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.normal(size=(h, w, 64)).astype(np.float32))
            for h, w in [(32, 32), (48, 48), (64, 64)]]
    tc, tp = tsplit([i.to("cuda", getattr(torch, dtype)) for i in imgs])
    scale, bias = (torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).cuda()
                   for _ in range(2))
    before = groupnorm_stitch.launches
    got = ops.fused_groupnorm_stitch(tc, tp, scale, bias, 8, exact=exact)
    torch.cuda.synchronize()
    assert groupnorm_stitch.launches == before + 1
    want = tst.gather_halo(tops.patched_groupnorm(tc, tp, scale, bias, 8, exact=exact),
                           tc.neighbors)
    tol = _tol(dtype, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
def test_patch_attention_rejects_misaligned_views_on_cuda():
    """The kernel copies 16-byte chunks: a base pointer or stride off 16 bytes
    raises before anything is launched."""
    _need_cuda()
    B, S, H, D = 1, 64, 2, 16
    flat = torch.randn(B * S * H * D + 1, device="cuda")
    shifted = flat[1:].view(B, S, H, D)                       # base off by 4 bytes
    padded = torch.randn(B, S, H * D + 1, device="cuda")[..., :H * D].view(B, S, H, D)
    ok = torch.randn(B, S, H, D, device="cuda")
    before = patch_attention.launches
    for q, k, v in ((shifted, ok, ok), (ok, padded, ok), (ok, ok, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            patch_attention(q, k, v)
    assert patch_attention.launches == before
