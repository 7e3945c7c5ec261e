"""The whole domain the TPU kernels take, on the CPU: keys of another length
than the queries, head dims past the widest CUDA instance, fp16, and
GroupNorm groups past the stitch's 512 shared-memory groups. The JAX
package's Pallas attention kernel (interpret mode) and its GN-stitch oracle
(``patched_groupnorm`` then ``gather_halo``, as ``tests/test_kernels.py``
builds it) against the port's entry points, which take their plain versions
on CPU tensors; the plain models of the CUDA attention kernel's split-KV cut
and column slices at those shapes.

Tolerances: fp32 1e-4; bf16 3e-2 (attention) and 2e-2 (GN-stitch), the
reference's; fp16 takes bf16's. The fp16 attention error measured here is
at most 2.5e-4 (printed with ``-s``). Inputs come from a numpy seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernel_domain.py
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import patched_ops as jops  # noqa: E402
from repro.core import stitcher as jst  # noqa: E402
from repro.core.patching import split as jsplit  # noqa: E402
from repro.kernels.patch_attention import patch_attention as jattn  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.groupnorm_stitch import SMEM_GROUPS  # noqa: E402
from repro_torch.kernels.patch_attention import (  # noqa: E402
    BLOCK_K, NEG_INF, SLICE_WIDTH, column_slices, patch_attention, split_kv)

CSRC = Path(ref.__file__).parent / "csrc"
H100_SMS = 132
ATTN_TOL = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 3e-2}
GN_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}

ATTN_CASES = [  # B, Sq, Sk, H, D, dtype
    # SD 1.5's and PixArt-α's text lengths under image queries, and the reverse
    (1, 64, 77, 2, 40, "float32"),
    (1, 32, 120, 2, 72, "float32"),
    (1, 77, 33, 2, 16, "float32"),
    (2, 17, 200, 1, 8, "float32"),
    (1, 64, 77, 2, 40, "bfloat16"),
    (1, 120, 32, 2, 72, "bfloat16"),
    # head dims past the widest instance
    (1, 40, 40, 2, 257, "float32"),
    (1, 33, 50, 1, 300, "float32"),
    (1, 16, 24, 1, 512, "float32"),
    (1, 40, 40, 2, 300, "bfloat16"),
    # fp16, with and without equal lengths and wide heads
    (2, 100, 100, 4, 32, "float16"),
    (1, 64, 77, 2, 40, "float16"),
    (1, 32, 120, 2, 72, "float16"),
    (1, 40, 40, 2, 257, "float16"),
]


@pytest.mark.parametrize("B,Sq,Sk,H,D,dtype", ATTN_CASES)
def test_patch_attention_matches_pallas_kernel_over_its_domain(B, Sq, Sk, H, D, dtype):
    rng = np.random.default_rng(Sq * 1000 + Sk + D)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, H, D)).astype(np.float32) for _ in range(2))
    want = jattn(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), interpret=True)
    got = patch_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Sq, H, D)
    err = float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())
    print(f"patch_attention B={B} Sq={Sq} Sk={Sk} H={H} D={D} {dtype}: max abs err {err:.3e}")
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_neg_inf_is_the_reference_padding_score():
    assert NEG_INF == -1e30


@pytest.mark.parametrize("Sq,Sk", [(50, 200), (300, 77), (7, 129)])
def test_split_kv_merge_equals_attention_at_other_key_lengths(Sq, Sk):
    """Every n_split from 1 to the key tiles of Sk: the ranges come from the
    keys, whatever the number of queries."""
    rng = np.random.default_rng(Sq + Sk)
    q = torch.from_numpy(rng.normal(size=(2, Sq, 2, 24)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, Sk, 2, 24)).astype(np.float32))
            for _ in range(2))
    want = ref.ref_attention(q, k, v)
    tiles = -(-Sk // BLOCK_K)
    for n in range(1, tiles + 1):
        ranges = ref.key_ranges(Sk, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == Sk and all(a < b for a, b in ranges)
        np.testing.assert_allclose(ref.ref_attention_split(q, k, v, n).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f"n_split={n}")


@pytest.mark.parametrize("B,Sq,Sk,H,block_q,want", [
    (1, 4096, 120, 16, 64, 1),     # PixArt-α's cross shape fills the card without a split
    (1, 4096, 77, 8, 64, 1),
    (1, 77, 4096, 8, 64, 9),       # 16 query tiles: nine ranges of the 64 key tiles
    (1, 77, 100, 8, 64, 2),        # at most one range per key tile
    (1, 100, 100, 2, 64, 2),
])
def test_split_rule_counts_query_tiles_from_sq_and_key_tiles_from_sk(B, Sq, Sk, H, block_q,
                                                                     want):
    assert split_kv(B, Sq, H, H100_SMS, block_q, Sk) == want


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_split_rule_counts_column_slices_as_blocks(slices):
    """A wide head dim's slices are blocks of the grid too: B=1, S=1024,
    H=2 has 32 query tiles, so 4 slices leave 128 blocks and 2 key ranges."""
    n = split_kv(1, 1024, 2, H100_SMS, 64, slices=slices)
    assert n == {1: 5, 2: 3, 4: 2}[slices]
    assert 32 * slices * n >= H100_SMS


def test_column_slices_cover_every_head_dim():
    assert SLICE_WIDTH == 256
    with pytest.raises(ValueError, match="head dim 0 < 1"):
        column_slices(0)
    for D in range(1, 4 * SLICE_WIDTH + 1):
        n = column_slices(D)
        assert (n - 1) * SLICE_WIDTH < D <= n * SLICE_WIDTH


def test_smem_groups_mirror_the_kernel_source():
    """The wrapper allocates the statistics buffer exactly where the stitch
    kernel leaves its shared memory for it."""
    m = re.search(r"constexpr int kSmemGroups = (\d+);",
                  (CSRC / "groupnorm_stitch.cu").read_text())
    assert m and int(m.group(1)) == SMEM_GROUPS


GN_CASES = [  # res, C, G, dtype
    ([(16, 16), (32, 32)], 16, 16, "float32"),        # per-channel statistics
    ([(16, 16), (24, 24)], 640, 640, "float32"),      # SD 1.5's width, past 512 groups
    ([(16, 16)], 1026, 513, "float32"),
    ([(16, 16), (24, 24)], 640, 640, "bfloat16"),
    ([(16, 16), (32, 32)], 16, 4, "float16"),
    ([(16, 16), (24, 24)], 24, 24, "float16"),
    ([(16, 16)], 640, 640, "float16"),
]


@pytest.mark.parametrize("res,C,G,dtype", GN_CASES)
@pytest.mark.parametrize("exact", [True, False])
def test_groupnorm_stitch_matches_reference_over_its_domain(res, C, G, dtype, exact):
    """The port's entry point against the reference's plain composite; the
    Pallas GN-stitch does not run under the installed jax."""
    rng = np.random.default_rng(C + G)
    imgs = [rng.normal(size=(h, w, C)).astype(np.float32) for h, w in res]
    scale, bias = (rng.normal(size=(C,)).astype(np.float32) for _ in range(2))
    jc, jp = jsplit([jnp.asarray(i, getattr(jnp, dtype)) for i in imgs])
    tc, tp = tsplit([torch.from_numpy(i).to(getattr(torch, dtype)) for i in imgs])
    got = ops.fused_groupnorm_stitch(tc, tp, torch.from_numpy(scale), torch.from_numpy(bias), G,
                                     exact=exact)
    # jitted over the fixed CSP: one compile instead of one per eager op
    oracle = jax.jit(lambda x, sc, bi: jst.gather_halo(
        jops.patched_groupnorm(jc, x, sc, bi, G, exact=exact), jc.neighbors))
    want = oracle(jp, jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == tp.dtype and got.shape == want.shape
    tol = GN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
