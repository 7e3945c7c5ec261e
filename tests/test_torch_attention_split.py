"""The attention kernel's arithmetic, checked on the CPU through its plain
models in ``repro_torch.kernels.ref``: the split-KV cut and log-sum-exp merge,
the rule that picks the number of splits, and the rounding of the
tensor-core products (three bf16 passes for fp32, one for bf16).

Tolerances: the split merge is exact up to fp32 summation order (1e-5); the
emulated products are held to the kernel's own tolerances, fp32 1e-4 and
bf16 3e-2. Inputs come from a numpy seed."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.patch_attention import (  # noqa: E402
    BLOCK_K, ROUTES, SLICE_WIDTH, patch_attention, route, split_kv)

H100_SMS = 132
SOURCE = Path(ref.__file__).parent / "csrc" / "patch_attention.cu"


def _qkv(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3)]


def test_block_k_mirrors_the_kernel_tile():
    """The split rule and key_ranges count keys in the kernel's own tiles."""
    m = re.search(r"constexpr int kBlockK = (\d+);", SOURCE.read_text())
    assert m and int(m.group(1)) == BLOCK_K


def _fp32_block_q() -> int:
    """Query rows per block of the fp32 wgmma route: 64 a warpgroup, kWgs
    warpgroups (csrc/patch_attention.cu)."""
    m = re.search(r"constexpr int kWgs = (\d+);", SOURCE.read_text())
    assert m and re.search(r"constexpr int kWgRows = 64 \* kWgs;", SOURCE.read_text())
    return 64 * int(m.group(1))


def test_fp32_route_rows_are_whole_warpgroups():
    """Two or more warpgroups of 64 rows: the rows the split rule counts for
    every fp32 head dim up to the widest instance."""
    assert _fp32_block_q() in (128, 192, 256)


# the benchmark cells' attention groups at one request (B = 1): SD 1.5's H = 8
# and PixArt-α's H = 16 at every level's sequence from 256 to 16,384 queries,
# over their own tokens and over the text keys (77 and 120)
CELL_GROUPS = [(S, H, Sk) for H in (8, 16) for S in (256, 576, 1024, 2304, 4096, 9216, 16384)
               for Sk in (None, 77, 120)]


@pytest.mark.parametrize("S,H,Sk", CELL_GROUPS)
def test_split_rule_at_the_fp32_route_rows(S, H, Sk):
    """At the wgmma route's rows per block every key range is whole tiles and
    holds a key, the ranges cover the keys in order, and the blocks reach the
    132 SMs unless every key tile already has a range of its own."""
    block_q = _fp32_block_q()
    keys = S if Sk is None else Sk
    n = split_kv(1, S, H, H100_SMS, block_q, Sk)
    tiles = -(-keys // BLOCK_K)
    ranges = ref.key_ranges(keys, n)
    assert 1 <= n <= tiles and len(ranges) == n
    assert ranges[0][0] == 0 and ranges[-1][1] == keys
    for (a, b), (c, _) in zip(ranges, ranges[1:] + [(keys, None)]):
        assert a < b == c and a % BLOCK_K == 0
    assert H * -(-S // block_q) * n >= H100_SMS or n == tiles


@pytest.mark.parametrize("dtype,D,want", [
    (torch.float32, 1, "wgmma_3xbf16"), (torch.float32, 40, "wgmma_3xbf16"),
    (torch.float32, SLICE_WIDTH, "wgmma_3xbf16"), (torch.float32, SLICE_WIDTH + 1, "mma_sync"),
    (torch.bfloat16, 40, "mma_sync"), (torch.float16, 72, "mma_sync"),
    (torch.bfloat16, SLICE_WIDTH + 1, "mma_sync")])
def test_route_is_chosen_by_dtype_and_head_dim(dtype, D, want):
    """The route a call runs depends on its dtype and head dim alone."""
    assert route(dtype, D) == want and want in ROUTES


def test_cpu_calls_count_no_launch():
    """A CPU tensor takes the plain version and counts on no route."""
    before = dict(patch_attention.launches_by_route)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 17, 2, 8, seed=3))
    patch_attention(q, k, v)
    assert patch_attention.launches_by_route == before


@pytest.mark.parametrize("S,n_split", [(17, 1), (65, 2), (1024, 3), (4096, 5)])
def test_split_kv_merge_equals_attention(S, n_split):
    """Per-range partials merged by log-sum-exp give plain attention; S=65
    with 2 splits leaves a last range of one key."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, S, 2, 8, seed=S))
    got = ref.ref_attention_split(q, k, v, n_split)
    np.testing.assert_allclose(got.numpy(), ref.ref_attention(q, k, v).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_split_kv_merge_matches_jax_reference():
    q, k, v = _qkv(2, 200, 2, 16, seed=4)
    got = ref.ref_attention_split(*map(torch.from_numpy, (q, k, v)), 4)
    want = jref.ref_attention(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_q", [64, 128])
def test_split_rule_fills_the_card_at_the_smallest_group(block_q):
    """B=1, S=1024, H=4 has 32 or 64 query tiles; the split reaches 132
    blocks."""
    B, S, H = 1, 1024, 4
    n = split_kv(B, S, H, H100_SMS, block_q)
    assert n > 1 and B * H * -(-S // block_q) * n >= H100_SMS


@pytest.mark.parametrize("B,H,n_sm,block_q", [(1, 1, 132, 128), (1, 4, 132, 64),
                                              (2, 4, 132, 128), (3, 2, 80, 64)])
def test_split_ranges_are_whole_nonempty_tiles(B, H, n_sm, block_q):
    """For every S from 1 to 4096 the ranges are non-empty, cover [0, S) in
    order, and start on tile boundaries."""
    for S in range(1, 4097):
        n = split_kv(B, S, H, n_sm, block_q)
        ranges = ref.key_ranges(S, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == S
        for (a, b), (c, _) in zip(ranges, ranges[1:] + [(S, None)]):
            assert a < b == c and a % BLOCK_K == 0, (S, n, ranges)


# the smallest B * H group of each public head dim on the main path: PixArt-α's
# DiT (H = 16, D = 72) and SD 1.5's UNet (H = 8, D = 40 / 80 / 160 at levels
# 0 / 1 / 2) at latents 32², 48², 64²
PUBLIC_GROUPS = [(1, S, 16) for S in (1024, 2304, 4096)] + [
    (1, S, 8) for S in (64, 144, 256, 576, 1024, 2304, 4096)]


@pytest.mark.parametrize("block_q", [64, 128])    # every instance reports one of the two
@pytest.mark.parametrize("B,S,H", PUBLIC_GROUPS)
def test_split_rule_fills_the_card_at_each_public_group(B, S, H, block_q):
    """At one request per group, the split reaches 132 blocks, or, where the
    sequence is too short for that, takes every key tile (one range each)."""
    n = split_kv(B, S, H, H100_SMS, block_q)
    tiles = -(-S // BLOCK_K)
    assert 1 <= n <= tiles
    assert B * H * -(-S // block_q) * n >= H100_SMS or n == tiles


@pytest.mark.parametrize("B,S,H,block_q", [(2, 4096, 4, 128), (1, 4096, 4, 64),
                                           (1, 2304, 4, 64), (4, 1024, 8, 128)])
def test_no_split_when_the_grid_fills_the_card(B, S, H, block_q):
    assert B * H * -(-S // block_q) >= H100_SMS
    assert split_kv(B, S, H, H100_SMS, block_q) == 1


EMULATED = [(7, 3, 1e-4),     # fp32 kernel: 3xbf16
            (7, 1, 3e-2),     # bf16 kernel
            (10, 3, 1e-4)]    # 3xTF32, the alternative


@pytest.mark.parametrize("bits,passes,tol,D", [  # D = 32 keeps its first ids
    pytest.param(*case, D, id="-".join(map(str, case)) + ("" if D == 32 else f"-D{D}"))
    for D in (32, 72, 160, 256) for case in EMULATED])
def test_emulated_products_hold_the_tolerance_at_s4096(bits, passes, tol, D):
    """The kernel's rounding at S = 4096, from the UNet's D = 32 to the
    widest instance; padded columns are zeros and add nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4096, 1, D, seed=7))
    err = (ref.emulated_attention(q, k, v, bits, passes) - ref.ref_attention(q, k, v)).abs()
    print(f"emulated attention D={D}, {bits} mantissa bits x {passes} passes: "
          f"max_abs_err {float(err.max()):.3e} (tol {tol:g})")
    assert float(err.max()) <= tol


@pytest.mark.parametrize("bits", [7, 10])
def test_one_pass_loses_what_three_keep(bits):
    """The split is there for accuracy: dropping the two correction passes
    raises the logit error by orders of magnitude, to above 1e-4."""
    q, k, _ = (torch.from_numpy(a[0, :, 0]) for a in _qkv(1, 4096, 1, 32, seed=8))
    exact = q.double() @ k.double().T
    err = {p: float((ref.split_matmul(q, k.T, bits, p).double() - exact).abs().max())
           for p in (1, 3)}
    print(f"q k^T logits, {bits} mantissa bits: max_abs_err by passes {err}")
    assert err[1] > 1e-4 and err[1] > 100 * err[3]


@pytest.mark.parametrize("bits", [10, 7])
def test_round_mantissa_keeps_the_format_bits(bits):
    """TF32 (10 bits) and bf16 (7 bits): the dropped bits are zero and the
    rounding error is at most half a unit in the last kept place."""
    x = torch.from_numpy(np.random.default_rng(9).normal(size=4096).astype(np.float32))
    r = ref.round_mantissa(x, bits)
    assert torch.all((r.view(torch.int32) & ((1 << (23 - bits)) - 1)) == 0)
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -(bits + 1)
    if bits == 7:   # as bf16 rounds: the two differ only on exact ties, which these lack
        assert float((r - x.bfloat16().float()).abs().max()) == 0.0
