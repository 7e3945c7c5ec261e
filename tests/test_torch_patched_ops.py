"""Port parity: stitcher and patched operators (repro_torch vs repro), fp32
at atol=rtol=1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import patched_ops as jops  # noqa: E402
from repro.core import stitcher as jst  # noqa: E402
from repro.core.patching import split as jsplit  # noqa: E402
from repro_torch.core import patched_ops as tops  # noqa: E402
from repro_torch.core import stitcher as tst  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
RES_SETS = [[(16, 16), (32, 32), (24, 24), (16, 16)], [(24, 24), (48, 48)]]
C = 8


def _batch(res, seed=0, c=C):
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(h, w, c)).astype(np.float32) for h, w in res]
    jc, jp = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    tc, tp = tsplit([torch.from_numpy(i) for i in imgs], patch=8)
    return jc, jp, tc, tp


def _vec(rng, *shape, s=1.0):
    a = (rng.normal(size=shape) * s).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("res", RES_SETS)
@pytest.mark.parametrize("halo", [1, 2])
def test_gather_halo_and_naive_stitch(res, halo):
    jc, jp, tc, tp = _batch(res)
    want = np.asarray(jst.gather_halo(jp, jc.neighbors, halo))
    np.testing.assert_array_equal(tst.gather_halo(tp, tc.neighbors, halo).numpy(), want)
    np.testing.assert_array_equal(tst.naive_stitch(tp, tc.neighbors, halo).numpy(), want)


@pytest.mark.parametrize("res", RES_SETS)
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("G", [2, 4])
def test_patched_groupnorm(res, exact, G):
    """Per-patch mode uses the population variance (correction=0); torch's
    default unbiased variance would miss this tolerance."""
    jc, jp, tc, tp = _batch(res, seed=1)
    rng = np.random.default_rng(2)
    js, ts = _vec(rng, C)
    jb, tb = _vec(rng, C)
    want = jops.patched_groupnorm(jc, jp, js, jb, G, exact=exact)
    got = tops.patched_groupnorm(tc, tp, ts, tb, G, exact=exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_csp_group_stats():
    jc, jp, tc, tp = _batch(RES_SETS[0], seed=3)
    for a, b in zip(tops.csp_group_stats(tc, tp, 4), jops.csp_group_stats(jc, jp, 4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("res", RES_SETS)
def test_patched_conv(k, res):
    jc, jp, tc, tp = _batch(res, seed=4)
    rng = np.random.default_rng(5)
    jw, tw = _vec(rng, k, k, C, 2 * C, s=0.1)
    jb, tb = _vec(rng, 2 * C)
    want = jops.patched_conv(jc, jp, jw, jb)
    got = tops.patched_conv(tc, tp, tw, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("res", RES_SETS)
def test_grouped_self_attention(res):
    jc, jp, tc, tp = _batch(res, seed=6)
    rng = np.random.default_rng(7)
    ws = [_vec(rng, C, C, s=0.2) for _ in range(4)]
    want = jops.grouped_self_attention(jc, jp, *[w[0] for w in ws], 2)
    got = tops.grouped_self_attention(tc, tp, *[w[1] for w in ws], 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_per_patch_groupnorm_differs_from_exact():
    _, _, tc, tp = _batch(RES_SETS[0], seed=8)
    one, zero = torch.ones(C), torch.zeros(C)
    a = tops.patched_groupnorm(tc, tp, one, zero, 4, exact=True)
    b = tops.patched_groupnorm(tc, tp, one, zero, 4, exact=False)
    assert float((a - b).abs().max()) > 1e-3
