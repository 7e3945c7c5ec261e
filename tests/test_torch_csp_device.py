"""The CSP's device metadata cache (``repro_torch.core.csp_device``): what
it returns, that it is built once per CSP, that results do not change with
it, and the CSP invariant the GroupNorm+stitch kernel relies on."""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.csp import build_csp as jbuild_csp  # noqa: E402
from repro_torch.core import csp_device as cd  # noqa: E402
from repro_torch.core import patched_ops as tops  # noqa: E402
from repro_torch.core.csp import build_csp  # noqa: E402
from repro_torch.core.patching import split  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import diffusion as tdm  # noqa: E402
from repro_torch.models import sampler as tsam  # noqa: E402

# every CSP of the GroupNorm+stitch sweeps (tests/test_kernels.py and the
# main path's three requests), at their GCD patch and at p=8
SWEEP_RES = [
    [(16, 16)],
    [(16, 16), (32, 32)],
    [(24, 24), (16, 16), (32, 32)],
    [(16, 16), (24, 24)],
    [(64, 64), (96, 96), (128, 128)],
    [(32, 32), (48, 48), (64, 64)],
]
TINY = dict(width=16, levels=2, blocks_per_level=1, n_heads=2, groups=4, d_text=8, n_text=2)


@pytest.mark.parametrize("res", SWEEP_RES)
@pytest.mark.parametrize("patch", [None, 8])
def test_csp_neighbors_stay_inside_their_request(res, patch):
    """neighbors[i, s] is -1 or a patch of patch i's own request, so in exact
    mode one request's statistics serve a patch's whole haloed tile."""
    for csp in (build_csp(res, patch=patch), jbuild_csp(res, patch=patch)):
        nb = np.asarray(csp.neighbors)
        req = np.asarray(csp.patch_req)
        owner = np.broadcast_to(req[:, None], nb.shape)
        assert np.all((nb == -1) | (req[np.maximum(nb, 0)] == owner))
        assert (nb >= 0).any() or csp.total == len(res)


def test_csp_device_returns_the_cached_tensors():
    csp = build_csp([(16, 16), (32, 32), (24, 24)], patch=8)
    first = cd.csp_device(csp, "cpu")
    again = cd.csp_device(csp, torch.device("cpu"))
    assert all(a is b for a, b in zip(first, again))
    level1 = tdm.csp_at_level(csp, 1)                  # a new CSP around the same arrays
    assert all(a is b for a, b in zip(first, cd.csp_device(level1, "cpu")))
    np.testing.assert_array_equal(first.neighbors.numpy(), csp.neighbors)
    np.testing.assert_array_equal(first.patch_req.numpy(), csp.patch_req)
    np.testing.assert_array_equal(first.counts.numpy(), np.diff(csp.request_offset))
    np.testing.assert_array_equal(first.neighbors_i32.numpy(), csp.neighbors)
    np.testing.assert_array_equal(first.patch_req_i32.numpy(), csp.patch_req)
    np.testing.assert_array_equal(first.request_offset_i32.numpy(), csp.request_offset)
    assert first.neighbors.dtype == torch.int64 and first.neighbors_i32.dtype == torch.int32
    other = build_csp([(16, 16), (32, 32), (24, 24)], patch=8)   # equal values, new arrays
    assert cd.csp_device(other, "cpu").neighbors is not first.neighbors
    n = len(cd._CACHE)
    del csp, level1, first, again
    gc.collect()
    assert len(cd._CACHE) == n - 1                     # the entry went with its arrays


def _uploaded_every_call(csp, device):
    """The metadata as the port copied it before the cache: new tensors from
    the numpy arrays on every call."""
    nb = torch.as_tensor(csp.neighbors, device=device)
    off = torch.as_tensor(csp.request_offset, device=device)
    req = torch.as_tensor(csp.patch_req, device=device)
    return cd.CSPDevice(nb, req, off[1:] - off[:-1], nb.int(), req.int(), off.int())


def test_csp_group_stats_count_unchanged_at_every_level():
    """The count from the cached patch counts (patches x p*p) equals the
    reference's H*W at level 0 and at the halved level 1, bit for bit."""
    rng = np.random.default_rng(4)
    imgs = [torch.from_numpy(rng.normal(size=(h, w, 8)).astype(np.float32))
            for h, w in [(16, 16), (32, 32), (24, 24)]]
    csp, patches = split(imgs, patch=8)
    for level, x in ((0, patches), (1, patches[:, ::2, ::2, :].contiguous())):
        lcsp = tdm.csp_at_level(csp, level)
        mean, var = tops.csp_group_stats(lcsp, x, 4)
        P, p, _, C = x.shape
        xs = x.float().reshape(P, p * p, 4, C // 4)
        seg = torch.as_tensor(lcsp.patch_req)
        zeros = torch.zeros(lcsp.n_requests, 4)
        s1 = zeros.index_add(0, seg, xs.sum(dim=(1, 3)))
        s2 = zeros.index_add(0, seg, (xs * xs).sum(dim=(1, 3)))
        cnt = (torch.as_tensor(lcsp.res[:, 0] * lcsp.res[:, 1], dtype=torch.float32)
               * (C // 4))[:, None]
        want_mean = s1 / cnt
        assert torch.equal(mean, want_mean)
        assert torch.equal(var, torch.clamp(s2 / cnt - want_mean * want_mean, min=0.0))


@pytest.mark.parametrize("kind", ["unet", "dit"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_cached_metadata_keeps_the_step_bit_identical(monkeypatch, kind, use_kernels):
    """One sampler step on one CSP: with the metadata copied on every call
    (as before the cache), then with the cache cold and warm."""
    rng = np.random.default_rng(5)
    cfg = tdm.DiffusionConfig(kind=kind, use_kernels=use_kernels, **TINY)
    params = tdm.init_diffusion(cfg, torch.Generator().manual_seed(0), device="cpu")
    imgs = [torch.from_numpy(rng.normal(size=(h, w, 4)).astype(np.float32))
            for h, w in [(16, 16), (24, 24), (32, 32)]]
    text = torch.from_numpy(rng.normal(size=(3, 2, 8)).astype(np.float32))
    csp, patches = split(imgs, patch=8)
    steps = torch.as_tensor([3, 17, 42])

    def step():
        return tsam.sampler_step(cfg, params, csp, patches, steps, 50, text)

    with monkeypatch.context() as m:
        for mod in (tops, tdm, ops):
            m.setattr(mod, "csp_device", _uploaded_every_call)
        before = step()
    cold, warm = step(), step()
    assert torch.equal(before, cold) and torch.equal(cold, warm)
