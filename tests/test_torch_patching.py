"""Port parity: CSP metadata and the patch layout (repro_torch vs repro)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import csp as jcsp  # noqa: E402
from repro.core import patching as jpat  # noqa: E402
from repro_torch.core import csp as tcsp  # noqa: E402
from repro_torch.core import patching as tpat  # noqa: E402

RES_SETS = [
    [(16, 16)],
    [(16, 16), (32, 32)],
    [(24, 24), (16, 16), (32, 32)],
    [(32, 16), (16, 32), (16, 16), (32, 16)],
    [(64, 64), (96, 96), (128, 128)],
]


@pytest.mark.parametrize("res", RES_SETS)
@pytest.mark.parametrize("patch", [None, 8])
def test_build_csp_matches_reference(res, patch):
    want = jcsp.build_csp(res, patch=patch)
    got = tcsp.build_csp(res, patch=patch)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f.name)
    assert tcsp.gcd_patch_size(res, cap=8) == jcsp.gcd_patch_size(res, cap=8)


@pytest.mark.parametrize("res", RES_SETS[:4])
def test_split_merge_match_reference_and_round_trip(res):
    rng = np.random.default_rng(0)
    imgs = [rng.normal(size=(h, w, 3)).astype(np.float32) for h, w in res]
    jc, jp = jpat.split([jnp.asarray(i) for i in imgs], patch=8)
    tc, tp = tpat.split([torch.from_numpy(i) for i in imgs], patch=8)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for im, back in zip(imgs, tpat.merge(tc, tp)):
        np.testing.assert_array_equal(back.numpy(), im)
    by_req = tpat.merge_by_request(tc, tp)
    assert sorted(by_req) == list(range(len(imgs)))
    for rid, back in by_req.items():
        np.testing.assert_array_equal(back.numpy(), imgs[rid])
    for g in range(tc.n_groups):
        grouped = tpat.group_images(tc, tp, g)
        np.testing.assert_array_equal(grouped.numpy(),
                                      np.asarray(jpat.group_images(jc, jp, g)))
        np.testing.assert_array_equal(tpat.ungroup_images(tc, grouped, g).numpy(),
                                      tp[tc.group_slice(g)].numpy())


def test_split_keeps_caller_req_ids():
    rng = np.random.default_rng(1)
    res = [(32, 32), (16, 16), (32, 32)]
    imgs = [torch.from_numpy(rng.normal(size=(h, w, 2)).astype(np.float32)) for h, w in res]
    csp, patches = tpat.split(imgs, req_ids=[70, 71, 72])
    assert list(csp.req_ids) == [71, 70, 72]
    out = tpat.merge_by_request(csp, patches)
    for rid, im in zip((70, 71, 72), imgs):
        assert torch.equal(out[rid], im)
