"""Port parity under mixed dtypes: every product of the diffusion path
promotes as jnp does (fp32 with bf16 -> fp32), so SD3-lite at
``dtype="bfloat16"`` (bf16 params, fp32 latents and timestep embedding)
serves as in the reference, and a mixed-dtype convolution raises in both.

The reference's bf16 params cross over through ``convert.py`` in their own
dtype. fp32 results are held at atol=rtol=1e-4 and bf16 results within one
bf16 ulp of the reference's; where the reference rounds to bf16 between
products, a rounding that falls the other way moves what follows, and the
reference's own bf16 tolerance, 2e-2, holds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import patched_ops as jops  # noqa: E402
from repro.core import serving as jsrv  # noqa: E402
from repro.core.patching import split as jsplit  # noqa: E402
from repro.core.requests import Request as JRequest  # noqa: E402
from repro.models import diffusion as jdm  # noqa: E402
from repro.models import sampler as jsam  # noqa: E402
from repro_torch.convert import diffusion_params_from_numpy, vae_params_from_numpy  # noqa: E402
from repro_torch.core import patched_ops as tops  # noqa: E402
from repro_torch.core import serving as tsrv  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.core.requests import Request as TRequest  # noqa: E402
from repro_torch.models import diffusion as tdm  # noqa: E402
from repro_torch.models import sampler as tsam  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(width=16, levels=2, blocks_per_level=1, n_heads=2, groups=4, d_text=8, n_text=2,
            dit_depth=2)
RES = [(16, 16), (24, 24), (32, 32)]
STEPS = np.array([3, 17, 42])
T_REQ = np.array([5.0, 300.0, 900.0], np.float32)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PAIRS = [(a, b) for a in DTYPES for b in DTYPES]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(a):
    """A jax array -> torch tensor on the CPU, bf16 carried bit for bit."""
    return diffusion_params_from_numpy({"x": np.asarray(a)}, device="cpu")["x"]


def _to_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_matches(got, want, tol=None):
    """Same dtype as the reference; fp32 within 1e-4, bf16 within one ulp,
    or both within ``tol`` where given."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (got.dtype, want.dtype)
    g, w = _to_numpy(got), np.asarray(want, np.float32)
    assert g.shape == w.shape
    if tol is not None:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
        return
    if want.dtype == jnp.float32:
        np.testing.assert_allclose(g, w, **TOL)
        return
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) / ulp))


def _patches(channels, dtype, seed=0):
    """The same three-resolution CSP batch in both packages, in ``dtype``."""
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(h, w, channels)).astype(np.float32) for h, w in RES]
    jc, jp = jsplit([jnp.asarray(i.astype(DTYPES[dtype][0])) for i in imgs], patch=8)
    tc, _ = tsplit([torch.from_numpy(i) for i in imgs], patch=8)
    return jc, jp, tc, _to_torch(jp)


def _weights(shapes, dtype, seed=1):
    rng = np.random.default_rng(seed)
    ws = [jnp.asarray((rng.normal(size=s) / np.sqrt(s[-2] if len(s) > 1 else 1))
                      .astype(DTYPES[dtype][0])) for s in shapes]
    return ws, [_to_torch(w) for w in ws]


# ---------------------------------------------------------------------------
# patched_ops over (patches, weights) dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adt,bdt", PAIRS)
def test_matmul_promotes_as_jnp(adt, bdt):
    (ja, _), (ta, _) = _weights([(5, 16), (16, 12)], adt)
    (_, jb), (_, tb) = _weights([(5, 16), (16, 12)], bdt)
    _assert_matches(tops.matmul(ta, tb), ja @ jb)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("pdt,wdt", PAIRS)
def test_patched_groupnorm_dtypes(pdt, wdt, exact):
    C = 16
    jc, jp, tc, tp = _patches(C, pdt)
    (js, jb), (ts, tb) = _weights([(C,), (C,)], wdt)
    want = jops.patched_groupnorm(jc, jp, js, jb, 4, exact=exact)
    _assert_matches(tops.patched_groupnorm(tc, tp, ts, tb, 4, exact=exact), want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("pdt,wdt", PAIRS)
def test_patched_conv_dtypes(pdt, wdt, k):
    """A 1x1 conv is a product and promotes; a kxk conv is a convolution and
    refuses mixed dtypes in both packages."""
    jc, jp, tc, tp = _patches(16, pdt)
    (jw, jb), (tw, tb) = _weights([(k, k, 16, 12), (12,)], wdt)
    if k > 1 and pdt != wdt:
        with pytest.raises((TypeError, RuntimeError)):
            jops.patched_conv(jc, jp, jw, jb)
        with pytest.raises((TypeError, RuntimeError)):
            tops.patched_conv(tc, tp, tw, tb)
        return
    _assert_matches(tops.patched_conv(tc, tp, tw, tb), jops.patched_conv(jc, jp, jw, jb))


@pytest.mark.parametrize("pdt,wdt", PAIRS)
def test_grouped_self_attention_dtypes(pdt, wdt):
    """bf16 patches round q/k/v (with bf16 weights) and the attention output
    to bf16 before the output projection."""
    C = 16
    jc, jp, tc, tp = _patches(C, pdt)
    jw, tw = _weights([(C, C)] * 4, wdt)
    want = jops.grouped_self_attention(jc, jp, *jw, 2)
    _assert_matches(tops.grouped_self_attention(tc, tp, *tw, 2), want,
                    tol=2e-2 if pdt == "bfloat16" else None)


# ---------------------------------------------------------------------------
# The whole model at dtype="bfloat16"
# ---------------------------------------------------------------------------

def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(h, w, 4)).astype(np.float32) for h, w in RES]
    text = rng.normal(size=(len(RES), TINY["n_text"], TINY["d_text"])).astype(np.float32)
    return imgs, text


@pytest.fixture(scope="module")
def bf16_params():
    jcfg = jdm.DiffusionConfig(kind="dit", dtype="bfloat16", **TINY)
    jparams = jdm.init_diffusion(jcfg, jax.random.PRNGKey(0))
    tparams = diffusion_params_from_numpy(_np_tree(jparams), device="cpu")
    return jparams, tparams


def test_bf16_params_cross_over_bit_for_bit(bf16_params):
    jparams, tparams = bf16_params
    jl, tl = jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(tparams)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert j.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


@pytest.fixture(scope="module")
def dit_ref(bf16_params):
    """The reference's outputs for both statistics modes."""
    jparams, _ = bf16_params
    imgs, text = _inputs()
    jc, jp = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    out = {}
    for exact in (True, False):
        jcfg = jdm.DiffusionConfig(kind="dit", dtype="bfloat16", use_kernels=False,
                                   exact_stats=exact, **TINY)
        out[exact] = (
            jdm.denoise_patched(jcfg, jparams, jc, jp, jnp.asarray(T_REQ), jnp.asarray(text)),
            jsam.sampler_step(jcfg, jparams, jc, jp, jnp.asarray(STEPS), 50, jnp.asarray(text)))
    return out


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_dit_matches_reference(bf16_params, dit_ref, use_kernels, exact):
    _, tparams = bf16_params
    cfg = tdm.DiffusionConfig(kind="dit", dtype="bfloat16", use_kernels=use_kernels,
                              exact_stats=exact, **TINY)
    imgs, text = _inputs()
    tc, tp = tsplit([torch.from_numpy(i) for i in imgs], patch=8)
    denoised, stepped = dit_ref[exact]
    assert denoised.dtype == stepped.dtype == jnp.float32
    _assert_matches(tdm.denoise_patched(cfg, tparams, tc, tp, torch.from_numpy(T_REQ),
                                        torch.from_numpy(text)), denoised)
    _assert_matches(tsam.sampler_step(cfg, tparams, tc, tp, torch.from_numpy(STEPS), 50,
                                      torch.from_numpy(text)), stepped)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_unet_raises_in_both(use_kernels):
    """The UNet's stem is a 3x3 conv of fp32 latents with bf16 weights:
    ``lax.conv_general_dilated`` refuses it, and so does the port. The
    params are the port's, carried to the reference bit for bit (the
    reference's own UNet init compiles one op per leaf shape, ~15 s)."""
    kw = dict(kind="unet", dtype="bfloat16", **TINY)
    tparams = tdm.init_diffusion(tdm.DiffusionConfig(**kw), torch.Generator().manual_seed(0),
                                 device="cpu")
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16)), tparams)
    imgs, text = _inputs()
    jc, jp = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    tc, tp = tsplit([torch.from_numpy(i) for i in imgs], patch=8)
    with pytest.raises((TypeError, RuntimeError)):
        jdm.denoise_patched(jdm.DiffusionConfig(use_kernels=False, **kw), jparams, jc, jp,
                            jnp.asarray(T_REQ), jnp.asarray(text))
    with pytest.raises((TypeError, RuntimeError)):
        tdm.denoise_patched(tdm.DiffusionConfig(use_kernels=use_kernels, **kw), tparams, tc,
                            tp, torch.from_numpy(T_REQ), torch.from_numpy(text))


# ---------------------------------------------------------------------------
# The engine: three denoising steps of a bf16 DiT, cache off and on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_cache", [False, True])
def test_bf16_dit_engine_steps_match_reference(bf16_params, use_cache):
    """As tests/test_torch_serving.py's ``real_pair``: both engines on the
    same params, VAE params and seed, three requests stepped three times
    from step 40 of 50."""
    jparams, tparams = bf16_params
    kw = dict(kind="dit", dtype="bfloat16", **TINY)
    ecfg = dict(clock="real", use_cache=use_cache, seed=3)
    jeng = jsrv.PatchedServeEngine(jdm.DiffusionConfig(use_kernels=False, **kw), jparams,
                                   jsrv.EngineConfig(**ecfg), dict.fromkeys(RES, 1.0), RES)
    teng = tsrv.PatchedServeEngine(
        tdm.DiffusionConfig(**kw), tparams, tsrv.EngineConfig(**ecfg),
        dict.fromkeys(RES, 1.0), RES, device="cpu",
        vae_params=vae_params_from_numpy(_np_tree(jeng.vae), "cpu"))
    reqs = {}
    for name, eng, cls in (("jax", jeng, JRequest), ("torch", teng, TRequest)):
        reqs[name] = [cls(rid=i, resolution=res, arrival=0.0, slo=1e9, total_steps=50,
                          steps_done=40, prompt=f"prompt-{i}") for i, res in enumerate(RES)]
        for r in reqs[name]:
            eng._prepare(r)
    for _ in range(3):
        js = jeng._denoise_step(reqs["jax"])
        ts = teng._denoise_step(reqs["torch"])
        assert ts == js
    for jr, tr in zip(reqs["jax"], reqs["torch"]):
        assert tr.steps_done == jr.steps_done == 43
        _assert_matches(tr.latent, jr.latent)
