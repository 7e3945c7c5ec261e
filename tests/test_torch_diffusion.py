"""Port parity: one denoising step end to end (UNet and DiT), the samplers,
the VAE/text stubs and the parameter tree, against the JAX reference's
``use_kernels=False`` path on the same converted params. fp32 at
atol=rtol=1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.patching import split as jsplit  # noqa: E402
from repro.models import diffusion as jdm  # noqa: E402
from repro.models import sampler as jsam  # noqa: E402
from repro.models import vae as jvae  # noqa: E402
from repro_torch.convert import diffusion_params_from_numpy, vae_params_from_numpy  # noqa: E402
from repro_torch.core.patching import merge as tmerge  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.models import diffusion as tdm  # noqa: E402
from repro_torch.models import sampler as tsam  # noqa: E402
from repro_torch.models import vae as tvae  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(width=16, levels=2, blocks_per_level=1, n_heads=2, groups=4, d_text=8, n_text=2)
RES = [(16, 16), (24, 24), (32, 32)]
STEPS = np.array([3, 17, 42])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(h, w, 4)).astype(np.float32) for h, w in RES]
    text = rng.normal(size=(len(RES), TINY["n_text"], TINY["d_text"])).astype(np.float32)
    return imgs, text


@pytest.fixture(scope="module", params=["unet", "dit"])
def case(request):
    """JAX outputs for one model kind, computed once: denoise_patched and
    sampler_step on a three-resolution CSP batch."""
    kind = request.param
    jcfg = jdm.DiffusionConfig(kind=kind, use_kernels=False, **TINY)
    jparams = jdm.init_diffusion(jcfg, jax.random.PRNGKey(0))
    imgs, text = _inputs()
    jc, jp = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    t = jnp.asarray([5.0, 300.0, 900.0])
    denoised = np.asarray(jdm.denoise_patched(jcfg, jparams, jc, jp, t, jnp.asarray(text)))
    stepped = np.asarray(jsam.sampler_step(jcfg, jparams, jc, jp, jnp.asarray(STEPS), 50,
                                           jnp.asarray(text)))
    tparams = diffusion_params_from_numpy(_np_tree(jparams), device="cpu")
    return dict(kind=kind, jparams=jparams, tparams=tparams, imgs=imgs, text=text,
                t=np.array(t), denoised=denoised, stepped=stepped)


def _tcfg(kind, **kw):
    return tdm.DiffusionConfig(kind=kind, **{**TINY, **kw})


@pytest.mark.parametrize("use_kernels", [True, False])
def test_denoise_patched_matches_reference(case, use_kernels):
    cfg = _tcfg(case["kind"], use_kernels=use_kernels)
    tc, tp = tsplit([torch.from_numpy(i) for i in case["imgs"]], patch=8)
    got = tdm.denoise_patched(cfg, case["tparams"], tc, tp, torch.from_numpy(case["t"]),
                              torch.from_numpy(case["text"]))
    np.testing.assert_allclose(got.numpy(), case["denoised"], **TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sampler_step_matches_reference(case, use_kernels):
    cfg = _tcfg(case["kind"], use_kernels=use_kernels)
    tc, tp = tsplit([torch.from_numpy(i) for i in case["imgs"]], patch=8)
    got = tsam.sampler_step(cfg, case["tparams"], tc, tp, torch.from_numpy(STEPS), 50,
                            torch.from_numpy(case["text"]))
    np.testing.assert_allclose(got.numpy(), case["stepped"], **TOL)


def test_block_hook_sees_every_block_in_plan_order(case):
    cfg = _tcfg(case["kind"])
    tc, tp = tsplit([torch.from_numpy(i) for i in case["imgs"]], patch=8)
    seen = []

    def hook(name, kind, fn, x):
        seen.append((name, kind))
        return fn(x)

    got = tdm.denoise_patched(cfg, case["tparams"], tc, tp, torch.from_numpy(case["t"]),
                              torch.from_numpy(case["text"]), block_hook=hook)
    assert seen == [(n, k) for n, k, _ in tdm.block_plan(cfg)]
    assert seen == [(n, k) for n, k, _ in jdm.block_plan(
        jdm.DiffusionConfig(kind=case["kind"], **TINY))]
    np.testing.assert_allclose(got.numpy(), case["denoised"], **TOL)


def test_gelu_is_the_tanh_approximation(monkeypatch):
    """jax.nn.gelu defaults to tanh; with torch's default erf GELU the
    port's attention block leaves the reference's tolerance."""
    jcfg = jdm.DiffusionConfig(kind="dit", use_kernels=False, **TINY)
    jparams = jdm.init_diffusion(jcfg, jax.random.PRNGKey(0))
    tparams = diffusion_params_from_numpy(_np_tree(jparams), device="cpu")
    rng = np.random.default_rng(5)
    imgs = [(3.0 * rng.normal(size=(h, w, TINY["width"]))).astype(np.float32) for h, w in RES]
    _, text = _inputs(seed=5)
    jc, jp = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    tc, tp = tsplit([torch.from_numpy(i) for i in imgs], patch=8)
    want = np.asarray(jdm._attn_block(jcfg, jc, jparams["blk0"], jp, jnp.asarray(text)))
    cfg = _tcfg("dit")

    def run():
        return tdm._attn_block(cfg, tc, tparams["blk0"], tp, torch.from_numpy(text)).numpy()

    np.testing.assert_allclose(run(), want, **TOL)
    gelu = torch.nn.functional.gelu
    monkeypatch.setattr(tdm.F, "gelu", lambda x, approximate="none": gelu(x))
    assert not np.allclose(run(), want, **TOL)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    if mse == 0:
        return float("inf")
    peak = float(np.max(np.abs(np.asarray(b)))) + 1e-9
    return 10 * np.log10(peak ** 2 / mse)


@pytest.mark.parametrize("kind", ["unet", "dit"])
def test_mixed_resolution_equals_sequential(kind):
    """tests/test_system.py::test_mixed_resolution_equals_sequential on the port."""
    cfg = _tcfg(kind, width=32, n_heads=2, d_text=16, n_text=4)
    params = tdm.init_diffusion(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.normal(size=(h, w, 4)).astype(np.float32)) for h, w in RES]
    text = torch.from_numpy(rng.normal(size=(3, 4, 16)).astype(np.float32))
    steps = torch.tensor([3, 17, 42])
    csp, patches = tsplit(imgs, patch=8)
    batched = tmerge(csp, tsam.sampler_step(cfg, params, csp, patches, steps, 50, text))
    for i in range(3):
        ci, pi = tsplit([imgs[i]], patch=8)
        solo = tmerge(ci, tsam.sampler_step(cfg, params, ci, pi, steps[i:i + 1], 50,
                                            text[i:i + 1]))[0]
        assert _psnr(batched[i], solo) > 80, (kind, i)


def test_denoise_image_matches_patched_run():
    cfg = _tcfg("unet")
    params = tdm.init_diffusion(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.normal(size=(2, 16, 16, 4)).astype(np.float32))
    text = torch.from_numpy(rng.normal(size=(2, 2, 8)).astype(np.float32))
    t = torch.tensor([10.0, 500.0])
    whole = tdm.denoise_image(cfg, params, imgs, t, text)
    csp, patches = tsplit([imgs[0], imgs[1]], patch=8)
    patched = torch.stack(tmerge(csp, tdm.denoise_patched(cfg, params, csp, patches, t, text)))
    np.testing.assert_allclose(patched.numpy(), whole.numpy(), **TOL)


def test_timestep_embedding_and_ddim_schedule():
    t = np.array([0.0, 1.0, 250.0, 999.0], np.float32)
    np.testing.assert_allclose(tdm.timestep_embedding(torch.from_numpy(t), 32).numpy(),
                               np.asarray(jdm.timestep_embedding(jnp.asarray(t), 32)), **TOL)
    for n in (4, 20, 50):
        jts, jab = jsam.ddim_schedule(n)
        tts, tab = tsam.ddim_schedule(n)
        np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
        np.testing.assert_array_equal(tab.numpy(), np.asarray(jab))
        assert tab.dtype == torch.float32


@pytest.mark.parametrize("kind", ["unet", "dit"])
def test_param_tree_paths_and_shapes_match_reference(kind):
    full = dict(use_kernels=False)
    jtree = jax.eval_shape(lambda k: jdm.init_diffusion(
        jdm.DiffusionConfig(kind=kind, **full), k), jax.random.PRNGKey(0))
    ttree = tdm.init_diffusion(tdm.DiffusionConfig(kind=kind, **full),
                               torch.Generator().manual_seed(0), device="cpu")
    jflat = {jax.tree_util.keystr(p): tuple(v.shape)
             for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + f"[{k!r}]")
            else:
                tflat[prefix + f"[{k!r}]"] = tuple(v.shape)

    walk(ttree, "")
    assert tflat == jflat


def test_vae_decode_matches_reference():
    jparams = jvae.init_vae(jax.random.PRNGKey(7), 4)
    tparams = vae_params_from_numpy(_np_tree(jparams), device="cpu")
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 8, 12, 4)).astype(np.float32)
    want = np.asarray(jvae.vae_decode(jparams, jnp.asarray(lat)))
    got = tvae.vae_decode(tparams, torch.from_numpy(lat))
    assert got.shape == (2, 64, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("prompt", ["", "prompt-0", "a red fox in the snow"])
def test_encode_prompt_is_bit_identical(prompt):
    want = np.asarray(jvae.encode_prompt(prompt, 4, 16))
    got = tvae.encode_prompt(prompt, 4, 16, device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_csp_at_level_halves_spatial_dims():
    imgs, _ = _inputs()
    csp, _ = tsplit([torch.from_numpy(i) for i in imgs], patch=8)
    lvl = tdm.csp_at_level(csp, 1)
    jc, _ = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    want = jdm.csp_at_level(jc, 1)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(lvl, f.name), getattr(want, f.name))
