"""Every head dim the TPU kernel takes, on the CPU: the JAX Pallas attention
kernel (interpret mode) against the port's plain ``ref_attention`` at public
models' head dims, the CUDA kernel's instance rule (which padded width runs a
head dim, which rows are padded in a copy, which dims run in column slices
and which are refused), and two
tiny models whose heads are not the "-lite" widths through both packages.

Tolerances: fp32 1e-4 and bf16 3e-2 (the reference's attention tolerances);
the models at 1e-4, the reference's fp32 bar. Inputs come from a numpy seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_attention_dims.py
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.patching import split as jsplit  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import diffusion as jdm  # noqa: E402
from repro.models import sampler as jsam  # noqa: E402
from repro_torch.convert import diffusion_params_from_numpy  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.patch_attention import (  # noqa: E402
    INSTANCE_WIDTHS, SLICE_WIDTH, column_slices, instance_width, row_width)
from repro_torch.models import diffusion as tdm  # noqa: E402
from repro_torch.models import sampler as tsam  # noqa: E402

SOURCE = Path(ref.__file__).parent / "csrc" / "patch_attention.cu"
# DiT-XL/PixArt-α 72, SD 1.5 40/80/160, Flux 128, and widths between
PUBLIC_DIMS = [12, 24, 40, 72, 80, 128, 160, 256]
TOL = dict(rtol=1e-4, atol=1e-4)


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [17, 100])
@pytest.mark.parametrize("D", PUBLIC_DIMS)
def test_pallas_kernel_matches_plain_attention_at_public_head_dims(D, S, dtype):
    """The reference's kernel pads S and takes D whole; the port's CPU route
    (its plain version) gives the same at every head dim."""
    rng = np.random.default_rng(D * 1000 + S)
    q, k, v = (rng.normal(size=(1, S, 2, D)).astype(np.float32) for _ in range(3))
    want = jops.grouped_attention_kernel(*(jnp.asarray(a, getattr(jnp, dtype))
                                           for a in (q, k, v)))
    got = ops.grouped_attention_kernel(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                         for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, S, 2, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=_tol(dtype), atol=_tol(dtype))


def test_every_head_dim_runs_in_the_narrowest_instance_that_holds_it():
    assert list(INSTANCE_WIDTHS) == sorted(INSTANCE_WIDTHS) and SLICE_WIDTH == 256
    assert all(w % 16 == 0 for w in INSTANCE_WIDTHS)     # whole MMA k-steps
    for D in range(1, SLICE_WIDTH + 1):
        w = instance_width(D)
        assert w in INSTANCE_WIDTHS and w >= D
        assert all(x < D for x in INSTANCE_WIDTHS if x < w), (D, w)


@pytest.mark.parametrize("D", [0, 257, 320])
def test_head_dims_past_the_widest_instance_raise(D):
    """No instance holds D = 0 or D > 256 whole, so ``instance_width``
    raises. The wrapper refuses only D = 0: a wider D runs in two column
    slices of the widest instance, each the attention of all of q and k on
    its 256 columns of v, which together are plain attention."""
    with pytest.raises(ValueError, match=r"head dim \d+ not in 1\.\.256"):
        instance_width(D)
    if D == 0:
        with pytest.raises(ValueError, match="head dim 0 < 1"):
            column_slices(D)
        return
    assert column_slices(D) == 2
    rng = np.random.default_rng(D)
    q = torch.from_numpy(rng.normal(size=(2, 33, 2, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 40, 2, D)).astype(np.float32))
            for _ in range(2))
    slices = [ref.ref_attention(q, k, v[..., c:c + SLICE_WIDTH])
              for c in range(0, D, SLICE_WIDTH)]
    np.testing.assert_allclose(torch.cat(slices, dim=-1).numpy(),
                               ref.ref_attention(q, k, v).numpy(), rtol=1e-6, atol=1e-6)


def test_instance_widths_mirror_the_kernel_source():
    """kWidths in the source is the wrapper's tuple, and both of the
    source's dispatch switches have one case per width, each naming its own
    instance."""
    text = SOURCE.read_text()
    m = re.search(r"constexpr int kWidths\[\] = \{([\d, ]+)\};", text)
    assert m and tuple(int(x) for x in m.group(1).split(",")) == INSTANCE_WIDTHS
    for fn in ("launch_d", "block_q"):
        cases = re.findall(rf"case (\d+): return {fn}<T, (\d+)>", text)
        assert all(a == b for a, b in cases), cases
        assert tuple(int(a) for a, _ in cases) == INSTANCE_WIDTHS


@pytest.mark.parametrize("dtype,chunk", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_unaligned_rows_pad_to_whole_16_byte_chunks_in_the_same_instance(dtype, chunk):
    es = torch.empty(0, dtype=dtype).element_size()
    for D in range(1, SLICE_WIDTH + 1):
        Dk = row_width(D, es)
        assert Dk % chunk == 0 and D <= Dk < D + chunk
        assert (Dk == D) == (D * es % 16 == 0)
        assert instance_width(Dk) == instance_width(D)


@pytest.mark.parametrize("D", [1, 12, 20, 36, 250])
def test_zero_padded_columns_leave_attention_unchanged(D):
    """What the wrapper does with an unaligned bf16 row: q, k, v padded with
    zero columns to ``row_width`` and the scale of the true D give the same
    first D columns, and zeros in the others."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 33, 3, D)).astype(np.float32))
               for _ in range(3))
    Dk = row_width(D, 2)
    padded = ref.ref_attention(*(torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v)),
                               scale=D ** -0.5)
    np.testing.assert_allclose(padded[..., :D].numpy(), ref.ref_attention(q, k, v).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not padded[..., D:].any()


# ---------------------------------------------------------------------------
# two tiny models whose heads the kernel's old instances did not take
# ---------------------------------------------------------------------------

RES = [(16, 16), (32, 32)]
STEPS = np.array([17, 42])
MODELS = {  # kind -> (config, the reference's use_kernels)
    # D = 24; the reference runs its Pallas kernel in interpret mode
    "dit": (dict(kind="dit", width=48, n_heads=2, dit_depth=2, groups=4, d_text=8, n_text=2),
            True),
    # D = 20 / 40 / 80 at levels 0 / 1 / 2 (the mid block's too); the
    # reference's GN-stitch Pallas path does not run under the installed jax
    "unet": (dict(kind="unet", width=40, levels=3, attn_levels=(0, 1, 2), n_heads=2,
                  blocks_per_level=1, groups=4, d_text=8, n_text=2), False),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """Reference outputs of one model, computed once: denoise_patched and
    sampler_step on a two-resolution CSP batch, params carried to the port
    by convert.py."""
    kw, ref_kernels = MODELS[request.param]
    jcfg = jdm.DiffusionConfig(use_kernels=ref_kernels, **kw)
    jparams = jdm.init_diffusion(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    imgs = [rng.normal(size=(h, w, 4)).astype(np.float32) for h, w in RES]
    text = rng.normal(size=(len(RES), kw["n_text"], kw["d_text"])).astype(np.float32)
    t = np.array([300.0, 900.0], np.float32)
    jc, jp = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    # jitted over the fixed CSP: one compile each instead of one per eager op
    denoise = jax.jit(lambda p, x, tt, e: jdm.denoise_patched(jcfg, p, jc, x, tt, e))
    step = jax.jit(lambda p, x, s, e: jsam.sampler_step(jcfg, p, jc, x, s, 50, e))
    return dict(
        kw=kw, imgs=imgs, text=text, t=t,
        tparams=diffusion_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                            device="cpu"),
        denoised=np.asarray(denoise(jparams, jp, jnp.asarray(t), jnp.asarray(text))),
        stepped=np.asarray(step(jparams, jp, jnp.asarray(STEPS), jnp.asarray(text))))


def test_model_head_dims_are_off_the_lite_widths(model):
    cfg = tdm.DiffusionConfig(**model["kw"])
    levels = range(cfg.levels) if cfg.kind == "unet" else [0]
    dims = {cfg.width * 2 ** lvl // cfg.n_heads for lvl in levels}
    assert dims == ({20, 40, 80} if cfg.kind == "unet" else {24})


def test_denoise_patched_matches_reference_at_new_head_dims(model):
    cfg = tdm.DiffusionConfig(**model["kw"])     # use_kernels: the CPU takes the plain version
    tc, tp = tsplit([torch.from_numpy(i) for i in model["imgs"]], patch=8)
    got = tdm.denoise_patched(cfg, model["tparams"], tc, tp, torch.from_numpy(model["t"]),
                              torch.from_numpy(model["text"]))
    np.testing.assert_allclose(got.numpy(), model["denoised"], **TOL)


def test_sampler_step_matches_reference_at_new_head_dims(model):
    cfg = tdm.DiffusionConfig(**model["kw"])
    tc, tp = tsplit([torch.from_numpy(i) for i in model["imgs"]], patch=8)
    got = tsam.sampler_step(cfg, model["tparams"], tc, tp, torch.from_numpy(STEPS), 50,
                            torch.from_numpy(model["text"]))
    np.testing.assert_allclose(got.numpy(), model["stepped"], **TOL)
