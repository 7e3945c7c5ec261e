"""Port parity: the optimizers and gradient compression against the JAX
reference (``repro.optim``). N AdamW and Adafactor updates from the same
params and the same per-step gradients agree at 1e-6 (fp32 params and
moments; bf16 params and moments within one bf16 ulp), compression
agrees bit for bit, and the first four cases of ``tests/test_optim.py``
(three optimizers converge, error feedback is unbiased) hold on the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,  # noqa: E402
                               adamw_update, global_norm)
from repro_torch.optim.compression import (compress_grads, init_error_state,  # noqa: E402
                                           quantized_psum)
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

SHAPES = {"w": (6, 5), "blocks": {"wq": (3, 4, 8), "scale": (3, 4)}, "b": (7,)}
N = 5


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return _tree(SHAPES, lambda s: (rng.normal(size=s) * scale).astype(np.float32))


def _to_torch(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.as_tensor(a).to(dtype), tree)


def _to_jax(tree, dtype=jnp.float32):
    return tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_trees(got, want, rtol, atol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        a = g[k].float().numpy() if isinstance(g[k], torch.Tensor) else np.asarray(g[k])
        np.testing.assert_allclose(a, np.asarray(w[k], np.float32), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_updates_match_reference(name, dtype):
    """N updates with fresh gradients each step (large ones, so AdamW's
    global-norm clip is active) from the same params; params, moments and
    step after each."""
    jinit, jupd = ((jopt.adamw_init, jopt.adamw_update) if name == "adamw"
                   else (jopt.adafactor_init, jopt.adafactor_update))
    tinit, tupd = ((adamw_init, adamw_update) if name == "adamw"
                   else (adafactor_init, adafactor_update))
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    p0 = _np_tree(0)
    jp, tp = _to_jax(p0, jdt), _to_torch(p0, tdt)
    jo, to = jinit(jp, dtype), tinit(tp, dtype)
    # fp32 at 1e-6; bf16 results may sit one bf16 rounding apart
    tol = 1e-6 if dtype == "float32" else 8e-3
    for i in range(N):
        g = _np_tree(10 + i, scale=3.0)
        jp, jo = jupd(jp, _to_jax(g, jdt), jo)
        tp, to = tupd(tp, _to_torch(g, tdt), to)
        _assert_trees(tp, jax.tree_util.tree_map(np.asarray, jp), tol, tol)
        for key in jo:
            if key == "step":
                assert to["step"].dtype == torch.int32 and int(to["step"]) == int(jo["step"]) == i + 1
            else:
                _assert_trees(to[key], jax.tree_util.tree_map(np.asarray, jo[key]), tol, tol)
    assert all(t.dtype == tdt for t in tree_leaves(tp))


def test_update_leaves_inputs_untouched():
    """Updates return new trees: params, grads and state stay as they were."""
    tp, g = _to_torch(_np_tree(0)), _to_torch(_np_tree(1))
    for init, upd in ((adamw_init, adamw_update), (adafactor_init, adafactor_update)):
        st = init(tp)
        before = [t.clone() for t in tree_leaves(tp) + tree_leaves(g) + tree_leaves(st)]
        upd(tp, g, st)
        after = tree_leaves(tp) + tree_leaves(g) + tree_leaves(st)
        assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_global_norm_matches_reference():
    t = _np_tree(4)
    want = float(jopt.global_norm(_to_jax(t)))
    assert abs(float(global_norm(_to_torch(t))) - want) <= 1e-6 * want


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_opt_init_and_update_dispatch(opt):
    cfg = dataclasses.replace(ARCHS["internlm2-1.8b"].reduced(), opt=opt,
                              opt_state_dtype="bfloat16")
    tp = _to_torch(_np_tree(0))
    st = topt.opt_init(cfg, tp)
    assert set(st) == ({"m", "v", "step"} if opt == "adamw" else {"v_row", "v_col", "step"})
    assert all(t.dtype == torch.bfloat16 for k, v in st.items() if k != "step"
               for t in tree_leaves(v))
    jp = _to_jax(_np_tree(0))
    jst = jopt.opt_init(cfg, jp)
    g = _np_tree(2)
    tp2, _ = topt.opt_update(cfg, tp, _to_torch(g), st)
    jp2, _ = jopt.opt_update(cfg, jp, _to_jax(g), jst)
    _assert_trees(tp2, jax.tree_util.tree_map(np.asarray, jp2), 1e-6, 1e-6)


def test_compress_grads_matches_reference():
    g = _np_tree(5, scale=2.0)
    jg, tg = _to_jax(g), _to_torch(g)
    je, te = jcomp.init_error_state(jg), init_error_state(tg)
    for _ in range(3):
        jd, je = jcomp.compress_grads(jg, je)
        td, te = compress_grads(tg, te)
        _assert_trees(td, jax.tree_util.tree_map(np.asarray, jd), 0, 0)
        _assert_trees(te, jax.tree_util.tree_map(np.asarray, je), 0, 0)


@pytest.mark.skipif(not hasattr(jax, "shard_map"),
                    reason="jax.shard_map unavailable in this JAX version")
def test_quantized_psum_waits_for_the_distributed_port(tmp_path):
    """The distributed port is here: on a one-rank gloo group,
    ``quantized_psum`` is ``tests/test_optim.py``'s single-device case (the
    identity up to quantization noise) and equals the reference's value."""
    import datetime
    import torch.distributed as dist
    from jax.sharding import PartitionSpec as P
    x = np.linspace(-3, 3, 128, dtype=np.float32)
    want = jax.shard_map(lambda v: jcomp.quantized_psum(v, "d"),
                         mesh=jax.make_mesh((1,), ("d",)), in_specs=P(), out_specs=P(),
                         check_vma=False)(jnp.asarray(x))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got = quantized_psum(torch.as_tensor(x))
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), x, atol=0.05)


# tests/test_optim.py's first four cases, on the port

def _quadratic():
    target = {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]]), "b": torch.tensor([0.1, -0.7])}

    def loss(p):
        return (torch.sum(torch.square(p["w"] - target["w"]))
                + torch.sum(torch.square(p["b"] - target["b"])))

    return loss, {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}


def _grad(loss, p):
    live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    gs = torch.autograd.grad(loss(live), list(live.values()))
    return dict(zip(live, gs))


def test_adamw_converges():
    loss, p = _quadratic()
    opt = adamw_init(p)
    l0 = float(loss(p))
    for _ in range(200):
        p, opt = adamw_update(p, _grad(loss, p), opt, lr=0.05, weight_decay=0.0)
    assert float(loss(p)) < 0.01 * l0


def test_adafactor_converges():
    loss, p = _quadratic()
    opt = adafactor_init(p)
    l0 = float(loss(p))
    for _ in range(300):
        p, opt = adafactor_update(p, _grad(loss, p), opt, lr=0.05)
    assert float(loss(p)) < 0.05 * l0


def test_compressed_grads_converge():
    loss, p = _quadratic()
    opt = adamw_init(p)
    err = init_error_state(p)
    l0 = float(loss(p))
    for _ in range(200):
        g, err = compress_grads(_grad(loss, p), err)
        p, opt = adamw_update(p, g, opt, lr=0.05, weight_decay=0.0)
    assert float(loss(p)) < 0.02 * l0


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.normal(size=(64, 64)).astype(np.float32))}
    err = init_error_state(g)
    acc = torch.zeros((64, 64))
    for _ in range(50):
        dq, err = compress_grads(g, err)
        acc = acc + dq["w"]
    # error feedback: the running mean converges to the true gradient
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(), atol=2e-3)


# make_train_step against the reference's, from the same params and batches

def _train_losses(arch, dtype, steps=4):
    """Per-step losses of the reference's and the port's ``make_train_step``
    from the same params (the reference's ``init_model``) and the same
    ``TokenPipeline`` batches."""
    from repro.configs import ARCHS as JARCHS
    from repro.data import TokenPipeline
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import lm as jlm
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.steps import make_train_step

    jcfg = dataclasses.replace(JARCHS[arch].reduced(), dtype=dtype)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype)
    jp, _ = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=1)
    batches = [next(pipe) for _ in range(steps)]
    jstep, jo, jl = jax.jit(jmake_train_step(jcfg)), jopt.opt_init(jcfg, jp), []
    tstep, to, tl = make_train_step(cfg, device="cpu"), topt.opt_init(cfg, tp), []
    for b in batches:
        jp, jo, jm = jstep(jp, jo, b)
        tp, to, tm = tstep(tp, to, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert tm["loss"].dtype == torch.float32 and not tm["loss"].requires_grad
    assert all(t.dtype == getattr(torch, dtype) for t in tree_leaves(tp))
    assert int(to["step"]) == steps
    return np.asarray(jl), np.asarray(tl)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x7b", "falcon-mamba-7b"])
def test_train_step_matches_reference(arch):
    """fp32: four steps' losses at 1e-4 relative."""
    jl, tl = _train_losses(arch, "float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_bf16_train_step_tracks_reference():
    """bf16 params (fp32 moments): the port's losses stay as close to the
    reference's bf16 losses as those are to the reference's own fp32
    losses (the bound ROADMAP Queue 3 sets for bf16 parity)."""
    jl16, tl16 = _train_losses("internlm2-1.8b", "bfloat16")
    jl32, _ = _train_losses("internlm2-1.8b", "float32")
    own = float(np.max(np.abs(jl16 - jl32)))
    assert 0 < own < 0.1
    assert float(np.max(np.abs(tl16 - jl16))) <= own
