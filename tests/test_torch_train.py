"""Port parity: the LM training objective and its gradients against the JAX
reference on the same params (JAX ``init_model`` through
``lm_params_from_numpy``) and the same numpy batch. fp32 reduced configs:
``lm_loss`` and every gradient leaf against ``jax.value_and_grad`` at 1e-4
relative to each leaf's largest magnitude, for all ten archs (falcon-mamba
and jamba through the SSM scan's backward), and again with
``flash_min_seq`` lowered so that the flash backward runs; the flash
backward against JAX's VJP on ``tests/test_flash.py``'s four gradient
cases; remat against no remat; ``groupnorm`` and ``cross_entropy`` at 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import patched_ops as jops  # noqa: E402
from repro.core.patching import split as jsplit  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import patched_ops as tops  # noqa: E402
from repro_torch.core.patching import merge as tmerge  # noqa: E402
from repro_torch.core.patching import split as tsplit  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402

REL = 1e-4
B, S = 2, 16
# tests/test_flash.py's gradient cases: (B, Sq, Sk, H, KV, D, Dv, causal, window, bq, bk)
GRAD_CASES = [
    (2, 64, 64, 4, 2, 16, 16, True, 0, 16, 16),
    (1, 100, 100, 2, 2, 8, 8, True, 0, 32, 32),
    (2, 64, 64, 4, 1, 16, 32, True, 0, 16, 32),   # MLA-style Dv != D, KV=1
    (1, 96, 96, 2, 2, 16, 16, True, 32, 32, 32),  # sliding window
]
# a key bias's gradient is zero in exact arithmetic (softmax is invariant to
# a shift shared by every key of a query); both sides give rounding noise,
# held to 1e-4 of the tree's largest gradient
ZERO_GRAD = ("/attn/bk", "/cross/bk")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.vlm_prefix:
        batch["prefix_embeds"] = (rng.normal(size=(b, cfg.vlm_prefix, cfg.d_model))
                                  * 0.1).astype(np.float32)
    if cfg.enc_layers:
        batch["enc_inputs"] = (rng.normal(size=(b, cfg.enc_seq, cfg.d_model))
                               * 0.1).astype(np.float32)
    return batch


def _torch_loss_grads(cfg, params, batch):
    loss, grads = loss_and_grads(cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), _leaves(grads)


def _check_against_jax(jcfg, tcfg, seed=0):
    jp, _ = jlm.init_model(jcfg, jax.random.PRNGKey(seed))
    batch = _batch(jcfg, seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(jcfg, p, jbatch)))(jp)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    loss, grads = _torch_loss_grads(tcfg, tp, batch)
    assert np.isfinite(loss)
    assert abs(loss - float(jloss)) <= REL * abs(float(jloss))
    want = {k: np.asarray(v) for k, v in _leaves(jgrads).items()}
    assert grads.keys() == want.keys()
    gmax = max(float(np.max(np.abs(w))) for w in want.values())
    for k, w in want.items():
        g = grads[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype and np.all(np.isfinite(g)), k
        den = gmax if k.endswith(ZERO_GRAD) else float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w)))
        assert err <= REL * den, (k, err, den)
    return grads


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_lm_loss_and_grads(arch):
    _check_against_jax(JARCHS[arch].reduced(), ARCHS[arch].reduced())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v3-671b", "mixtral-8x7b"])
def test_lm_grads_flash_route(arch):
    """S=16 >= flash_min_seq=8 with 8-wide blocks: GQA, MLA (Dv != D) and
    the sliding window (mixtral's reduced window is 8) through the flash
    backward inside the full loss."""
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), flash_min_seq=8)
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), flash_min_seq=8)
    _check_against_jax(jcfg, tcfg)


@pytest.mark.parametrize("B_,Sq,Sk,H,KV,D,Dv,causal,window,bq,bk", GRAD_CASES)
def test_flash_backward(B_, Sq, Sk, H, KV, D, Dv, causal, window, bq, bk):
    """tests/test_flash.py's gradient cases: the port's dq, dk, dv against
    the reference's custom VJP, and the port's output."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B_, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B_, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B_, Sk, KV, Dv)).astype(np.float32)
    w = rng.normal(size=(B_, Sq, H, Dv)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, causal, window, 0, bq, bk) * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal, window, 0, bq, bk)
    (out * torch.as_tensor(w)).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_flash_backward_q_offset_and_dtype():
    """A query offset (the queries are the last Sq of Sk positions) against
    the dense autograd version, and bf16 inputs get bf16 gradients."""
    rng = np.random.default_rng(2)
    Sq, Sk, H, KV, D = 24, 40, 4, 2, 8
    q = torch.tensor(rng.normal(size=(1, Sq, H, D)).astype(np.float32), requires_grad=True)
    k = torch.tensor(rng.normal(size=(1, Sk, KV, D)).astype(np.float32), requires_grad=True)
    v = torch.tensor(rng.normal(size=(1, Sk, KV, D)).astype(np.float32), requires_grad=True)
    w = torch.as_tensor(rng.normal(size=(1, Sq, H, D)).astype(np.float32))
    off = Sk - Sq
    (tflash.flash_attention(q, k, v, True, 12, off, 8, 16) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    qg = q.reshape(1, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * D ** -0.5
    qpos = torch.arange(Sq)[:, None] + off
    kpos = torch.arange(Sk)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - 12)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    dense = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(1, Sq, H, D)
    (dense * w).sum().backward()
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a, t.grad, rtol=1e-5, atol=1e-5)
    qb, kb, vb = (t.detach().bfloat16().requires_grad_(True) for t in (q, k, v))
    tflash.flash_attention(qb, kb, vb, True, 0, off, 8, 16).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (qb, kb, vb))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-v0.1-52b", "whisper-base",
                                  "deepseek-v3-671b"])
def test_remat_changes_no_gradient(arch):
    """``remat=True`` recomputes each period in the backward pass; the loss
    and every gradient equal those without it."""
    cfg = ARCHS[arch].reduced()
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg, 3)
    loss0, g0 = _torch_loss_grads(cfg, params, batch)
    loss1, g1 = _torch_loss_grads(dataclasses.replace(cfg, remat=True), params, batch)
    assert loss0 == loss1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7, msg=k)


def test_remat_recomputes_periods():
    """With remat the forward keeps fewer saved tensors: the checkpointed
    periods' activations are dropped and recomputed."""
    cfg = ARCHS["internlm2-1.8b"].reduced()
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    for v in _leaves(params).values():
        v.requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 4).items()}
    counts = []
    for remat in (False, True):
        n = [0]

        def pack(t):
            n[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tlm.lm_loss(dataclasses.replace(cfg, remat=remat), params, batch)
        counts.append(n[0])
    assert counts[1] < counts[0] // 2, counts


def test_scan_backward_matches_out_of_place_loop():
    """The SSM scan's custom backward against autograd through a plain
    out-of-place loop; the scan leaves its inputs as they were."""
    gen = torch.Generator().manual_seed(0)
    shape = (2, 9, 6, 4)
    a = torch.exp(-torch.rand(shape, generator=gen)).requires_grad_(True)
    b = torch.randn(shape, generator=gen).requires_grad_(True)
    w = torch.randn(shape, generator=gen)
    b0 = b.detach().clone()
    h = tmamba._scan(a, b)
    assert torch.equal(b.detach(), b0)
    (h * w).sum().backward()
    got = (a.grad.clone(), b.grad.clone())
    a.grad = b.grad = None
    hs, prev = [], torch.zeros_like(b[:, 0])
    for t in range(shape[1]):
        prev = a[:, t] * prev + b[:, t]
        hs.append(prev)
    want_h = torch.stack(hs, dim=1)
    torch.testing.assert_close(h, want_h, rtol=1e-6, atol=1e-6)
    (want_h * w).sum().backward()
    torch.testing.assert_close(got[0], a.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], b.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 16), 4), ((1, 9, 7, 24), 8)])
def test_groupnorm(shape, groups):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 2 + 0.3).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    want = jlayers.groupnorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups)
    got = tlayers.groupnorm(torch.as_tensor(x), torch.as_tensor(scale),
                            torch.as_tensor(bias), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got16 = tlayers.groupnorm(torch.as_tensor(x).bfloat16(), torch.as_tensor(scale),
                              torch.as_tensor(bias), groups)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    empty = tlayers.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                  torch.zeros(3, 7))
    assert float(empty) == 0.0      # max(sum(mask), 1) keeps an empty mask finite


@pytest.mark.parametrize("res", [[(16, 16), (32, 32), (24, 24)], [(24, 24), (48, 48)]])
def test_exact_patched_groupnorm_equals_whole_image(res):
    """The port's analogue of tests/test_patched_ops.py::test_groupnorm_exact:
    exact-mode ``patched_groupnorm`` on the CSP equals the whole-image
    ``groupnorm`` of each request, and the port's whole-image ``groupnorm``
    equals the reference's on the same images."""
    C, G = 8, 4
    rng = np.random.default_rng(1)
    imgs = [rng.normal(size=(h, w, C)).astype(np.float32) for h, w in res]
    scale = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    tc, tp = tsplit([torch.from_numpy(i) for i in imgs], patch=8)
    out = tops.patched_groupnorm(tc, tp, torch.as_tensor(scale), torch.as_tensor(bias), G)
    jc, jp = jsplit([jnp.asarray(i) for i in imgs], patch=8)
    jops.patched_groupnorm(jc, jp, jnp.asarray(scale), jnp.asarray(bias), G)
    for im, om in zip(imgs, tmerge(tc, out)):
        ref = tlayers.groupnorm(torch.from_numpy(im)[None], torch.as_tensor(scale),
                                torch.as_tensor(bias), G)[0]
        np.testing.assert_allclose(om.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
        jref = jlayers.groupnorm(jnp.asarray(im)[None], jnp.asarray(scale),
                                 jnp.asarray(bias), G)[0]
        np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=1e-5, atol=1e-5)
