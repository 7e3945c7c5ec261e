"""Port parity: the LM layers (norms, both MLPs, RoPE, ParamBuilder trees)
and the chunked flash attention, against the JAX reference on the same
numpy inputs. fp32: layers at 1e-5, flash at 2e-4 (``tests/test_flash.py``'s
own bar) over the same five cases."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_flash.py's cases: (B, Sq, Sk, H, KV, D, Dv, causal, window, bq, bk)
CASES = [
    (2, 64, 64, 4, 2, 16, 16, True, 0, 16, 16),
    (1, 100, 100, 2, 2, 8, 8, True, 0, 32, 32),
    (2, 64, 64, 4, 1, 16, 32, True, 0, 16, 32),   # MLA-style Dv != D, KV=1
    (1, 96, 96, 2, 2, 16, 16, True, 32, 32, 32),  # sliding window
    (2, 48, 80, 2, 2, 16, 16, False, 0, 16, 32),  # cross/full, Sq != Sk
]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 7, 128)])
def test_norms(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3 + 0.5).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(tlayers.rmsnorm(_t(x), _t(scale)), jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    _close(tlayers.layernorm(_t(x), _t(scale), _t(bias)),
           jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    _close(tlayers.layernorm(_t(x), _t(scale), None),
           jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale), None))
    for arch in ("internlm2-1.8b", "granite-34b"):          # rmsnorm, layernorm
        cfg = ARCHS[arch].reduced(d_model=shape[-1])
        p = {"scale": scale, "bias": bias} if cfg.norm == "layernorm" else {"scale": scale}
        _close(tlayers.apply_norm(cfg, _t(x), {k: _t(v) for k, v in p.items()}),
               jlayers.apply_norm(JARCHS[arch].reduced(d_model=shape[-1]), jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in p.items()}))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "starcoder2-3b", "granite-34b",
                                  "whisper-base"])
def test_mlp(arch):
    """swiglu, and gelu with biases: jax.nn.gelu's tanh approximation."""
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    b = jlayers.ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jlayers.init_mlp(jcfg, b, jcfg.d_model, jcfg.d_ff)
    rng = np.random.default_rng(1)
    # non-zero biases, so that the bias paths are checked too
    p = {k: np.asarray(v) + (rng.normal(size=v.shape).astype(np.float32) if k.startswith("b_")
                             else 0) for k, v in b.params.items()}
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    want = jlayers.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tlayers.apply_mlp(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, rtol=1e-5, atol=2e-5)
    tb = tlayers.ParamBuilder(torch.Generator().manual_seed(0), torch.float32, "cpu")
    tlayers.init_mlp(tcfg, tb, tcfg.d_model, tcfg.d_ff)
    assert {k: tuple(v.shape) for k, v in tb.params.items()} == \
        {k: v.shape for k, v in b.params.items()}


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (128, 1e6), (8, 1e5)])
def test_rope(head_dim, theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, head_dim)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 1000]).astype(np.int32)
    _close(tlayers.rope_freqs(head_dim, theta), jlayers.rope_freqs(head_dim, theta))
    _close(tlayers.apply_rope(_t(x), _t(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_param_builder_submodule_and_stack():
    b = tlayers.ParamBuilder(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    b.make("w", (3, 4))
    sub = b.submodule("blk/attn")
    sub.make("wq", (4, 8))
    sub.make("bq", (8,), init="zeros")
    assert b.params["blk"]["attn"]["wq"].dtype == torch.bfloat16
    assert float(b.params["blk"]["attn"]["bq"].abs().sum()) == 0.0
    trees = [{"a": torch.full((2,), float(i)), "s": {"b": torch.full((3, 1), float(i))}}
             for i in range(4)]
    st = tlayers.stack_params(trees)
    assert st["a"].shape == (4, 2) and st["s"]["b"].shape == (4, 3, 1)
    assert torch.equal(tlayers.tree_index(st, 2)["s"]["b"], trees[2]["s"]["b"])
    jst = jlayers.stack_params([jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), t)
                                for t in trees])
    _close(st["s"]["b"], jst["s"]["b"])


def test_param_builder_draws_on_the_generators_device():
    """A CPU generator draws on the CPU whatever the target device, so a
    seed gives the same params as before the LM builder existed."""
    b = tlayers.ParamBuilder(torch.Generator().manual_seed(7), torch.float32, "cpu")
    b.make("w", (5, 6))
    want = torch.randn((5, 6), generator=torch.Generator().manual_seed(7)) * (1.0 / np.sqrt(5))
    assert torch.equal(b.params["w"], want)


def _dense_ref(q, k, v, causal, window):
    """tests/test_flash.py's dense oracle, in JAX."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    s = jnp.einsum("bqkgd,bskd->bkgqs", qg, k) * D ** -0.5
    qpos = jnp.arange(Sq)[:, None]
    kpos = jnp.arange(k.shape[1])[None, :]
    m = jnp.ones((Sq, k.shape[1]), bool)
    if causal:
        m = kpos <= qpos
        if window:
            m &= kpos > qpos - window
    s = jnp.where(m[None, None, None], s, -1e30)
    o = jnp.einsum("bkgqs,bskv->bqkgv", jax.nn.softmax(s, axis=-1), v)
    return o.reshape(B, Sq, H, v.shape[-1])


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,Dv,causal,window,bq,bk", CASES)
def test_flash_forward(B, Sq, Sk, H, KV, D, Dv, causal, window, bq, bk):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, Dv)).astype(np.float32)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal, window, 0, bq, bk)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal, window, 0, bq, bk)
    _close(got, want, rtol=2e-4, atol=2e-4)
    _close(got, _dense_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window),
           rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q_offset,window", [(5, 0), (16, 8)])
def test_flash_query_offset_and_block_skip(q_offset, window):
    """A query block placed at ``q_offset`` (as a chunk of a longer prompt),
    and windows narrow enough that whole key blocks are skipped: the same
    values as the reference, which visits every block."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 24, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, 48, 1, 8)).astype(np.float32)
    v = rng.normal(size=(1, 48, 1, 8)).astype(np.float32)
    args = (True, window, q_offset, 8, 8)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), *args, scale=0.3)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *args, 0.3)
    _close(got, want, rtol=2e-4, atol=2e-4)


def test_flash_bf16_keeps_dtype():
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 40, 2, 16)), dtype=torch.bfloat16)
               for _ in range(3))
    out = tflash.flash_attention(q, k, v, True, 0, 0, 16, 16)
    assert out.dtype == torch.bfloat16
    ref = tflash.flash_attention(q.float(), k.float(), v.float(), True, 0, 0, 16, 16)
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)

