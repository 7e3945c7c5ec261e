"""Port parity: MoE dispatch and the Mamba mixer against the JAX reference on
the same params and numpy inputs. MoE at 2e-4 (with the deepseek-reduced
shared expert, and with a capacity that drops tokens); Mamba at the
reference's own bar (rtol 1e-3, atol 1e-4); the port's scan against a
sequential loop."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import ParamBuilder as JParamBuilder  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_TOL = dict(rtol=2e-4, atol=2e-4)
MAMBA_TOL = dict(rtol=1e-3, atol=1e-4)


def _params(jcfg, init, seed=0):
    b = JParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    init(b)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, b.params), device="cpu")
    return b.params, tp


def _moe_cfgs(arch="mixtral-8x7b", **over):
    return (dataclasses.replace(JARCHS[arch].reduced(), **over),
            dataclasses.replace(ARCHS[arch].reduced(), **over))


MOE_CASES = {
    "mixtral-cf8": ("mixtral-8x7b", dict(capacity_factor=8.0), 8),
    "mixtral-reduced": ("mixtral-8x7b", {}, 16),
    "mixtral-drops": ("mixtral-8x7b", dict(capacity_factor=0.01), 32),
    "deepseek-shared": ("deepseek-v3-671b", {}, 16),
    "jamba-drops": ("jamba-v0.1-52b", dict(capacity_factor=0.5), 24),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_reference(case):
    arch, over, S = MOE_CASES[case]
    jcfg, tcfg = _moe_cfgs(arch, **over)
    jp, tp = _params(jcfg, lambda b: jmoe.init_moe(jcfg, b, jcfg.d_model, jcfg.d_ff))
    x = np.random.default_rng(0).normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tcfg, tp, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)
    if "drops" in case:   # dropped tokens are zero rows, as in the reference
        zero = np.all(np.abs(ty.numpy().reshape(-1, jcfg.d_model)) < 1e-12, axis=-1)
        assert zero.mean() > 0.2
        np.testing.assert_array_equal(
            zero, np.all(np.abs(np.asarray(jy).reshape(-1, jcfg.d_model)) < 1e-12, axis=-1))


def test_moe_compute_resident_block_matches_reference():
    """``_moe_compute`` with a block of resident experts (``e_start``)."""
    jcfg, tcfg = _moe_cfgs(capacity_factor=1.0)
    jp, tp = _params(jcfg, lambda b: jmoe.init_moe(jcfg, b, jcfg.d_model, jcfg.d_ff))
    xt = np.random.default_rng(1).normal(size=(24, jcfg.d_model)).astype(np.float32)
    sl = slice(1, 3)
    jy, jaux = jmoe._moe_compute(jcfg, jnp.asarray(xt), jp["router"], jp["w_gate"][sl],
                                 jp["w_up"][sl], jp["w_down"][sl], 1, jcfg.n_experts)
    ty, taux = tmoe._moe_compute(tcfg, torch.as_tensor(xt), tp["router"], tp["w_gate"][sl],
                                 tp["w_up"][sl], tp["w_down"][sl], 1, tcfg.n_experts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)


def test_moe_slots_are_fifo_and_order_independent():
    """Every kept choice owns one (expert, slot); slots follow token order
    within an expert (FIFO drops); dropped choices point at (0, C-1) with a
    zero row. So ``index_put_(accumulate=True)`` gives bit-identical buffers
    whatever order the additions land in, as atomics on the card may."""
    rng = np.random.default_rng(2)
    E, C, T, k, d = 4, 8, 40, 2, 16
    eid = torch.as_tensor(rng.integers(0, E, size=T * k))
    keep, le, pos = tmoe._slots(eid, E, 0, E, C)
    kept = list(zip(le[keep].tolist(), pos[keep].tolist()))
    assert len(kept) == len(set(kept))
    for e in range(E):
        mine = (eid == e).nonzero()[:, 0]
        assert pos[mine[:C]].tolist() == list(range(min(C, len(mine))))
        assert not keep[mine[C:]].any()
    assert le[~keep].eq(0).all() and pos[~keep].eq(C - 1).all()
    vals = torch.where(keep[:, None], torch.as_tensor(rng.normal(size=(T * k, d)),
                                                      dtype=torch.float32), 0)
    bufs = []
    for order in (torch.arange(T * k), torch.arange(T * k).flip(0),
                  torch.as_tensor(rng.permutation(T * k))):
        buf = torch.zeros((E, C, d))
        buf.index_put_((le[order], pos[order]), vals[order], accumulate=True)
        bufs.append(buf)
    assert all(torch.equal(b, bufs[0]) for b in bufs[1:])


def _mamba():
    jcfg, tcfg = JARCHS["falcon-mamba-7b"].reduced(), ARCHS["falcon-mamba-7b"].reduced()
    jp, tp = _params(jcfg, lambda b: jmamba.init_mamba(jcfg, b))
    return jcfg, tcfg, jp, tp


def test_mamba_mixer_matches_reference():
    jcfg, tcfg, jp, tp = _mamba()
    x = (np.random.default_rng(0).normal(size=(2, 10, jcfg.d_model)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(tmamba.mamba_mixer(tcfg, tp, torch.as_tensor(x)).numpy(),
                               np.asarray(jmamba.mamba_mixer(jcfg, jp, jnp.asarray(x))),
                               **MAMBA_TOL)


def test_mamba_decode_chain_matches_reference():
    jcfg, tcfg, jp, tp = _mamba()
    B, S = 2, 9
    x = (np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)) * 0.3).astype(np.float32)
    jst = jmamba.init_mamba_state(jcfg, B)
    tst = tmamba.init_mamba_state(tcfg, B, device="cpu")
    for t in range(S):
        jo, jst = jmamba.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
        to, tst = tmamba.mamba_decode(tcfg, tp, torch.as_tensor(x[:, t:t + 1]), tst)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MAMBA_TOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), **MAMBA_TOL)
    # the full-sequence mixer agrees with the decode chain, and the prefill
    # state continues it
    full = tmamba.mamba_mixer(tcfg, tp, torch.as_tensor(x))
    st = tlm._mamba_prefill_state(tcfg, tp, torch.as_tensor(x))
    jst2 = jlm._mamba_prefill_state(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(full[:, -1:].numpy(), to.numpy(), **MAMBA_TOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(st[key].numpy(), tst[key].numpy(), **MAMBA_TOL)
        np.testing.assert_allclose(st[key].numpy(), np.asarray(jst2[key]), **MAMBA_TOL)


def _loop_scan(a, b):
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_scan_matches_sequential_loop(S):
    rng = np.random.default_rng(S)
    a = torch.as_tensor(np.exp(-rng.random(size=(2, S, 5, 3))), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(2, S, 5, 3)), dtype=torch.float32)
    want = _loop_scan(a, b)
    torch.testing.assert_close(tmamba._scan(a.clone(), b.clone()), want, rtol=1e-5, atol=1e-6)
    # the reference's associative_scan over the same pairs
    _, jh = jax.lax.associative_scan(jmamba._scan_combine,
                                     (jnp.asarray(a.numpy()), jnp.asarray(b.numpy())), axis=1)
    np.testing.assert_allclose(tmamba._scan(a.clone(), b.clone()).numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-6)


def test_bf16_decode_continues_prefill():
    """The conv sums in fp32 in the full-sequence and the decode path alike,
    so in bf16 a chain of decode steps from a prefill cache agrees with the
    causal forward over the same tokens at the reference's fp32 bar (2e-3);
    summing in bf16 in each path's own order misses it."""
    cfg = dataclasses.replace(ARCHS["falcon-mamba-7b"].reduced(), dtype="bfloat16")
    params = tlm.init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(4)
    B, S, n = 2, 64, 4
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, S + n)).astype(np.int32))
    full, _, _, _ = tlm.forward(cfg, params, toks, mode="train")
    _, cache, _, _ = tlm.forward(cfg, params, toks[:, :S], mode="prefill")
    for i in range(n):
        dec, cache, _, _ = tlm.forward(cfg, params, toks[:, S + i:S + i + 1], mode="decode",
                                       cache=cache)
        want = full[:, S + i].float()
        err = float((dec[:, 0].float() - want).abs().max() / want.abs().max())
        assert err < 2e-3, (i, err)
