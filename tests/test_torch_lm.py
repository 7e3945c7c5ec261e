"""Port parity: the LM serving forward of all ten architectures against the
JAX reference on the same params (JAX ``init_model`` through
``lm_params_from_numpy``) and the same numpy inputs. fp32 reduced configs:
the causal forward, prefill (logits and every cache leaf) and one decode
step from a padded cache, each at 1e-4 relative to the largest reference
value; the flash routes inside the full forward; the port's own
prefill/decode consistency at the reference's 2e-3; packed prefill at 1e-4;
bf16 params carried over bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import seqpack as jseqpack  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import seqpack as tseqpack  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

REL = 1e-4
B, S = 2, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _inputs(cfg, rng, B, S):
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    kw = {}
    if cfg.vlm_prefix:
        kw["prefix_embeds"] = (rng.normal(size=(B, cfg.vlm_prefix, cfg.d_model))
                               * 0.1).astype(np.float32)
    if cfg.enc_layers:
        kw["enc_inputs"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                            * 0.1).astype(np.float32)
    return toks, kw


def _pad_jax_cache(jcfg, cache, max_len):
    """tests/test_models_smoke.py's padding of a prefill cache."""
    big = jlm.init_cache(jcfg, B, max_len=max_len)

    def mrg(bl, sl):
        if bl.ndim == 0 or bl.shape == sl.shape:
            return sl
        return jnp.pad(sl, [(0, b - s) for b, s in zip(bl.shape, sl.shape)])
    return jax.tree_util.tree_map(mrg, big, cache)


def _torch_cache(jcache):
    return {"blocks": lm_params_from_numpy(_np(jcache["blocks"]), device="cpu"),
            "cur_len": int(jcache["cur_len"])}


@pytest.fixture(scope="module", params=sorted(JARCHS))
def case(request):
    """One architecture's reduced config: JAX params and outputs of the three
    modes, and the port's params converted from them."""
    arch = request.param
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp, _ = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    toks, kw = _inputs(jcfg, np.random.default_rng(0), B, S)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    train, _, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, :S]), mode="train", **jkw)
    pre, jcache, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, :S]), mode="prefill", **jkw)
    padded = _pad_jax_cache(jcfg, jcache, S + jcfg.vlm_prefix + 4)
    dec, jdcache, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, S:]), mode="decode",
                                     cache=padded)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=lm_params_from_numpy(_np(jp), "cpu"),
                toks=toks, kw=kw, train=np.asarray(train), pre=np.asarray(pre),
                jcache=_np(jcache), padded=padded, dec=np.asarray(dec), jdcache=_np(jdcache))


def _tkw(kw):
    return {k: torch.as_tensor(v) for k, v in kw.items()}


def test_forward_train(case):
    logits, cache, aux, _ = tlm.forward(case["tcfg"], case["tp"],
                                        torch.as_tensor(case["toks"][:, :S]), mode="train",
                                        **_tkw(case["kw"]))
    assert cache is None and torch.isfinite(aux)
    assert _rel(logits, case["train"]) < REL


def test_prefill_step(case):
    """``make_prefill_step``'s last-token logits and every cache leaf."""
    batch = dict(case["kw"], tokens=case["toks"][:, :S])
    last, cache = tsteps.make_prefill_step(case["tcfg"], "cpu")(case["tp"], batch)
    assert _rel(last, case["pre"][:, -1]) < REL
    assert cache["cur_len"] == int(case["jcache"]["cur_len"]) == S + case["tcfg"].vlm_prefix
    want, got = _leaves(case["jcache"]["blocks"]), _leaves(cache["blocks"])
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) < REL, k
    full, _, _, _ = tlm.forward(case["tcfg"], case["tp"], torch.as_tensor(batch["tokens"]),
                                mode="prefill", **_tkw(case["kw"]))
    assert _rel(full, case["pre"]) < REL


def test_decode_step(case):
    """One ``make_decode_step`` from the reference's padded prefill cache:
    logits and every leaf of the cache it returns (updated in place)."""
    cache = _torch_cache(case["padded"])
    logits, new = tsteps.make_decode_step(case["tcfg"], "cpu")(
        case["tp"], cache, {"tokens": case["toks"][:, S:]})
    assert _rel(logits, case["dec"][:, 0]) < REL
    assert new["cur_len"] == int(case["jdcache"]["cur_len"])
    want, got = _leaves(case["jdcache"]["blocks"]), _leaves(new["blocks"])
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) < REL, k
        assert got[k].data_ptr() == _leaves(cache["blocks"])[k].data_ptr(), k


def test_init_model_and_cache_trees(case):
    """The port's own ``init_model`` and ``init_cache`` give the reference's
    tree paths, shapes and dtypes."""
    tp = tlm.init_model(case["tcfg"], torch.Generator().manual_seed(0), device="cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _leaves(_np(case["jp"])).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in
           _leaves(tp).items()}
    assert got == want
    jc, tc = jlm.init_cache(case["jcfg"], 3, 20, 5), tlm.init_cache(case["tcfg"], 3, 20, 5,
                                                                   device="cpu")
    assert tc["cur_len"] == int(jc["cur_len"]) == 5
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(tc["blocks"]).items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in _leaves(_np(jc["blocks"])).items()}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x7b", "deepseek-v3-671b",
                                  "whisper-base"])
def test_flash_route_inside_forward(arch):
    """``flash_min_seq=8``: ``attend`` (GQA, a sliding window shorter than
    the sequence, the encoder and cross-attention) and ``mla_attend`` stream
    through flash inside the causal forward and the prefill. Then one decode
    from the unpadded prefill cache: mixtral's ring has wrapped (S > window)
    and the others' full caches clamp the write to their last slot, as the
    reference's ``dynamic_update_slice`` does."""
    over = dict(flash_min_seq=8)
    jcfg, tcfg = JARCHS[arch].reduced(**over), ARCHS[arch].reduced(**over)
    jp, _ = jlm.init_model(jcfg, jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(_np(jp), "cpu")
    Sf = 40
    toks, kw = _inputs(jcfg, np.random.default_rng(1), B, Sf)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    for mode in ("train", "prefill"):
        want, jc, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, :Sf]), mode=mode, **jkw)
        got, tc, _, _ = tlm.forward(tcfg, tp, torch.as_tensor(toks[:, :Sf]), mode=mode,
                                    **_tkw(kw))
        assert _rel(got, want) < REL, mode
    for k, v in _leaves(_np(jc["blocks"])).items():
        assert _rel(_leaves(tc["blocks"])[k], v) < REL, k
    want, jc, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, Sf:]), mode="decode", cache=jc)
    got, tc, _, _ = tlm.forward(tcfg, tp, torch.as_tensor(toks[:, Sf:]), mode="decode",
                                cache=tc)
    assert _rel(got, want) < REL
    for k, v in _leaves(_np(jc["blocks"])).items():
        assert _rel(_leaves(tc["blocks"])[k], v) < REL, k


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x7b", "jamba-v0.1-52b",
                                  "falcon-mamba-7b", "whisper-base"])
def test_port_prefill_decode_consistency(arch):
    """The port on its own params (``init_model``): prefill S tokens, pad the
    cache, decode token S, against the causal forward over S+1 tokens at the
    reference's 2e-3 (``tests/test_models_smoke.py``)."""
    cfg = ARCHS[arch].reduced()
    if cfg.n_experts:   # capacity drops are batch-composition dependent
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks, kw = _inputs(cfg, np.random.default_rng(2), B, S)
    kw = _tkw(kw)
    toks = torch.as_tensor(toks)
    full, _, _, _ = tlm.forward(cfg, params, toks, mode="train", **kw)
    _, cache, _, _ = tlm.forward(cfg, params, toks[:, :S], mode="prefill", **kw)
    big = tlm.init_cache(cfg, B, S + 4, device="cpu")
    for k, leaf in _leaves(cache["blocks"]).items():
        _leaves(big["blocks"])[k][tuple(slice(0, n) for n in leaf.shape)] = leaf
    big["cur_len"] = cache["cur_len"]
    dec, _, _, _ = tlm.forward(cfg, params, toks[:, S:], mode="decode", cache=big)
    assert _rel(dec[:, 0], full[:, -1]) < 2e-3


def test_pack_arrays_identical():
    rng = np.random.default_rng(0)
    for lens, mult in (([5, 17, 9], 8), ([40, 1, 40, 2, 3, 7], 128), ([1], 16)):
        prompts = [rng.integers(0, 100, size=n).astype(np.int32) for n in lens]
        ids = list(range(10, 10 + len(lens)))
        j, t = jseqpack.pack(prompts, ids, mult), tseqpack.pack(prompts, ids, mult)
        assert t.total == j.total
        for name in ("req_ids", "lengths", "offsets", "tokens", "segment_ids", "positions"):
            a, b = np.asarray(getattr(t, name)), np.asarray(getattr(j, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        np.testing.assert_array_equal(
            tseqpack.segment_causal_mask(torch.as_tensor(t.segment_ids)).numpy(),
            np.asarray(jseqpack.segment_causal_mask(j.segment_ids)))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "starcoder2-3b"])
def test_packed_prefill_matches_reference(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp, _ = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in (5, 17, 9)]
    jb, tb = jseqpack.pack(prompts, pad_mult=8), tseqpack.pack(prompts, pad_mult=8)
    want = jseqpack.unpack_by_request(jb, jseqpack.packed_prefill(jcfg, jp, jb))
    got = tseqpack.unpack_by_request(tb, tseqpack.packed_prefill(tcfg, tp, tb))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        assert _rel(got[rid], want[rid]) < REL, rid
        own, _, _, _ = tlm.forward(tcfg, tp, torch.as_tensor(prompts[rid][None]), mode="train")
        assert _rel(got[rid], own[0, -1]) < 1e-3, rid


def test_bf16_params_convert_bit_for_bit():
    """A bf16 reduced config: ``ml_dtypes.bfloat16`` leaves become
    ``torch.bfloat16`` with the same bits, and the bf16 forward agrees with
    the reference's bf16 forward to bf16 precision."""
    jcfg = JARCHS["internlm2-1.8b"].reduced(dtype="bfloat16")
    tcfg = ARCHS["internlm2-1.8b"].reduced(dtype="bfloat16")
    jp, _ = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(_np(jp), "cpu")
    for k, v in _leaves(_np(jp)).items():
        t = _leaves(tp)[k]
        assert t.dtype == torch.bfloat16, k
        assert np.array_equal(t.view(torch.int16).numpy(), v.view(np.int16)), k
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    want, _, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks), mode="train")
    got, _, _, _ = tlm.forward(tcfg, tp, torch.as_tensor(toks), mode="train")
    assert got.dtype == torch.bfloat16
    assert _rel(got, np.asarray(want, np.float32)) < 3e-2


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    """``device=None`` means the card: without one, every LM entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["internlm2-1.8b"].reduced()
    for call in (lambda: tlm.init_model(cfg, torch.Generator().manual_seed(0)),
                 lambda: tlm.init_cache(cfg, 1, 8),
                 lambda: tsteps.make_prefill_step(cfg),
                 lambda: tsteps.make_decode_step(cfg),
                 lambda: lm_params_from_numpy({"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
