"""LM-family model builder: dense / MoE / MLA / SSM / hybrid / enc-dec / VLM,
the port of the reference's ``repro/models/lm.py``: the forward of the three
modes and the training objective (``lm_loss``, ``mtp_logits``).

One code path builds all ten architectures of ``repro_torch.configs`` from
a ``ModelConfig``:
- layers are grouped into repeating *periods* (``cfg.layer_plan()``); each slot
  in a period has its own param subtree stacked over ``n_periods`` under
  ``params["blocks"]`` (the reference's layout), and a Python loop over the
  periods takes the place of the reference's ``lax.scan``;
- three modes: "train" (the causal forward, no cache), "prefill" (emit cache),
  "decode" (one token against the cache); with ``cfg.remat`` the train
  forward recomputes each period in the backward pass
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

``cache["cur_len"]`` is a host ``int``, so a decode step never waits for the
device to read it. A decode step writes the new token's entries into the
cache's tensors in place and returns a cache over the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamBuilder, Params, apply_mlp, apply_norm,
                                       cross_entropy, embed, init_mlp, init_norm, linear,
                                       stack_params, stack_specs, tree_index, tree_unbind)

Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_model(cfg, generator: torch.Generator, device=None) -> Params:
    """Random params with the reference's tree paths and shapes, in
    ``cfg.dtype`` on ``device``, drawn on ``generator``'s device."""
    return build_model(cfg, generator, device)[0]


def build_model(cfg, generator: Optional[torch.Generator], device=None
                ) -> Tuple[Params, Tree]:
    """(params, logical-axis specs), as the reference's ``init_model``
    returns them. On the ``meta`` device nothing is drawn (``generator`` may
    be ``None``)."""
    dtype = torch_dtype(cfg)
    dev = resolve_device(device)
    b = ParamBuilder(generator, dtype, dev)
    b.make("embed", (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=0.02)
    if cfg.learned_pos:
        b.make("pos_embed", (cfg.max_pos, cfg.d_model), (None, "embed"), scale=0.02)

    plan = cfg.layer_plan()
    periods = []
    for _ in range(cfg.n_periods):
        pb = ParamBuilder(generator, dtype, dev)
        for s, (mixer, ffn) in enumerate(plan):
            sb = pb.submodule(f"slot{s}")
            init_norm(cfg, sb, "norm1", cfg.d_model)
            if mixer == "attn":
                attn_mod.init_attention(cfg, sb.submodule("attn"))
                if cfg.cross_attn:
                    init_norm(cfg, sb, "norm_cross", cfg.d_model)
                    attn_mod.init_attention(cfg, sb.submodule("cross"), cross=True)
            elif mixer == "mla":
                attn_mod.init_mla(cfg, sb.submodule("attn"))
            elif mixer == "mamba":
                mamba_mod.init_mamba(cfg, sb.submodule("mamba"))
            if ffn != "none":
                init_norm(cfg, sb, "norm2", cfg.d_model)
                fb = sb.submodule("ffn")
                if ffn == "moe":
                    moe_mod.init_moe(cfg, fb, cfg.d_model, cfg.d_ff)
                else:
                    init_mlp(cfg, fb, cfg.d_model, cfg.d_ff)
        periods.append(pb)
    b.params["blocks"] = stack_params([pb.params for pb in periods])
    b.specs["blocks"] = stack_specs(periods[0].specs)
    del periods

    init_norm(cfg, b, "final_norm", cfg.d_model)
    if not cfg.tie_embeddings:
        b.make("lm_head", (cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), scale=0.02)

    if cfg.enc_layers:
        eb = b.submodule("encoder")
        layers = []
        for _ in range(cfg.enc_layers):
            epb = ParamBuilder(generator, dtype, dev)
            init_norm(cfg, epb, "norm1", cfg.d_model)
            attn_mod.init_attention(cfg, epb.submodule("attn"))
            init_norm(cfg, epb, "norm2", cfg.d_model)
            init_mlp(cfg, epb.submodule("ffn"), cfg.d_model, cfg.d_ff)
            layers.append(epb)
        eb.params["layers"] = stack_params([e.params for e in layers])
        eb.specs["layers"] = stack_specs(layers[0].specs)
        init_norm(cfg, eb, "final_norm", cfg.d_model)

    if cfg.mtp:  # DeepSeek multi-token prediction: 1 extra attn block + proj
        mb = b.submodule("mtp")
        mb.make("proj", (2 * cfg.d_model, cfg.d_model), (None, "embed"))
        init_norm(cfg, mb, "norm1", cfg.d_model)
        attn_mod.init_attention(cfg, mb.submodule("attn"))
        init_norm(cfg, mb, "norm2", cfg.d_model)
        init_mlp(cfg, mb.submodule("ffn"), cfg.d_model, cfg.d_ff)
    return b.params, b.specs


# ---------------------------------------------------------------------------
# Block application (one slot of a period)
# ---------------------------------------------------------------------------

def _apply_slot(cfg, slot_plan, p, x, positions, mode, cache, cur_len,
                cross_kv=None):
    """Returns (x, new_cache_slot, aux_loss)."""
    mixer, ffn = slot_plan
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.tp_mode == "sp" and mode != "decode":
        x = attn_mod.seq_shard_constraint(x)
    h = apply_norm(cfg, x, p["norm1"])
    new_cache: Dict[str, Any] = {}

    if mixer == "attn":
        if mode == "decode":
            out, kv = attn_mod.decode_attend(cfg, p["attn"], h, cache["self"], cur_len)
            new_cache["self"] = kv
        else:
            k, v = attn_mod.project_kv(cfg, p["attn"], h, positions)
            out = attn_mod.attend(cfg, p["attn"], h, positions, kind="causal",
                                  kv_override=(k, v))
            if mode == "prefill":
                new_cache["self"] = _ring_pack(cfg, k, v)
        x = x + out
        if cfg.cross_attn and (cross_kv is not None or "cross" in (cache or {})):
            hc = apply_norm(cfg, x, p["norm_cross"])
            if mode == "decode":
                ck, cv = cache["cross"]["k"], cache["cross"]["v"]
                new_cache["cross"] = cache["cross"]
            else:
                ck, cv = cross_kv
                if mode == "prefill":
                    new_cache["cross"] = {"k": ck, "v": cv}
            out = attn_mod.attend(cfg, p["cross"], hc, positions, kind="full",
                                  kv_override=(ck, cv))
            x = x + out
    elif mixer == "mla":
        if mode == "decode":
            out, kv = attn_mod.mla_decode_attend(cfg, p["attn"], h, cache["self"],
                                                 cur_len)
            new_cache["self"] = kv
        else:
            out = attn_mod.mla_attend(cfg, p["attn"], h, positions, kind="causal")
            if mode == "prefill":
                _, _, ckv, krope = attn_mod._mla_qkv(cfg, p["attn"], h, positions)
                new_cache["self"] = {"ckv": ckv, "krope": krope}
        x = x + out
    elif mixer == "mamba":
        if mode == "decode":
            out, st = mamba_mod.mamba_decode(cfg, p["mamba"], h, cache["self"])
            new_cache["self"] = st
        else:
            out = mamba_mod.mamba_mixer(cfg, p["mamba"], h)
            if mode == "prefill":
                new_cache["self"] = _mamba_prefill_state(cfg, p["mamba"], h)
        x = x + out

    if ffn != "none":
        h = apply_norm(cfg, x, p["norm2"])
        if ffn == "moe":
            out, aux = moe_mod.apply_moe(cfg, p["ffn"], h)
        else:
            out = apply_mlp(cfg, p["ffn"], h)
        x = x + out
    return x, new_cache, aux


def _ring_pack(cfg, k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Prefill -> decode cache. SWA archs keep a ring of the last W entries."""
    W = cfg.sliding_window
    S = k.shape[1]
    if not W or S <= W:
        return {"k": k, "v": v}
    slots = torch.arange(S - W, S, device=k.device) % W
    kr = k.new_zeros((k.shape[0], W) + k.shape[2:])
    vr = v.new_zeros((v.shape[0], W) + v.shape[2:])
    kr[:, slots] = k[:, S - W:]
    vr[:, slots] = v[:, S - W:]
    return {"k": kr, "v": vr}


def _mamba_prefill_state(cfg, p, h):
    """Recover final SSM + conv state after a full-sequence mixer pass."""
    S = h.shape[1]
    xi, _ = mamba_mod.in_proj(h, p["in_proj"])
    xc = mamba_mod._conv_silu(cfg, p, xi)
    dt, Bm, _ = mamba_mod._ssm_params(cfg, p, xc)
    hh = mamba_mod._scan(*mamba_mod._discretize(p, dt, Bm, xc))
    W = cfg.conv_width
    return {"ssm": hh[:, -1].clone(), "conv": xi[:, S - (W - 1):].contiguous()}


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, tokens, prefix_embeds, mode, cur_len=None):
    x = embed(tokens, params["embed"])
    if prefix_embeds is not None and mode != "decode":
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    if mode == "decode":
        positions = torch.full((B, S), cur_len, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    if cfg.learned_pos:
        # the reference's dynamic_slice clamps the start into the table
        start = 0 if mode != "decode" else min(cur_len, params["pos_embed"].shape[0] - 1)
        pe = params["pos_embed"][start:start + (S if mode != "decode" else 1)]
        x = x + pe[None].to(x.dtype)
    return x, positions


def _encode(cfg, params, enc_inputs):
    """Whisper/ViT stub encoder over precomputed frame/patch embeddings."""
    x = enc_inputs.to(torch_dtype(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    for lp in tree_unbind(params["encoder"]["layers"]):
        h = apply_norm(cfg, x, lp["norm1"])
        x = x + attn_mod.attend(cfg, lp["attn"], h, positions, kind="full")
        h = apply_norm(cfg, x, lp["norm2"])
        x = x + apply_mlp(cfg, lp["ffn"], h)
    return apply_norm(cfg, x, params["encoder"]["final_norm"])


def forward(cfg, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_inputs: Optional[torch.Tensor] = None,
            mode: str = "train",
            cache: Optional[Tree] = None,
            ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor, torch.Tensor]:
    """Returns (logits, new_cache, aux_loss, hidden).

    train/prefill: tokens (B, S) [+ prefix/enc stubs]
    decode:        tokens (B, 1), cache required (updated in place).
    """
    cur_len = cache["cur_len"] if cache is not None else None
    x, positions = _embed_inputs(cfg, params, tokens, prefix_embeds, mode, cur_len)
    S = x.shape[1]

    memory = _encode(cfg, params, enc_inputs) if enc_inputs is not None else None
    enc_pos = None
    if memory is not None:
        enc_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                               device=memory.device).expand(memory.shape[:2])

    plan = cfg.layer_plan()

    def period(x, aux, block_p, cache_in):
        new_slots = {}
        for s, slot_plan in enumerate(plan):
            ck = None
            if memory is not None and slot_plan[0] == "attn" and cfg.cross_attn:
                ck = attn_mod.project_kv(cfg, block_p[f"slot{s}"]["cross"], memory, enc_pos)
            x, ncs, aux_s = _apply_slot(
                cfg, slot_plan, block_p[f"slot{s}"], x, positions, mode,
                cache_in[f"slot{s}"] if cache_in is not None else None,
                cur_len, cross_kv=ck)
            new_slots[f"slot{s}"] = ncs
            aux = aux + aux_s
        return x, aux, new_slots

    # the reference's jax.checkpoint(period_body): each period's activations
    # are recomputed in the backward pass instead of kept
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    period_caches = []
    for n, block_p in enumerate(tree_unbind(params["blocks"])):
        cache_in = tree_index(cache["blocks"], n) if cache is not None else None
        if remat:
            x, aux_total, new_slots = checkpoint(period, x, aux_total, block_p, cache_in,
                                                 use_reentrant=False)
        else:
            x, aux_total, new_slots = period(x, aux_total, block_p, cache_in)
        if mode == "prefill":
            period_caches.append(new_slots)

    x = apply_norm(cfg, x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = linear(x, head)

    new_cache = None
    if mode == "prefill":
        new_cache = {"blocks": stack_params(period_caches), "cur_len": S}
    elif mode == "decode":
        new_cache = {"blocks": cache["blocks"], "cur_len": cur_len + 1}
    return logits, new_cache, aux_total, x


def mtp_logits(cfg, params: Params, hidden: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
    """DeepSeek MTP: predict token t+2 from (hidden_t, embed(token_{t+1}))."""
    p = params["mtp"]
    # torch.roll(tokens, -1, 1) as a concatenation, which DTensor takes
    nxt = embed(torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1), params["embed"])
    h = linear(torch.cat([hidden, nxt.to(hidden.dtype)], dim=-1), p["proj"])
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    hh = apply_norm(cfg, h, p["norm1"])
    h = h + attn_mod.attend(cfg, p["attn"], hh, positions, kind="causal")
    hh = apply_norm(cfg, h, p["norm2"])
    h = h + apply_mlp(cfg, p["ffn"], hh)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return linear(h, head)


# ---------------------------------------------------------------------------
# Loss / train objective
# ---------------------------------------------------------------------------

def lm_loss(cfg, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy (labels shifted by one inside), plus
    0.01 x the MoE load-balance loss and 0.3 x the MTP loss on t+2."""
    logits, _, aux, hidden = forward(
        cfg, params, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"),
        enc_inputs=batch.get("enc_inputs"),
        mode="train")
    labels = batch["labels"]
    npfx = cfg.vlm_prefix
    if npfx and "prefix_embeds" in batch:
        logits = logits[:, npfx:]
    loss = cross_entropy(logits[:, :-1], labels[:, 1:], mask=batch.get("loss_mask"))
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    if cfg.mtp:
        l2 = mtp_logits(cfg, params, hidden, batch["tokens"])
        if npfx and "prefix_embeds" in batch:
            l2 = l2[:, npfx:]
        loss = loss + 0.3 * cross_entropy(l2[:, :-2], labels[:, 2:])
    return loss


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, cur_len: int = 0, device=None) -> Tree:
    """Zero-filled decode cache with the reference's stacked (P, B, ...) layout."""
    dtype = torch_dtype(cfg)
    dev = resolve_device(device)
    P = cfg.n_periods
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    kv = cfg.n_kv_heads

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    blocks: Dict[str, Any] = {}
    for s, (mixer, _) in enumerate(cfg.layer_plan()):
        slot: Dict[str, Any] = {}
        if mixer == "attn":
            W = cfg.sliding_window or 0
            S = min(max_len, W) if W else max_len
            slot["self"] = {"k": zeros(P, batch, S, kv, hd), "v": zeros(P, batch, S, kv, hd)}
            if cfg.cross_attn:
                slot["cross"] = {"k": zeros(P, batch, cfg.enc_seq, kv, hd),
                                 "v": zeros(P, batch, cfg.enc_seq, kv, hd)}
        elif mixer == "mla":
            m = cfg.mla
            slot["self"] = {"ckv": zeros(P, batch, max_len, m.kv_lora_rank),
                            "krope": zeros(P, batch, max_len, m.qk_rope_head_dim)}
        elif mixer == "mamba":
            slot["self"] = {"ssm": zeros(P, batch, cfg.d_inner, cfg.ssm_state,
                                         dt=torch.float32),
                            "conv": zeros(P, batch, cfg.conv_width - 1, cfg.d_inner)}
        blocks[f"slot{s}"] = slot
    return {"blocks": blocks, "cur_len": int(cur_len)}
