"""Attention variants: GQA/MQA (optionally sliding-window), cross-attention,
and DeepSeek-style MLA with a compressed KV cache. The port of the
reference's ``repro/models/attention.py``.

Cache layout (per attention layer):
  full/GQA : {"k": (B, S_max, n_kv, hd), "v": (B, S_max, n_kv, hd)}
  SWA      : same with S_max = window (ring buffer indexed by pos % window)
  MLA      : {"ckv": (B, S_max, kv_lora), "krope": (B, S_max, rope_dim)}

The decode functions write the new token's entries into the cache tensors in
place and return those same tensors (the reference returns new arrays); a
decode step then moves one token's K/V, not the whole cache. The reference's
two sharding constraints are the identity without a mesh and are left out.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import ParamBuilder, Params, apply_rope, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(cfg, b: ParamBuilder) -> None:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b.make("wq", (d, h * hd))
    b.make("wk", (d, kv * hd))
    b.make("wv", (d, kv * hd))
    b.make("wo", (h * hd, d))
    if cfg.use_bias:
        b.make("bq", (h * hd,), init="zeros")
        b.make("bk", (kv * hd,), init="zeros")
        b.make("bv", (kv * hd,), init="zeros")
        b.make("bo", (d,), init="zeros")


def init_mla(cfg, b: ParamBuilder) -> None:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    b.make("wq_a", (d, m.q_lora_rank))
    b.make("q_norm", (m.q_lora_rank,), init="ones")
    b.make("wq_b", (m.q_lora_rank, h * qk))
    b.make("wkv_a", (d, m.kv_lora_rank + m.qk_rope_head_dim))
    b.make("kv_norm", (m.kv_lora_rank,), init="ones")
    b.make("wkv_b", (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)))
    b.make("wo", (h * m.v_head_dim, d))


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          scale: float) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k,v: (B,Sk,KV,hd)  mask: broadcastable (B,1,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    bias = torch.where(mask, 0.0, NEG_INF)                  # (B|1, 1, Sq, Sk)
    logits = logits + bias[:, :, None, :, :]                # -> (B, KV, G, Sq, Sk)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def causal_mask(Sq: int, Sk: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(1, 1, Sq, Sk) boolean mask. window>0 adds sliding-window banding."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None, None]


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _project(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], heads: int,
             hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    y = (x @ w).reshape(B, S, heads, hd)
    if b is not None:
        y = y + b.reshape(1, 1, heads, hd)
    return y


def attend(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
           kind: str = "causal",
           kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           ) -> torch.Tensor:
    """Full-sequence (train / prefill) GQA attention. x: (B, S, d).

    kind: "causal" (+ cfg.sliding_window) or "full" (encoder / cross).
    Sequences of at least ``cfg.flash_min_seq`` stream through the chunked
    flash path; shorter ones use the exact dense path.
    """
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _project(x, p["wq"], p.get("bq"), h, hd)
    if kv_override is None:
        k, v = project_kv(cfg, p, x, positions)
    else:
        k, v = kv_override
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    Sk = k.shape[1]
    causal = kind == "causal"
    if max(S, Sk) >= cfg.flash_min_seq:
        out = flash_attention(q, k, v, causal, cfg.sliding_window if causal else 0,
                              0, min(512, _ceil_pow2(S)), min(1024, _ceil_pow2(Sk)),
                              hd ** -0.5)
    else:
        if causal:
            mask = causal_mask(S, Sk, window=cfg.sliding_window, device=x.device)
        else:
            mask = torch.ones((1, 1, S, Sk), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, scale=hd ** -0.5)
    out = out.reshape(B, S, h * hd) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


def project_kv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV projection for cross-attention memory or cache fill."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = _project(x, p["wk"], p.get("bk"), kv, hd)
    v = _project(x, p["wv"], p.get("bv"), kv, hd)
    if cfg.rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def decode_attend(cfg, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  cur_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); cache k/v: (B, S_cache, kv, hd); cur_len: host int.

    Sliding-window caches are ring buffers: slot = cur_len % window, and the
    validity mask covers min(cur_len + 1, S_cache) entries. The slot is
    clamped to S_cache - 1, as the reference's ``dynamic_update_slice``
    clamps it.
    """
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    S_cache = cache["k"].shape[1]
    window = cfg.sliding_window

    q = _project(x, p["wq"], p.get("bq"), h, hd)
    k_new = _project(x, p["wk"], p.get("bk"), kv, hd)
    v_new = _project(x, p["wv"], p.get("bv"), kv, hd)
    if cfg.rope:
        pos = torch.full((B, 1), cur_len, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)

    slot = min(cur_len % window if window else cur_len, S_cache - 1)
    k, v = cache["k"], cache["v"]
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]

    n_valid = min(cur_len + 1, S_cache) if window else cur_len + 1
    valid = torch.arange(S_cache, device=x.device) < n_valid
    out = _sdpa(q, k, v, valid[None, None, None, :], scale=hd ** -0.5)
    out = out.reshape(B, 1, h * hd) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank Q/KV with compressed cache
# ---------------------------------------------------------------------------

def _mla_qkv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    q_lat = rmsnorm(x @ p["wq_a"], p["q_norm"])
    q = (q_lat @ p["wq_b"]).reshape(B, S, cfg.n_heads,
                                    m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ p["wkv_a"]
    ckv, k_rope = torch.split(kv_a, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rmsnorm(ckv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_wkv_b(cfg, p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv_b (r, h*(nope+v)) -> its K part (r, h, nope) and V part (r, h, v)."""
    m = cfg.mla
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, cfg.n_heads,
                               m.qk_nope_head_dim + m.v_head_dim)
    return wkv_b[:, :, : m.qk_nope_head_dim], wkv_b[:, :, m.qk_nope_head_dim:]


def _mla_attend_core(cfg, p: Params, q_nope, q_rope, ckv, k_rope, mask):
    """Attention against the *compressed* cache (absorbed-matrix trick).

    ckv: (B, Sk, r); k_rope: (B, Sk, rd); q_*: (B, Sq, h, .). The K side of
    wkv_b is absorbed into the query, so logits are computed in the rank-r
    space and per-head K/V never materialise.
    """
    m = cfg.mla
    wk_b, wv_b = _mla_wkv_b(cfg, p)
    q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), wk_b.float())
    logits = torch.einsum("bqhr,bsr->bhqs", q_eff, ckv.float())
    logits = logits + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), k_rope.float())
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    logits = logits * scale + torch.where(mask, 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, ckv.float())
    out = torch.einsum("bqhr,rhv->bqhv", ctx, wv_b.float())
    return out.to(q_nope.dtype)


def mla_attend(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
               kind: str = "causal") -> torch.Tensor:
    """Full-sequence MLA. x: (B,S,d).

    Sequences of at least ``cfg.flash_min_seq`` run flash over the absorbed
    representation: q' = [q_nope @ Wk_b^T ; q_rope], k' = [ckv ; k_rope] (one
    KV "head" of width r+rope), v = ckv.
    """
    B, S, _ = x.shape
    m = cfg.mla
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, p, x, positions)
    if S >= cfg.flash_min_seq:
        wk_b, wv_b = _mla_wkv_b(cfg, p)
        q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope, wk_b)
        q_all = torch.cat([q_eff, q_rope], dim=-1)                 # (B,S,h,r+rd)
        k_all = torch.cat([ckv, k_rope], dim=-1)[:, :, None, :]
        v_all = ckv[:, :, None, :]
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        ctx = flash_attention(q_all, k_all, v_all, kind == "causal", 0, 0,
                              512, 1024, scale)                    # (B,S,h,r)
        out = torch.einsum("bqhr,rhv->bqhv", ctx.float(), wv_b.float()).to(x.dtype)
    else:
        mask = causal_mask(S, S, device=x.device) if kind == "causal" \
            else torch.ones((1, 1, S, S), dtype=torch.bool, device=x.device)
        out = _mla_attend_core(cfg, p, q_nope, q_rope, ckv, k_rope, mask)
    return out.reshape(B, S, cfg.n_heads * m.v_head_dim) @ p["wo"]


def mla_decode_attend(cfg, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                      cur_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,1,d); cache: ckv (B,S,r), krope (B,S,rd), written in place at
    min(cur_len, S - 1), where the reference's ``dynamic_update_slice``
    clamps."""
    B = x.shape[0]
    m = cfg.mla
    pos = torch.full((B, 1), cur_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv(cfg, p, x, pos)
    ckv, krope = cache["ckv"], cache["krope"]
    S_cache = ckv.shape[1]
    slot = min(cur_len, S_cache - 1)
    ckv[:, slot] = ckv_new[:, 0]
    krope[:, slot] = krope_new[:, 0]
    mask = (torch.arange(S_cache, device=x.device) <= cur_len)[None, None, None, :]
    out = _mla_attend_core(cfg, p, q_nope, q_rope, ckv, krope, mask)
    out = out.reshape(B, 1, cfg.n_heads * m.v_head_dim) @ p["wo"]
    return out, {"ckv": ckv, "krope": krope}
