"""Attention variants: GQA/MQA (optionally sliding-window), cross-attention,
and DeepSeek-style MLA with a compressed KV cache. The port of the
reference's ``repro/models/attention.py``.

Cache layout (per attention layer):
  full/GQA : {"k": (B, S_max, n_kv, hd), "v": (B, S_max, n_kv, hd)}
  SWA      : same with S_max = window (ring buffer indexed by pos % window)
  MLA      : {"ckv": (B, S_max, kv_lora), "krope": (B, S_max, rope_dim)}

The decode functions write the new token's entries into the cache tensors in
place and return those same tensors (the reference returns new arrays); a
decode step then moves one token's K/V, not the whole cache.

Under a mesh (``repro_torch.launch.context``) with DTensor activations, the
reference's two sharding constraints redistribute, and the GQA core (the
dense path, flash and decode) runs on each rank's local shards: batch over
the DP axes, heads over "model" (or, with ``tp_mode="sp"``, the query
sequence over "model" with K/V whole), as the reference's constraints leave
them. GSPMD partitions that contraction by itself; DTensor cannot, since it
would fold two split dims (batch and KV heads) into one. Without a mesh every
function is the single-device code.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import ParamBuilder, Params, apply_rope, linear, rmsnorm

NEG_INF = -1e30


def _dist_mesh(*xs):
    """``sharding.model_mesh()`` when one of ``xs`` is a DTensor, else None."""
    mesh = shd.model_mesh()
    return mesh if mesh is not None and any(shd.is_dtensor(x) for x in xs) else None


def _batch_spec(mesh, B: int):
    dp = dp_axes(mesh)
    return dp if B % math.prod(mesh.shape[a] for a in dp) == 0 else None


def seq_shard_constraint(x: torch.Tensor) -> torch.Tensor:
    """tp_mode="sp": activations sharded over "model" on the SEQUENCE dim.

    With MQA/GQA the K/V tensors are tiny, so sequence-parallel attention
    gathers K/V instead of all-reducing full activations: projections and
    MLP become comm-free, per-layer collectives drop to weight gathers.
    """
    mesh = _dist_mesh(x)
    if mesh is None:
        return x
    s_spec = "model" if x.shape[1] % mesh.shape["model"] == 0 else None
    spec = (_batch_spec(mesh, x.shape[0]), s_spec) + (None,) * (x.dim() - 2)
    return shd.place(x, shd.NamedSharding(mesh, spec))


def _constrain_kv(x: torch.Tensor) -> torch.Tensor:
    """Replicate small KV tensors across the model axis before attention
    (batch stays over the DP axes): one small all-gather, where a kv
    projection's sharding left in place would spread into the attention
    contraction."""
    mesh = _dist_mesh(x)
    if mesh is None:
        return x
    spec = (_batch_spec(mesh, x.shape[0]),) + (None,) * (x.dim() - 1)
    return shd.place(x, shd.NamedSharding(mesh, spec))


def _gqa_core(core: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              seq_split: bool, hd_core: Optional[Callable] = None) -> torch.Tensor:
    """``core(q, k, v, q_offset)`` -> (B, Sq, H, Dv): a GQA attention over
    whole K/V. Under a mesh it runs on local shards, batch over the DP axes,
    and over "model" on the first of:
    - for K/V whose head dim is split over "model" (a decode cache whose KV
      heads do not split) and no gradient, the head dim, with
      ``hd_core(q, k, v, reduce_logits)`` summing the logits across "model"
      (the reference's logits all-reduce; gathering the cache instead would
      move all of it every step);
    - with ``seq_split`` (tp_mode="sp"), or query heads that do not split,
      the query rows, each rank passing its rows' offset, K/V whole;
    - the query heads with each rank's KV heads (whole K/V sliced locally
      when the KV heads do not split);
    - else replicated."""
    mesh = _dist_mesh(q, k, v)
    if mesh is None:
        return core(q, k, v, 0)
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    tp = mesh.shape["model"]
    dm = mesh.device_mesh
    b = _batch_spec(mesh, B)
    m = dm.get_local_rank("model")
    mi = mesh.axis_names.index("model")
    hd_split = (hd_core is not None and shd.is_dtensor(k) and k.placements[mi].is_shard(3)
                and not (H % tp == 0 and KV % tp == 0)
                and not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad)))
    if hd_split:
        import torch.distributed._functional_collectives as funcol
        q_spec = kv_spec = (b, None, None, "model")
        group = dm.get_group("model")

        def local(ql, kl, vl):
            return hd_core(ql, kl, vl, lambda t: funcol.all_reduce(t, "sum", group))
    elif (seq_split or H % tp != 0) and Sq % tp == 0 and Sq > 1:
        q_spec, kv_spec = (b, "model", None, None), (b, None, None, None)
        Sl = Sq // tp

        def local(ql, kl, vl):
            return core(ql, kl, vl, m * Sl)
    elif H % tp == 0:
        Hl, G = H // tp, H // KV
        q_spec = (b, None, "model", None)
        kv_split = KV % tp == 0
        kv_spec = q_spec if kv_split else (b, None, None, None)

        def local(ql, kl, vl):
            if not kv_split:              # this rank's query heads' KV heads
                if G % Hl == 0:
                    j = m * Hl // G
                    kl, vl = kl[:, :, j:j + 1], vl[:, :, j:j + 1]
                else:
                    idx = (torch.arange(Hl, device=kl.device) + m * Hl) // G
                    kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
            return core(ql, kl, vl, 0)
    else:
        q_spec = kv_spec = (b, None, None, None)

        def local(ql, kl, vl):
            return core(ql, kl, vl, 0)
    out = shd.on_shards(local, mesh, [q_spec, kv_spec, kv_spec],
                        (shd.placements(mesh, q_spec),))(q, k, v)
    if hd_split:    # the heads' outputs whole again (one token's: small)
        out = shd.place(out, shd.NamedSharding(mesh, (b, None, None, None)))
    return out


def _write_slot(t: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``t[:, slot] = new[:, 0]`` for a cache tensor t (B, S, ...). On a
    DTensor whose S is split, the rank whose shard holds ``slot`` writes it
    into its local shard (a select on a split dim would gather a copy)."""
    if not shd.is_dtensor(t) or not any(p.is_shard(1) for p in t.placements):
        t[:, slot] = new[:, 0]
        return
    from torch.distributed.tensor import Replicate, distribute_tensor
    places = [Replicate() if p.is_shard(1) else p for p in t.placements]
    new = (new.redistribute(t.device_mesh, places) if shd.is_dtensor(new)
           else distribute_tensor(new, t.device_mesh, places, src_data_rank=None))
    size = t.to_local().shape[1]
    idx = shd.shard_index(t.device_mesh, [i for i, p in enumerate(t.placements)
                                          if p.is_shard(1)])
    if idx * size <= slot < (idx + 1) * size:
        t.to_local()[:, slot - idx * size] = new.to_local()[:, 0]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(cfg, b: ParamBuilder, cross: bool = False) -> None:
    """``cross`` marks a cross-attention block, as in the reference; its
    params are the same as self-attention's."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b.make("wq", (d, h * hd), ("embed", "heads_x_dim"))
    b.make("wk", (d, kv * hd), ("embed", "kv_x_dim"))
    b.make("wv", (d, kv * hd), ("embed", "kv_x_dim"))
    b.make("wo", (h * hd, d), ("heads_x_dim", "embed"))
    if cfg.use_bias:
        b.make("bq", (h * hd,), ("heads_x_dim",), init="zeros")
        b.make("bk", (kv * hd,), ("kv_x_dim",), init="zeros")
        b.make("bv", (kv * hd,), ("kv_x_dim",), init="zeros")
        b.make("bo", (d,), ("embed",), init="zeros")


def init_mla(cfg, b: ParamBuilder) -> None:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    b.make("wq_a", (d, m.q_lora_rank), ("embed", None))
    b.make("q_norm", (m.q_lora_rank,), (None,), init="ones")
    b.make("wq_b", (m.q_lora_rank, h * qk), (None, "heads_x_dim"))
    b.make("wkv_a", (d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None))
    b.make("kv_norm", (m.kv_lora_rank,), (None,), init="ones")
    b.make("wkv_b", (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
           (None, "heads_x_dim"))
    b.make("wo", (h * m.v_head_dim, d), ("heads_x_dim", "embed"))


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          scale: float, reduce_logits: Optional[Callable] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k,v: (B,Sk,KV,hd)  mask: broadcastable (B,1,Sq,Sk).
    ``reduce_logits`` sums the logits of a head dim split across ranks."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    if reduce_logits is not None:
        logits = reduce_logits(logits)
    logits = logits * scale
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
    y = linear(x, w)
    if b is not None:
        y = y + b
    if shd.is_dtensor(y):
        # a split of heads*hd that the heads do not take (8 KV heads over 16
        # ranks) cannot be unflattened: gather it first
        split = [i for i, p in enumerate(y.placements) if p.is_shard(y.dim() - 1)]
        if heads % math.prod(y.device_mesh.size(i) for i in split) != 0:
            from torch.distributed.tensor import Replicate
            y = y.redistribute(y.device_mesh, [Replicate() if i in split else p
                                               for i, p in enumerate(y.placements)])
    return y.reshape(B, S, heads, hd)


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
    seq_split = cfg.tp_mode == "sp" and S == Sk
    if seq_split:
        q = seq_shard_constraint(q)      # q stays sequence-sharded; K/V full
    if max(S, Sk) >= cfg.flash_min_seq:
        def core(q, k, v, q_off):
            return flash_attention(q, k, v, causal, cfg.sliding_window if causal else 0,
                                   q_off, min(512, _ceil_pow2(S)), min(1024, _ceil_pow2(Sk)),
                                   hd ** -0.5)
    else:
        def core(q, k, v, q_off):
            Sq = q.shape[1]
            if causal:
                mask = causal_mask(Sq, Sk, q_off, cfg.sliding_window, device=q.device)
            else:
                mask = torch.ones((1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
            return _sdpa(q, k, v, mask, scale=hd ** -0.5)
    out = _gqa_core(core, q, k, v, seq_split)
    out = linear(out.reshape(B, S, h * hd), p["wo"])
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
    return _constrain_kv(k), _constrain_kv(v)


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
    _write_slot(k, slot, k_new)
    _write_slot(v, slot, v_new)

    n_valid = min(cur_len + 1, S_cache) if window else cur_len + 1
    valid = torch.arange(S_cache, device=x.device) < n_valid
    def core(q, k, v, _, reduce_logits=None):
        return _sdpa(q, k, v, valid[None, None, None, :], hd ** -0.5, reduce_logits)
    out = _gqa_core(core, q, k, v, False,
                    hd_core=lambda q, k, v, red: core(q, k, v, 0, red))
    out = linear(out.reshape(B, 1, h * hd), p["wo"])
    if "bo" in p:
        out = out + p["bo"]
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank Q/KV with compressed cache
# ---------------------------------------------------------------------------

def _mla_qkv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    q_lat = rmsnorm(linear(x, p["wq_a"]), p["q_norm"])
    q = linear(q_lat, p["wq_b"]).reshape(B, S, cfg.n_heads,
                                    m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = linear(x, p["wkv_a"])
    ckv, k_rope = torch.split(kv_a, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rmsnorm(ckv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_wkv_b(cfg, wkv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv_b (r, h*(nope+v)) -> its K part (r, h, nope) and V part (r, h, v);
    h is whatever heads wkv_b holds (all, or a rank's share)."""
    m = cfg.mla
    wkv_b = wkv_b.reshape(m.kv_lora_rank, -1, m.qk_nope_head_dim + m.v_head_dim)
    return wkv_b[:, :, : m.qk_nope_head_dim], wkv_b[:, :, m.qk_nope_head_dim:]


def _mla_core(cfg, wkv_b, q_nope, q_rope, ckv, k_rope, mask):
    m = cfg.mla
    wk_b, wv_b = _mla_wkv_b(cfg, wkv_b)
    q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), wk_b.float())
    logits = torch.einsum("bqhr,bsr->bhqs", q_eff, ckv.float())
    logits = logits + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), k_rope.float())
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    logits = logits * scale + torch.where(mask, 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, ckv.float())
    out = torch.einsum("bqhr,rhv->bqhv", ctx, wv_b.float())
    return out.to(q_nope.dtype)


def _mla_attend_core(cfg, p: Params, q_nope, q_rope, ckv, k_rope, mask):
    """Attention against the *compressed* cache (absorbed-matrix trick).

    ckv: (B, Sk, r); k_rope: (B, Sk, rd); q_*: (B, Sq, h, .). The K side of
    wkv_b is absorbed into the query, so logits are computed in the rank-r
    space and per-head K/V never materialise. Under a mesh it runs on local
    shards: batch over the DP axes, heads (and wkv_b's) over "model", the
    compressed cache whole on every "model" rank.
    """
    mesh = _dist_mesh(q_nope, ckv)
    if mesh is None:
        return _mla_core(cfg, p["wkv_b"], q_nope, q_rope, ckv, k_rope, mask)
    b = _batch_spec(mesh, q_nope.shape[0])
    hs = "model" if cfg.n_heads % mesh.shape["model"] == 0 else None
    q_spec, c_spec = (b, None, hs, None), (b, None, None)
    fn = shd.on_shards(lambda qn, qr, c, kr, w: _mla_core(cfg, w, qn, qr, c, kr, mask),
                       mesh, [q_spec, q_spec, c_spec, c_spec, (None, hs)],
                       (shd.placements(mesh, q_spec),))
    return fn(q_nope, q_rope, ckv, k_rope, p["wkv_b"])


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
        wk_b, wv_b = _mla_wkv_b(cfg, p["wkv_b"])
        q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope, wk_b)
        q_all = torch.cat([q_eff, q_rope], dim=-1)                 # (B,S,h,r+rd)
        k_all = _constrain_kv(torch.cat([ckv, k_rope], dim=-1)[:, :, None, :])
        v_all = _constrain_kv(ckv[:, :, None, :])
        scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        ctx = _gqa_core(lambda q, k, v, q_off: flash_attention(
            q, k, v, kind == "causal", 0, q_off, 512, 1024, scale),
            q_all, k_all, v_all, False)                            # (B,S,h,r)
        out = torch.einsum("bqhr,rhv->bqhv", ctx.float(), wv_b.float()).to(x.dtype)
    else:
        mask = causal_mask(S, S, device=x.device) if kind == "causal" \
            else torch.ones((1, 1, S, S), dtype=torch.bool, device=x.device)
        out = _mla_attend_core(cfg, p, q_nope, q_rope, ckv, k_rope, mask)
    return linear(out.reshape(B, S, cfg.n_heads * m.v_head_dim), p["wo"])


def mla_decode_attend(cfg, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                      cur_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,1,d); cache: ckv (B,S,r), krope (B,S,rd), written in place at
    min(cur_len, S - 1), where the reference's ``dynamic_update_slice``
    clamps."""
    B = x.shape[0]
    m = cfg.mla
    pos = torch.full((B, 1), cur_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv(cfg, p, x, pos)
    q_nope = _constrain_kv(q_nope)
    q_rope = _constrain_kv(q_rope)
    ckv, krope = cache["ckv"], cache["krope"]
    S_cache = ckv.shape[1]
    slot = min(cur_len, S_cache - 1)
    _write_slot(ckv, slot, ckv_new)
    _write_slot(krope, slot, krope_new)
    mask = (torch.arange(S_cache, device=x.device) <= cur_len)[None, None, None, :]
    out = _mla_attend_core(cfg, p, q_nope, q_rope, ckv, krope, mask)
    out = linear(out.reshape(B, 1, cfg.n_heads * m.v_head_dim), p["wo"])
    return out, {"ckv": ckv, "krope": krope}
