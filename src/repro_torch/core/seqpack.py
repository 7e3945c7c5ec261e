"""Compressed Sparse Sequence packing, the CSP idea applied to LM serving
(the port of the reference's ``repro/core/seqpack.py``): variable-length
prefills become one packed token batch with request offsets.

- ``pack``: heterogeneous prompts -> (tokens (1, T_pad), segment_ids,
  positions), numpy on the host, bit-identical to the reference, with
  requests sorted by length so same-length groups are contiguous;
- attention stays request-local via a segment mask (no token attends across
  requests);
- ``packed_prefill`` returns each request's last-token logits, and
  ``unpack_by_request`` maps them back to the caller's request ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm, tree_index


@dataclass(frozen=True)
class PackedBatch:
    req_ids: np.ndarray       # (R,) caller ids, length-sorted
    lengths: np.ndarray       # (R,)
    offsets: np.ndarray       # (R+1,) CSR offsets into the packed axis
    total: int                # padded packed length
    tokens: np.ndarray        # (1, total) int32
    segment_ids: np.ndarray   # (1, total) int32; -1 = padding
    positions: np.ndarray     # (1, total) int32 within-request positions


def _bucket(n: int, mult: int = 128) -> int:
    return max(mult, -(-n // mult) * mult)


def pack(prompts: Sequence[np.ndarray],
         req_ids: Sequence[int] | None = None,
         pad_mult: int = 128) -> PackedBatch:
    R = len(prompts)
    if req_ids is None:
        req_ids = list(range(R))
    lengths = np.asarray([len(p) for p in prompts], np.int64)
    order = np.argsort(lengths, kind="stable")
    lengths = lengths[order]
    req_ids = np.asarray(req_ids, np.int64)[order]
    prompts = [np.asarray(prompts[int(i)], np.int32) for i in order]

    offsets = np.zeros(R + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    total = _bucket(int(offsets[-1]), pad_mult)

    tokens = np.zeros(total, np.int32)
    seg = np.full(total, -1, np.int32)
    pos = np.zeros(total, np.int32)
    for i, p in enumerate(prompts):
        s, e = offsets[i], offsets[i + 1]
        tokens[s:e] = p
        seg[s:e] = i
        pos[s:e] = np.arange(len(p))
    return PackedBatch(req_ids=req_ids, lengths=lengths, offsets=offsets,
                       total=total, tokens=tokens[None], segment_ids=seg[None],
                       positions=pos[None])


def segment_causal_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """(1, T) -> (1, 1, T, T): causal AND same-request."""
    seg = segment_ids[0]
    T = seg.shape[0]
    same = (seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
    ar = torch.arange(T, device=seg.device)
    causal = ar[:, None] >= ar[None, :]
    return (same & causal)[None, None]


def packed_prefill(cfg, params, batch: PackedBatch) -> torch.Tensor:
    """One forward over the packed batch on the params' device; returns
    per-request last-token logits (R, vocab). Uses the dense-mask attention
    path (packed lengths are bucketed; masks are segment-local)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch.tokens, device=dev)
    positions = torch.as_tensor(batch.positions, device=dev)
    x = F.embedding(tokens, params["embed"])
    mask = segment_causal_mask(torch.as_tensor(batch.segment_ids, device=dev))
    plan = cfg.layer_plan()
    n_heads, hd = cfg.n_heads, cfg.resolved_head_dim
    for n in range(cfg.n_periods):
        for s, (mixer, _) in enumerate(plan):
            if mixer != "attn":
                raise NotImplementedError("seqpack targets attention archs")
            p = tree_index(params["blocks"][f"slot{s}"], n)
            h = apply_norm(cfg, x, p["norm1"])
            k, v = attn_mod.project_kv(cfg, p["attn"], h, positions)
            q = attn_mod._project(h, p["attn"]["wq"], p["attn"].get("bq"), n_heads, hd)
            if cfg.rope:
                q = attn_mod.apply_rope(q, positions, cfg.rope_theta)
            out = attn_mod._sdpa(q, k, v, mask, scale=hd ** -0.5)
            out = out.reshape(1, batch.total, -1) @ p["attn"]["wo"]
            if "bo" in p["attn"]:
                out = out + p["attn"]["bo"]
            x = x + out
            h = apply_norm(cfg, x, p["norm2"])
            x = x + apply_mlp(cfg, p["ffn"], h)
    x = apply_norm(cfg, x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    last = torch.as_tensor(batch.offsets[1:] - 1, device=dev)
    return x[0, last] @ head


def unpack_by_request(batch: PackedBatch, per_request) -> dict:
    """{original req_id: row} for (R, ...) outputs."""
    return {int(rid): per_request[i] for i, rid in enumerate(batch.req_ids)}
