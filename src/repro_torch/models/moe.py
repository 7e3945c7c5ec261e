"""Mixture-of-Experts with sort-based capacity dispatch, the port of the
reference's ``repro/models/moe.py`` without a mesh.

Token -> expert slots come from a stable argsort, as in the reference, so the
FIFO drop policy (earlier tokens keep their slot when an expert overflows its
capacity) and every kept token's (expert, slot) are the reference's. Dropped
tokens produce zero output (the residual passes them through) and an aux
load-balancing loss discourages drops.

The expert-parallel ``shard_map`` branch of the reference belongs to the
distributed port; here every expert is resident.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamBuilder, Params


def init_moe(cfg, b: ParamBuilder, d_model: int, d_ff: int) -> None:
    E = cfg.n_experts
    b.make("router", (d_model, E), scale=0.02)
    b.make("w_gate", (E, d_model, d_ff))
    b.make("w_up", (E, d_model, d_ff))
    b.make("w_down", (E, d_ff, d_model))
    if cfg.n_shared_experts:
        ffs = d_ff * cfg.n_shared_experts
        b.make("shared_w_gate", (d_model, ffs))
        b.make("shared_w_up", (d_model, ffs))
        b.make("shared_w_down", (ffs, d_model))


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(math.ceil(n_tokens * top_k / n_experts * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _slots(eid: torch.Tensor, E_total: int, e_start: int, E_loc: int, C: int):
    """Each (token, choice)'s expert slot, by its rank among the choices of
    its expert in token order (a stable sort: FIFO drops). eid: (T*k,).
    Returns (keep, local expert, slot); dropped entries point at (0, C-1)."""
    order = torch.argsort(eid, stable=True)
    se = eid[order]
    starts = torch.searchsorted(se, torch.arange(E_total, dtype=se.dtype, device=se.device))
    rank_sorted = torch.arange(eid.shape[0], device=eid.device) - starts[se]
    pos = torch.empty_like(rank_sorted).index_put_((order,), rank_sorted)
    local = (eid >= e_start) & (eid < e_start + E_loc)
    keep = (pos < C) & local
    return keep, torch.where(keep, eid - e_start, 0), torch.where(keep, pos, C - 1)


def _moe_compute(cfg, xt: torch.Tensor, router: torch.Tensor, wg, wu, wd,
                 e_start: int, E_total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local-token MoE. xt (T, d); wg/wu/wd hold the E_loc resident experts,
    a contiguous block starting at ``e_start``. Returns the output of the
    resident experts and the aux loss."""
    T, d = xt.shape
    E_loc = wg.shape[0]
    k = cfg.moe_top_k
    C = moe_capacity(T, E_total, k, cfg.capacity_factor)

    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    # torch.topk leaves the order of equal values unspecified where lax.top_k
    # takes the lower index first; random activations give no exact ties
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)         # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux; the reference's bincount as a
    # scatter-add (torch.bincount sizes its output from the data, which makes
    # the host wait for the card)
    top1 = expert_ids[:, 0]
    density = probs.new_zeros(E_total).index_add_(0, top1, probs.new_ones(T)) / T
    aux = torch.sum(density * probs.mean(dim=0)) * E_total

    keep, le_safe, pos_safe = _slots(expert_ids.reshape(T * k), E_total, e_start, E_loc, C)

    # each kept token owns its (expert, slot); dropped ones add zeros into
    # (0, C-1), so the accumulation gives the same sums in any order
    xk = xt[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = xt.new_zeros((E_loc, C, d))
    buf.index_put_((le_safe, pos_safe), torch.where(keep[:, None], xk, 0),
                   accumulate=True)

    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd)                                   # (E_loc, C, d)

    ytk = torch.where(keep[:, None], out_buf[le_safe, pos_safe], 0)
    y = (ytk * gate_vals.reshape(T * k, 1).to(ytk.dtype)).reshape(T, k, d).sum(dim=1)
    return y, aux.float()


def apply_moe(cfg, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    y, aux = _moe_compute(cfg, x.reshape(B * S, d), p["router"],
                          p["w_gate"], p["w_up"], p["w_down"], 0, cfg.n_experts)
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        xt = x.reshape(B * S, d)
        hs = F.silu(xt @ p["shared_w_gate"]) * (xt @ p["shared_w_up"])
        y = y + (hs @ p["shared_w_down"]).reshape(B, S, d)
    return y, aux
