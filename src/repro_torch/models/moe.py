"""Mixture-of-Experts with sort-based capacity dispatch and expert
parallelism, the port of the reference's ``repro/models/moe.py``.

Token -> expert slots come from a stable argsort, as in the reference, so the
FIFO drop policy (earlier tokens keep their slot when an expert overflows its
capacity) and every kept token's (expert, slot) are the reference's. Dropped
tokens produce zero output (the residual passes them through) and an aux
load-balancing loss discourages drops.

Under a mesh with "model" (``repro_torch.launch.context``, with a device
mesh) the FFN runs on each rank's local shards (``sharding.on_shards``, the
reference's ``shard_map``): every DP shard routes its local tokens (routing is
replicated across "model"), each "model" shard computes only its resident
experts, in the reference's four layouts:
- 2D EP (E divides data x model): weights all-gathered over "data", expert e
  resident on model rank e % tp (strided ownership);
- expert-on-model (E divides model): a contiguous block per model rank, FSDP
  weights all-gathered over "data";
- ff-sharded TP (E does not divide model): every expert local, its hidden dim
  split over "model";
- token gather (2D EP, decode-size batches whose tokens weigh far less than a
  layer's weight gather): the tokens are all-gathered over "data" and the
  weights never move.
The all-gathers are functional collectives with autograd. The reference's
``psum`` of the partial outputs and its ``pmean`` of the aux loss are the
``Partial`` placements of the local outputs (the aux as each rank's share
of a sum), reduced as the branch returns.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.layers import ParamBuilder, Params, linear, reduce_partial


def init_moe(cfg, b: ParamBuilder, d_model: int, d_ff: int) -> None:
    E = cfg.n_experts
    b.make("router", (d_model, E), (None, None), scale=0.02)  # replicated (tiny)
    b.make("w_gate", (E, d_model, d_ff), ("experts", "embed", "ff"))
    b.make("w_up", (E, d_model, d_ff), ("experts", "embed", "ff"))
    b.make("w_down", (E, d_ff, d_model), ("experts", "ff", "embed"))
    if cfg.n_shared_experts:
        ffs = d_ff * cfg.n_shared_experts
        b.make("shared_w_gate", (d_model, ffs), ("embed", "ff"))
        b.make("shared_w_up", (d_model, ffs), ("embed", "ff"))
        b.make("shared_w_down", (ffs, d_model), ("ff", "embed"))


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(math.ceil(n_tokens * top_k / n_experts * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _slots(eid: torch.Tensor, E_total: int, e_start: int, E_loc: int, C: int,
           owner_stride: int = 0, owner_idx: int = 0):
    """Each (token, choice)'s expert slot, by its rank among the choices of
    its expert in token order (a stable sort: FIFO drops). eid: (T*k,).
    Resident experts: the block [e_start, e_start + E_loc), or with
    ``owner_stride`` every e with e % owner_stride == owner_idx at local
    index e // owner_stride. Returns (keep, local expert, slot); dropped
    entries point at (0, C-1)."""
    order = torch.argsort(eid, stable=True)
    se = eid[order]
    starts = torch.searchsorted(se, torch.arange(E_total, dtype=se.dtype, device=se.device))
    rank_sorted = torch.arange(eid.shape[0], device=eid.device) - starts[se]
    pos = torch.empty_like(rank_sorted).index_put_((order,), rank_sorted)
    if owner_stride:
        local = (eid % owner_stride) == owner_idx
        le = eid // owner_stride
    else:
        local = (eid >= e_start) & (eid < e_start + E_loc)
        le = eid - e_start
    keep = (pos < C) & local
    return keep, torch.where(keep, le, 0), torch.where(keep, pos, C - 1)


def _moe_compute(cfg, xt: torch.Tensor, router: torch.Tensor, wg, wu, wd,
                 e_start: int, E_total: int, owner_stride: int = 0, owner_idx: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local-token MoE. xt (T, d); wg/wu/wd hold the E_loc resident experts,
    a contiguous block starting at ``e_start`` or strided (``_slots``).
    Returns the output of the resident experts only and the aux loss."""
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

    keep, le_safe, pos_safe = _slots(expert_ids.reshape(T * k), E_total, e_start, E_loc, C,
                                     owner_stride, owner_idx)

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


def ep_layout(cfg, mesh, B: int, S: int) -> str:
    """The reference's choice of expert-parallel layout for (B, S) tokens
    on ``mesh``: "2d_token_gather", "2d_weight_gather", "expert_on_model"
    or "ff_tp". Token gather: with 2D EP the weights are resident; when the
    tokens weigh far less than a layer's weight gather (decode steps), the
    tokens are all-gathered over "data" and the expert weights stay."""
    E, tp = cfg.n_experts, mesh.shape["model"]
    if E % (tp * mesh.shape.get("data", 1)) == 0:    # 2D EP: experts over data x model
        dp_total = math.prod(mesh.shape[a] for a in dp_axes(mesh))
        weight_gather_bytes = (E // tp) * 3 * cfg.d_model * cfg.d_ff * 2
        token_bytes = B * S * cfg.d_model * 2
        if token_bytes * 8 < weight_gather_bytes and B % dp_total == 0:
            return "2d_token_gather"
        return "2d_weight_gather"
    return "expert_on_model" if E % tp == 0 else "ff_tp"


def _apply_moe_ep(cfg, p: Params, x: torch.Tensor, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` branch over the mesh's local shards."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial
    B, S, d = x.shape
    E = cfg.n_experts
    dm = mesh.device_mesh
    dp = dp_axes(mesh)
    tp = mesh.shape["model"]
    data_n = mesh.shape.get("data", 1)
    layout = ep_layout(cfg, mesh, B, S)
    expert_2d, token_gather = layout.startswith("2d"), layout == "2d_token_gather"
    expert_on_model = layout == "expert_on_model"
    fsdp_ax = "data" if cfg.fsdp else None
    if expert_2d:
        wspec = wd_spec = (("data", "model"), None, None)
    elif expert_on_model:
        wspec, wd_spec = ("model", fsdp_ax, None), ("model", None, fsdp_ax)
    else:
        wspec, wd_spec = (None, fsdp_ax, "model"), (None, "model", fsdp_ax)
    # decode with a tiny batch: tokens replicated across DP (B=1 long-context)
    x_split = B % math.prod(mesh.shape[a] for a in dp) == 0
    x_spec = (dp if x_split else None, None, None)
    m_idx = dm.get_local_rank("model")
    d_idx = dm.get_local_rank("data") if "data" in mesh.axis_names else 0

    # (torch before 2.13 names it all_gather_tensor_autograd)
    all_gather = (getattr(funcol, "all_gather_single_autograd", None)
                  or funcol.all_gather_tensor_autograd)

    def gather(t, dim):
        return all_gather(t, dim, dm.get_group("data"))

    def f(x_loc, router, wg, wu, wd):
        Bl, Sl, _ = x_loc.shape
        if token_gather:
            xt_full = gather(x_loc, 0)
            y, aux = _moe_compute(cfg, xt_full.reshape(-1, d), router, wg, wu, wd, 0, E,
                                  owner_stride=tp * data_n, owner_idx=d_idx * tp + m_idx)
            return y.reshape(-1, Sl, d), aux
        if expert_2d:
            # gathered over data: model rank m holds the experts e with
            # e % tp == m at local index e // tp (strided ownership)
            wg, wu, wd = gather(wg, 0), gather(wu, 0), gather(wd, 0)
            y, aux = _moe_compute(cfg, x_loc.reshape(Bl * Sl, d), router, wg, wu, wd, 0, E,
                                  owner_stride=tp, owner_idx=m_idx)
        else:
            if cfg.fsdp:
                wg, wu, wd = gather(wg, 1), gather(wu, 1), gather(wd, 2)
            e_start = m_idx * (E // tp) if expert_on_model else 0
            y, aux = _moe_compute(cfg, x_loc.reshape(Bl * Sl, d), router, wg, wu, wd,
                                  e_start, E)
        return y.reshape(Bl, Sl, d), aux

    # psum over "model" (and over "data" for the gathered tokens): Partial
    y_places = [Partial() if a == "model" or (token_gather and a == "data") else pl
                for a, pl in zip(mesh.axis_names, shd.placements(mesh, x_spec))]
    # pmean over every axis: each rank's share of a Partial sum
    aux_places = [Partial()] * len(mesh.axis_names)
    split = (dp if x_split else ()) + ("model",)
    fn = shd.on_shards(f, mesh, [x_spec, (None, None), wspec, wspec, wd_spec],
                       (y_places, aux_places), split=split)
    y, aux = fn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    # summed at once, as the reference's psum and pmean are, inside its
    # shard_map: a partial sum carried into the norm and the next layer's
    # products would have DTensor repeat those on every "model" rank
    return reduce_partial(y), reduce_partial(aux / mesh.size)


def apply_moe(cfg, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). Expert-parallel under a mesh."""
    B, S, d = x.shape
    mesh = shd.model_mesh()
    if mesh is None:
        y, aux = _moe_compute(cfg, x.reshape(B * S, d), p["router"],
                              p["w_gate"], p["w_up"], p["w_down"], 0, cfg.n_experts)
        y = y.reshape(B, S, d)
    else:
        y, aux = _apply_moe_ep(cfg, p, x, mesh)
    if cfg.n_shared_experts:
        xt = x.reshape(B * S, d)
        hs = F.silu(linear(xt, p["shared_w_gate"])) * linear(xt, p["shared_w_up"])
        y = y + linear(hs, p["shared_w_down"]).reshape(B, S, d)
    return y, aux
