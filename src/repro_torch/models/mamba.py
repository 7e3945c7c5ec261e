"""Mamba-1 (S6) selective state-space mixer, the port of the reference's
``repro/models/mamba.py``.

The reference evaluates the recurrence h_t = A_t * h_{t-1} + b_t with
``jax.lax.associative_scan``; torch has none. ``_scan`` evaluates it over the
sequence axis with plain tensor ops on the (B, S, d_inner, d_state) fp32
pairs, one position at a time, and has a custom backward for training.
Decode is a single state update per token.

State threading (per mamba layer):
  ssm_state : (B, d_inner, d_state)   fp32
  conv_state: (B, conv_width - 1, d_inner)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import ParamBuilder, Params, linear, reduce_partial


def init_mamba(cfg, b: ParamBuilder) -> None:
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = cfg.resolved_dt_rank
    b.make("in_proj", (d, 2 * di), ("embed", "d_inner"))
    b.make("conv_w", (cfg.conv_width, di), (None, "d_inner"), scale=0.5)
    b.make("conv_b", (di,), ("d_inner",), init="zeros")
    b.make("x_proj", (di, dt_rank + 2 * st), ("d_inner", None))
    b.make("dt_proj", (dt_rank, di), (None, "d_inner"))
    b.make("dt_bias", (di,), ("d_inner",), init="zeros")
    b.make("A_log", (di, st), ("d_inner", None), init="zeros")  # A = -exp(0) = -1
    b.make("D", (di,), ("d_inner",), init="ones")
    b.make("out_proj", (di, d), ("d_inner", "embed"))


def in_proj(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xi, z) = the two halves of ``x @ w``. With w's output dim split
    over "model" (a DTensor), each half of w is split on its own first: a
    rank's shard of x @ w straddles the halves, so chunking the product
    would gather it whole, and its gradient, on every rank."""
    if not any(pl.is_shard(1) for pl in getattr(w, "placements", ())):
        return torch.chunk(linear(x, w), 2, dim=-1)
    di = w.shape[-1] // 2
    return tuple(linear(x, w[:, i * di:(i + 1) * di].redistribute(w.device_mesh, w.placements))
                 for i in range(2))


def _ssm_params(cfg, p: Params, xc: torch.Tensor):
    """xc: (B, S, di) post-conv activations -> dt, B_mat, C_mat (fp32)."""
    st = cfg.ssm_state
    dt_rank = cfg.resolved_dt_rank
    proj = reduce_partial(linear(xc, p["x_proj"])).float()
    dt, Bm, Cm = torch.split(proj, [dt_rank, st, st], dim=-1)
    dt = F.softplus(linear(dt, p["dt_proj"].float()) + p["dt_bias"].float())   # (B,S,di)
    return dt, Bm, Cm


def _discretize(p: Params, dt: torch.Tensor, Bm: torch.Tensor, xc: torch.Tensor):
    """Returns Abar (B,S,di,st) and Bx (B,S,di,st), fp32."""
    A = -torch.exp(p["A_log"].float())                                  # (di, st)
    Abar = torch.exp(dt[..., None] * A[None, None])                     # (B,S,di,st)
    Bx = (dt * xc.float())[..., None] * Bm[:, :, None, :]
    return Abar, Bx


def _scan_combine(a, b):
    a1, b1 = a
    a2, b2 = b
    return a2 * a1, a2 * b1 + b2


def _scan_loop(Abar: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """h_t += Abar_t * h_{t-1} for t = 1 .. S-1, in place on h; returns h."""
    for t in range(1, h.shape[1]):
        h[:, t].addcmul_(Abar[:, t], h[:, t - 1])
    return h


class _ScanFn(torch.autograd.Function):
    """The scan with a backward: the forward is the loop on a copy of Bx;
    the backward runs the recurrence in reverse time,
    g_t = dL/dh_t + Abar_{t+1} * g_{t+1}, dBx_t = g_t, dAbar_t = g_t * h_{t-1}
    (dAbar_0 = 0, since h_{-1} = 0)."""

    @staticmethod
    def forward(ctx, Abar, Bx):
        h = _scan_loop(Abar, Bx.clone())
        ctx.save_for_backward(Abar, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        Abar, h = ctx.saved_tensors
        g = dh.clone()
        for t in range(g.shape[1] - 2, -1, -1):
            g[:, t].addcmul_(Abar[:, t + 1], g[:, t + 1])
        dAbar = torch.zeros_like(Abar)
        torch.mul(g[:, 1:], h[:, :-1], out=dAbar[:, 1:])
        return dAbar, g


def _scan(Abar: torch.Tensor, Bx: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``_scan_combine`` over axis 1: h_t = Abar_t * h_{t-1}
    + Bx_t with h_{-1} = 0, as one in-place multiply-add per position.
    Without autograd (prefill, decode) it overwrites Bx and returns it; when
    a gradient is needed it goes through ``_ScanFn``, which leaves Bx as it
    is and has the reverse-time loop as its backward.

    At falcon-mamba-7b's width, (2, 1024, 8192, 16) fp32, this loop beats a
    log-step (Hillis-Steele) scan of ``_scan_combine`` on an H100 80GB HBM3
    at 700 W (``chip_smoke.py`` phase 6 times both; PERF.md): the loop is
    bound by the host's launches, the log-step scan by its ~6 GB a round of
    traffic over 10 rounds."""
    places = getattr(Abar, "placements", None)
    if places is not None:
        # DTensors: the recurrence is elementwise across batch and d_inner,
        # so each rank scans its own shards
        from repro_torch.launch import context
        from repro_torch.launch import sharding as shd
        mesh = context.current_mesh()
        spec = shd.spec_of(mesh, places, Abar.dim())
        return shd.on_shards(_scan, mesh, [spec, spec], (list(places),))(Abar, Bx)
    if torch.is_grad_enabled() and (Abar.requires_grad or Bx.requires_grad):
        return _ScanFn.apply(Abar, Bx)
    return _scan_loop(Abar, Bx)


def _conv_silu(cfg, p: Params, xi: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv1d of width W over the sequence, then SiLU, in
    fp32, cast back to xi's dtype. The full-sequence and the decode path both
    take it (the reference sums in the activations' dtype, in another order
    in each path), so a bf16 decode step continues a bf16 prefill exactly."""
    S = xi.shape[1]
    W = cfg.conv_width
    xpad = F.pad(xi, (0, 0, W - 1, 0)).float()
    xc = sum(xpad[:, i:i + S] * p["conv_w"][i].float() for i in range(W))
    return F.silu(xc + p["conv_b"].float()).to(xi.dtype)


def mamba_mixer(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mixer (train / prefill). x: (B, S, d) -> (B, S, d)."""
    xi, z = in_proj(x, p["in_proj"])                                    # (B,S,di)
    xc = _conv_silu(cfg, p, xi)
    dt, Bm, Cm = _ssm_params(cfg, p, xc)
    h = _scan(*_discretize(p, dt, Bm, xc))
    y = torch.einsum("bsnt,bst->bsn", h, Cm)
    y = y + p["D"].float() * xc.float()
    y = y * F.silu(z).float()
    return linear(y.to(x.dtype), p["out_proj"])


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None
                     ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner), dtype=dtype,
                            device=dev),
    }


def mamba_decode(cfg, p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step. x: (B, 1, d). Writes the new state into ``state``'s
    tensors in place (the reference returns new arrays) and returns them."""
    xi, z = in_proj(x, p["in_proj"])                                    # (B,1,di)
    window = torch.cat([state["conv"], xi.to(state["conv"].dtype)], dim=1)  # (B, W, di)
    xc = _conv_silu(cfg, p, window)[:, -1:]                            # (B,1,di)

    dt, Bm, Cm = _ssm_params(cfg, p, xc)
    Abar, Bx = _discretize(p, dt, Bm, xc)                              # (B,1,di,st)
    h = Abar[:, 0] * state["ssm"] + Bx[:, 0]                           # (B,di,st)
    y = torch.einsum("bnt,bt->bn", h, Cm[:, 0])                        # (B,di)
    y = y + p["D"].float() * xc[:, 0].float()
    y = y * F.silu(z[:, 0]).float()
    out = linear(y.to(x.dtype), p["out_proj"])[:, None]
    state["ssm"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return out, state
