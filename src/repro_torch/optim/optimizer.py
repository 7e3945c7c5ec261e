"""AdamW with global-norm clipping, and Adafactor, over nested dicts of
tensors: the port of the reference's ``repro/optim/optimizer.py``.

Moments are stored in ``opt_state_dtype`` and computed in fp32; ``step`` is
an int32 scalar tensor on the params' device, and the bias correction
``b ** step`` is taken in fp32 there, so an update never waits for the host.
Each update returns new trees, as the reference does: nothing it was given is
written, so a checkpoint snapshot of an earlier step never sees a later one.
Leaves are visited in sorted key order, the order of ``jax.tree_util``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map, tree_unzip


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _step_zero(params) -> torch.Tensor:
    """The int32 step counter, on the params' device."""
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def adamw_init(params, dtype: str = "float32") -> Dict[str, Any]:
    dt = _dtype(dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step_zero(params)}


def adamw_update(params, grads, opt, *, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0) -> Tuple[Any, Dict[str, Any]]:
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    t = step.float()
    c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
    c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m32.to(m.dtype), v32.to(v.dtype)

    new_p, new_m, new_v = tree_unzip(tree_map(upd, params, grads, opt["m"], opt["v"]), 3)
    return new_p, {"m": new_m, "v": new_v, "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, beta1=0) — T5X-style, for the 671B
# config where even bf16 AdamW moments leave no activation headroom.
# ---------------------------------------------------------------------------

def adafactor_init(params, dtype: str = "float32"):
    dt = _dtype(dtype)

    def vr(p):
        return torch.zeros(p.shape[:-1] if p.dim() >= 2 else p.shape, dtype=dt,
                           device=p.device)

    def vc(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else ()
        return torch.zeros(shape, dtype=dt, device=p.device)

    return {"v_row": tree_map(vr, params), "v_col": tree_map(vc, params),
            "step": _step_zero(params)}


def adafactor_update(params, grads, opt, *, lr: float = 1e-3,
                     beta2: float = 0.999, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    step = opt["step"] + 1

    def upd(p, g, vr, vc):
        g32 = g.float()
        g2 = torch.square(g32) + eps
        if p.dim() >= 2:
            vr32 = beta2 * vr.float() + (1 - beta2) * torch.mean(g2, dim=-1)
            vc32 = beta2 * vc.float() + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = (vr32[..., None] * vc32[..., None, :]
                     / torch.clamp(torch.mean(vr32, dim=-1, keepdim=True)[..., None], min=eps))
            u = g32 * torch.rsqrt(torch.clamp(denom, min=eps))
        else:
            vr32 = beta2 * vr.float() + (1 - beta2) * g2
            vc32 = vc.float()
            u = g32 * torch.rsqrt(torch.clamp(vr32, min=eps))
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        new_p = (p.float() - lr * (u + weight_decay * p.float())).to(p.dtype)
        return new_p, vr32.to(vr.dtype), vc32.to(vc.dtype)

    new_p, new_vr, new_vc = tree_unzip(
        tree_map(upd, params, grads, opt["v_row"], opt["v_col"]), 3)
    return new_p, {"v_row": new_vr, "v_col": new_vc, "step": step}
