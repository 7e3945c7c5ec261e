"""Samplers: DDIM (eps-prediction, UNet) and rectified-flow Euler (DiT).

Requests in one CSP batch sit at *different* step indices (paper Fig. 1);
all per-step coefficients are per-request vectors broadcast per patch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csp import CSP
from repro_torch.core.patched_ops import patch_request_index
from repro_torch.models import diffusion as dm


def ddim_schedule(total_steps: int, T: int = 1000):
    """(timesteps int64, alpha-bar float32): computed in float64 numpy, then
    cast, as the reference does."""
    betas = np.linspace(1e-4, 0.02, T, dtype=np.float64)
    ab = np.cumprod(1.0 - betas)
    ts = np.linspace(T - 1, 0, total_steps).round().astype(np.int64)
    return torch.as_tensor(ts), torch.as_tensor(ab[ts], dtype=torch.float32)


def sampler_step(cfg: dm.DiffusionConfig, params, csp: CSP,
                 patches: torch.Tensor, step_req: torch.Tensor, total_steps: int,
                 text: torch.Tensor, block_hook=None) -> torch.Tensor:
    """Advance every request one denoising step. step_req: (R,) int, the
    number of steps already taken (0 .. total_steps-1)."""
    dev = patches.device
    seg = patch_request_index(csp, dev)
    step_req = torch.as_tensor(step_req, device=dev).long()
    if cfg.kind == "dit":
        # rectified flow: t goes 1 -> 0; x_{t+dt} = x + (t_next - t) * v
        t_cur = 1.0 - step_req.float() / total_steps
        t_next = 1.0 - (step_req.float() + 1) / total_steps
        v = dm.denoise_patched(cfg, params, csp, patches, t_cur * 1000.0, text,
                               block_hook)
        dt = (t_next - t_cur)[seg][:, None, None, None]
        return patches + dt * v
    # DDIM (eta=0)
    ts, ab = ddim_schedule(total_steps)
    ts, ab = ts.to(dev), ab.to(dev)
    k = step_req
    ab_k = ab[k][seg][:, None, None, None]
    ab_next = torch.where(k + 1 < total_steps, ab[torch.clamp(k + 1, max=total_steps - 1)],
                          1.0)[seg][:, None, None, None]
    t_model = ts[k].float()
    eps = dm.denoise_patched(cfg, params, csp, patches, t_model, text, block_hook)
    x0 = (patches - torch.sqrt(1 - ab_k) * eps) / torch.sqrt(ab_k)
    return torch.sqrt(ab_next) * x0 + torch.sqrt(1 - ab_next) * eps
