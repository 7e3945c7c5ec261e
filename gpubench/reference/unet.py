"""The UNet kind: ResBlocks and transformer blocks over levels that halve the
image, skips from the way down to the way up, sampled by DDIM with eta = 0.
Its parameter rows, its per-request conditioning, its forward pass and its
sampler, in plain PyTorch."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.diffusion import (Arith, attn_block, group_norm, precision, res_block,
                                          temb_mlp, text_kv)
from gpubench.reference.params import Spec, attn, conv, gn, res, temb_specs

TINY = dict(name="tiny-unet", kind="unet", latent_channels=4, width=16, levels=2,
            blocks_per_level=1, attn_levels=[0, 1], n_heads=2, groups=4, d_text=8, n_text=4,
            t_dim=16, exact_stats=True, use_kernels=True, dtype="float32", vae_width=8,
            precision="float32, TF32 off")


def specs(cfg: dict) -> List[Spec]:
    t, c0, w, dt = cfg["t_dim"], cfg["latent_channels"], cfg["width"], cfg["d_text"]
    levels = cfg["levels"]
    chans = [w * 2 ** lvl for lvl in range(levels)]
    rows = temb_specs(t) + conv("stem", 3, c0, w)
    for lvl in range(levels):
        for i in range(cfg["blocks_per_level"]):
            rows += res(f"down{lvl}_res{i}", chans[lvl], chans[lvl], t)
            if lvl in cfg["attn_levels"]:
                rows += attn(f"down{lvl}_attn{i}", chans[lvl], dt)
        if lvl + 1 < levels:
            rows += conv(f"down{lvl}_ds", 3, chans[lvl], chans[lvl + 1])
    cm = chans[-1]
    rows += res("mid_res1", cm, cm, t) + attn("mid_attn", cm, dt) + res("mid_res2", cm, cm, t)
    for lvl in reversed(range(levels)):
        if lvl + 1 < levels:
            rows += conv(f"up{lvl}_us", 3, chans[lvl + 1], chans[lvl])
        for i in range(cfg["blocks_per_level"]):
            rows += res(f"up{lvl}_res{i}", 2 * chans[lvl] if i == 0 else chans[lvl],
                        chans[lvl], t)
            if lvl in cfg["attn_levels"]:
                rows += attn(f"up{lvl}_attn{i}", chans[lvl], dt)
    rows += gn("out_norm", w) + conv("out_conv", 3, w, c0)
    return rows


def conditioning(cfg: dict) -> list:
    """The text embedding, normal x 0.3: the scale of the program's
    prompt-embedding stand-in."""
    return [("text", (cfg["n_text"], cfg["d_text"]), 0.3)]


def forward(ar: Arith, cfg: dict, P: dict, x: torch.Tensor, t: torch.Tensor,
            text: torch.Tensor) -> torch.Tensor:
    """eps of one image x (1, C0, H, W) at timestep t."""
    temb = temb_mlp(ar, cfg, P, t)
    levels, attn_levels = cfg["levels"], cfg["attn_levels"]

    def transformer(name, h):
        return attn_block(ar, cfg, P[name], h, text_kv(ar, P[name], text))

    x = ar.conv(x, P["stem"]["w"], P["stem"]["b"])
    skips = []
    for lvl in range(levels):
        for i in range(cfg["blocks_per_level"]):
            x = res_block(ar, cfg, P[f"down{lvl}_res{i}"], x, temb)
            if lvl in attn_levels:
                x = transformer(f"down{lvl}_attn{i}", x)
        skips.append(x)
        if lvl + 1 < levels:
            # stride-2 SAME: the even side pads only right and bottom
            x = ar.conv(F.pad(x, (0, 1, 0, 1)), P[f"down{lvl}_ds"]["w"],
                        P[f"down{lvl}_ds"]["b"], stride=2, padding=0)
    x = res_block(ar, cfg, P["mid_res1"], x, temb)
    x = transformer("mid_attn", x)
    x = res_block(ar, cfg, P["mid_res2"], x, temb)
    for lvl in reversed(range(levels)):
        if lvl + 1 < levels:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = ar.conv(x, P[f"up{lvl}_us"]["w"], P[f"up{lvl}_us"]["b"])
        for i in range(cfg["blocks_per_level"]):
            if i == 0:
                x = torch.cat([x, skips[lvl]], dim=1)
            x = res_block(ar, cfg, P[f"up{lvl}_res{i}"], x, temb)
            if lvl in attn_levels:
                x = transformer(f"up{lvl}_attn{i}", x)
    h = F.silu(group_norm(x, P["out_norm"], cfg["groups"]))
    return ar.conv(h, P["out_conv"]["w"], P["out_conv"]["b"])


def ddim_schedule(steps: int, T: int = 1000):
    """(timesteps, alpha-bar at them as float32): linear betas 1e-4..0.02."""
    betas = np.linspace(1e-4, 0.02, T, dtype=np.float64)
    ab = np.cumprod(1.0 - betas)
    ts = np.linspace(T - 1, 0, steps).round().astype(np.int64)
    return ts, ab[ts].astype(np.float32)


def sample(cfg: dict, P: dict, latent: torch.Tensor, cond: Dict[str, torch.Tensor], steps: int,
           tf32: bool = False) -> torch.Tensor:
    """DDIM, eta = 0, over ``steps`` timesteps from 999 down to 0."""
    ar = Arith(tf32)
    dev = latent.device
    x = latent.float().permute(2, 0, 1)[None]
    with precision(tf32), torch.no_grad():
        ts, ab = ddim_schedule(steps)
        for k in range(steps):
            a = torch.tensor(ab[k], device=dev)
            a_next = torch.tensor(ab[k + 1] if k + 1 < steps else 1.0,
                                  dtype=torch.float32, device=dev)
            eps = forward(ar, cfg, P, x, torch.tensor(float(ts[k]), device=dev), cond["text"])
            x0 = (x - torch.sqrt(1 - a) * eps) / torch.sqrt(a)
            x = torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * eps
    return x[0].permute(1, 2, 0)
