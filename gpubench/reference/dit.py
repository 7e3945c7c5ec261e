"""The DiT kind: transformer blocks over 1x1 latent-pixel tokens with one
adaLN (scale, shift, gate) shared by all blocks, sampled by rectified-flow
Euler steps. Its parameter rows, its per-request conditioning, its forward
pass and its sampler, in plain PyTorch."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from gpubench.reference.diffusion import (Arith, attn_block, group_norm, image, precision,
                                          temb_mlp, text_kv, tokens)
from gpubench.reference.params import Spec, attn, gn, normal, temb_specs, zeros

TINY = dict(name="tiny-dit", kind="dit", latent_channels=4, width=24, dit_depth=2, n_heads=3,
            groups=4, d_text=12, n_text=5, t_dim=16, exact_stats=True, use_kernels=True,
            dtype="float32", vae_width=8, precision="float32, TF32 off")


def specs(cfg: dict) -> List[Spec]:
    t, c0, w, dt = cfg["t_dim"], cfg["latent_channels"], cfg["width"], cfg["d_text"]
    rows = temb_specs(t)
    rows += [normal("tok_in", (c0, w)), zeros("tok_in_b", (w,)),
             normal("adaln_w", (t, 3 * w), 0.02), zeros("adaln_b", (3 * w,))]
    for i in range(cfg["dit_depth"]):
        rows += attn(f"blk{i}", w, dt)
    rows += gn("out_norm", w)
    rows += [normal("tok_out", (w, c0), 0.02), zeros("tok_out_b", (c0,))]
    return rows


def conditioning(cfg: dict) -> list:
    """The text embedding, normal x 0.3: the scale of the program's
    prompt-embedding stand-in."""
    return [("text", (cfg["n_text"], cfg["d_text"]), 0.3)]


def forward(ar: Arith, cfg: dict, P: dict, x: torch.Tensor, t: torch.Tensor,
            text: torch.Tensor) -> torch.Tensor:
    """Velocity of one image x (1, C0, H, W) at time t (in [0, 1000])."""
    _, _, H, W = x.shape
    temb = temb_mlp(ar, cfg, P, t)
    sc, sh, gate = torch.chunk(ar.mm(F.silu(temb), P["adaln_w"]) + P["adaln_b"], 3, dim=-1)
    h = ar.mm(tokens(x), P["tok_in"]) + P["tok_in_b"]                # (S, width)
    for i in range(cfg["dit_depth"]):
        p = P[f"blk{i}"]
        y = tokens(attn_block(ar, cfg, p, image(h * (1 + sc) + sh, H, W),
                              text_kv(ar, p, text)))
        h = h + gate * (y - h)
    h = tokens(group_norm(image(h, H, W), P["out_norm"], cfg["groups"]))
    return image(ar.mm(h, P["tok_out"]) + P["tok_out_b"], H, W)


def sample(cfg: dict, P: dict, latent: torch.Tensor, cond: Dict[str, torch.Tensor], steps: int,
           tf32: bool = False) -> torch.Tensor:
    """Euler steps of the velocity from t = 1 down to t = 0."""
    ar = Arith(tf32)
    dev = latent.device
    x = latent.float().permute(2, 0, 1)[None]
    with precision(tf32), torch.no_grad():
        for k in range(steps):
            t_cur = 1.0 - torch.tensor(k, dtype=torch.float32, device=dev) / steps
            t_next = 1.0 - torch.tensor(k + 1, dtype=torch.float32, device=dev) / steps
            x = x + (t_next - t_cur) * forward(ar, cfg, P, x, t_cur * 1000.0, cond["text"])
    return x[0].permute(1, 2, 0)
