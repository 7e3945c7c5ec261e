"""Model work of one DiT denoising step of one request at latent (H, W),
every latent pixel a token, as a whole image: the FLOPs of every matrix
product (2 a multiply-add), the text's keys and values projected once for
the request. Normalisations, activations and softmax are left out."""
from __future__ import annotations

from gpubench.work.unet import attn_block


def flops(cfg: dict, H: int, W: int) -> float:
    t, w, c0, S = cfg["t_dim"], cfg["width"], cfg["latent_channels"], H * W
    f = 2 * 2.0 * t * t + 2.0 * t * 3 * w + 2 * 2.0 * S * c0 * w
    return f + cfg["dit_depth"] * attn_block(cfg, S, w)
