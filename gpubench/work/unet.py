"""Model work of one UNet denoising step of one request at latent (H, W),
as a whole image: the FLOPs of every matrix product and convolution (2 a
multiply-add), the text's keys and values projected once for the request.
Normalisations, activations and softmax are left out (a few per cent)."""
from __future__ import annotations


def _conv(h: int, w: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * k * k * cin * cout


def _res(cfg: dict, h: int, w: int, cin: int, cout: int) -> float:
    f = _conv(h, w, 3, cin, cout) + 2.0 * cfg["t_dim"] * 2 * cout + _conv(h, w, 3, cout, cout)
    return f + (_conv(h, w, 1, cin, cout) if cin != cout else 0.0)


def attn_block(cfg: dict, S: int, c: int) -> float:
    """Self-attention (q, k, v, o projections; scores and values over S keys),
    cross-attention to n_text tokens, and a 4x feed-forward, over S tokens."""
    T, dt = cfg["n_text"], cfg["d_text"]
    self_attn = 4 * 2.0 * S * c * c + 4.0 * S * S * c
    cross = 2 * 2.0 * S * c * c + 2 * 2.0 * T * dt * c + 4.0 * S * T * c
    return self_attn + cross + 2 * 2.0 * S * c * 4 * c


def flops(cfg: dict, H: int, W: int) -> float:
    t, w0, c0, L = cfg["t_dim"], cfg["width"], cfg["latent_channels"], cfg["levels"]
    chans = [w0 * 2 ** lvl for lvl in range(L)]
    f = 2 * 2.0 * t * t + _conv(H, W, 3, c0, w0)
    for lvl in range(L):
        h, w = H >> lvl, W >> lvl
        for _ in range(cfg["blocks_per_level"]):
            f += _res(cfg, h, w, chans[lvl], chans[lvl])
            if lvl in cfg["attn_levels"]:
                f += attn_block(cfg, h * w, chans[lvl])
        if lvl + 1 < L:
            f += _conv(h // 2, w // 2, 3, chans[lvl], chans[lvl + 1])
    h, w, cm = H >> (L - 1), W >> (L - 1), chans[-1]
    f += 2 * _res(cfg, h, w, cm, cm) + attn_block(cfg, h * w, cm)
    for lvl in reversed(range(L)):
        h, w = H >> lvl, W >> lvl
        if lvl + 1 < L:
            f += _conv(h, w, 3, chans[lvl + 1], chans[lvl])
        for i in range(cfg["blocks_per_level"]):
            f += _res(cfg, h, w, 2 * chans[lvl] if i == 0 else chans[lvl], chans[lvl])
            if lvl in cfg["attn_levels"]:
                f += attn_block(cfg, h * w, chans[lvl])
    return f + _conv(H, W, 3, w0, c0)
