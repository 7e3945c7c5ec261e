"""The parameter trees of the two model kinds and of the VAE decoder, as
(path, shape, init, scale) rows: the tree paths, shapes and initial scales
of the program's models, written out from their published block structure.
``gpubench.inputs`` draws the weights from these rows; a test holds them to
the program's own trees."""
from __future__ import annotations

import math
from typing import List, Tuple

Spec = Tuple[str, Tuple[int, ...], str, float]


def _normal(path: str, shape, scale: float | None = None) -> Spec:
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[-2] if len(shape) >= 2 else shape[-1], 1))
    return (path, tuple(shape), "normal", scale)


def _zeros(path: str, shape) -> Spec:
    return (path, tuple(shape), "zeros", 0.0)


def _conv(path: str, k: int, cin: int, cout: int) -> List[Spec]:
    return [_normal(f"{path}/w", (k, k, cin, cout), 1.0 / math.sqrt(k * k * cin)),
            _zeros(f"{path}/b", (cout,))]


def _gn(path: str, c: int) -> List[Spec]:
    return [(f"{path}/scale", (c,), "ones", 1.0), _zeros(f"{path}/bias", (c,))]


def _res(path: str, cin: int, cout: int, t_dim: int) -> List[Spec]:
    rows = _gn(f"{path}/gn1", cin) + _conv(f"{path}/conv1", 3, cin, cout)
    rows += [_normal(f"{path}/temb_w", (t_dim, 2 * cout)), _zeros(f"{path}/temb_b", (2 * cout,))]
    rows += _gn(f"{path}/gn2", cout) + _conv(f"{path}/conv2", 3, cout, cout)
    if cin != cout:
        rows += _conv(f"{path}/skip", 1, cin, cout)
    return rows


def _attn(path: str, c: int, d_text: int) -> List[Spec]:
    rows = _gn(f"{path}/gn", c)
    rows += [_normal(f"{path}/{n}", (c, c)) for n in ("wq", "wk", "wv", "wo")]
    rows += [_normal(f"{path}/xq", (c, c)), _normal(f"{path}/xk", (d_text, c)),
             _normal(f"{path}/xv", (d_text, c)), _normal(f"{path}/xo", (c, c))]
    rows += _gn(f"{path}/gn_ff", c)
    rows += [_normal(f"{path}/ff1", (c, 4 * c)), _normal(f"{path}/ff2", (4 * c, c))]
    return rows


def model_specs(cfg: dict) -> List[Spec]:
    """Rows of the denoiser of ``cfg`` (a configuration file's fields)."""
    t, c0, w, dt = cfg["t_dim"], cfg["latent_channels"], cfg["width"], cfg["d_text"]
    rows = [_normal("temb_w1", (t, t)), _zeros("temb_b1", (t,)),
            _normal("temb_w2", (t, t)), _zeros("temb_b2", (t,))]
    if cfg["kind"] == "dit":
        rows += [_normal("tok_in", (c0, w)), _zeros("tok_in_b", (w,)),
                 _normal("adaln_w", (t, 3 * w), 0.02), _zeros("adaln_b", (3 * w,))]
        for i in range(cfg["dit_depth"]):
            rows += _attn(f"blk{i}", w, dt)
        rows += _gn("out_norm", w)
        rows += [_normal("tok_out", (w, c0), 0.02), _zeros("tok_out_b", (c0,))]
        return rows
    levels = cfg["levels"]
    chans = [w * 2 ** lvl for lvl in range(levels)]
    rows += _conv("stem", 3, c0, w)
    for lvl in range(levels):
        for i in range(cfg["blocks_per_level"]):
            rows += _res(f"down{lvl}_res{i}", chans[lvl], chans[lvl], t)
            if lvl in cfg["attn_levels"]:
                rows += _attn(f"down{lvl}_attn{i}", chans[lvl], dt)
        if lvl + 1 < levels:
            rows += _conv(f"down{lvl}_ds", 3, chans[lvl], chans[lvl + 1])
    cm = chans[-1]
    rows += _res("mid_res1", cm, cm, t) + _attn("mid_attn", cm, dt) + _res("mid_res2", cm, cm, t)
    for lvl in reversed(range(levels)):
        if lvl + 1 < levels:
            rows += _conv(f"up{lvl}_us", 3, chans[lvl + 1], chans[lvl])
        for i in range(cfg["blocks_per_level"]):
            rows += _res(f"up{lvl}_res{i}", 2 * chans[lvl] if i == 0 else chans[lvl],
                         chans[lvl], t)
            if lvl in cfg["attn_levels"]:
                rows += _attn(f"up{lvl}_attn{i}", chans[lvl], dt)
    rows += _gn("out_norm", w) + _conv("out_conv", 3, w, c0)
    return rows


def vae_specs(cfg: dict) -> List[Spec]:
    """Rows of the pixel-shuffle VAE decoder (x8, latent -> RGB)."""
    c0, w = cfg["latent_channels"], cfg["vae_width"]
    return [_normal("conv1/w", (3, 3, c0, w), 0.1), _zeros("conv1/b", (w,)),
            _normal("conv2/w", (3, 3, w, 3 * 64), 0.1), _zeros("conv2/b", (3 * 64,))]
