"""The VAE decoder's parameter rows, the row helpers each model kind's
``specs`` builds its denoiser from, and ``model_specs``, which asks the
configuration's kind: (path, shape, init, scale) rows, the tree paths, shapes
and initial scales of the program's models, written out from their published
block structure. ``gpubench.inputs`` draws the weights from these rows; a test
holds them to the program's own trees."""
from __future__ import annotations

import math
from typing import List, Tuple

from gpubench.reference import kind

Spec = Tuple[str, Tuple[int, ...], str, float]


def normal(path: str, shape, scale: float | None = None) -> Spec:
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[-2] if len(shape) >= 2 else shape[-1], 1))
    return (path, tuple(shape), "normal", scale)


def zeros(path: str, shape) -> Spec:
    return (path, tuple(shape), "zeros", 0.0)


def conv(path: str, k: int, cin: int, cout: int) -> List[Spec]:
    return [normal(f"{path}/w", (k, k, cin, cout), 1.0 / math.sqrt(k * k * cin)),
            zeros(f"{path}/b", (cout,))]


def gn(path: str, c: int) -> List[Spec]:
    return [(f"{path}/scale", (c,), "ones", 1.0), zeros(f"{path}/bias", (c,))]


def res(path: str, cin: int, cout: int, t_dim: int) -> List[Spec]:
    rows = gn(f"{path}/gn1", cin) + conv(f"{path}/conv1", 3, cin, cout)
    rows += [normal(f"{path}/temb_w", (t_dim, 2 * cout)), zeros(f"{path}/temb_b", (2 * cout,))]
    rows += gn(f"{path}/gn2", cout) + conv(f"{path}/conv2", 3, cout, cout)
    if cin != cout:
        rows += conv(f"{path}/skip", 1, cin, cout)
    return rows


def attn(path: str, c: int, d_text: int) -> List[Spec]:
    rows = gn(f"{path}/gn", c)
    rows += [normal(f"{path}/{n}", (c, c)) for n in ("wq", "wk", "wv", "wo")]
    rows += [normal(f"{path}/xq", (c, c)), normal(f"{path}/xk", (d_text, c)),
             normal(f"{path}/xv", (d_text, c)), normal(f"{path}/xo", (c, c))]
    rows += gn(f"{path}/gn_ff", c)
    rows += [normal(f"{path}/ff1", (c, 4 * c)), normal(f"{path}/ff2", (4 * c, c))]
    return rows


def temb_specs(t: int) -> List[Spec]:
    """The timestep MLP (t_dim -> t_dim -> t_dim) every kind starts with."""
    return [normal("temb_w1", (t, t)), zeros("temb_b1", (t,)),
            normal("temb_w2", (t, t)), zeros("temb_b2", (t,))]


def model_specs(cfg: dict) -> List[Spec]:
    """Rows of the denoiser of ``cfg`` (a configuration file's fields)."""
    return kind(cfg).specs(cfg)


def vae_specs(cfg: dict) -> List[Spec]:
    """Rows of the pixel-shuffle VAE decoder (x8, latent -> RGB)."""
    c0, w = cfg["latent_channels"], cfg["vae_width"]
    return [normal("conv1/w", (3, 3, c0, w), 0.1), zeros("conv1/b", (w,)),
            normal("conv2/w", (3, 3, w, 3 * 64), 0.1), zeros("conv2/b", (3 * 64,))]
