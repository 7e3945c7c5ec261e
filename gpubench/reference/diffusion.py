"""Plain PyTorch reference of one request served alone, as a whole image:
the parts that the model kinds share, and ``sample``, which hands a request
to its configuration's kind (``reference/<kind>.py``).

Shared: the transformer block (GroupNorm, self-attention, cross-attention to
the text, feed-forward), the ResBlock, GroupNorm, the timestep embedding and
its MLP, and the VAE decoder (two 3x3 convolutions and an x8 pixel shuffle),
written from the block structure that the configuration files describe, on
NCHW images with plain ``torch`` operations: no patches, no halos, no
kernels, no batching.

``tf32=True`` computes every matrix product and convolution on operands
rounded to TensorFloat-32 (10 mantissa bits, to nearest even) with float32
accumulation, as the card's TF32 tensor cores do: the benchmark's control,
one precision below the float32 that the configurations state. On the card
it also lets cuBLAS and cuDNN use TF32; in float32 mode it forbids them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

from gpubench.reference import kind

GN_EPS = 1e-5
# rows of attention scores held at once: (heads, rows, keys) fp32 under 1 GiB
SCORE_ELEMENTS = 1 << 28


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TensorFloat-32 value (ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def precision(tf32: bool):
    """Sets the card's TF32 switches for the duration, then restores them."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Arith:
    """Matrix products and convolutions in float32 or TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return to_tf32(x) if self.tf32 else x.float()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)

    def conv(self, x: torch.Tensor, w_hwio: torch.Tensor, b=None, stride: int = 1,
             padding=1) -> torch.Tensor:
        """x (1, Cin, H, W); w (kh, kw, Cin, Cout) as the tree stores it."""
        y = F.conv2d(self._r(x), self._r(w_hwio.permute(3, 2, 0, 1)), stride=stride,
                     padding=padding)
        return y if b is None else y + b[None, :, None, None]


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(R,) -> (R, dim): cos then sin of t times 10000^(-i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm(x: torch.Tensor, gp: dict, groups: int) -> torch.Tensor:
    """GroupNorm over (channels of a group, H, W) of one image (1, C, H, W)."""
    return F.group_norm(x.float(), groups, gp["scale"].float(), gp["bias"].float(), GN_EPS)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (H*W, C)."""
    return x[0].flatten(1).t()


def image(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(H*W, C) -> (1, C, H, W)."""
    return t.t().reshape(1, -1, H, W)


def attention(ar: Arith, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of (H, Sq, D) over (H, Sk, D), in blocks of query rows."""
    nh, sq, d = q.shape
    rows = max(1, SCORE_ELEMENTS // (nh * k.shape[1]))
    out = []
    for r0 in range(0, sq, rows):
        s = ar.mm(q[:, r0:r0 + rows], k.transpose(1, 2)) * d ** -0.5
        out.append(ar.mm(torch.softmax(s, dim=-1), v))
    return torch.cat(out, dim=1)


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(S, C) -> (n, S, C // n)."""
    return t.reshape(t.shape[0], n, -1).transpose(0, 1)


def attn_block(ar: Arith, cfg: dict, p: dict, x: torch.Tensor, kv_text) -> torch.Tensor:
    """GroupNorm, self-attention over the whole image, cross-attention of every
    pixel to the text tokens, GroupNorm, tanh-GELU feed-forward; residuals
    around the three from the normalised input. ``kv_text``: the text's
    (keys, values), projected once per request."""
    _, C, H, W = x.shape
    n = cfg["n_heads"]
    h = tokens(group_norm(x, p["gn"], cfg["groups"]))                # (S, C)
    q, k, v = (_heads(ar.mm(h, p[w]), n) for w in ("wq", "wk", "wv"))
    h = h + ar.mm(attention(ar, q, k, v).transpose(0, 1).reshape(-1, C), p["wo"])
    tk, tv = kv_text
    xq = _heads(ar.mm(h, p["xq"]), n)
    h = h + ar.mm(attention(ar, xq, _heads(tk, n), _heads(tv, n)).transpose(0, 1)
                  .reshape(-1, C), p["xo"])
    hn = tokens(group_norm(image(h, H, W), p["gn_ff"], cfg["groups"]))
    ff = ar.mm(F.gelu(ar.mm(hn, p["ff1"]), approximate="tanh"), p["ff2"])
    return image(h + ff, H, W)


def text_kv(ar: Arith, p: dict, text: torch.Tensor):
    return ar.mm(text, p["xk"]), ar.mm(text, p["xv"])


def res_block(ar: Arith, cfg: dict, p: dict, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    h = ar.conv(F.silu(group_norm(x, p["gn1"], cfg["groups"])), p["conv1"]["w"], p["conv1"]["b"])
    scale, shift = torch.chunk(ar.mm(F.silu(temb), p["temb_w"]) + p["temb_b"], 2, dim=-1)
    h = h * (1 + scale[0, :, None, None]) + shift[0, :, None, None]
    h = ar.conv(F.silu(group_norm(h, p["gn2"], cfg["groups"])), p["conv2"]["w"], p["conv2"]["b"])
    if "skip" in p:
        x = ar.conv(x, p["skip"]["w"], p["skip"]["b"], padding=0)
    return x + h


def temb_mlp(ar: Arith, cfg: dict, P: dict, t: torch.Tensor) -> torch.Tensor:
    e = timestep_embedding(t.reshape(1), cfg["t_dim"])
    e = F.silu(ar.mm(e, P["temb_w1"]) + P["temb_b1"])
    return ar.mm(e, P["temb_w2"]) + P["temb_b2"]                     # (1, t_dim)


def sample(cfg: dict, P: dict, latent: torch.Tensor, cond: Dict[str, torch.Tensor],
           steps: int, tf32: bool = False) -> torch.Tensor:
    """The request's final latent (H, W, C0) from its initial noise latent
    (H, W, C0) and its conditioning tensors by name, after ``steps`` steps of
    its configuration's kind."""
    return kind(cfg).sample(cfg, P, latent, cond, steps, tf32)


def vae_decode(vae: dict, z: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Latent (h, w, C0) -> image (8h, 8w, 3) in [-1, 1]: conv, SiLU, conv,
    then each pixel's 192 channels laid out as its 8 x 8 block of RGB."""
    ar = Arith(tf32)
    with precision(tf32), torch.no_grad():
        x = z.float().permute(2, 0, 1)[None]
        h = ar.conv(F.silu(ar.conv(x, vae["conv1"]["w"], vae["conv1"]["b"])),
                    vae["conv2"]["w"], vae["conv2"]["b"])[0]                  # (192, h, w)
        hh, ww = h.shape[1:]
        img = h.reshape(8, 8, 3, hh, ww).permute(3, 0, 4, 1, 2).reshape(8 * hh, 8 * ww, 3)
        return torch.tanh(img)
