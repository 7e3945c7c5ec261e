"""Patch-tailored diffusion operators (paper §4.2).

Pixel-wise operators (Linear / FeedForward / Cross-Attention / 1x1 conv) run
on the (P, p, p, C) patch batch unchanged. Two operators need cross-patch
context:

- Convolution: halo exchange via the stitcher, then VALID conv;
- Self-Attention: CSP resolution groups reassemble full images (pure
  reshape), run batched attention per group, split back.

GroupNorm comes in two modes:
- exact (default): per-request statistics via segment reduction over that
  request's patches — patched execution equals unpatched execution;
- per-patch (paper-faithful ``exact=False``): each patch normalized with its
  own stats, reproducing the paper's approximation.

Every product goes through ``matmul``, which promotes mixed operands as
``jnp`` does (fp32 with bf16 -> fp32), and under ``use_kernels`` takes a
product of CUDA tensors to the fp32 GEMM kernel's route rule; convolutions,
like ``lax.conv_general_dilated``, refuse mixed dtypes.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.csp import CSP
from repro_torch.core.csp_device import csp_device
from repro_torch.core.patching import group_images, ungroup_images
from repro_torch.core.stitcher import gather_halo
from repro_torch.kernels.fp32_gemm import weight_matmul


def patch_request_index(csp: CSP, device: torch.device) -> torch.Tensor:
    """(P,) int64 request index of every patch, on ``device`` (cached)."""
    return csp_device(csp, device).patch_req


def matmul(a: torch.Tensor, b: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
    """``a @ b`` with jnp's type promotion: the narrower operand is cast to
    the common dtype (fp32 with bf16 -> fp32), where ``torch.matmul``
    refuses mixed dtypes. Same-dtype operands are not copied, so their
    product is bit for bit ``a @ b``. With ``use_kernels`` and ``a`` on
    CUDA, ``b`` is a weight and the product goes to
    ``fp32_gemm.weight_matmul``: the fp32 GEMM kernel where its route rule
    takes the dtype and shape, else ``a @ b``."""
    if use_kernels and a.device.type == "cuda":
        return weight_matmul(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """NHWC input, HWIO weight -> NHWC output (the reference's conv layout).
    The permutes are views: the input reaches the conv as channels_last."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------

def csp_group_stats(csp: CSP, patches: torch.Tensor, groups: int):
    """Exact per-(request, channel-group) mean/var across all its patches."""
    P, p, _, C = patches.shape
    G = groups
    x = patches.float().reshape(P, p * p, G, C // G)
    meta = csp_device(csp, patches.device)
    zeros = torch.zeros(csp.n_requests, G, device=patches.device)
    s1 = zeros.index_add(0, meta.patch_req, x.sum(dim=(1, 3)))      # (R, G)
    s2 = zeros.index_add(0, meta.patch_req, (x * x).sum(dim=(1, 3)))
    # a request's pixels: its patches times p*p (= H*W at this level)
    cnt = ((meta.counts * (p * p)).float() * (C // G))[:, None]     # (R, 1)
    mean = s1 / cnt
    var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
    return mean, var                                                # (R, G) each


def patched_groupnorm(csp: CSP, patches: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int, eps: float = 1e-5,
                      exact: bool = True) -> torch.Tensor:
    P, p, _, C = patches.shape
    G = groups
    dt = patches.dtype
    x = patches.float().reshape(P, p, p, G, C // G)
    if exact:
        mean, var = csp_group_stats(csp, patches, groups)          # (R, G)
        seg = patch_request_index(csp, patches.device)
        mu = mean[seg][:, None, None, :, None]
        rs = torch.rsqrt(var + eps)[seg][:, None, None, :, None]
    else:  # paper-faithful per-patch statistics; population variance as jnp.var
        mu = x.mean(dim=(1, 2, 4), keepdim=True)
        rs = torch.rsqrt(x.var(dim=(1, 2, 4), keepdim=True, correction=0) + eps)
    out = ((x - mu) * rs).reshape(P, p, p, C) * scale + bias
    return out.to(dt)


# ---------------------------------------------------------------------------
# Convolution with halo
# ---------------------------------------------------------------------------

def patched_conv(csp: CSP, patches: Optional[torch.Tensor], w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 haloed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 (or kxk, k odd) conv over patches with neighbor halos.

    w: (kh, kw, Cin, Cout). Pass ``haloed`` to reuse a pre-stitched tensor
    (e.g. the fused groupnorm+stitch kernel output).
    """
    kh, kw = w.shape[0], w.shape[1]
    if kh == 1 and kw == 1:
        out = matmul(patches, w[0, 0])
        return out + b if b is not None else out
    halo = kh // 2
    x = haloed if haloed is not None else gather_halo(
        patches, csp_device(csp, patches.device).neighbors, halo)
    out = conv_nhwc(x, w)
    return out + b if b is not None else out


# ---------------------------------------------------------------------------
# Resolution-grouped self-attention
# ---------------------------------------------------------------------------

def per_image_apply(csp: CSP, patches: torch.Tensor,
                    fn: Callable[[torch.Tensor, int], torch.Tensor]) -> torch.Tensor:
    """Apply fn to each resolution group's image batch (n_g, H, W, C).

    fn(imgs, group_index) -> imgs."""
    blocks = []
    for g in range(csp.n_groups):
        imgs = group_images(csp, patches, g)
        blocks.append(ungroup_images(csp, fn(imgs, g), g))
    return torch.cat(blocks, dim=0)


def grouped_self_attention(csp: CSP, patches: torch.Tensor, wq, wk, wv, wo,
                           n_heads: int) -> torch.Tensor:
    """Image-level self-attention on CSP groups (paper Fig. 9a): rebuild the
    full images, group requests by resolution, batch the attention."""
    C = patches.shape[-1]
    hd = C // n_heads

    def attn(imgs, _):
        n, H, W, _ = imgs.shape
        t = imgs.reshape(n, H * W, C)
        q = matmul(t, wq).reshape(n, H * W, n_heads, hd)
        k = matmul(t, wk).reshape(n, H * W, n_heads, hd)
        v = matmul(t, wv).reshape(n, H * W, n_heads, hd)
        s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * hd ** -0.5
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("nhqk,nkhd->nqhd", pr, v.float())
        o = o.reshape(n, H * W, C).to(t.dtype)
        o = matmul(o, wo)
        return o.reshape(n, H, W, C)

    return per_image_apply(csp, patches, attn)
