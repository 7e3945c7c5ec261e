"""Plain PyTorch versions of the CUDA kernels: the CPU path and the oracle
the kernels are held against."""
from __future__ import annotations

import torch

from repro_torch.core.stitcher import gather_halo


def ref_groupnorm_stitch(patches, neighbors, mean_c, rstd_c, scale, bias,
                         halo: int = 1):
    """Normalize (per-patch per-channel stats) then halo-gather."""
    x = patches.float()
    normed = ((x - mean_c[:, None, None, :]) * rstd_c[:, None, None, :]
              * scale.float() + bias.float()).to(patches.dtype)
    return gather_halo(normed, neighbors, halo)


def ref_attention(q, k, v, scale=None):
    """q,k,v: (B, S, H, D) full bidirectional attention, fp32 softmax."""
    D = q.shape[-1]
    sc = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
