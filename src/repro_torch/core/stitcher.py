"""Patch Edge Stitcher — halo exchange for cross-patch operators (paper §4.3).

Plain PyTorch version. The fused CUDA kernel
(``repro_torch.kernels.groupnorm_stitch``) does this halo movement inside the
GroupNorm pass; this module is its plain version.

Layout: patches (P, p, p, C) NHWC; neighbors (P, 8) with slot order
N, S, W, E, NW, NE, SW, SE (-1 = absent -> zero padding, paper §4.2).
"""
from __future__ import annotations

import torch


def _neighbor_index(neighbors, device: torch.device) -> torch.Tensor:
    """(P, 8) numpy array or tensor -> int64 tensor on ``device``. The model
    passes the CSP's cached device copy (``core.csp_device``), which comes
    back as it is, with no copy; a numpy array is copied on every call."""
    return torch.as_tensor(neighbors, device=device).long()


def gather_halo(patches: torch.Tensor, neighbors, halo: int = 1) -> torch.Tensor:
    """(P, p, p, C) -> (P, p+2h, p+2h, C) with edges pulled from neighbors.

    A single batched gather per direction: take(neighbor_idx) then slice the
    facing edge strip. Absent neighbors (-1) contribute zeros.
    """
    P, p, _, C = patches.shape
    h = halo
    nb = _neighbor_index(neighbors, patches.device)
    safe = nb.clamp(min=0)
    present = (nb >= 0).to(patches.dtype)[:, :, None, None, None]

    def take(slot):
        return patches[safe[:, slot]] * present[:, slot]

    north = take(0)[:, p - h:, :, :]         # bottom strip of N neighbor
    south = take(1)[:, :h, :, :]
    west = take(2)[:, :, p - h:, :]
    east = take(3)[:, :, :h, :]
    nw = take(4)[:, p - h:, p - h:, :]
    ne = take(5)[:, p - h:, :h, :]
    sw = take(6)[:, :h, p - h:, :]
    se = take(7)[:, :h, :h, :]

    top = torch.cat([nw, north, ne], dim=2)        # (P, h, p+2h, C)
    bot = torch.cat([sw, south, se], dim=2)
    mid = torch.cat([west, patches, east], dim=2)  # (P, p, p+2h, C)
    return torch.cat([top, mid, bot], dim=1)


def naive_stitch(patches: torch.Tensor, neighbors, halo: int = 1) -> torch.Tensor:
    """The paper's 'naive stitching' baseline (Fig. 7): one masked gather and
    copy per direction. Same output as gather_halo."""
    P, p, _, C = patches.shape
    h = halo
    out = patches.new_zeros((P, p + 2 * h, p + 2 * h, C))
    out[:, h:h + p, h:h + p, :] = patches
    nb = _neighbor_index(neighbors, patches.device)
    regions = {
        0: (slice(0, h), slice(h, h + p), lambda q: q[:, p - h:, :, :]),
        1: (slice(h + p, h + p + h), slice(h, h + p), lambda q: q[:, :h, :, :]),
        2: (slice(h, h + p), slice(0, h), lambda q: q[:, :, p - h:, :]),
        3: (slice(h, h + p), slice(h + p, None), lambda q: q[:, :, :h, :]),
        4: (slice(0, h), slice(0, h), lambda q: q[:, p - h:, p - h:, :]),
        5: (slice(0, h), slice(h + p, None), lambda q: q[:, p - h:, :h, :]),
        6: (slice(h + p, None), slice(0, h), lambda q: q[:, :h, p - h:, :]),
        7: (slice(h + p, None), slice(h + p, None), lambda q: q[:, :h, :h, :]),
    }
    for slot, (rs, cs, crop) in regions.items():
        idx = nb[:, slot]
        src = torch.where((idx >= 0)[:, None, None, None],
                          crop(patches[idx.clamp(min=0)]), 0)
        out[:, rs, cs, :] = src
    return out
