"""Compressed Sparse Patch (CSP) format — the paper's §4.1 data structure.

Host-side (numpy) metadata describing a batch of patches cut from
mixed-resolution latents. Invariants that everything downstream relies on:

- requests are **sorted by resolution** (ascending H, then W), so all patches
  of a resolution group are contiguous (paper Fig. 8c);
- within a request, patches are row-major, and within a group consecutive
  requests are contiguous — so group->image assembly is a pure
  reshape/transpose (no gather), which is what makes the CSP-grouped
  batched attention cheap (§4.2);
- ``request_offset`` plays the CSR role: patches of request i live in
  [request_offset[i], request_offset[i+1]) (paper Fig. 8d);
- ``neighbors`` stores the 8-neighborhood patch index (-1 when absent) used
  by halo exchange for convolution (§4.2) and the edge stitcher (§4.3).

The patch *data* lives on device as one (P, p, p, C) array; this metadata is
static per compiled batch signature (bucketed — see serving engine).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

# neighbor slot order: N, S, W, E, NW, NE, SW, SE
NEIGHBOR_OFFSETS = np.array(
    [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)],
    np.int64)


@dataclass(frozen=True)
class CSP:
    patch: int
    req_ids: np.ndarray        # (R,) caller's request ids, resolution-sorted
    res: np.ndarray            # (R, 2) latent (H, W) per request
    grid: np.ndarray           # (R, 2) (H//p, W//p)
    request_offset: np.ndarray  # (R+1,)
    group_offset: np.ndarray   # (G+1,) patch offsets per resolution group
    group_res: np.ndarray      # (G, 2)
    group_count: np.ndarray    # (G,) requests per group
    patch_req: np.ndarray      # (P,) request index (into the sorted order)
    patch_rc: np.ndarray       # (P, 2) row, col within the request grid
    neighbors: np.ndarray      # (P, 8) global patch index, -1 if absent

    @property
    def n_requests(self) -> int:
        return len(self.req_ids)

    @property
    def n_groups(self) -> int:
        return len(self.group_count)

    @property
    def total(self) -> int:
        return int(self.request_offset[-1])

    def patches_of(self, i: int) -> slice:
        return slice(int(self.request_offset[i]), int(self.request_offset[i + 1]))

    def group_slice(self, g: int) -> slice:
        return slice(int(self.group_offset[g]), int(self.group_offset[g + 1]))


def gcd_patch_size(resolutions: Sequence[Tuple[int, int]],
                   cap: int = 0) -> int:
    """Paper policy: patch side = GCD of all dims in the batch (optionally
    capped to bound the per-patch working set)."""
    g = 0
    for h, w in resolutions:
        g = math.gcd(g, math.gcd(int(h), int(w)))
    if cap:
        while g > cap:
            g //= 2
    return max(g, 1)


def build_csp(resolutions: Sequence[Tuple[int, int]],
              req_ids: Sequence[int] | None = None,
              patch: int | None = None) -> CSP:
    """Build CSP metadata for a batch of latent resolutions."""
    R = len(resolutions)
    if req_ids is None:
        req_ids = list(range(R))
    res = np.asarray(resolutions, np.int64).reshape(R, 2)
    p = patch or gcd_patch_size(resolutions)
    assert np.all(res % p == 0), (res, p)

    order = np.lexsort((res[:, 1], res[:, 0]))           # sort by (H, W)
    res = res[order]
    req_ids = np.asarray(req_ids, np.int64)[order]
    grid = res // p

    counts = grid[:, 0] * grid[:, 1]
    request_offset = np.zeros(R + 1, np.int64)
    np.cumsum(counts, out=request_offset[1:])
    P = int(request_offset[-1])

    # resolution groups over the sorted requests
    group_res, group_start = [], []
    for i in range(R):
        if i == 0 or (res[i] != res[i - 1]).any():
            group_res.append(res[i])
            group_start.append(i)
    group_start.append(R)
    G = len(group_res)
    group_res = np.asarray(group_res, np.int64).reshape(G, 2)
    group_count = np.diff(group_start)
    group_offset = request_offset[np.asarray(group_start)]

    patch_req = np.repeat(np.arange(R), counts)
    patch_rc = np.zeros((P, 2), np.int64)
    neighbors = np.full((P, 8), -1, np.int64)
    for i in range(R):
        gh, gw = grid[i]
        base = request_offset[i]
        rr, cc = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        rr, cc = rr.ravel(), cc.ravel()
        patch_rc[base:base + gh * gw, 0] = rr
        patch_rc[base:base + gh * gw, 1] = cc
        for s, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
            nr, nc = rr + dr, cc + dc
            ok = (nr >= 0) & (nr < gh) & (nc >= 0) & (nc < gw)
            idx = base + nr * gw + nc
            neighbors[base:base + gh * gw, s] = np.where(ok, idx, -1)

    return CSP(patch=p, req_ids=req_ids, res=res, grid=grid,
               request_offset=request_offset, group_offset=group_offset,
               group_res=group_res, group_count=group_count,
               patch_req=patch_req, patch_rc=patch_rc, neighbors=neighbors)
