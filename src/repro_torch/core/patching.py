"""Image <-> patch-batch conversion under the CSP layout.

split: list of NHWC latents (one per request, mixed resolutions)
       -> (csp, patches (P, p, p, C))
merge: inverse. Both are reshape/permute per request (no gathers) and the
group view used by attention is a pure reshape thanks to CSP ordering.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.csp import CSP, build_csp


def image_to_patches(img: torch.Tensor, p: int) -> torch.Tensor:
    """(H, W, C) -> (gh*gw, p, p, C), row-major patches."""
    H, W, C = img.shape
    gh, gw = H // p, W // p
    return (img.reshape(gh, p, gw, p, C)
            .permute(0, 2, 1, 3, 4)
            .reshape(gh * gw, p, p, C))


def patches_to_image(patches: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(gh*gw, p, p, C) -> (gh*p, gw*p, C)."""
    P, p, _, C = patches.shape
    return (patches.reshape(gh, gw, p, p, C)
            .permute(0, 2, 1, 3, 4)
            .reshape(gh * p, gw * p, C))


def split(images: Sequence[torch.Tensor], patch: int | None = None,
          req_ids: Sequence[int] | None = None) -> Tuple[CSP, torch.Tensor]:
    res = [(im.shape[0], im.shape[1]) for im in images]
    csp = build_csp(res, req_ids=req_ids, patch=patch)
    # images must be emitted in CSP (resolution-sorted) order
    order = np.lexsort((np.asarray(res)[:, 1], np.asarray(res)[:, 0]))
    parts = [image_to_patches(images[int(i)], csp.patch) for i in order]
    return csp, torch.cat(parts, dim=0)


def merge(csp: CSP, patches: torch.Tensor) -> List[torch.Tensor]:
    """Returns images in the caller's original request order (valid when
    split() was called with default req_ids = 0..R-1)."""
    out: List[torch.Tensor] = [None] * csp.n_requests
    for i in range(csp.n_requests):
        gh, gw = map(int, csp.grid[i])
        out[int(csp.req_ids[i])] = patches_to_image(patches[csp.patches_of(i)], gh, gw)
    return out


def merge_by_request(csp: CSP, patches: torch.Tensor) -> dict:
    """{original req_id: image} — unambiguous regardless of sort order."""
    out = {}
    for i in range(csp.n_requests):
        gh, gw = map(int, csp.grid[i])
        out[int(csp.req_ids[i])] = patches_to_image(patches[csp.patches_of(i)], gh, gw)
    return out


def group_images(csp: CSP, patches: torch.Tensor, g: int) -> torch.Tensor:
    """All images of resolution-group g as one batch: (n_g, H, W, C).

    Pure reshape/permute — the CSP ordering guarantee (paper §4.2)."""
    n = int(csp.group_count[g])
    H, W = map(int, csp.group_res[g])
    p = csp.patch
    gh, gw = H // p, W // p
    blk = patches[csp.group_slice(g)]
    return (blk.reshape(n, gh, gw, p, p, -1)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(n, H, W, blk.shape[-1]))


def ungroup_images(csp: CSP, imgs: torch.Tensor, g: int) -> torch.Tensor:
    """(n_g, H, W, C) -> the group's patch block (n_g*gh*gw, p, p, C)."""
    n, H, W, C = imgs.shape
    p = csp.patch
    gh, gw = H // p, W // p
    return (imgs.reshape(n, gh, p, gw, p, C)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(n * gh * gw, p, p, C))
