"""The CSP's metadata on the device, uploaded once per CSP and device.

A CSP's ``neighbors``, ``patch_req`` and ``request_offset`` are numpy arrays;
every op that indexes with them needs them on the patches' device. Copying
them there on each call costs a host-to-device copy from pageable memory,
which waits for the stream: the host can then never run ahead of the card.
``csp_device`` packs the three into one pinned buffer, copies it once with
``non_blocking=True`` and returns the cached tensors after that.

The cache is keyed on the ``id`` of ``csp.neighbors`` and the device, and an
entry holds only weak references to the arrays it was built from: a hit
needs the same three array objects (``csp_at_level`` makes a new CSP per
level around the same arrays, so all levels share one entry), and an entry
goes away with its ``neighbors`` array.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.csp import CSP


class CSPDevice(NamedTuple):
    neighbors: torch.Tensor           # (P, 8) int64, -1 where absent
    patch_req: torch.Tensor           # (P,) int64 request index of each patch
    counts: torch.Tensor              # (R,) int64 patches per request
    neighbors_i32: torch.Tensor       # (P, 8) int32, for the kernels
    patch_req_i32: torch.Tensor       # (P,) int32
    request_offset_i32: torch.Tensor  # (R+1,) int32


_CACHE: dict = {}


def _arrays(csp: CSP) -> tuple:
    return csp.neighbors, csp.patch_req, csp.request_offset


def csp_device(csp: CSP, device) -> CSPDevice:
    """The CSP's metadata as tensors on ``device``: one non-blocking upload
    per CSP and device (CUDA), then the cached tensors."""
    device = torch.device(device)
    key = (id(csp.neighbors), str(device))
    hit = _CACHE.get(key)
    if hit is not None and all(ref() is a for ref, a in zip(hit[0], _arrays(csp))):
        return hit[1]
    P = csp.total
    host = torch.from_numpy(np.concatenate(
        [csp.neighbors.ravel(), csp.patch_req, csp.request_offset]).astype(np.int64))
    if device.type == "cuda":
        wide = host.pin_memory().to(device, non_blocking=True)
    else:
        wide = host.to(device)
    narrow = wide.to(torch.int32)
    offset = wide[9 * P:]
    meta = CSPDevice(neighbors=wide[:8 * P].view(P, 8), patch_req=wide[8 * P:9 * P],
                     counts=offset[1:] - offset[:-1],
                     neighbors_i32=narrow[:8 * P].view(P, 8),
                     patch_req_i32=narrow[8 * P:9 * P], request_offset_i32=narrow[9 * P:])
    _CACHE[key] = (tuple(weakref.ref(a) for a in _arrays(csp)), meta)
    weakref.finalize(csp.neighbors, _CACHE.pop, key, None)
    return meta
