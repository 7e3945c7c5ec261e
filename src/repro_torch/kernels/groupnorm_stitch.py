"""Wrappers of the fused GroupNorm + patch-edge stitch CUDA kernels
(``csrc/groupnorm_stitch.cu``), the port of the TPU kernel
``src/repro/kernels/groupnorm_stitch.py`` and of the statistics its caller
computed for it.

- ``gn_partials``: (P, p, p, C) patches -> (P, G, 2) fp32 (sum x, sum x^2)
  per patch and channel group (kernel 1);
- ``gn_stitch``: normalise and stitch the haloed tiles, the statistics
  finalised from the partials in the kernel's prologue (kernel 2); past
  ``SMEM_GROUPS`` groups a finalise kernel writes them to a (P, G, 2) buffer
  that the stitch reads instead (two launches in this one call);
- ``groupnorm_stitch``: the whole function, both kernels.

The CSP metadata arguments are int32 tensors on the patches' device
(``core.csp_device``). A CPU tensor takes the plain versions (``ref.py``:
partials, finalise, then ``ref_groupnorm_stitch``); a CUDA tensor launches
the kernels or raises. On CUDA nothing here copies from the host or
synchronises, so a call can be captured in a CUDA graph. ``.launches``
counts, on each wrapper, its calls that launched on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_gn_finalize, ref_gn_partials, ref_groupnorm_stitch

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
# groups whose 9 sets of (mean, rstd) the stitch kernel keeps in shared memory
# (kSmemGroups in csrc/groupnorm_stitch.cu, which a test holds equal); past it
# the statistics go through a (P, G, 2) buffer in device memory
SMEM_GROUPS = 512


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"groupnorm_stitch: {msg}")


def _check_patches(patches: torch.Tensor, groups: int) -> None:
    _check(patches.device.type == "cuda", f"unsupported device {patches.device}")
    _check(patches.dim() == 4 and patches.shape[1] == patches.shape[2],
           f"patches must be (P, p, p, C), got {tuple(patches.shape)}")
    _check(patches.dtype in _SUFFIX, f"unsupported dtype {patches.dtype}")
    _check(patches.is_contiguous(), "patches must be contiguous")
    C = patches.shape[-1]
    _check(0 < groups and C % groups == 0, f"groups {groups} must divide C={C}")


def _launcher(kind: str, dtype: torch.dtype):
    return getattr(build.library(), f"ps_gn_{kind}_{_SUFFIX[dtype]}")


def gn_partials(patches: torch.Tensor, groups: int) -> torch.Tensor:
    """(P, p, p, C) fp32/bf16/fp16 -> (P, G, 2) fp32 (sum x, sum x^2) per patch and
    channel group."""
    if patches.device.type == "cpu":
        return ref_gn_partials(patches, groups)
    _check_patches(patches, groups)
    P, p, _, C = patches.shape
    part = torch.empty((P, groups, 2), dtype=torch.float32, device=patches.device)
    if P == 0:
        return part
    stream = torch.cuda.current_stream(patches.device).cuda_stream
    build.check(_launcher("partials", patches.dtype)(
        patches.data_ptr(), part.data_ptr(), P, p, C, groups, stream), "gn_partials")
    gn_partials.launches += 1
    return part


def gn_stitch(patches: torch.Tensor, partials: torch.Tensor, neighbors: torch.Tensor,
              patch_req: torch.Tensor, request_offset: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, eps: float = 1e-5, exact: bool = True,
              halo: int = 1) -> torch.Tensor:
    """Normalised haloed tiles (P, p+2h, p+2h, C) in the patches' dtype.
    partials (P, G, 2) fp32 from ``gn_partials``; neighbors (P, 8),
    patch_req (P,), request_offset (R+1,) int32; scale/bias (C,) fp32.
    exact: per-request statistics, else per-patch (the paper's)."""
    P, p, _, C = patches.shape
    G = partials.shape[1]
    if patches.device.type == "cpu":
        mean, rstd = ref_gn_finalize(partials, patch_req, request_offset, p, C, eps, exact)
        return ref_groupnorm_stitch(patches, neighbors, mean.repeat_interleave(C // G, dim=-1),
                                    rstd.repeat_interleave(C // G, dim=-1), scale, bias, halo)
    _check_patches(patches, G)
    _check(0 <= halo <= p, f"halo {halo} outside [0, {p}]")
    R1 = request_offset.shape[0] if request_offset.dim() == 1 else 0
    _check(R1 >= 2, "request_offset must be (R+1,)")
    for name, t, shape, dtype in (
            ("partials", partials, (P, G, 2), torch.float32),
            ("neighbors", neighbors, (P, 8), torch.int32),
            ("patch_req", patch_req, (P,), torch.int32),
            ("request_offset", request_offset, (R1,), torch.int32),
            ("scale", scale, (C,), torch.float32), ("bias", bias, (C,), torch.float32)):
        _check(t.shape == shape and t.dtype == dtype,
               f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        _check(t.device == patches.device, "all inputs must be on one device")
        _check(t.is_contiguous(), "all inputs must be contiguous")
    out = torch.empty((P, p + 2 * halo, p + 2 * halo, C), dtype=patches.dtype,
                      device=patches.device)
    if P == 0:
        return out
    stats = (torch.empty((P, G, 2), dtype=torch.float32, device=patches.device)
             if G > SMEM_GROUPS else None)
    stream = torch.cuda.current_stream(patches.device).cuda_stream
    build.check(_launcher("stitch", patches.dtype)(
        patches.data_ptr(), partials.data_ptr(), None if stats is None else stats.data_ptr(),
        neighbors.data_ptr(), patch_req.data_ptr(),
        request_offset.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        P, p, C, G, halo, int(exact), eps, stream), "gn_stitch")
    gn_stitch.launches += 1
    return out


def groupnorm_stitch(patches: torch.Tensor, neighbors: torch.Tensor, patch_req: torch.Tensor,
                     request_offset: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5, exact: bool = True,
                     halo: int = 1) -> torch.Tensor:
    """GroupNorm + stitch of (P, p, p, C) patches into (P, p+2h, p+2h, C)
    tiles: ``gn_partials`` then ``gn_stitch``, two launches on the card."""
    out = gn_stitch(patches, gn_partials(patches, groups), neighbors, patch_req,
                    request_offset, scale, bias, eps, exact, halo)
    if patches.device.type == "cuda" and patches.shape[0] > 0:
        groupnorm_stitch.launches += 1
    return out


gn_partials.launches = 0
gn_stitch.launches = 0
groupnorm_stitch.launches = 0
