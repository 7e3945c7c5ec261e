"""Wrapper of the fused GroupNorm + patch-edge stitch CUDA kernel
(``csrc/groupnorm_stitch.cu``), the port of the TPU kernel
``src/repro/kernels/groupnorm_stitch.py``.

A CPU tensor takes the plain version (``ref.ref_groupnorm_stitch``); a CUDA
tensor launches the kernel or raises. ``groupnorm_stitch.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_groupnorm_stitch

_LAUNCHERS = {torch.float32: "ps_groupnorm_stitch_f32",
              torch.bfloat16: "ps_groupnorm_stitch_bf16"}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"groupnorm_stitch: {msg}")


def groupnorm_stitch(patches: torch.Tensor, neighbors: torch.Tensor,
                     mean_c: torch.Tensor, rstd_c: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor,
                     halo: int = 1) -> torch.Tensor:
    """patches (P,p,p,C) fp32/bf16; neighbors (P,8) int32; mean_c/rstd_c (P,C)
    fp32 per-patch per-channel stats; scale/bias (C,) fp32. Returns the
    normalized haloed tiles (P, p+2h, p+2h, C) in the patches' dtype."""
    if patches.device.type == "cpu":
        return ref_groupnorm_stitch(patches, neighbors, mean_c, rstd_c, scale,
                                    bias, halo)
    _check(patches.device.type == "cuda", f"unsupported device {patches.device}")
    P, p, p2, C = patches.shape
    _check(p == p2, f"patches must be square, got {tuple(patches.shape)}")
    _check(patches.dtype in _LAUNCHERS, f"unsupported dtype {patches.dtype}")
    _check(0 <= halo <= p, f"halo {halo} outside [0, {p}]")
    _check(neighbors.shape == (P, 8) and neighbors.dtype == torch.int32,
           "neighbors must be (P, 8) int32")
    for name, t, shape in (("mean_c", mean_c, (P, C)), ("rstd_c", rstd_c, (P, C)),
                           ("scale", scale, (C,)), ("bias", bias, (C,))):
        _check(t.shape == shape and t.dtype == torch.float32,
               f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    for t in (patches, neighbors, mean_c, rstd_c, scale, bias):
        _check(t.device == patches.device, "all inputs must be on one device")
        _check(t.is_contiguous(), "all inputs must be contiguous")
    out = torch.empty((P, p + 2 * halo, p + 2 * halo, C), dtype=patches.dtype,
                      device=patches.device)
    if P == 0:
        return out
    fn = getattr(build.library(), _LAUNCHERS[patches.dtype])
    stream = torch.cuda.current_stream(patches.device).cuda_stream
    build.check(fn(patches.data_ptr(), neighbors.data_ptr(), mean_c.data_ptr(),
                   rstd_c.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), P, p, C, halo, stream), "groupnorm_stitch")
    groupnorm_stitch.launches += 1
    return out


groupnorm_stitch.launches = 0
