"""Wrapper of the flash-attention CUDA kernel (``csrc/patch_attention.cu``),
the port of the TPU kernel ``src/repro/kernels/patch_attention.py``.

A CPU tensor takes the plain version (``ref.ref_attention``); a CUDA tensor
launches the kernel or raises. ``patch_attention.launches`` counts the kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_attention

_LAUNCHERS = {torch.float32: "ps_patch_attention_f32",
              torch.bfloat16: "ps_patch_attention_bf16"}
HEAD_DIMS = (8, 16, 32, 64)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"patch_attention: {msg}")


def patch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q,k,v: (B, S, H, D), any strides with unit stride over D ->
    (B, S, H, D) contiguous full bidirectional attention, scale D**-0.5."""
    if q.device.type == "cpu":
        return ref_attention(q, k, v)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dim() == 4, f"expected (B, S, H, D), got {tuple(q.shape)}")
    B, S, H, D = q.shape
    _check(q.dtype in _LAUNCHERS, f"unsupported dtype {q.dtype}")
    _check(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    for t in (k, v):
        _check(t.shape == q.shape and t.dtype == q.dtype and t.device == q.device,
               "q, k and v must share shape, dtype and device")
    for t in (q, k, v):
        _check(t.stride(3) == 1, "the head dimension must have unit stride")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return out
    fn = getattr(build.library(), _LAUNCHERS[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, D,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], D ** -0.5, stream),
                "patch_attention")
    patch_attention.launches += 1
    return out


patch_attention.launches = 0
