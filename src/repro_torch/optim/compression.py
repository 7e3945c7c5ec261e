"""Gradient compression: int8 quantization with error feedback, the port of
the reference's ``repro/optim/compression.py``.

Numerics: per-tensor symmetric scale, residual carried forward (error
feedback) so quantization noise averages out instead of biasing the
trajectory. Two entry points:
- ``compress_grads``: pure numeric transform usable inside any train step
  (it simulates the at-wire quantization);
- ``quantized_psum``: a sum over a ``torch.distributed`` group that sends
  int8 codes (as int32 accumulators) instead of the values, for custom DP
  loops.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.layers import tree_map, tree_unzip


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: Any, error_state: Any) -> Tuple[Any, Any]:
    """Returns (dequantized grads, new error state). error_state mirrors
    grads (fp32 residuals), zeros to initialize."""
    def one(g, e):
        g32 = g.float() + e
        q, s = _quant(g32)
        deq = q.float() * s
        return deq.to(g.dtype), g32 - deq

    return tree_unzip(tree_map(one, grads, error_state), 2)


def init_error_state(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)


def quantized_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire sum of ``x`` over ``group`` (the default group when
    None): quantize locally with a shared max-scale (an all-reduce MAX of
    max|x|, / 127 + 1e-12), sum the round-half-even codes clipped to +-127
    as int32 accumulators (an all-reduce SUM), dequantize. Returns fp32."""
    import torch.distributed as dist
    amax = torch.max(torch.abs(x)).float()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.float() * scale
