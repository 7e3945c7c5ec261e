"""Work of one ``patch_attention`` call: q (B, Sq, H, D) over k, v (B, Sk, H, D).

Operations: q k^T and p v, 2 x B H Sq Sk D multiply-adds each, on the
tensor cores' peak (989 TFLOP/s: the bound any implementation of the
product could reach, whatever its precision tricks). Bytes: q, k and v read
once and o written once. The bound is the larger of the two times."""
from __future__ import annotations

from gpubench.work.peaks import HBM_BYTES_PER_S, TENSOR_FLOPS


def flops(B: int, Sq: int, H: int, D: int, Sk: int) -> float:
    return 4.0 * B * H * Sq * Sk * D


def nbytes(B: int, Sq: int, H: int, D: int, Sk: int, elt: int) -> float:
    return float(elt) * B * H * D * (2 * Sq + 2 * Sk)


def bound_s(call) -> float:
    """call: (B, Sq, H, D, Sk, element size) as the trace records it."""
    B, Sq, H, D, Sk, elt = call
    return max(flops(B, Sq, H, D, Sk) / TENSOR_FLOPS, nbytes(B, Sq, H, D, Sk, elt) / HBM_BYTES_PER_S)
