"""Work of one ``groupnorm_stitch`` call: GroupNorm of (P, p, p, C) patches
with per-request statistics, written out as haloed (P, p+2, p+2, C) tiles.

Bytes: the patches read once and the haloed tiles written once (the halo
is output the kernel has to write), plus scale and bias. Operations: the
statistics (a square and two adds an input element) and the affine
normalisation (a multiply-add an output element, scale and shift folded),
at the float32 peak (67 TFLOP/s). The bound is the larger of the two times."""
from __future__ import annotations

from gpubench.work.peaks import FP32_FLOPS, HBM_BYTES_PER_S


def nbytes(P: int, p: int, C: int, elt: int, halo: int = 1) -> float:
    return float(elt) * P * C * (p * p + (p + 2 * halo) ** 2) + 2.0 * 4 * C


def flops(P: int, p: int, C: int, halo: int = 1) -> float:
    return 3.0 * P * p * p * C + 2.0 * P * (p + 2 * halo) ** 2 * C


def bound_s(call) -> float:
    """call: (P, p, p, C, groups, element size) as the trace records it."""
    P, p, _, C, _, elt = call
    return max(nbytes(P, p, C, elt) / HBM_BYTES_PER_S, flops(P, p, C) / FP32_FLOPS)
