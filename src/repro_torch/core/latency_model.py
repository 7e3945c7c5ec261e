"""Step-latency features and surrogates used by the serving engine
(paper §6.1): batch-composition features, the closed-form step-latency
surrogate of the simulated clock, and the resolution concentration of a
batch."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def make_features(counts: Sequence[int], patches_per_res: Sequence[int]) -> np.ndarray:
    counts = np.asarray(counts, np.float64)
    total_patches = float(np.sum(counts * np.asarray(patches_per_res)))
    distinct = float(np.sum(counts > 0))
    return np.concatenate([counts, [distinct, total_patches]])


def analytic_step_latency(counts: Sequence[int],
                          patches_per_res: Sequence[int],
                          base: float = 2.0e-3, per_patch: float = 0.9e-3,
                          per_group: float = 0.6e-3,
                          attn_scale: float = 6e-7) -> float:
    """Closed-form step-latency surrogate used by the *simulated* clock.
    Captures the paper's Fig. 6 structure: batches of only-high-res are
    slower, batching sublinear, per-distinct-resolution attention group
    overhead."""
    counts = np.asarray(counts, np.float64)
    pres = np.asarray(patches_per_res, np.float64)
    total_patches = float(np.sum(counts * pres))
    groups = float(np.sum(counts > 0))
    attn = float(np.sum(counts * pres ** 2)) * attn_scale
    return base + per_patch * total_patches ** 0.82 + per_group * groups + attn


def resolution_concentration(counts: Sequence[int],
                             patches_per_res: Sequence[int]) -> float:
    """Herfindahl index of the batch's per-resolution patch shares, in
    (0, 1]: 1.0 when every patch comes from one resolution, approaching 1/n
    for an even n-way shape mix."""
    counts = np.asarray(counts, np.float64)
    ppr = np.asarray(patches_per_res, np.float64)
    patches = counts * ppr
    total = float(patches.sum())
    if total <= 0:
        return 1.0
    shares = patches / total
    return float(np.sum(shares ** 2))
