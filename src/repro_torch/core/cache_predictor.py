"""Cache Reuse Predictor (paper §5.1 / §7): the threshold policy.

``ThresholdPredictor`` maps the per-patch relative input delta to a reuse
decision, delta < tau (tau trades quality against savings).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ThresholdPredictor:
    tau: float = 5e-3

    def __call__(self, delta: torch.Tensor) -> torch.Tensor:
        return delta < self.tau
