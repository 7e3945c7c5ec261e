"""Cache Reuse Predictor (paper §5.1 / §7).

Two interchangeable policies mapping per-patch input-delta features to a
reuse decision:

- ``ThresholdPredictor``: delta < tau (tau trades quality against savings);
- ``MLPPredictor``: a small learned classifier trained on profiled
  (input-delta features -> was the output delta < eps?) pairs, the
  reference's stand-in for the paper's random forest.
  Features: [log delta, step fraction, block fraction, log input scale].

Both take the per-patch deltas as a tensor on the engine's device and return
a boolean tensor there, so either can be ``PatchedServeEngine.predictor``.
The MLP is a plain function of a dict of fp32 tensors (``w1, b1, w2, b2``),
the reference's parameter names and shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


@dataclass
class ThresholdPredictor:
    tau: float = 5e-3

    def __call__(self, delta: torch.Tensor) -> torch.Tensor:
        return delta < self.tau


def predictor_features(delta: torch.Tensor, step_frac: float, block_frac: float,
                       in_scale: torch.Tensor) -> torch.Tensor:
    """(P,) metrics -> (P, 4) features."""
    return torch.stack([
        torch.log10(delta + 1e-9),
        torch.full_like(delta, step_frac),
        torch.full_like(delta, block_frac),
        torch.log10(in_scale + 1e-9),
    ], dim=-1)


def init_mlp(generator: torch.Generator, d_in: int = 4, hidden: int = 16,
             device=None) -> Params:
    """Normal weights scaled by 1/sqrt(fan-in) and zero biases, drawn on the
    CPU from ``generator`` and moved to ``device`` (``None``: the card)."""
    dev = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=generator) / np.sqrt(shape[0])).to(dev)

    return {"w1": normal((d_in, hidden)), "b1": torch.zeros(hidden, device=dev),
            "w2": normal((hidden, 1)), "b2": torch.zeros(1, device=dev)}


def mlp_logit(params: Params, feats: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(feats @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[..., 0]


def _train_step(params: Params, feats: torch.Tensor, labels: torch.Tensor,
                lr: float) -> Tuple[Params, torch.Tensor]:
    """One full-batch gradient step on the logistic loss, written as the
    reference writes it (max(z, 0) - z*y + log1p(exp(-|z|)), stable for any
    logit z); each leaf becomes ``p - lr * g``, with no optimiser state."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    z = mlp_logit(leaves, feats)
    loss = torch.mean(torch.clamp(z, min=0) - z * labels
                      + torch.log1p(torch.exp(-torch.abs(z))))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {k: v - lr * g for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def train_mlp(feats: np.ndarray, labels: np.ndarray, epochs: int = 400,
              lr: float = 0.05, seed: int = 0, device=None) -> Tuple[Params, float]:
    """Full-batch logistic training from ``torch.Generator().manual_seed(seed)``
    on ``device`` (``None``: the card); returns (params, final accuracy)."""
    dev = resolve_device(device)
    params = init_mlp(torch.Generator().manual_seed(seed), d_in=feats.shape[-1], device=dev)
    f = torch.as_tensor(feats, dtype=torch.float32, device=dev)
    y = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    for _ in range(epochs):
        params, _ = _train_step(params, f, y, lr)
    with torch.no_grad():
        acc = float(torch.mean(((mlp_logit(params, f) > 0) == (y > 0.5)).float()).item())
    return params, acc


@dataclass
class MLPPredictor:
    params: Params
    step_frac: float = 0.0
    block_frac: float = 0.0
    in_scale: float = 1.0

    def at(self, step_frac: float, block_frac: float) -> "MLPPredictor":
        return MLPPredictor(self.params, step_frac, block_frac, self.in_scale)

    def __call__(self, delta: torch.Tensor) -> torch.Tensor:
        feats = predictor_features(delta, self.step_frac, self.block_frac,
                                   torch.full_like(delta, self.in_scale))
        with torch.no_grad():
            return mlp_logit(self.params, feats) > 0
