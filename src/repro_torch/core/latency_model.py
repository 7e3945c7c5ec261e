"""Throughput Analyzer — online MLP latency predictor (paper §6.1), and the
step-latency surrogates of the simulated clock.

The predictor maps a batch composition to its per-denoise-step latency,
replacing exhaustive offline profiling (the paper's "Explosive
Combination"). Inputs per the paper: task count per resolution, number of
distinct ongoing resolutions, and total patch count. Trained on measured
combinations (80/20 split) by full-batch gradient descent; the paper
reports < 3.7% error.

The MLP is a plain function of a dict of fp32 tensors (``w1, b1, w2, b2, w3,
b3``), the reference's parameter names and shapes, so
``repro_torch.convert.mlp_params_from_numpy`` can start it from the
reference's weights. The surrogates below it are numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


def make_features(counts: Sequence[int], patches_per_res: Sequence[int]) -> np.ndarray:
    counts = np.asarray(counts, np.float64)
    total_patches = float(np.sum(counts * np.asarray(patches_per_res)))
    distinct = float(np.sum(counts > 0))
    return np.concatenate([counts, [distinct, total_patches]])


def _init(generator: torch.Generator, d_in: int, hidden: int = 32, device=None) -> Params:
    """Normal weights scaled by 1/sqrt(fan-in) and zero biases, drawn on the
    CPU from ``generator`` and moved to ``device`` (``None``: the card)."""
    dev = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=generator) / np.sqrt(shape[0])).to(dev)

    return {"w1": normal((d_in, hidden)), "b1": torch.zeros(hidden, device=dev),
            "w2": normal((hidden, hidden)), "b2": torch.zeros(hidden, device=dev),
            "w3": normal((hidden, 1)), "b3": torch.zeros(1, device=dev)}


def _fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


def _step(p: Params, x: torch.Tensor, y: torch.Tensor, lr: float) -> Tuple[Params, torch.Tensor]:
    """One full-batch gradient step on the mean squared error: each leaf
    becomes ``p - lr * g``, with no optimiser state."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = torch.mean(torch.square(_fwd(leaves, x) - y))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {k: v - lr * g for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


@dataclass
class LatencyModel:
    params: Params
    mu_x: np.ndarray
    sd_x: np.ndarray
    mu_y: float
    sd_y: float
    eval_err: float = 0.0

    def predict(self, feats: np.ndarray) -> float:
        x = (np.atleast_2d(feats) - self.mu_x) / self.sd_x
        with torch.no_grad():
            y = _fwd(self.params, torch.as_tensor(x, dtype=torch.float32,
                                                  device=self.params["w1"].device))
        return float(y[0].item() * self.sd_y + self.mu_y)


def fit_latency_model(features: np.ndarray, latencies: np.ndarray,
                      epochs: int = 1500, lr: float = 0.01,
                      train_frac: float = 0.8, seed: int = 0,
                      device=None) -> LatencyModel:
    """Fit on a ``train_frac`` split drawn from ``np.random.default_rng(seed)``
    and report the mean relative error on the rest as ``eval_err``. The
    weights start from ``torch.Generator().manual_seed(seed)`` and train on
    ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(features)
    order = rng.permutation(n)
    ntr = int(n * train_frac)
    tr, ev = order[:ntr], order[ntr:]
    mu_x, sd_x = features[tr].mean(0), features[tr].std(0) + 1e-8
    mu_y, sd_y = float(latencies[tr].mean()), float(latencies[tr].std() + 1e-8)
    xt = torch.as_tensor((features[tr] - mu_x) / sd_x, dtype=torch.float32, device=dev)
    yt = torch.as_tensor((latencies[tr] - mu_y) / sd_y, dtype=torch.float32, device=dev)
    params = _init(torch.Generator().manual_seed(seed), features.shape[-1], device=dev)
    for _ in range(epochs):
        params, _ = _step(params, xt, yt, lr)
    m = LatencyModel(params, mu_x, sd_x, mu_y, sd_y)
    if len(ev):
        preds = np.array([m.predict(features[i]) for i in ev])
        rel = np.abs(preds - latencies[ev]) / np.maximum(latencies[ev], 1e-9)
        m.eval_err = float(np.mean(rel))
    return m


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


def patch_aware_step_latency(counts: Sequence[int],
                             resolutions: Sequence[Tuple[int, int]],
                             patch: int, base: float = 2.0e-3,
                             per_patch: float = 0.45e-3,
                             per_pixel: float = 6.5e-6,
                             per_group: float = 0.6e-3,
                             cache_hit_rate: float = 0.0,
                             reuse_efficiency: float = 0.65) -> float:
    """Patch-size-aware step-latency surrogate for **cross-engine**
    comparison in the cluster sim (``repro_torch.cluster``).

    ``analytic_step_latency`` prices a step purely in patch counts, which is
    fine inside one engine (its patch size is fixed) but cannot compare
    engines with different GCD patches. Here compute scales with latent
    pixels (invariant to how latents are cut) while per-patch overhead —
    halo exchange, gather bookkeeping, boundary stitching (paper §4.2/4.3) —
    scales with patch count and redundant halo pixels, so a replica whose
    resolution set admits a larger GCD patch is honestly faster, by the
    overhead share only.

    ``cache_hit_rate`` (from ``CacheHitModel``) discounts the compute share:
    a reused patch skips its block math but still pays gather/scatter and
    bookkeeping, so only ``reuse_efficiency`` of a hit's cost is saved.
    ``base`` and per-group overhead are never discounted."""
    counts = np.asarray(counts, np.float64)
    hw = np.asarray(resolutions, np.float64)
    n_patches = float(np.sum(
        counts * (hw[:, 0] // patch) * (hw[:, 1] // patch)))
    pixels = float(np.sum(counts * hw[:, 0] * hw[:, 1]))
    groups = float(np.sum(counts > 0))
    halo = n_patches * 4.0 * patch          # redundant halo ring per patch
    compute = (per_patch * n_patches ** 0.9
               + per_pixel * (pixels + halo) ** 0.85)
    discount = 1.0 - reuse_efficiency * min(max(cache_hit_rate, 0.0), 1.0)
    return base + per_group * groups + compute * discount


# ---------------- patch-cache hit-rate surrogate (cluster sim) -------------

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


@dataclass
class CacheHitModel:
    """Per-step patch-cache hit probability as a logistic in the replica's
    resolution-set concentration and the batch's mean step fraction — the
    two locality drivers of the tensor path (fewer distinct shapes -> fewer
    Expired/New transitions in ``core/cache.py``; later denoising steps ->
    smaller input deltas -> more reuse under the threshold predictor). The
    default coefficients are the reference's least-squares logit fit to 100
    ``Metrics.cache_samples`` of its tiny CPU tensor path (the samples are
    ``benchmarks/data/cache_calibration.json``). Refit with
    ``fit_cache_hit_model`` against fresh ``Metrics.cache_samples`` when the
    predictor, tau, or models change."""
    b0: float = -6.07     # intercept (hit rate floor)
    b_conc: float = 1.76  # >= 0: monotone in concentration
    b_step: float = 9.32  # >= 0: monotone in step fraction

    def hit_rate(self, concentration: float, step_frac: float) -> float:
        z = (self.b0 + self.b_conc * min(max(concentration, 0.0), 1.0)
             + self.b_step * min(max(step_frac, 0.0), 1.0))
        return float(1.0 / (1.0 + np.exp(-z)))

    def two_level_hit_rate(self, concentration: float, step_frac: float,
                           l1_frac: float, l2_frac: float,
                           l2_discount: float = 0.7) -> float:
        """Two-level effective hit probability for the fleet cache tier
        (``repro_torch.cluster.cachetier``). ``hit_rate`` assumes the
        replica's local (L1) patch cache is warm for the whole batch; here
        only ``l1_frac`` of the batch's patch keys are locally warm, and of
        the cold remainder ``l2_frac`` can be recovered from the fleet (L2)
        tier — discounted by ``l2_discount`` because a remote hit pays fetch
        latency on the step's critical path (the fetch itself is charged on
        the sim clock by the tier client)."""
        p = self.hit_rate(concentration, step_frac)
        l1 = min(max(l1_frac, 0.0), 1.0)
        l2 = min(max(l2_frac, 0.0), 1.0)
        return p * (l1 + (1.0 - l1) * l2 * min(max(l2_discount, 0.0), 1.0))


def fit_cache_hit_model(samples: Sequence[Tuple[float, float, float]]
                        ) -> CacheHitModel:
    """Least-squares logit fit of (concentration, step_frac, hit_rate)
    samples — e.g. ``Metrics.cache_samples`` recorded by the real tensor
    path. Slopes are clamped non-negative so the surrogate stays monotone
    in both locality drivers even on noisy calibration data."""
    arr = np.asarray(samples, np.float64)
    if arr.ndim != 2 or arr.shape[0] < 3 or arr.shape[1] != 3:
        raise ValueError("need >= 3 (concentration, step_frac, hit) samples")
    y = np.clip(arr[:, 2], 1e-3, 1.0 - 1e-3)
    logit = np.log(y / (1.0 - y))
    X = np.stack([np.ones(len(arr)), arr[:, 0], arr[:, 1]], axis=1)
    coef, *_ = np.linalg.lstsq(X, logit, rcond=None)
    return CacheHitModel(b0=float(coef[0]),
                         b_conc=float(max(coef[1], 0.0)),
                         b_step=float(max(coef[2], 0.0)))
