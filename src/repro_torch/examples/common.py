"""Helpers shared by the examples and the cache-hit calibration: the tiny
and full-width models, request lists, and real- and sim-clock engines over
the latent ladder 16²/24²/32² (full width: 64²/96²/128²), the port's copy
of ``benchmarks/common.py``'s.

Every helper takes ``device`` (``None``: the CUDA card, raising without
one); the model helpers and ``real_engine`` also take an optional
``params`` tree, so that a caller can run them on weights drawn
elsewhere."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.latency_model import analytic_step_latency
from repro_torch.core.requests import Request, poisson_workload
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.serving import EngineConfig, PatchedServeEngine
from repro_torch.device import resolve_device
from repro_torch.models import diffusion as dm

RES = [(16, 16), (24, 24), (32, 32)]          # latent Low / Medium / High
FULL_RES = [(64, 64), (96, 96), (128, 128)]   # 512/768/1024-pixel requests


def tiny_model(kind="unet", device=None, params=None):
    """(config, params) of the tiny UNet (or DiT) with the CUDA kernels
    (their plain versions on CPU tensors); params drawn from seed 0 unless
    given."""
    cfg = dm.DiffusionConfig(kind=kind, width=32, levels=2, blocks_per_level=1,
                             n_heads=2, groups=4, d_text=16, n_text=4)
    if params is None:
        params = dm.init_diffusion(cfg, torch.Generator().manual_seed(0),
                                   device=resolve_device(device))
    return cfg, params


def full_model(kind="unet", device=None, params=None):
    """(config, params) of SDXL-lite (``kind="dit"``: SD3-lite) at full width
    with the CUDA kernels; params drawn from seed 0 unless given."""
    cfg = dm.SDXL_LITE if kind == "unet" else dm.SD3_LITE
    if params is None:
        params = dm.init_diffusion(cfg, torch.Generator().manual_seed(0),
                                   device=resolve_device(device))
    return cfg, params


def make_requests(counts: Sequence[int], steps=4, res=RES) -> List[Request]:
    """``counts[i]`` requests at ``res[i]``, all arrived at 0 with no deadline."""
    reqs = []
    for side, c in zip(res, counts):
        for _ in range(c):
            reqs.append(Request(rid=len(reqs), resolution=side, arrival=0.0, slo=1e9,
                                total_steps=steps))
    return reqs


def real_engine(full=False, cache_capacity=256, device=None, params=None):
    """Real-clock engine with the patch cache on (tau 0.05): the tiny UNet on
    ``RES``, or (``full``) SDXL-lite on ``FULL_RES``."""
    cfg, params = (full_model if full else tiny_model)(device=device, params=params)
    res = FULL_RES if full else RES
    ecfg = EngineConfig(clock="real", use_cache=True, cache_tau=0.05,
                        cache_capacity=cache_capacity)
    return PatchedServeEngine(cfg, params, ecfg, dict.fromkeys(res, 1.0), res, device=device)


class _Seq:
    """Latency of a system that cannot batch across resolutions: each
    resolution present runs its own step, one after another."""

    def __init__(self, patches_per_res):
        self.ppr = patches_per_res

    def predict(self, f):
        counts = f[:len(RES)]
        return sum(analytic_step_latency([c if i == j else 0 for j in range(len(RES))], self.ppr)
                   for i, c in enumerate(counts) if c > 0)


def sim_engine(policy="slo", same_res=False, mixed_batching=True, device=None):
    """Sim-clock engine that runs no model: requests carry no tensors and a
    step is accounting under the analytic latency surrogate.
    ``mixed_batching=False`` models a system that cannot batch across
    resolutions at all (per-resolution latency additive)."""
    cfg, params = tiny_model(device=device)
    ecfg = EngineConfig(clock="sim", sim_synthetic=True,
                        scheduler=SchedulerConfig(policy=policy, same_res_only=same_res))
    eng = PatchedServeEngine(cfg, params, ecfg, dict.fromkeys(RES, 1.0), RES, device=device)
    for res in eng.resolutions:
        eng.sa[res] = analytic_step_latency(
            [1 if r == res else 0 for r in eng.resolutions], eng.patches_per_res) * 10
    if not mixed_batching:
        eng.latency_model = _Seq(eng.patches_per_res)
    return eng


def workload(eng, qps, duration=40.0, seed=0):
    """Poisson arrivals over ``RES``, 10-step requests, SLO 5x standalone."""
    return poisson_workload(qps, duration, RES, 5.0, eng.sa, steps=10, seed=seed)


def psnr(a, b) -> float:
    """PSNR of ``a`` against the reference ``b``, peak = max |b|
    (``tests/test_system.py``'s measure); inf when they are equal."""
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    peak = float(np.max(np.abs(b))) + 1e-9
    return 10 * np.log10(peak ** 2 / mse)
