"""Serving launcher: run the PatchedServe engine of the port on a real or
simulated workload, on the CUDA card unless ``--device cpu`` is given.

    python -m repro_torch.launch.serve --qps 1.0 --duration 5 --cache
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.latency_model import analytic_step_latency
from repro_torch.core.requests import poisson_workload
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.serving import EngineConfig, PatchedServeEngine
from repro_torch.device import resolve_device
from repro_torch.models import diffusion as dm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="unet", choices=["unet", "dit"])
    ap.add_argument("--qps", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--slo-scale", type=float, default=5.0)
    ap.add_argument("--cache", action="store_true")
    ap.add_argument("--policy", default="slo", choices=["slo", "fcfs"])
    ap.add_argument("--clock", default="real", choices=["real", "sim"])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mcfg = dm.DiffusionConfig(kind=args.model, width=32, levels=2,
                              blocks_per_level=1, n_heads=2, groups=4,
                              d_text=16, n_text=4, use_kernels=True)
    params = dm.init_diffusion(mcfg, torch.Generator().manual_seed(0), device=device)
    resolutions = [(16, 16), (24, 24), (32, 32)]
    ecfg = EngineConfig(clock=args.clock, use_cache=args.cache,
                        scheduler=SchedulerConfig(policy=args.policy))
    eng = PatchedServeEngine(mcfg, params, ecfg,
                             dict.fromkeys(map(tuple, resolutions), 1.0),
                             resolutions, device=device)
    if args.clock == "real":
        eng.calibrate(total_steps_hint=args.steps)
    else:
        for res in eng.resolutions:
            eng.sa[res] = analytic_step_latency(
                [1 if r == res else 0 for r in eng.resolutions],
                eng.patches_per_res) * args.steps
    wl = poisson_workload(args.qps, args.duration, resolutions,
                          args.slo_scale, eng.sa, steps=args.steps)
    m = eng.run(wl)
    print(f"device={device} requests={len(wl)} completed={m.completed} dropped={m.dropped} "
          f"SLO={m.slo_satisfaction:.3f} goodput={m.goodput:.3f}/s "
          f"mean_step={np.mean(m.step_latencies)*1e3 if m.step_latencies else 0:.1f}ms "
          f"savings={np.mean(m.compute_savings) if m.compute_savings else 0.0:.2f}")
    return m


if __name__ == "__main__":
    main()
