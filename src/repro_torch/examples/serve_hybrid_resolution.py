"""End-to-end demo: serve a hybrid-resolution Poisson workload through the
full PatchedServe engine (SLO scheduler + latency predictor + patch cache),
real clock, and print the SLO metrics and save one generated image.

    PYTHONPATH=src python -m repro_torch.examples.serve_hybrid_resolution --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_hybrid_resolution --full

By default the tiny UNet on latents 16²/24²/32²; ``--full`` serves
SDXL-lite on 64²/96²/128² through both CUDA kernels.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.requests import poisson_workload
from repro_torch.device import resolve_device
from repro_torch.examples.common import real_engine

STEPS = 6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="SDXL-lite on 64²/96²/128² with the CUDA kernels")
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "patchedserve_example_image.npy"))
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    engine = real_engine(args.full, cache_capacity=512, device=dev)
    res = engine.resolutions

    print(f"{engine.mcfg.name} on {dev}: calibrating latency model (paper §6.1)...")
    engine.calibrate(total_steps_hint=STEPS)
    print("  standalone latencies:", {k: f"{v:.2f}s" for k, v in engine.sa.items()})

    workload = poisson_workload(qps=1.0, duration=args.duration, resolutions=res,
                                slo_scale=8.0, standalone_latency=engine.sa,
                                steps=STEPS, seed=0)
    print(f"serving {len(workload)} requests ({[r.resolution for r in workload]})")
    t0 = time.time()
    m = engine.run(workload, max_wall=300)
    print(f"completed={m.completed} dropped={m.dropped} "
          f"SLO satisfaction={m.slo_satisfaction:.2f} "
          f"goodput={m.goodput:.2f} req/s "
          f"cache savings={np.mean(m.compute_savings) if m.compute_savings else 0:.1%} "
          f"wall={time.time() - t0:.0f}s")
    image = None
    if engine.outputs:
        rid, image = next(iter(engine.outputs.items()))
        np.save(args.out, image)
        print(f"request {rid}: decoded image {image.shape} -> {args.out}")
    return {"metrics": m, "workload": workload, "engine": engine, "image": image}


if __name__ == "__main__":
    main()
