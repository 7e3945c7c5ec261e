"""Calibrate ``CacheHitModel`` against the real tensor path of the port.

Runs the diffusion engine with the patch cache and the threshold reuse
predictor on (tau 0.05) over batch compositions that span the surrogate's
two features — resolution concentration (pure single-resolution batches
against even mixes) and step fraction (samples are recorded per denoise
step, early through late) — and fits the logistic hit-rate model on the
recorded ``Metrics.cache_samples`` triples.

    PYTHONPATH=src python -m repro_torch.examples.calibrate_cache_hit_model --device cpu
    PYTHONPATH=src python -m repro_torch.examples.calibrate_cache_hit_model --full

By default the tiny UNet on latents 16²/24²/32² (``common.real_engine``);
``--full`` collects on SDXL-lite at 64²/96²/128² with the CUDA kernels.
The fit and the samples go to ``--out`` (default
``build/cache_calibration_<device>.json``); the checked-in calibration
data and ``CacheHitModel``'s defaults are left as they are.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.core.latency_model import CacheHitModel, fit_cache_hit_model
from repro_torch.device import resolve_device
from repro_torch.examples.common import make_requests, real_engine

#: per-resolution request counts (L, M, H): pure batches pin concentration
#: at 1.0, pairs sit in between, even mixes at the low end
COMBOS = [
    (3, 0, 0), (0, 3, 0), (0, 0, 3),
    (2, 2, 0), (0, 2, 2), (2, 0, 2),
    (1, 1, 1), (2, 2, 2), (4, 1, 1), (1, 1, 4),
]
STEPS = 10
BUILD = Path(__file__).resolve().parents[3] / "build"


def collect_samples(combos=None, full: bool = False, device=None, params=None,
                    log=print) -> list:
    """``Metrics.cache_samples`` of one fresh engine per composition of
    ``combos`` (default ``COMBOS``), in order, each request ``STEPS`` steps
    long."""
    samples = []
    for counts in COMBOS if combos is None else combos:
        eng = real_engine(full, device=device, params=params)
        for r in make_requests(counts, steps=STEPS, res=eng.resolutions):
            eng.submit(r)
        eng.drain(0.0)
        got = eng.metrics.cache_samples
        samples.extend(got)
        log(f"counts={counts}: {len(got)} samples, "
            f"mean hit {sum(s[2] for s in got) / max(len(got), 1):.3f}")
    return samples


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="SDXL-lite on 64²/96²/128² with the CUDA kernels")
    ap.add_argument("--out", default=None,
                    help="JSON path; default build/cache_calibration_<device>.json")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    samples = collect_samples(full=args.full, device=dev)
    fit, default = fit_cache_hit_model(samples), CacheHitModel()
    out = {
        "meta": {"combos": [list(c) for c in COMBOS], "steps": STEPS,
                 "engine": f"common.real_engine(full={args.full})",
                 "device": str(dev), "n_samples": len(samples)},
        "fit": {"b0": fit.b0, "b_conc": fit.b_conc, "b_step": fit.b_step},
        "samples": [[round(a, 6), round(b, 6), round(c, 6)] for a, b, c in samples],
    }
    path = Path(args.out) if args.out else BUILD / f"cache_calibration_{dev.type}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"\nfit: b0={fit.b0:.4f} b_conc={fit.b_conc:.4f} b_step={fit.b_step:.4f} "
          f"({len(samples)} samples) -> {path}")
    print(f"checked-in defaults: b0={default.b0} b_conc={default.b_conc} "
          f"b_step={default.b_step}")
    return out


if __name__ == "__main__":
    main()
