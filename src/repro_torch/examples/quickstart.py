"""Quickstart: batch three mixed-resolution diffusion requests as ONE patch
batch, denoise one step, and check that the outputs match each request run
alone — the paper's core mechanism.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart --full [--kind dit]

By default the tiny UNet (``--kind dit``: the tiny DiT) on latents
16²/24²/32² with patch 8, and every request held to max |batched - solo|
< 1e-4. ``--full`` takes the full-width configs with the CUDA kernels:
SDXL-lite on latents 64²/96²/128² (patch 32, 29 patches) or SD3-lite on
32²/48²/64² (patch 16); every request is held to PSNR > 80 and the
requests at steps 10 and 30 to max |batched - solo| < 1e-4. The request
at step 0 gets only the PSNR bar: the first DDIM step divides by
sqrt(alpha_bar) ~ 0.006 and so amplifies fp32 rounding about 150x.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core.patching import merge, split
from repro_torch.device import resolve_device
from repro_torch.examples.common import FULL_RES, RES, full_model, psnr, tiny_model
from repro_torch.models.sampler import sampler_step

# kind -> (latent sides, patch) of the full-width runs
FULL = {"unet": (FULL_RES, 32), "dit": ([(32, 32), (48, 48), (64, 64)], 16)}
STEPS = (0, 10, 30)                                  # mixed progress (Fig. 1)
TOTAL_STEPS = 50
ERR_BAR = 1e-4          # max |batched - solo| (examples/quickstart.py's)
PSNR_BAR = 80.0         # tests/test_system.py's


def run(kind: str = "unet", full: bool = False, device=None, params=None,
        use_kernels: bool = True, sides=None) -> dict:
    """One batched sampler step of three requests and each request's step
    alone. Returns the CSP, both outputs per request, and one row per
    request: resolution, step, max |batched - solo|, PSNR, bitwise.
    ``use_kernels=False`` takes the plain path; ``sides`` replaces the
    three latent sides (each a multiple of the patch, in any order)."""
    dev = resolve_device(device)
    cfg, params = (full_model if full else tiny_model)(kind, device=dev, params=params)
    cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
    res, patch = FULL[kind] if full else (RES, 8)
    res = sides or res
    rng = np.random.default_rng(0)
    latents = [torch.as_tensor(rng.normal(size=(h, w, cfg.latent_channels)),
                               dtype=torch.float32, device=dev) for h, w in res]
    text = torch.as_tensor(rng.normal(size=(len(res), cfg.n_text, cfg.d_text)),
                           dtype=torch.float32, device=dev)
    steps = torch.as_tensor(STEPS)

    csp, patches = split(latents, patch=patch)
    # the CSP holds the requests sorted by side; steps and text follow it
    order = [int(i) for i in csp.req_ids]
    batched = merge(csp, sampler_step(cfg, params, csp, patches, steps[order], TOTAL_STEPS,
                                      text[order]))
    solo, rows = [], []
    for i, lat in enumerate(latents):
        ci, pi = split([lat], patch=patch)
        solo.append(merge(ci, sampler_step(cfg, params, ci, pi, steps[i:i + 1], TOTAL_STEPS,
                                           text[i:i + 1]))[0])
        rows.append({"request": i, "resolution": tuple(lat.shape[:2]), "step": STEPS[i],
                     "max_abs_err": float((batched[i] - solo[i]).abs().max()),
                     "psnr": psnr(batched[i], solo[i]),
                     "bitwise": bool(torch.equal(batched[i], solo[i]))})
    return {"cfg": cfg, "csp": csp, "batched": batched, "solo": solo, "rows": rows}


def check(rows, full: bool) -> None:
    """The bars of the module docstring; raises on the first miss."""
    for r in rows:
        if full and r["psnr"] <= PSNR_BAR:
            raise AssertionError(f"request {r['request']}: PSNR {r['psnr']:.1f} <= {PSNR_BAR}")
        if (not full or r["step"] > 0) and not r["max_abs_err"] < ERR_BAR:
            raise AssertionError(f"request {r['request']} at step {r['step']}: max |batched - "
                                 f"solo| = {r['max_abs_err']:.2e} >= {ERR_BAR}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="unet", choices=["unet", "dit"])
    ap.add_argument("--full", action="store_true",
                    help="the full-width config with the CUDA kernels")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)
    out = run(args.kind, args.full, args.device)
    csp = out["csp"]
    print(f"{out['cfg'].name if args.full else 'tiny ' + args.kind}: CSP: {csp.total} patches of "
          f"{csp.patch}x{csp.patch}, {csp.n_groups} resolution groups")
    for r in out["rows"]:
        print(f"request {r['request']} {r['resolution']} at step {r['step']}: max |batched - "
              f"solo| = {r['max_abs_err']:.2e}, PSNR = {r['psnr']:.1f} dB, "
              f"bitwise {'equal' if r['bitwise'] else 'not equal'}")
    check(out["rows"], args.full)
    print("mixed-resolution patch batching is exact — quickstart OK")
    return out


if __name__ == "__main__":
    main()
