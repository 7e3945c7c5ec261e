#!/usr/bin/env python3
"""Measure the port's whole GroupNorm+stitch call, and one profiled SDXL-lite
sampler step, in a given source tree on one NVIDIA GPU.

    python3 scripts/gn_stitch_compare.py [--src PATH] [--label NAME]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's), so that another commit unpacked beside the checkout
(``git archive``) is measured by the same code; run two trees in one command,
in turns, to compare them on one card. It uses only entry points that every
version of the port has: ``kernels.ops.fused_groupnorm_stitch``,
``core.patching.split``, ``models.sampler.sampler_step``.

For each main-path shape (the three-request CSP of ``chip_smoke.py``: level 0
p=32 with C=64 and 128, level 1 p=16 with C=128 and 256; P=29), each dtype and
each stats mode, one JSON line ``{"gn_call": ...}``:

- ``eager_ms``: CUDA events around 50 eager calls, over 50 (what a caller
  waits for, host launch cost and any synchronise included);
- ``device_ms``: the summed device time of every kernel, copy and memset of
  50 calls under ``torch.profiler``, over 50;
- ``device_ops``, ``memcpy``, ``sync``: device operations, ``cudaMemcpyAsync``
  and ``cudaStreamSynchronize`` calls per call;
- ``bound_ms``: one read of the patches and one write of the haloed tiles at
  3.35 TB/s (H100 SXM data sheet).

Then one ``{"step": ...}`` line: an SDXL-lite step with the kernels, as
``chip_smoke.py`` phase 3 runs it, over three profiled steps: device ops,
device busy ms, the GroupNorm+stitch path's device ms (every device op
launched inside ``fused_groupnorm_stitch``), ``cudaMemcpyAsync`` and
``cudaStreamSynchronize`` calls, each per step, and the best unprofiled
host-clock step of five.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
CHIP_RES = [(64, 64), (96, 96), (128, 128)]
CALLS = 50
# record_function range around fused_groupnorm_stitch in the step profile; the
# profiler also lists it, and each profiler step, on the device timeline as a
# span that is not an op
SPAN = "gn_stitch_path"


def emit(label: str, key: str, row: dict) -> None:
    print(json.dumps({key: row, "label": label}), flush=True)


def profiled(torch, fn, n: int):
    """``fn`` run ``n`` times under ``torch.profiler``, after a first cycle of
    ``n`` runs that is discarded (the profiler can miss the device events
    at the start of its first cycle)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def runtime_counts(prof, n: int) -> dict:
    """Device ops, H2D/D2H copy calls and stream synchronises per call, and
    the device time of the ops launched inside a ``SPAN`` range (a device
    op is matched to its runtime launch call by correlation id)."""
    events = prof.events()
    dev = [e for e in events if e.device_type.name == "CUDA" and e.name != SPAN
           and not e.name.startswith("ProfilerStep")]
    host = [e for e in events if e.device_type.name == "CPU"]
    names = [e.name for e in host]
    spans = [(e.time_range.start, e.time_range.end) for e in host if e.name == SPAN]
    launched = {e.id: e.time_range.start for e in host if e.name.startswith("cuda")}
    in_span = [e for e in dev if e.id in launched
               and any(a <= launched[e.id] <= b for a, b in spans)]
    return {"device_ops": len(dev) / n,
            "device_ms": sum(e.device_time for e in dev) / 1e3 / n,
            "span_device_ms": sum(e.device_time for e in in_span) / 1e3 / n,
            "memcpy": names.count("cudaMemcpyAsync") / n,
            "sync": names.count("cudaStreamSynchronize") / n}


def gn_calls(torch, dev, label: str) -> None:
    from repro_torch.core.patching import split
    from repro_torch.kernels.ops import fused_groupnorm_stitch
    gen = torch.Generator().manual_seed(0)
    for level, C in ((0, 64), (0, 128), (1, 128), (1, 256)):
        f = 2 ** level
        res = [(h // f, w // f) for h, w in CHIP_RES]
        for dtype in (torch.float32, torch.bfloat16):
            imgs = [torch.randn(h, w, C, generator=gen).to(dev, dtype) for h, w in res]
            csp, patches = split(imgs, patch=32 // f)
            scale = torch.randn(C, generator=gen).to(dev)
            bias = torch.randn(C, generator=gen).to(dev)
            P, p = patches.shape[0], patches.shape[1]
            es = patches.element_size()
            bound = (P * p * p * C + P * (p + 2) ** 2 * C) * es / HBM_BYTES_PER_S * 1e3
            for exact in (True, False):
                def fn():
                    return fused_groupnorm_stitch(csp, patches, scale, bias, 8, exact=exact)
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CALLS):
                    fn()
                end.record()
                end.synchronize()
                eager = start.elapsed_time(end) / CALLS
                counts = runtime_counts(profiled(torch, fn, CALLS), CALLS)
                del counts["span_device_ms"]
                row = dict(level=level, P=P, p=p, C=C, dtype=str(dtype).split(".")[1],
                           exact=exact, eager_ms=eager, bound_ms=bound, **counts)
                emit(label, "gn_call", row)


def step_profile(torch, dev, label: str, n: int = 3) -> None:
    import numpy as np
    from torch.profiler import record_function

    import repro_torch.models.diffusion as dm
    from repro_torch.core.patching import split
    from repro_torch.models.sampler import sampler_step
    rng = np.random.default_rng(1)
    cfg = dm.SDXL_LITE
    params = dm.init_diffusion(cfg, torch.Generator().manual_seed(0), device=dev)
    imgs = [torch.as_tensor(rng.normal(size=(h, w, cfg.latent_channels)),
                            dtype=torch.float32, device=dev) for h, w in CHIP_RES]
    text = torch.as_tensor(rng.normal(size=(len(CHIP_RES), cfg.n_text, cfg.d_text)),
                           dtype=torch.float32, device=dev)
    steps = torch.as_tensor([3, 17, 42])
    csp, patches = split(imgs)
    inner = dm.fused_groupnorm_stitch

    def traced(*args, **kwargs):
        with record_function(SPAN):
            return inner(*args, **kwargs)

    dm.fused_groupnorm_stitch = traced
    cfg = dataclasses.replace(cfg, use_kernels=True)

    def step():
        return sampler_step(cfg, params, csp, patches, steps, 50, text)

    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    prof = profiled(torch, step, n)
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2          # two cycles of n steps
    counts = runtime_counts(prof, n)
    counts["gn_path_device_ms"] = counts.pop("span_device_ms")
    row = dict(P=csp.total, p=csp.patch, host_ms_best=min(host), wall_ms_profiled=wall_ms / n,
               busy_share=counts["device_ms"] * n / wall_ms, **counts)
    emit(label, "step", row)
    dm.fused_groupnorm_stitch = inner


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="tree", help="names the tree in every output line")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("gn_stitch_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | {args.label}: {repro_torch.__file__} | torch {torch.__version__}",
          flush=True)
    dev = torch.device("cuda")
    gn_calls(torch, dev, args.label)
    step_profile(torch, dev, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
