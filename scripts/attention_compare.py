#!/usr/bin/env python3
"""Time the port's fp32 ``patch_attention`` at the benchmark cells' shapes in
a given source tree on one NVIDIA GPU.

    python3 scripts/attention_compare.py [--src PATH] [--label NAME]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's), so that another commit unpacked beside the checkout
(``git archive``) is measured by the same code; run two trees in one command,
in turns, to compare them on one card. It uses only what every version of
the port since the kernels' public head dims has:
``kernels.patch_attention.patch_attention`` and ``kernels.ref``.

One JSON line ``{"attention": ...}`` a shape (``SHAPES``: SD 1.5's D = 40 /
80 / 160 at its three levels' sequences, PixArt-α's D = 72, and both text
lengths under image queries), fp32, q, k and v strided views of one
projection as the models make them:

- ``ms``: device ms a call, CUDA events around replays of a CUDA graph of
  10 calls (the inputs stay in L2, as on the main path);
- ``bound_ms`` and ``bound_by``: the largest of q, k, v read and o written
  once at 3.35 TB/s, three bf16 MMA passes of the flops at 989 TFLOP/s, and
  the B·H·Sq·Sk exponentials at 3.9e12/s; ``share`` is ``bound_ms / ms``;
- ``roofline``: the flops counted once at 989 TFLOP/s or the bytes, over
  ``ms`` (what the benchmark's ``patch_attention_roofline`` counts);
- ``max_abs_err``: against ``ref.ref_attention`` (fp32 tolerance 1e-4), and
  ``emulated_err`` against ``ref.emulated_attention`` (the kernel's own
  3xbf16 rounding);
- ``routes``: ``patch_attention.launches_by_route`` over the shape's calls,
  where the tree counts them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
MMA_FLOPS = 989e12
EXP2_PER_S = 3.9e12
# (B, Sq, Sk, H, D): Sk None is self-attention over the Sq tokens
SHAPES = ([(1, S, None, 8, 40) for S in (4096, 9216, 16384)]
          + [(1, S, None, 8, 80) for S in (1024, 2304, 4096)]
          + [(1, S, None, 8, 160) for S in (256, 576, 1024)]
          + [(1, S, None, 16, 72) for S in (1024, 2304, 4096)]
          + [(1, 4096, 77, 8, 40), (1, 16384, 77, 8, 40), (1, 4096, 120, 16, 72),
             (1, 1024, 77, 8, 160)])


def cuda_ms(torch, fn, calls: int = 10, replays: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bounds(B: int, Sq: int, Sk: int, H: int, D: int) -> tuple:
    flops = 4.0 * B * H * Sq * Sk * D
    t_bytes = 4.0 * B * H * D * (2 * Sq + 2 * Sk) / HBM_BYTES_PER_S
    terms = {"bytes": t_bytes, "mma_3xbf16": 3 * flops / MMA_FLOPS,
             "exp": B * H * Sq * Sk / EXP2_PER_S}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term, max(flops / MMA_FLOPS, t_bytes) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.patch_attention import patch_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "src": args.src, "device": smi}), flush=True)
    gen = torch.Generator().manual_seed(0)
    for B, Sq, Sk, H, D in SHAPES:
        if Sk is None:
            q, k, v = torch.randn(B, Sq, 3, H, D, generator=gen).cuda().unbind(dim=2)
        else:
            q = torch.randn(B, Sq, H, D, generator=gen).cuda()
            k, v = torch.randn(B, Sk, 2, H, D, generator=gen).cuda().unbind(dim=2)
        Sk = k.shape[1]
        routes = getattr(patch_attention, "launches_by_route", None)
        before = dict(routes) if routes is not None else None
        got = patch_attention(q, k, v)
        err = float((got - ref.ref_attention(q, k, v)).abs().max())
        emu = float((got - ref.emulated_attention(q, k, v)).abs().max())
        ms = cuda_ms(torch, lambda: patch_attention(q, k, v))
        bms, term, roof_ms = bounds(B, Sq, Sk, H, D)
        row = dict(B=B, Sq=Sq, Sk=Sk, H=H, D=D, ms=ms, bound_ms=bms, bound_by=term,
                   share=bms / ms, roofline=roof_ms / ms, max_abs_err=err, emulated_err=emu)
        if before is not None:
            row["routes"] = {r: n - before[r] for r, n in routes.items()}
        print(json.dumps({"attention": row, "label": args.label}), flush=True)
        del q, k, v, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
