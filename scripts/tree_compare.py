#!/usr/bin/env python3
"""Time the main path's two kernel rows and the public-width engine steps of
a given checkout on one NVIDIA GPU, with that checkout's own code.

    python3 scripts/tree_compare.py [--root PATH] [--label NAME]

``--root`` is the checkout to measure (default: this one). Unpack another
commit beside it (``git archive``) and run both in one command, in turns
(parent, change, change, parent), to compare them on one card. It calls
only functions of the checkout's ``chip_smoke.py`` that every version since
the public-width phase has: ``phase_device`` (which builds the kernels),
``attention_row`` and ``gn_rows`` (phase 2), and ``heads_timing`` on the
PixArt-α- and SD 1.5-shaped models (phase 11). Prints one JSON line:
the attention kernel's ms at B=2 S=4096 H=4 D=32 fp32, the whole
GroupNorm+stitch call's ms at level 0 (P=29, p=32, C=128, fp32, exact), and
each model's engine step ms through the kernels and through the plain route
(median of 5 in turns).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout to measure")
    ap.add_argument("--label", default="this", help="a name for the output line")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    import chip_smoke as cs      # puts the checkout's src/ first on sys.path
    if not torch.cuda.is_available():
        print("tree_compare: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.phase_device()
    gen = torch.Generator().manual_seed(0)
    attn = cs.attention_row(dev, gen, 2, 4096, 4, 32, torch.float32)
    gn = [r for r in cs.gn_rows(dev, gen, 0, 128, cs.CHIP_RES, 32, torch.float32, (True,))]
    heads = {}
    for cfg in (cs.PIXART_ALPHA, cs.SD15):
        params = cs.init_diffusion(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        kernel_ms, plain_ms = cs.heads_timing(dev, cfg, params)
        heads[cfg.name] = {"kernels_ms": kernel_ms, "plain_ms": plain_ms}
        del params
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": str(args.root), "device": smi,
                      "attention_ms": attn["ms"], "gn_stitch_ms": gn[0]["ms"],
                      "heads": heads}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
