"""Roofline terms of a dry-run cell on H100s, the port of the reference's
``repro/launch/roofline.py``.

``python -m repro_torch.launch.roofline --shape train_4k`` reads the
single-mesh records that ``repro_torch.launch.dryrun`` wrote (per-device
flops, argument and output bytes and collective bytes of one step on the
16x16 mesh) and turns each into three times, the step taking at least the
largest:

    compute_s = flops / PEAK_FLOPS
    memory_s = (argument + output - alias bytes) / HBM_BW
    collective_s = collective bytes / LINK_BW

``memory_s`` is a floor: each argument read once and each output written
once, an output written in place into an argument (a decode step's cache)
counted with the argument. The reference divides XLA's ``bytes accessed``
(its estimate after fusion) instead; the port has no fused program to
count, and the eager op traffic of the dry-run (``bytes_eager``, kept in
``per_device``) depends on the torch version and on no fusion, so it stays
out of the terms, ``dominant`` and ``roofline_frac``.

The dry-run's eager trace counts every period of layers (or extrapolates
from one and two periods, exactly), so the reference's correction for an
XLA ``while`` body counted once (``raw + (trips - 1) * per_trip``) has no
counterpart here. ``model_flops`` is the reference's 6·N·D (train) or
2·N_active·D (serving), on the abstract params.

Constants, per H100 SXM card:
- PEAK_FLOPS: 989e12 dense bf16 flop/s (NVIDIA H100 data sheet, SXM, without
  sparsity; at the full 700 W power limit);
- HBM_BW: 3.35e12 B/s of HBM3 (the same data sheet);
- LINK_BW: 50e9 B/s, the per-GPU link that a 16-wide mesh axis crosses: it
  spans two 8-GPU nodes, and a DGX H100 node has one 400 Gb/s NDR InfiniBand
  port (ConnectX-7) per GPU (NVIDIA DGX H100 data sheet), so a ring over
  the axis runs at that port's 50 GB/s each way, not at NVLink's 450 GB/s
  inside the node.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch import steps as steps_mod

PEAK_FLOPS = 989e12        # bf16 dense, per H100 SXM
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 50e9             # bytes/s per GPU across nodes (400 Gb/s NDR)


def model_flops(cfg, shape) -> float:
    """6·N·D train / 2·N_active·D_step decode, N_active for MoE."""
    params_abs, _ = steps_mod.abstract_params(cfg)

    def leaves_under(tree, pred, path=()):
        if isinstance(tree, dict):
            return sum(leaves_under(v, pred, path + (k,)) for k, v in tree.items())
        return tree.numel() if pred(path, tree) else 0

    total = leaves_under(params_abs, lambda p, leaf: True)
    embed = leaves_under(params_abs,
                         lambda p, leaf: p[-1] in ("embed", "lm_head", "pos_embed"))
    expert = leaves_under(
        params_abs,
        lambda p, leaf: "ffn" in p and leaf.dim() == 4
        and p[-1] in ("w_gate", "w_up", "w_down"))
    n_eff = total - embed - expert
    if cfg.n_experts:
        n_eff += expert * cfg.moe_top_k / cfg.n_experts
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill")
                                   else 1)
    if shape.kind == "train":
        return 6.0 * n_eff * tokens
    return 2.0 * n_eff * tokens


def analyze_cell(arch: str, shape_name: str, results_dir: Path,
                 config_override=None) -> Optional[Dict]:
    cfg = config_override or ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, _ = shape_applicable(cfg, shape)
    if not ok:
        return None
    rec = json.loads((results_dir / f"{arch}__{shape_name}__single.json").read_text())
    mem = rec["memory"]
    total = {"flops": rec["cost"]["flops"],
             "bytes": float(mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                            - mem["alias_size_in_bytes"]),
             "bytes_eager": rec["cost"]["bytes_eager"],
             "coll": rec["collectives"]["total_bytes"]}
    n_dev = rec["devices"]
    compute_s = total["flops"] / PEAK_FLOPS
    memory_s = total["bytes"] / HBM_BW
    coll_s = total["coll"] / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name, "mesh": "single",
        "per_device": total, "raw_flops": total["flops"],
        "terms_s": terms, "dominant": dominant,
        "model_flops": mf, "useful_flops_ratio": mf / max(total["flops"] * n_dev, 1.0),
        "roofline_frac": compute_s / max(compute_s, memory_s, coll_s),
        "step_s_bound": max(terms.values()),
        "memory_bytes": mem,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--results", default="build/dryrun_results")
    ap.add_argument("--out", default="build/roofline_results.json")
    args = ap.parse_args(argv)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    rows = []
    for a in archs:
        for s in shapes:
            try:
                r = analyze_cell(a, s, Path(args.results))
            except Exception as e:
                print(f"FAIL {a} {s}: {e}")
                continue
            if r is None:
                continue
            rows.append(r)
            t = r["terms_s"]
            print(f"{a:18s} {s:12s} comp={t['compute_s']:.4f}s "
                  f"mem={t['memory_s']:.4f}s coll={t['collective_s']:.4f}s "
                  f"dom={r['dominant']:12s} useful={r['useful_flops_ratio']:.2f}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"wrote {args.out} ({len(rows)} cells)")


if __name__ == "__main__":
    main()
