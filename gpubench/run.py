"""Run one cell of the benchmark once and print its result as the last line.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout holding ``BENCHMARK.json``, ``gpubench/`` and
the program under ``src/repro_torch``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced run.
Needs the CUDA card: without it, or with fewer cards than the cell asks
for, it exits 2 and prints no result; it exits 3 if JAX or the JAX package
was loaded. Build outputs stay inside the checkout, under ``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "gpubench" / sub)
    from gpubench import cell, manifest
    entry = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        cell.log(f"needs {entry['chips']} CUDA card(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.set_device(0)
    result = cell.run_cell(entry, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = cell.forbidden_modules()
    if bad:
        cell.log(f"loaded JAX or the JAX package: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
