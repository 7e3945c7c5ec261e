"""Scheduler demo (sim clock): sweep QPS and compare PatchedServe's
SLO-aware scheduling against FCFS (Mixed-Cache) and a same-resolution-only
baseline that cannot batch across resolutions (NIRVANA-like) — the paper's
Fig. 12 shape in seconds, no model execution needed.

    PYTHONPATH=src python -m repro_torch.examples.slo_scheduler_demo --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.examples.common import sim_engine, workload

QPS = (4.0, 8.0, 16.0, 24.0, 32.0)
DURATION = 40.0
# (name, sim_engine arguments) of the three arms
ARMS = (("patchedserve", dict(policy="slo")),
        ("mixed_cache", dict(policy="fcfs")),
        ("nirvana", dict(policy="fcfs", same_res=True, mixed_batching=False)))


def rows(qps_list=QPS, duration=DURATION, device=None) -> list:
    """One row per QPS: ``(qps, slo satisfaction of each arm...)``, each
    arm on workload seed 1."""
    out = []
    for qps in qps_list:
        row = [qps]
        for _, kw in ARMS:
            eng = sim_engine(**kw, device=device)
            row.append(eng.run(workload(eng, qps, duration=duration, seed=1)).slo_satisfaction)
        out.append(tuple(row))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)
    print(f"{'qps':>6} {'patchedserve':>14} {'mixed_cache':>12} {'nirvana':>9}")
    out = rows(device=args.device)
    for qps, slo, fcfs, same in out:
        print(f"{qps:6.1f} {slo:14.3f} {fcfs:12.3f} {same:9.3f}")
    print("\nSLO-aware + mixed-resolution batching sustains load the baselines drop.")
    return out


if __name__ == "__main__":
    main()
