"""One run of one cell, from set-up to the result line's object. ``run.py``
checks for the card first; tests call ``run_cell`` on the CPU."""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

from gpubench import check, manifest, serve
from gpubench.trace import Tracer
from gpubench.traffic import lead_in_s

# the traced stretch: the window's last TRACE_S seconds (at most 40% of it)
TRACE_S = 8.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def card_state() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_precision(cfg: dict) -> None:
    """float32 with TF32 off, as every configuration states."""
    if cfg["precision"] != "float32, TF32 off":
        raise ValueError(f"unsupported precision {cfg['precision']!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_cell(entry: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """The result object of one run (``checks`` last), after logging the
    counts, the generator's lateness and every number compared to stderr."""
    cfg, traffic = entry["cfg"], entry["traffic"]
    cuda = torch.device(device).type == "cuda"
    set_precision(cfg)
    parts = serve.set_up(cfg, traffic, seconds, seed, device)
    prime_s = Tracer.prime() if trace else (0.0, 0.0)
    setup_s = time.perf_counter() - t_start
    engine = parts["engine"]
    run = serve.Run(entry["name"], cfg, traffic, float(seconds), seed, setup_s)
    tracer = None
    if trace:
        stretch = min(TRACE_S, 0.4 * seconds)
        tracer = Tracer(time.perf_counter() + lead_in_s(traffic) + seconds - stretch, stretch)
    with torch.no_grad():
        serve.drive(engine, parts["arrivals"], parts["inputs"], run, tracer)
    run.profile = tracer.summary([t.events for t in run.ticks]) if tracer is not None else None
    for s in run.served:
        s.image = engine.outputs.get(s.arrival.index)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"card: {card_state() if cuda else 'none (CPU run)'}")
    counted = run.counted
    log(f"submitted {len(run.served)}; window {len(counted)}: completed "
        f"{sum(s.done is not None for s in counted)}, dropped "
        f"{sum(s.dropped is not None for s in counted)}, in flight at the end "
        f"{sum(s.done is None and s.dropped is None for s in counted)}, met "
        f"{sum(s.met for s in counted)}; steps {len(run.window_ticks)} in the window")
    log("window misses (due s, latent side, how): " + ", ".join(
        f"({s.arrival.due:.2f}, {s.arrival.res[0]}, "
        f"{'dropped' if s.dropped is not None else 'late' if s.done is not None else 'unfinished'})"
        for s in counted if not s.met))
    late = np.asarray(run.lateness) * 1e3
    if late.size:
        log(f"generator lateness ms: median {np.median(late):.3f} p99 "
            f"{np.percentile(late, 99):.3f} max {late.max():.3f}")
    metrics = manifest.read_metrics(entry["per_layer"] if trace else entry["end_to_end"], run)
    picks = check.draw_sample(run, traffic["check"]["per_resolution"])
    served = {s.arrival.index: {"latent": s.request.latent, "image": s.image} for s in picks}
    del parts, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.run_checks(run, served, [s.arrival.index for s in picks], device)
    check_s = time.perf_counter() - t_check
    log(f"reference check of {len(picks)} requests "
        f"{sorted({s.arrival.res for s in picks})} in {check_s:.1f} s")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": check.correct(checks), "attempted": len(counted),
              "failed": checks["failed"]["value"],
              "metrics": metrics, "device": dev}
    if run.profile is not None:
        p = run.profile
        dev["busy_s"], dev["window_s"] = p["busy_s"], p["window_s"]
        result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
        log(f"trace: {p['ticks']} ticks, busy {p['busy_s']:.4f} s of {p['window_s']:.4f} s "
            f"({p['busy_in_ticks_s']:.4f} s inside ticks), "
            f"active {p['active_s']:.4f} s, {len(p['attention_calls'])} attention and "
            f"{len(p['gn_calls'])} GN-stitch calls; starting the profiler held the loop "
            f"{p['start_s']:.3f} s, collecting its events after the drain took {p['stop_s']:.3f} s")
        recorded, launched = p["call_counts"]["attention_calls"]
        log(f"attention calls recorded {recorded}, wrapper launches {launched}"
            + ("" if recorded == launched else ": they differ, so patch_attention_roofline "
               "is left out"))
    log(f"run phases s: set-up {setup_s:.1f} (profiler first start {prime_s[0]:.1f}, "
        f"stop {prime_s[1]:.1f}), lead-in {lead_in_s(traffic):.1f}, window {seconds:g}, "
        f"drain {run.t_end - run.t_open - seconds:.1f}, trace collection "
        f"{run.profile['stop_s'] if run.profile else 0.0:.1f}, check {check_s:.1f}, "
        f"total {time.perf_counter() - t_start:.1f}")
    for k, v in metrics.items():
        log(f"metric {k} {v['value']!r} {v['unit']}")
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result
