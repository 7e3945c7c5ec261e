"""One traced run of a cell that keeps every tick's ``TickEvents`` and reads
the device trace against the program's own spans.

    python3 gpubench/tick_probe.py --workload NAME --seed N [--seconds S] [--out FILE]

Runs like ``run.py --trace 1`` (set-up, lead-in, the window, the drain, the
traced stretch at the window's end) and prints one JSON line: the cell's
per-layer metrics; over the window's steps the mean of each ``tick.*``
phase and ``csp_ms``; over the traced stretch ``step_idle_share``, the
share of busy device time inside the ticks' spans beside the harness's own
``busy_in_ticks_s``, and every idle gap named after the innermost program
span open at its midpoint (the idle ms by name, and a tally of the gaps of
1 ms or more); the spans' host cost a
tick; and what ``torch.cuda.set_sync_debug_mode("warn")`` reports over a few
model steps. No reference check: ``run.py`` decides ``correct``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class Recorder:
    """The engine, with every ``TickEvents`` its ticks return kept in order."""

    def __init__(self, engine):
        self.engine, self.events = engine, []

    def tick(self, now):
        ev = self.engine.tick(now)
        self.events.append(ev)
        return ev

    def __getattr__(self, name):
        return getattr(self.engine, name)


def active_intervals(tracer):
    """The stretches in which the engine held an active request, from the
    harness's tick spans and flags (as ``Tracer.summary`` takes them)."""
    from gpubench.trace import union
    ticks = [(a, b) for a, b, n in sorted(tracer.spans) if n == "gpubench.tick"]
    out = []
    for i, ((a, b), (stepped, after)) in enumerate(zip(ticks, tracer.tick_flags)):
        if stepped:
            out.append((a, b))
        if after and i + 1 < len(ticks):
            out.append((b, ticks[i + 1][0]))
    return union(out)


def busy_intervals(tracer):
    import torch
    from gpubench.trace import union
    cuda = torch.autograd.DeviceType.CUDA
    return union([(e.start_ns() * 1e-9, e.end_ns() * 1e-9) for e in tracer.events
                  if e.device_type() == cuda and not e.is_user_annotation()])


def span_cost_ns(n: int = 20000) -> float:
    """Host ns to record one span, as a tick records it."""
    from repro_torch.core.serving import _close, span_clock
    spans = []
    t = span_clock()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        t = _close(spans, "tick.probe", t)
    return (time.perf_counter_ns() - t0) / n


def sync_debug(engine, traffic, steps: int = 3) -> dict:
    """Warnings that the sync debug mode raises over ``steps`` model steps of
    one request of each resolution (a synchronise or a blocking copy inside
    the step)."""
    import torch
    from repro_torch.core.requests import Request
    reqs = [Request(rid=20_000_000 + i, resolution=tuple(r), arrival=0.0, slo=1e9,
                    total_steps=traffic["steps"]) for i, r in enumerate(engine.resolutions)]
    for r in reqs:
        engine._prepare(r)
    torch.cuda.synchronize()
    per_step = []
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                engine._denoise_step(reqs)
                per_step.append(len(got) - sum(per_step))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = {}
    for w in got:
        k = f"{Path(w.filename).name}:{w.lineno}: {str(w.message)[:80]}"
        where[k] = where.get(k, 0) + 1
    return {"steps": steps, "warnings": len(got), "per_step": per_step,
            "where": sorted(where.items(), key=lambda kv: -kv[1])}


def probe(entry: dict, seed: int, seconds: float, device, t_start: float) -> dict:
    """The probe's result object for one run of ``entry`` (a ``manifest.cell``)."""
    import torch
    from gpubench import cell, manifest, serve, spans
    from gpubench.trace import Tracer, complement, intersect
    from gpubench.traffic import lead_in_s
    cuda = torch.device(device).type == "cuda"
    cfg, traffic = entry["cfg"], entry["traffic"]
    cell.set_precision(cfg)
    parts = serve.set_up(cfg, traffic, seconds, seed, device)
    Tracer.prime()
    engine = Recorder(parts["engine"])
    run = serve.Run(entry["name"], cfg, traffic, seconds, seed, time.perf_counter() - t_start)
    stretch = min(cell.TRACE_S, 0.4 * seconds)
    tracer = Tracer(time.perf_counter() + lead_in_s(traffic) + seconds - stretch, stretch)
    with torch.no_grad():
        serve.drive(engine, parts["arrivals"], parts["inputs"], run, tracer)
        run.profile = prof = tracer.summary()
        debug = sync_debug(engine.engine, traffic) if cuda else None
    in_window = {id(t) for t in run.window_ticks}
    window = [ev for ev, t in zip(engine.events, run.ticks) if id(t) in in_window]
    phases = {}
    for ev in window:
        for a, b, n in spans.tick_spans(ev):
            phases.setdefault(n, []).append(1e3 * (b - a))
    busy = busy_intervals(tracer)
    lo = tracer.t_stop_wall - (tracer.t_stop_pc - tracer.t_start_pc)
    traced = [ev for ev in engine.events
              if ev.spans and lo <= ev.spans[0].start_ns * 1e-9 < tracer.t_stop_wall]
    program = [s for ev in traced for s in spans.tick_spans(ev)]
    active = active_intervals(tracer)
    gaps = [g for a, b in (complement(busy, active[0][0], active[-1][1]) if active else [])
            for g in intersect([(a, b)], active)]
    named = spans.name_gaps(gaps, program, tracer.spans)
    tally, idle_ms = {}, {}
    for n, s in named:
        idle_ms[n] = idle_ms.get(n, 0.0) + 1e3 * s
        if s >= 1e-3:
            c, tot = tally.get(n, (0, 0.0))
            tally[n] = (c + 1, tot + 1e3 * s)
    per_span = span_cost_ns()
    stepping = [ev for ev in window if ev.stepped]
    spans_a_tick = sum(len(ev.spans) for ev in stepping) / max(len(stepping), 1)
    step_ms = 1e3 * sum(ev.dt for ev in stepping) / max(len(stepping), 1)
    return {
        "workload": entry["name"], "seed": seed, "seconds": seconds,
        "card": cell.card_state() if cuda else "none (CPU run)",
        "metrics": {k: v["value"]
                    for k, v in manifest.read_metrics(entry["per_layer"], run).items()},
        "csp_ms": spans.csp_ms(window),
        "step_idle_share": spans.step_idle_share(busy, traced, lo, tracer.t_stop_wall),
        "phase_ms_mean": {n: sum(v) / len(v) for n, v in phases.items()},
        "phase_ms_max": {n: max(v) for n, v in phases.items()},
        "window_steps": len(stepping), "step_ms": step_ms,
        "busy_s": prof["busy_s"], "busy_in_ticks_s": prof["busy_in_ticks_s"],
        "busy_in_tick_spans_pct": spans.busy_in_ticks_share(busy, traced),
        "idle_gaps": [[n, s] for n, s in named[:10]],
        "gaps_1ms_by_name": {n: {"count": c, "ms": ms} for n, (c, ms) in
                             sorted(tally.items(), key=lambda kv: -kv[1][1])},
        "idle_ms_by_name": dict(sorted(idle_ms.items(), key=lambda kv: -kv[1])),
        "span_ns": per_span, "spans_a_tick": spans_a_tick,
        "span_us_a_tick": per_span * spans_a_tick * 1e-3,
        "span_share_of_step_pct": 1e-4 * per_span * spans_a_tick / step_ms if step_ms else None,
        "sync_debug": debug,
        "total_s": time.perf_counter() - t_start,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "gpubench" / sub)
    import torch
    from gpubench import cell, manifest
    if not torch.cuda.is_available():
        cell.log("needs a CUDA card")
        return 2
    torch.cuda.set_device(0)
    out = probe(manifest.cell(args.workload), args.seed, args.seconds, "cuda", T_START)
    for k in ("busy_in_tick_spans_pct", "step_idle_share", "csp_ms", "span_us_a_tick"):
        cell.log(f"{k} {out[k]!r}")
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
