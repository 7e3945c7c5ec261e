"""What the program's own spans give the benchmark.

The program stamps each request with ``Request.admitted`` (the tick's
``now``, on the harness's clock) and keeps its ``tick.decode`` span on
``Request.decode_span``; every tick returns its host phases on
``TickEvents.spans`` (``Span(name, start_ns, end_ns, rid)`` on the wall
clock, the device trace's time base). The readers of ``queue_wait_ms`` and
``decode_ms`` take the request fields from a finished ``serve.Run``. The
trace reductions below take the ``TickEvents`` of the ticks and the
device's busy intervals (wall-clock seconds): ``tick_probe.py`` prints
them. Every function returns None where the program records nothing, as a
program without the spans does.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from gpubench.trace import OTHER_SPAN, SPAN_NAMES, intersect, length, union

Interval = Tuple[float, float]
# the phases whose host work lays out and gathers the CSP batch
CSP_PHASES = ("tick.split", "tick.merge")


def queue_wait_ms(run) -> Optional[float]:
    """Mean over the window's admitted requests of admission - due time."""
    waits = [s.request.admitted - s.due for s in run.counted
             if getattr(s.request, "admitted", None) is not None]
    return 1e3 * sum(waits) / len(waits) if waits else None


def decode_ms(run) -> Optional[float]:
    """Mean over the window's completed requests of their ``tick.decode``."""
    spans = [getattr(s.request, "decode_span", None) for s in run.counted if s.done is not None]
    spans = [d for d in spans if d is not None]
    return 1e-6 * sum(d.end_ns - d.start_ns for d in spans) / len(spans) if spans else None


def tick_spans(ev) -> list:
    """A tick's spans as (start s, end s, name), or [] without spans."""
    return [(s.start_ns * 1e-9, s.end_ns * 1e-9, s.name) for s in getattr(ev, "spans", ())]


def csp_ms(events: Iterable) -> Optional[float]:
    """Mean over the stepping ticks of ``tick.split`` + ``tick.merge``."""
    per = [sum(b - a for a, b, n in spans if n in CSP_PHASES)
           for spans in map(tick_spans, events) if any(n == "tick.split" for _, _, n in spans)]
    return 1e3 * sum(per) / len(per) if per else None


def step_intervals(events: Iterable) -> List[Interval]:
    """Each stepping tick's interval from ``tick.split``'s start to
    ``tick.sync``'s end."""
    out = []
    for ev in events:
        d = {n: (a, b) for a, b, n in tick_spans(ev)}
        if "tick.split" in d and "tick.sync" in d:
            out.append((d["tick.split"][0], d["tick.sync"][1]))
    return out


def step_idle_share(busy: List[Interval], events: Iterable, lo: float,
                    hi: float) -> Optional[float]:
    """Per cent of the step intervals inside [lo, hi] with nothing running
    on the device; ``busy`` is sorted and disjoint."""
    steps = intersect(union(step_intervals(events)), [(lo, hi)])
    total = length(steps)
    return 100.0 * (1.0 - length(intersect(busy, steps)) / total) if total > 0 else None


def busy_in_ticks_share(busy: List[Interval], events: Iterable) -> Optional[float]:
    """Per cent of the device's busy time that lies inside a tick's spans."""
    spans = union([(a, b) for ev in events for a, b, _ in tick_spans(ev)])
    total = length(busy)
    return 100.0 * length(intersect(busy, spans)) / total if spans and total > 0 else None


def name_at(t: float, program: List[Tuple[float, float, str]],
            harness: List[Tuple[float, float, str]]) -> str:
    """The innermost program span open at ``t``; where none is, the
    harness's span open there (as ``trace.SPAN_NAMES`` names it), else
    ``trace.OTHER_SPAN``."""
    open_ = [(b - a, n) for a, b, n in program if a <= t <= b]
    if open_:
        return min(open_)[1]
    return next((SPAN_NAMES[n] for a, b, n in harness if a <= t <= b), OTHER_SPAN)


def name_gaps(gaps: List[Interval], program, harness) -> List[Tuple[str, float]]:
    """Each idle gap as (the name at its midpoint, its seconds), longest first."""
    out = [(name_at(0.5 * (a + b), program, harness), b - a) for a, b in gaps]
    return sorted(out, key=lambda g: -g[1])
