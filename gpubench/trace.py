"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` recording
device activity only, over a few seconds inside the window that start and
end between engine ticks (each of which ends in a device synchronise), with
the benchmark's own spans around its calls into the engine (host wall
clock, the profiler's time base), the program's own spans of each tick
(``TickEvents.spans``, on the same clock) and a record of the shape of
every call into the two CUDA kernels' entry points.

The shapes are recorded by swapping
``repro_torch.models.diffusion.grouped_attention_kernel`` and
``fused_groupnorm_stitch`` for recorders, so an attention that reaches the
kernel by another name is not seen. The attention recorder checks itself:
its count of calls over the stretch against the change in the wrapper's own
counter (``repro_torch.kernels.patch_attention.patch_attention.launches``);
where the two differ, ``patch_attention_roofline`` is left out rather than
read from part of the calls.

Starting the profiler the first time and collecting its events each hold
the host for seconds, so set-up starts and stops it once (``prime``), and
the profiler stays on from the stretch's start until the run's drain has
ended (``stop``); events after the stretch are dropped. The stretch ends
where the window closes, so that only the stretch and the drain are
collected. (Turning device recording off at the stretch's end drops every
event of the stretch: busy 0 s on an H100 with torch 2.11.) Host
operators are not recorded. Nothing is written to disk: the trace is
reduced in memory to kernel times, the device's busy and idle time, and
the breakdown."""
from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# the benchmark's spans, as the breakdown names what the host was doing
SPAN_NAMES = {"gpubench.tick": "engine.tick", "gpubench.idle": "harness.wait_for_arrivals"}
OTHER_SPAN = "harness.loop"


def kernel_base(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return base.rsplit("::", 1)[-1] if base else name[:80]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def intersect(xs, ys) -> List[Tuple[float, float]]:
    """Intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(xs, lo: float, hi: float) -> List[Tuple[float, float]]:
    out, cur = [], lo
    for a, b in xs:
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _attention_wrapper():
    """The program's attention wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.patch_attention import patch_attention
    return patch_attention


def _activities() -> list:
    return [torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
            else torch.profiler.ProfilerActivity.CPU]


class Tracer:
    """Profiles from ``start`` (perf_counter) for ``seconds``, at tick boundaries."""

    def __init__(self, start: float, seconds: float):
        self.start_at, self.seconds = start, seconds
        self.prof = None
        self.done = self.ended = False
        self.t_start_pc = self.t_stop_pc = 0.0
        self.attention_calls: List[Tuple[int, ...]] = []
        self.gn_calls: List[Tuple[int, ...]] = []
        self.tick_flags: List[Tuple[bool, bool]] = []   # (stepped, still active after)
        self._patched: Dict[str, object] = {}
        self.spans: List[Tuple[float, float, str]] = []   # wall-clock seconds
        self.launches = [0, 0]     # the attention wrapper's counter at the stretch's ends

    @staticmethod
    def prime() -> Tuple[float, float]:
        """Start and stop the profiler once, outside any measurement; the
        seconds that starting and stopping took."""
        t0 = time.perf_counter()
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof.__exit__(None, None, None)
        return t1 - t0, time.perf_counter() - t1

    def maybe_toggle(self, now: float) -> None:
        if self.done or self.ended:
            return
        if self.prof is None and now >= self.start_at:
            self._start()
        elif self.prof is not None and now >= self.t_start_pc + self.seconds:
            self._end_stretch()

    @property
    def recording(self) -> bool:
        return self.prof is not None and not self.ended

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.recording:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0 * 1e-9, time.time_ns() * 1e-9, name))

    def note_tick(self, stepped: bool, active_after: bool) -> None:
        if self.recording:
            self.tick_flags.append((stepped, active_after))

    def _start(self) -> None:
        t0 = time.perf_counter()
        from repro_torch.models import diffusion
        attn, gn = diffusion.grouped_attention_kernel, diffusion.fused_groupnorm_stitch

        def rec_attn(q, k, v):
            self.attention_calls.append((*q.shape, k.shape[1], q.element_size()))
            return attn(q, k, v)

        def rec_gn(csp, patches, *a, **kw):
            self.gn_calls.append((*patches.shape, a[2] if len(a) > 2 else kw["groups"],
                                  patches.element_size()))
            return gn(csp, patches, *a, **kw)

        self._patched = {"grouped_attention_kernel": attn, "fused_groupnorm_stitch": gn}
        diffusion.grouped_attention_kernel, diffusion.fused_groupnorm_stitch = rec_attn, rec_gn
        self.launches[0] = _attention_wrapper().launches
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.__enter__()
        self.t_start_pc = time.perf_counter()
        self.start_s = self.t_start_pc - t0

    def _end_stretch(self) -> None:
        """The stretch ends here; the profiler runs on until ``stop``."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop_pc = time.perf_counter()
        self.t_stop_wall = time.time_ns() * 1e-9
        self.launches[1] = _attention_wrapper().launches
        from repro_torch.models import diffusion
        for name, fn in self._patched.items():
            setattr(diffusion, name, fn)
        self.ended = True

    def stop(self) -> None:
        """After the run's drain: collect the events of the stretch."""
        if self.prof is None:
            return
        if not self.ended:
            self._end_stretch()
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.events = [e for e in self.prof.profiler.kineto_results.events()
                       if e.start_ns() * 1e-9 < self.t_stop_wall]
        self.stop_s = time.perf_counter() - t0
        self.prof = None
        self.done = True

    def summary(self, tick_events: Iterable = ()) -> Optional[dict]:
        """Kernel seconds by name, the kernels' call shapes, busy and idle
        time, and the breakdown, whose idle gaps are named by the innermost
        program span of ``tick_events`` (the run's ``TickEvents``) open at
        each; None if the stretch never started."""
        if not self.done:
            return None
        gpu = []
        cuda = torch.autograd.DeviceType.CUDA
        kernel_s: Dict[str, float] = {}
        for e in self.events:
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            gpu.append((a, b))
            base = kernel_base(e.name())
            kernel_s[base] = kernel_s.get(base, 0.0) + (b - a)
        spans = sorted(self.spans)
        busy = union(gpu)
        ticks = [(a, b) for a, b, n in spans if n == "gpubench.tick"]
        active = []
        for i, ((a, b), (stepped, after)) in enumerate(zip(ticks, self.tick_flags)):
            if stepped:
                active.append((a, b))
            if after and i + 1 < len(ticks):
                active.append((b, ticks[i + 1][0]))
        active = union(active)
        from gpubench.spans import name_gaps, tick_spans
        lo, hi = (active[0][0], active[-1][1]) if active else (0.0, 0.0)
        program = [sp for ev in tick_events for sp in tick_spans(ev)
                   if sp[1] >= lo and sp[0] <= hi]
        gaps = name_gaps([g for a, b in (complement(busy, lo, hi) if active else [])
                          for g in intersect([(a, b)], active)], program, spans)
        return {
            "kernel_s": kernel_s,
            "attention_calls": self.attention_calls,
            "gn_calls": self.gn_calls,
            # {calls' key: (calls recorded, the wrapper's launches)} over the stretch
            "call_counts": {"attention_calls": (len(self.attention_calls),
                                                self.launches[1] - self.launches[0])},
            "busy_s": length(busy),
            "window_s": self.t_stop_pc - self.t_start_pc,
            "active_s": length(active),
            "busy_in_active_s": length(intersect(busy, active)),
            # how well the two clocks line up: device work happens inside ticks
            "busy_in_ticks_s": length(intersect(busy, union(ticks))),
            "ticks": len(ticks),
            "start_s": self.start_s,
            "stop_s": self.stop_s,
            "idle_gaps": [[n, s] for n, s in gaps[:10]],
            "device_ops": [[n, s] for n, s in sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]],
        }
