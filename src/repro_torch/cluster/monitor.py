"""Fleet health monitor — streaming windowed metrics, SLO error-budget
burn-rate alerting, and online anomaly detection.

The tracer (``trace.py``) explains an SLO miss *after* the run: attribution and the
predictor report are terminal snapshots. This module closes the loop
while the sim is still running. ``FleetMonitor`` subscribes to the
tracer's event bus (``Tracer.subscribe``) and folds every event into
sim-clock-windowed timeseries — counters, gauges, and mergeable
histograms — one bin per ``MonitorConfig.window`` seconds, covering all
subsystems: router holds/gangs (``batcher.py``), tier bytes + hit rates
(``cachetier.py``), spawn/retire/crash/escalation
(``autoscaler.py``/``router.py``), zone health and checkpoint overhead
(``driver.py``). On top of the timeseries:

- **SLO error-budget burn-rate alerting** (SRE-style): with
  ``slo_target`` = the fraction of finished requests that must meet
  their SLO, the error budget is ``1 - slo_target``; the *burn rate*
  over a trailing window is ``miss_fraction / (1 - slo_target)`` (1.0 =
  burning exactly the budget). Each ``AlertRule`` fires when the burn
  rate clears its threshold in **both** a short and a long trailing
  window — the short window makes the alert fast, the long window makes
  it robust to blips. Every fired alert carries the **dominant latency
  component** of the violating spans inside the alert's window, so an
  alert reads "budget burning 4x in 3s/12s windows, dominated by
  ``requeue_wait``".

- **Online changepoint detection** (EWMA + two-sided CUSUM) on
  configurable per-window signals (queue depth, SLO miss rate, tier hit
  rate, ...). A detection emits an ``anomaly`` event back onto the bus
  (retained in every trace mode) and is counted per signal in
  ``summary()``.

- **Exporters**: a Prometheus text-exposition snapshot
  (``prometheus_text``), a JSONL health log (``write_jsonl`` — one
  ``window`` record per closed bin plus the alert/anomaly log; rendered
  offline by ``scripts/fleet_dashboard.py``).

**Windows close immutably.** The driver calls ``pulse(now, ...)`` at the
end of each event-loop iteration, after every event for sim-time ``now``
has been delivered. Event timestamps never precede the previous
iteration's clock, so once the clock enters bin ``b`` every bin ``< b``
can no longer receive events. Alert rules and changepoints therefore
evaluate **closed bins only** — which makes each alert's dominant
component *exactly* reproducible post-hoc: recomputing the dominant over
the tracer's finished spans restricted to the alert's recorded bin range
(``dominant_over_spans``) matches the streamed value by construction
(asserted per-alert by ``cluster_sweep --monitor``).

Like tracing, monitoring is **zero-cost when off**: ``ClusterConfig
.monitor=None`` constructs nothing and the driver's per-event work is
one ``is not None`` check; headline metrics are bit-identical with the
monitor on or off (asserted in tests).
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.trace import COMPONENTS, Tracer

__all__ = [
    "AlertRule", "MonitorConfig", "FleetMonitor", "WindowedHistogram",
    "default_rules", "bin_of", "dominant_component", "dominant_over_spans",
]


# ---------------------------------------------------------------------------
# shared pure helpers (the sweep's post-hoc recompute uses these too, so the
# streamed and recomputed dominants can never diverge on tie-breaks)
# ---------------------------------------------------------------------------

def bin_of(t: float, window: float) -> int:
    """Window-bin index of sim instant ``t`` (bin ``i`` covers
    ``[i*window, (i+1)*window)``)."""
    return int(math.floor(t / window))


def dominant_component(counts: Counter) -> str:
    """Deterministic argmax over a dominant-component histogram: highest
    count wins, ties broken by ``COMPONENTS`` declaration order.
    ``"none"`` when the histogram is empty."""
    best, best_n = "none", 0
    for comp in COMPONENTS:
        n = counts.get(comp, 0)
        if n > best_n:
            best, best_n = comp, n
    return best


def dominant_over_spans(spans: Sequence, lo_bin: int, hi_bin: int,
                        window: float) -> str:
    """Post-hoc dominant latency component of the SLO-violating spans
    (missed or dropped) that *finished* inside bins ``[lo_bin, hi_bin]``
    — the exact recompute of a fired alert's ``dominant`` field from
    ``Tracer.finished``."""
    counts: Counter = Counter()
    for s in spans:
        if s.end is None:
            continue
        if s.outcome == "dropped" or not s.slo_met:
            if lo_bin <= bin_of(s.end, window) <= hi_bin:
                counts[s.dominant()] += 1
    return dominant_component(counts)


# ---------------------------------------------------------------------------
# mergeable histogram
# ---------------------------------------------------------------------------

class WindowedHistogram:
    """Fixed-bound bucket histogram; the per-window latency aggregate.

    Merging adds bucket counts elementwise, so merge is associative,
    commutative, and order-independent (property-tested) — per-window
    histograms fold into per-alert or whole-run views without rescanning
    samples. ``bounds`` are the inclusive upper edges of the finite
    buckets; one overflow bucket catches the rest."""

    __slots__ = ("bounds", "counts", "sum", "n")

    def __init__(self, bounds: Sequence[float]):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"bounds must be strictly increasing: {bounds}")
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, x: float) -> None:
        # bucket i holds values <= bounds[i] (Prometheus ``le`` semantics):
        # the first bound >= x is exactly x's bucket; past the last bound
        # the index lands on the overflow bucket
        self.counts[bisect_left(self.bounds, x)] += 1
        self.sum += x
        self.n += 1

    def merge(self, other: "WindowedHistogram") -> "WindowedHistogram":
        """Pure merge — returns a new histogram, operands untouched."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}")
        out = WindowedHistogram(self.bounds)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.sum = self.sum + other.sum
        out.n = self.n + other.n
        return out

    def quantile(self, q: float) -> float:
        """Bucket-upper-edge quantile estimate (inf bucket reports the
        largest finite bound)."""
        if self.n == 0:
            return 0.0
        rank = q * self.n
        run = 0
        for i, c in enumerate(self.counts):
            run += c
            if run >= rank:
                return self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
        return self.bounds[-1]

    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": round(self.sum, 6), "n": self.n}

    def __eq__(self, other) -> bool:
        return isinstance(other, WindowedHistogram) \
            and self.bounds == other.bounds \
            and self.counts == other.counts \
            and abs(self.sum - other.sum) < 1e-9 and self.n == other.n


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AlertRule:
    """One multi-window burn-rate rule (SRE style: fast rules page on
    sharp burns, slow rules on sustained ones).

    A rule is armed only once its long window has fully elapsed — a burn
    estimate over a fraction of the window is dominated by a handful of
    requests and pages on startup transients, not incidents."""
    name: str                  # rule id (label on alerts + Prometheus)
    short_window: float = 3.0  # s (sim) — fast trailing window
    long_window: float = 12.0  # s (sim) — slow trailing window (>= short)
    burn_rate: float = 4.0     # fire when burn >= this multiple of the
    #                            error budget in BOTH windows (1.0 =
    #                            burning exactly the budget)
    repeat: float = 5.0        # s (sim) between refires while the rule
    #                            stays active (so long incidents keep
    #                            producing alert evidence)

    def __post_init__(self) -> None:
        if self.short_window <= 0 or self.long_window < self.short_window:
            raise ValueError(
                f"need 0 < short_window <= long_window, got "
                f"{self.short_window}/{self.long_window}")
        if self.burn_rate <= 0:
            raise ValueError("burn_rate must be > 0")
        if self.repeat <= 0:
            raise ValueError("repeat must be > 0")


def default_rules() -> Tuple[AlertRule, ...]:
    """The stock rule pair: a fast page on sharp burns and a slower,
    lower-threshold rule for sustained budget bleed."""
    return (
        AlertRule("fast_burn", short_window=3.0, long_window=12.0,
                  burn_rate=4.0, repeat=5.0),
        AlertRule("slow_burn", short_window=6.0, long_window=24.0,
                  burn_rate=2.0, repeat=10.0),
    )


@dataclass
class MonitorConfig:
    """Fleet-monitor knobs. Every field unit-documented."""
    window: float = 1.0            # s (sim) — width of one aggregation bin
    slo_target: float = 0.9        # fraction of finished requests that
    #                                must meet their SLO; error budget is
    #                                1 - slo_target
    rules: Tuple[AlertRule, ...] = ()   # burn-rate alert rules; empty ()
    #                                     installs default_rules()
    min_done: int = 4              # requests (finished, long window) — a
    #                                rule never fires on fewer samples
    #                                (guards cold-start noise)
    signals: Tuple[str, ...] = (   # per-window signals watched by the
        "queue_depth",             # changepoint detectors: any counter
        "slo_miss_rate",           # key, the two rate signals
        "escalations",             # (slo_miss_rate, tier_hit_rate), or
    )                              # the gauges (queue_depth, replicas)
    ewma_alpha: float = 0.3        # EWMA smoothing weight in (0, 1] for
    #                                the per-signal mean/variance baseline
    cusum_k: float = 0.5           # CUSUM slack, in baseline std-devs —
    #                                drift below this is never accumulated
    cusum_h: float = 4.0           # CUSUM decision threshold, in
    #                                std-devs of accumulated drift
    min_windows: int = 5           # closed windows of warmup before a
    #                                changepoint may fire
    min_std: float = 1e-3          # floor (signal units) on the baseline
    #                                std-dev, so flat signals don't turn
    #                                any wiggle into infinite z-scores
    incident_horizon: float = 8.0  # s (sim) after an injected fault
    #                                (crash / zone outage end) still
    #                                counted as inside the incident for
    #                                precision/recall accounting
    latency_buckets: Tuple[float, ...] = (
        0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
    #                              # s — finite upper edges of the
    #                                per-window latency histogram (one
    #                                overflow bucket is added on top)

    def __post_init__(self) -> None:
        if self.window <= 0:
            raise ValueError(f"window must be > 0, got {self.window}")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError(
                f"slo_target must be in (0, 1), got {self.slo_target}")
        if not self.rules:
            self.rules = default_rules()
        if self.min_done < 1:
            raise ValueError("min_done must be >= 1")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.cusum_k < 0 or self.cusum_h <= 0:
            raise ValueError("need cusum_k >= 0 and cusum_h > 0")
        if self.min_windows < 1:
            raise ValueError("min_windows must be >= 1")
        if self.min_std <= 0:
            raise ValueError("min_std must be > 0")
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")


# ---------------------------------------------------------------------------
# changepoint detector
# ---------------------------------------------------------------------------

class _Changepoint:
    """EWMA baseline + two-sided CUSUM over one per-window signal."""

    __slots__ = ("cfg", "mean", "var", "n", "gp", "gm")

    def __init__(self, cfg: MonitorConfig):
        self.cfg = cfg
        self.mean = 0.0
        self.var = 0.0
        self.n = 0          # windows folded into the baseline
        self.gp = 0.0       # upward CUSUM statistic
        self.gm = 0.0       # downward CUSUM statistic

    def update(self, x: float) -> Optional[str]:
        """Fold one closed-window value; returns ``"up"``/``"down"`` when
        the accumulated drift crosses the decision threshold (the
        statistic then resets and re-arms), else None."""
        cfg = self.cfg
        fired: Optional[str] = None
        if self.n >= cfg.min_windows:
            sd = max(math.sqrt(max(self.var, 0.0)), cfg.min_std)
            z = (x - self.mean) / sd
            self.gp = max(0.0, self.gp + z - cfg.cusum_k)
            self.gm = max(0.0, self.gm - z - cfg.cusum_k)
            if self.gp > cfg.cusum_h or self.gm > cfg.cusum_h:
                fired = "up" if self.gp >= self.gm else "down"
                self.gp = self.gm = 0.0
        a = cfg.ewma_alpha
        if self.n == 0:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += a * d
            self.var = (1.0 - a) * (self.var + a * d * d)
        self.n += 1
        return fired


# ---------------------------------------------------------------------------
# per-window bin
# ---------------------------------------------------------------------------

class _Bin:
    """One aggregation window: counters, end-of-window gauges, latency
    histogram, and the dominant-component histogram of the violating
    spans that finished inside it."""

    __slots__ = ("counts", "queue_depth", "replicas", "hist", "dom")

    def __init__(self, buckets: Tuple[float, ...]):
        self.counts: Dict[str, float] = {}
        self.queue_depth: Optional[float] = None
        self.replicas: Optional[float] = None
        self.hist = WindowedHistogram(buckets)
        self.dom: Counter = Counter()

    def bump(self, key: str, by: float = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + by


class FleetMonitor:
    """Streaming health monitor over one cluster run (single-use, like
    the driver). Construct with the run's *enabled* tracer; the monitor
    subscribes itself to the bus. The driver calls ``pulse`` once per
    event-loop iteration and ``finalize`` at shutdown."""

    def __init__(self, cfg: MonitorConfig, tracer: Tracer):
        if not getattr(tracer, "enabled", False):
            raise TypeError("FleetMonitor needs an enabled Tracer "
                            "(the driver builds one when monitor is on)")
        self.cfg = cfg
        self._tracer = tracer
        self._bins: Dict[int, _Bin] = {}
        self._cur = 0                   # first bin not yet closed
        self._final = False
        self._hist_total = WindowedHistogram(cfg.latency_buckets)
        self._totals: Dict[str, float] = {}
        self._last_queue = 0.0
        self._last_replicas = 0.0
        self._detectors: Dict[str, _Changepoint] = {
            s: _Changepoint(cfg) for s in cfg.signals}
        self._rule_active: Dict[str, bool] = {r.name: False
                                              for r in cfg.rules}
        self._rule_last_fire: Dict[str, float] = {}
        self.alerts: List[dict] = []
        self.anomalies: List[dict] = []
        self.changepoints: Counter = Counter()
        self._incidents: List[Tuple[float, float]] = []
        tracer.subscribe(on_event=self._on_event, on_span=self._on_span)

    # ---------------- bus fold ----------------

    def _bin(self, t: float) -> _Bin:
        b = self._bins.get(bin_of(t, self.cfg.window))
        if b is None:
            b = self._bins[bin_of(t, self.cfg.window)] \
                = _Bin(self.cfg.latency_buckets)
        return b

    def _count(self, t: float, key: str, by: float = 1) -> None:
        self._bin(t).bump(key, by)
        self._totals[key] = self._totals.get(key, 0) + by

    def _on_event(self, rec: dict) -> None:
        if self._final:
            return                      # post-run drain (settle(inf))
        k = rec["kind"]
        t = rec["t"]
        if k == "submit":
            self._count(t, "arrivals")
        elif k == "dispatch":
            self._count(t, "dispatches")
        elif k == "complete":
            self._count(t, "completed")
            self._count(t, "slo_ok" if rec["slo_met"] else "slo_miss")
            self._bin(t).hist.observe(rec["latency"])
            self._hist_total.observe(rec["latency"])
        elif k == "drop":
            self._count(t, "dropped")
        elif k == "batch_hold":
            self._count(t, "holds")
        elif k == "gang":
            self._count(t, "gangs")
            self._count(t, "gang_reqs", rec["batch"])
        elif k == "escalate":
            self._count(t, "escalations")
        elif k == "requeue":
            self._count(t, "requeues")
        elif k == "replica_spawn":
            self._count(t, "spawns")
        elif k == "replica_retired":
            self._count(t, "retired")
        elif k == "replica_crash":
            self._count(t, "crashes")
            self._incidents.append((t, t + self.cfg.incident_horizon))
        elif k == "zone_outage":
            self._count(t, "zone_outages")
            if not rec.get("degraded"):
                self._incidents.append(
                    (t, rec["down_until"] + self.cfg.incident_horizon))
        elif k == "checkpoint_write":
            self._count(t, "checkpoint_writes", rec["snapshots"])
            self._count(t, "checkpoint_seconds", rec["cost"])
        elif k == "step":
            self._count(t, "steps")
            self._count(t, "step_reqs", rec["batch"])
        elif k == "tier_fetch":
            self._count(t, "tier_hits" if rec["hit"] else "tier_misses")
        elif k == "tier_commit":
            self._count(t, "tier_commits")
            self._count(t, "tier_commit_bytes", rec["nbytes"])
        elif k == "tier_evict":
            self._count(t, "tier_evicts")
            self._count(t, "tier_evict_bytes", rec["nbytes"])
        elif k == "tier_prefetch":
            self._count(t, "tier_prefetch_bytes", rec["nbytes"])
        elif k == "migrate_end":
            self._count(t, "migrations")
        elif k == "scale":
            self._count(t, "scale_up" if rec["action"] > 0
                        else "scale_down")
        # alert/anomaly records are the monitor's own output looped back
        # on the bus — never folded, or alerting would self-excite

    def _on_span(self, span) -> None:
        """Closed request span: record the dominant component of each
        violator in the bin its lifecycle *ended* in — the same bin its
        complete/drop event lands in, so per-bin miss counts and the
        dominant histogram always agree."""
        if self._final or span.end is None:
            return
        if span.outcome == "dropped" or not span.slo_met:
            self._bin(span.end).dom[span.dominant()] += 1

    # ---------------- driver hooks ----------------

    def pulse(self, now: float, queue_depth: float = 0.0,
              replicas: float = 0.0) -> None:
        """End-of-iteration heartbeat: every event for sim-time ``now``
        has been delivered, so bins below ``bin_of(now)`` are immutable —
        close them (changepoints), evaluate the alert rules over the
        closed suffix, then sample this instant's gauges into the
        still-open bin."""
        b = bin_of(now, self.cfg.window)
        if b > self._cur:
            for cb in range(self._cur, b):
                self._close(cb)
            self._cur = b
            self._eval_rules(now, hi=b - 1)
        cur = self._bin(now)
        cur.queue_depth = float(queue_depth)
        cur.replicas = float(replicas)
        self._last_queue = float(queue_depth)
        self._last_replicas = float(replicas)

    def finalize(self, now: float) -> None:
        """Run over: close every bin through ``bin_of(now)``, run one
        last rule evaluation, and stop folding (the driver's shutdown
        tier drain emits post-run commit events that belong to no
        window)."""
        if self._final:
            return
        hi = bin_of(now, self.cfg.window)
        for cb in range(self._cur, hi + 1):
            self._close(cb)
        self._cur = hi + 1
        self._eval_rules(now, hi=hi)
        self._final = True

    # ---------------- window close + detection ----------------

    def _close(self, cb: int) -> None:
        # carry the last sampled gauges into bins no pulse landed in
        b = self._bins.get(cb)
        if b is None:
            b = self._bins[cb] = _Bin(self.cfg.latency_buckets)
        if b.queue_depth is None:
            b.queue_depth = self._last_queue
        if b.replicas is None:
            b.replicas = self._last_replicas
        for name, det in self._detectors.items():
            x = self._signal(name, b)
            if x is None:
                continue
            direction = det.update(x)
            if direction is not None:
                self.changepoints[name] += 1
                t = (cb + 1) * self.cfg.window
                rec = {"t": round(t, 6), "kind": "anomaly", "signal": name,
                       "direction": direction, "value": round(x, 6),
                       "baseline": round(det.mean, 6), "bin": cb}
                self.anomalies.append(rec)
                self._tracer.anomaly(t, signal=name, direction=direction,
                                     value=x, baseline=det.mean, bin=cb)

    def _signal(self, name: str, b: _Bin) -> Optional[float]:
        """Value of one watched signal for a closed bin; None skips the
        detector update (no data, e.g. a rate with no samples)."""
        if name == "queue_depth":
            return b.queue_depth
        if name == "replicas":
            return b.replicas
        if name == "slo_miss_rate":
            done = b.counts.get("completed", 0) + b.counts.get("dropped", 0)
            if done == 0:
                return None
            return (b.counts.get("slo_miss", 0)
                    + b.counts.get("dropped", 0)) / done
        if name == "tier_hit_rate":
            probes = b.counts.get("tier_hits", 0) \
                + b.counts.get("tier_misses", 0)
            if probes == 0:
                return None
            return b.counts.get("tier_hits", 0) / probes
        return b.counts.get(name, 0)

    # ---------------- burn-rate rules ----------------

    def _window_tallies(self, lo: int, hi: int) -> Tuple[float, float]:
        """(finished, missed) over closed bins [lo, hi]."""
        done = miss = 0.0
        for cb in range(max(lo, 0), hi + 1):
            b = self._bins.get(cb)
            if b is None:
                continue
            done += b.counts.get("completed", 0) + b.counts.get("dropped", 0)
            miss += b.counts.get("slo_miss", 0) + b.counts.get("dropped", 0)
        return done, miss

    def _burn(self, lo: int, hi: int) -> Tuple[float, float]:
        """(burn rate, finished) over closed bins [lo, hi]."""
        done, miss = self._window_tallies(lo, hi)
        if done == 0:
            return 0.0, 0.0
        return (miss / done) / (1.0 - self.cfg.slo_target), done

    def _eval_rules(self, now: float, hi: int) -> None:
        if hi < 0:
            return
        w = self.cfg.window
        for rule in self.cfg.rules:
            n_s = max(1, round(rule.short_window / w))
            n_l = max(1, round(rule.long_window / w))
            if hi + 1 < n_l:
                continue            # long window not fully elapsed yet
            burn_s, _ = self._burn(hi - n_s + 1, hi)
            burn_l, done_l = self._burn(hi - n_l + 1, hi)
            firing = burn_s >= rule.burn_rate and burn_l >= rule.burn_rate \
                and done_l >= self.cfg.min_done
            was = self._rule_active[rule.name]
            self._rule_active[rule.name] = firing
            if not firing:
                continue
            last = self._rule_last_fire.get(rule.name)
            if was and last is not None and now - last < rule.repeat:
                continue                # active and recently fired
            self._rule_last_fire[rule.name] = now
            lo = max(hi - n_l + 1, 0)
            dom: Counter = Counter()
            for cb in range(lo, hi + 1):
                b = self._bins.get(cb)
                if b is not None:
                    dom.update(b.dom)
            rec = {"t": round(now, 6), "kind": "alert", "rule": rule.name,
                   "burn_short": round(burn_s, 4),
                   "burn_long": round(burn_l, 4),
                   "threshold": rule.burn_rate,
                   "short_s": rule.short_window, "long_s": rule.long_window,
                   "win": [lo, hi], "dominant": dominant_component(dom),
                   "transition": not was}
            self.alerts.append(rec)
            self._tracer.alert(now, rule=rule.name, burn_short=burn_s,
                               burn_long=burn_l, threshold=rule.burn_rate,
                               win=[lo, hi], dominant=rec["dominant"],
                               transition=not was)

    # ---------------- incident accounting ----------------

    def incident_windows(self) -> List[Tuple[float, float]]:
        """Injected-fault incident intervals (crash / zone outage, padded
        by ``incident_horizon``), overlaps merged."""
        merged: List[Tuple[float, float]] = []
        for lo, hi in sorted(self._incidents):
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return merged

    def _precision_recall(self) -> dict:
        incidents = self.incident_windows()
        tp = sum(1 for a in self.alerts
                 if any(lo <= a["t"] <= hi for lo, hi in incidents))
        covered = sum(1 for lo, hi in incidents
                      if any(lo <= a["t"] <= hi for a in self.alerts))
        return {
            "incidents": len(incidents),
            "alerts_in_incident": tp,
            "precision": round(tp / len(self.alerts), 4)
            if self.alerts else 1.0,
            "recall": round(covered / len(incidents), 4)
            if incidents else 1.0,
        }

    # ---------------- reporting ----------------

    def summary(self) -> dict:
        by_rule: Counter = Counter(a["rule"] for a in self.alerts)
        return {
            "window": self.cfg.window,
            "slo_target": self.cfg.slo_target,
            "bins": self._cur,
            "alerts": len(self.alerts),
            "alerts_by_rule": dict(by_rule.most_common()),
            "anomalies": len(self.anomalies),
            "changepoints": {s: int(self.changepoints.get(s, 0))
                             for s in self.cfg.signals},
            **self._precision_recall(),
        }

    def window_records(self) -> List[dict]:
        """One record per closed bin, in time order (the JSONL body and
        the dashboard's table rows)."""
        out = []
        w = self.cfg.window
        for cb in sorted(b for b in self._bins if b < self._cur):
            b = self._bins[cb]
            out.append({
                "kind": "window", "bin": cb,
                "t0": round(cb * w, 6), "t1": round((cb + 1) * w, 6),
                "queue_depth": b.queue_depth, "replicas": b.replicas,
                "counters": {k: round(v, 6) for k, v in
                             sorted(b.counts.items())},
                "latency": b.hist.to_dict(),
                "dominant": dict(b.dom.most_common()),
            })
        return out

    def write_jsonl(self, path) -> int:
        """Health log: a ``monitor_meta`` header, one ``window`` record
        per closed bin, then the alert and anomaly logs. Rendered by
        ``scripts/fleet_dashboard.py``. Returns records written."""
        windows = self.window_records()
        n = 0
        with open(path, "w") as fh:
            fh.write(json.dumps({
                "kind": "monitor_meta", "window": self.cfg.window,
                "slo_target": self.cfg.slo_target, "bins": self._cur,
                "rules": [{"name": r.name, "short_s": r.short_window,
                           "long_s": r.long_window,
                           "burn_rate": r.burn_rate, "repeat": r.repeat}
                          for r in self.cfg.rules],
                "signals": list(self.cfg.signals),
                "alerts": len(self.alerts),
                "anomalies": len(self.anomalies)}) + "\n")
            n += 1
            for rec in (*windows, *self.alerts, *self.anomalies):
                fh.write(json.dumps(rec) + "\n")
                n += 1
        return n

    def prometheus_text(self) -> str:
        """Prometheus text-exposition snapshot of the run-total counters,
        last-sampled gauges, the latency histogram, and the alert /
        anomaly counts (no duplicate series; sanity-parsed in tests and
        CI)."""
        tot = self._totals
        lines: List[str] = []

        def counter(name: str, help_: str, value: float,
                    labels: str = "") -> None:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{labels} {_num(value)}")

        def _num(v: float) -> str:
            return str(int(v)) if float(v).is_integer() else repr(round(v, 6))

        counter("fleet_requests_total", "Requests submitted.",
                tot.get("arrivals", 0))
        counter("fleet_completed_total", "Requests completed.",
                tot.get("completed", 0))
        counter("fleet_slo_miss_total",
                "Completed requests that missed their SLO.",
                tot.get("slo_miss", 0))
        counter("fleet_dropped_total", "Requests dropped.",
                tot.get("dropped", 0))
        counter("fleet_requeues_total", "Crash requeues.",
                tot.get("requeues", 0))
        counter("fleet_escalations_total", "Cascade escalations.",
                tot.get("escalations", 0))
        counter("fleet_batch_holds_total", "Batch-former holds.",
                tot.get("holds", 0))
        counter("fleet_gangs_total", "Gang dispatches.",
                tot.get("gangs", 0))
        counter("fleet_replica_spawns_total", "Replica spawns.",
                tot.get("spawns", 0))
        counter("fleet_replica_crashes_total", "Replica crashes.",
                tot.get("crashes", 0))
        counter("fleet_zone_outages_total", "Zone outages.",
                tot.get("zone_outages", 0))
        counter("fleet_checkpoint_seconds_total",
                "Sim seconds spent writing checkpoints.",
                tot.get("checkpoint_seconds", 0))
        counter("fleet_steps_total", "Denoise steps executed.",
                tot.get("steps", 0))
        lines.append("# HELP fleet_tier_fetch_total Tier fetch probes.")
        lines.append("# TYPE fleet_tier_fetch_total counter")
        for res in ("hit", "miss"):
            key = "tier_hits" if res == "hit" else "tier_misses"
            lines.append(f'fleet_tier_fetch_total{{result="{res}"}} '
                         f"{_num(tot.get(key, 0))}")
        lines.append("# HELP fleet_tier_bytes_total Tier bytes moved.")
        lines.append("# TYPE fleet_tier_bytes_total counter")
        for op in ("commit", "evict", "prefetch"):
            lines.append(f'fleet_tier_bytes_total{{op="{op}"}} '
                         f"{_num(tot.get(f'tier_{op}_bytes', 0))}")
        lines.append("# HELP fleet_alerts_total Burn-rate alerts fired.")
        lines.append("# TYPE fleet_alerts_total counter")
        by_rule = Counter(a["rule"] for a in self.alerts)
        for rule in self.cfg.rules:
            lines.append(f'fleet_alerts_total{{rule="{rule.name}"}} '
                         f"{by_rule.get(rule.name, 0)}")
        lines.append("# HELP fleet_anomalies_total Changepoints detected.")
        lines.append("# TYPE fleet_anomalies_total counter")
        for sig in self.cfg.signals:
            lines.append(f'fleet_anomalies_total{{signal="{sig}"}} '
                         f"{int(self.changepoints.get(sig, 0))}")
        lines.append("# HELP fleet_queue_depth Frontend queue depth "
                     "(last sample).")
        lines.append("# TYPE fleet_queue_depth gauge")
        lines.append(f"fleet_queue_depth {_num(self._last_queue)}")
        lines.append("# HELP fleet_replicas_ready Ready replicas "
                     "(last sample).")
        lines.append("# TYPE fleet_replicas_ready gauge")
        lines.append(f"fleet_replicas_ready {_num(self._last_replicas)}")
        h = self._hist_total
        name = "fleet_request_latency_seconds"
        lines.append(f"# HELP {name} End-to-end request latency.")
        lines.append(f"# TYPE {name} histogram")
        run = 0
        for bound, c in zip(h.bounds, h.counts):
            run += c
            lines.append(f'{name}_bucket{{le="{_num(bound)}"}} {run}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {h.n}')
        lines.append(f"{name}_sum {_num(round(h.sum, 6))}")
        lines.append(f"{name}_count {h.n}")
        return "\n".join(lines) + "\n"
