"""Fleet tracing — a sim-clock event bus + per-request span tracer.

The cluster layer reports aggregate outcomes (``ClusterMetrics``) but
cannot answer *why* one request missed its deadline: was it parked in the
frontend queue behind a cold start, requeued by a crash, stuck behind a
migration drain, or taxed by checkpoint writes and tier fetches? This
module adds that answer without touching the simulation's semantics:

- **Event bus** (``Tracer``): every lifecycle transition — submit,
  batch-former hold / gang dispatch, dispatch, admit, denoise step,
  checkpoint write, tier fetch/publish, tier escalation,
  migration drain, crash/requeue/resume, complete/drop — plus the fleet
  events the driver previously kept in ad-hoc lists (``failure_log``,
  ``repartition_log``, ``zone_outage_log``, autoscaler actions) becomes a
  typed, timestamped record on one bus. Events are emitted in driver
  processing order and exported stably sorted by ``(t, seq)``, so the
  exported stream is non-decreasing in sim time and same-instant batches
  (e.g. the orphans of a zone outage) keep their emission order — the
  driver emits requeues in arrival order, matching ``Router.requeue``.

- **Span state machine**: per request, the tracer folds events into a
  latency decomposition over ``COMPONENTS``. The invariant is
  *conservation*: at every instant a request is in exactly one state, and
  every interval between consecutive events is charged to exactly one
  component — so the components of a finished request provably sum to its
  end-to-end latency (finish - arrival), including across crash-requeue
  (a mid-step kill rolls the in-flight step charge back to the crash
  instant; work invalidated by the rollback is *relabeled* from
  ``denoise`` to ``denoise_lost``, preserving the sum) and mid-migration
  paths (waiting on a draining replica is ``migration_drain``). Tests
  assert the sum to 1e-9.

- **SLO-violation attribution**: for every missed or dropped request the
  dominant component, aggregated into a fleet histogram
  (``attribution_summary`` -> ``ClusterMetrics.summary()["attribution"]``).

- **Predictor calibration**: at dispatch the tracer records the finish
  time the replica's own latency surrogate predicts
  (``Replica.predicted_finish``); at completion the residual. MAE / p95
  absolute error / signed bias land in ``summary()["predictor"]``, with a
  drift flag when the rolling bias exceeds a threshold — the paper's
  "lightweight online latency prediction" made inspectable.

- **Exporters**: JSONL (one event per line, plus one ``span`` record per
  finished request) and Chrome-trace/Perfetto JSON (zones as process
  groups, replicas as tracks, denoise steps as duration slices, outages /
  repartitions / scale actions as instant events). Sampling modes bound
  the retained event log on big sweeps: ``all`` keeps everything,
  ``violations`` keeps only requests that missed or dropped (step events
  are elided), ``sample`` keeps a per-request Bernoulli subset. The span /
  attribution / predictor aggregates are always computed over *all*
  requests regardless of mode — sampling bounds the log, not the stats.

Tracing is **zero-cost when disabled**: every instrumented call site is
guarded by ``if tracer.enabled:`` against the shared ``NULL_TRACER``
singleton, so the disabled path is one attribute load + branch and the
simulation stays bit-identical with tracing on or off (asserted in tests).
"""
from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Resolution = Tuple[int, int]

#: latency-decomposition components; per finished request they sum to
#: finish - arrival (the conservation invariant)
COMPONENTS = (
    "frontend_wait",     # in the router queue, never yet dispatched
    "requeue_wait",      # back in the router queue after a crash requeue
    "batch_wait",        # queued but deliberately held by the batch former
    "replica_wait",      # in a replica's wait queue (admission pending)
    "migration_drain",   # waiting on a replica that is draining to migrate
    "denoise",           # executing denoise steps that counted
    "denoise_lost",      # executed step time a crash rolled back
    "checkpoint_wait",   # active but stalled behind checkpoint writes
    "tier_wait",         # active but stalled behind tier fetch/publish
    "batch_stall",       # active residual (should be ~0; conservation net)
    "escalation",        # re-entering the cascade after a confidence-gate
    #                      escalation: from the rejected cheap completion
    #                      until the higher model tier admits the request
)

_FRONTEND, _REPLICA, _ACTIVE, _DONE = 0, 1, 2, 3


@dataclass
class TraceConfig:
    """Tracer knobs. ``mode`` bounds the retained event log:
    ``all`` | ``violations`` (keep only missed/dropped requests' lifecycle
    events; batch step events elided) | ``sample`` (Bernoulli per-request
    subset at ``sample_rate``). Aggregates (attribution, predictor,
    conservation spans) always cover every request."""
    mode: str = "all"                # retained-event policy (see above)
    sample_rate: float = 0.05        # ``sample`` mode keep probability,
    #                                  per request, in (0, 1]
    seed: int = 0                    # ``sample`` mode Bernoulli RNG seed
    # predictor drift: flag when |rolling mean residual| over the last
    # ``predictor_window`` completions exceeds ``drift_bias_frac`` x the
    # window's mean actual latency
    predictor_window: int = 200
    drift_bias_frac: float = 0.25

    def __post_init__(self) -> None:
        if self.mode not in ("all", "violations", "sample"):
            raise ValueError(
                f"mode must be all|violations|sample, got {self.mode!r}")
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError("sample_rate must be in (0, 1]")
        if self.predictor_window < 1:
            raise ValueError("predictor_window must be >= 1")


class NullTracer:
    """Shared disabled tracer. Call sites guard with ``if tracer.enabled:``
    so this object's methods are almost never reached; they exist so an
    unguarded call is still a no-op rather than an AttributeError."""
    enabled = False

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return _noop


def _noop(*args, **kwargs) -> None:
    return None


#: the one disabled tracer every component defaults to
NULL_TRACER = NullTracer()


class _Span:
    """Per-request decomposition state. ``label`` is the component the
    currently-open interval will be charged to; ``step_dts`` remembers each
    counted denoise step's duration so a crash rollback can relabel exactly
    the invalidated steps."""
    __slots__ = ("rid", "arrival", "slo", "resolution", "phase", "label",
                 "last_t", "comp", "replica", "pend_ckpt", "pend_tier",
                 "step_dts", "bands", "predicted_finish", "end", "outcome",
                 "slo_met", "requeues", "total_steps")

    def __init__(self, rid: int, arrival: float, slo: float,
                 resolution: Resolution, total_steps: int, bands: int):
        self.rid = rid
        self.arrival = arrival
        self.slo = slo
        self.resolution = resolution
        self.total_steps = total_steps
        self.phase = _FRONTEND
        self.label = "frontend_wait"
        self.last_t = arrival
        self.comp = dict.fromkeys(COMPONENTS, 0.0)
        self.replica: Optional[int] = None
        self.pend_ckpt = 0.0
        self.pend_tier = 0.0
        self.step_dts: List[float] = []
        self.bands = [0.0] * bands
        self.predicted_finish: Optional[float] = None
        self.end: Optional[float] = None
        self.outcome: Optional[str] = None   # completed | dropped
        self.slo_met = False
        self.requeues = 0

    # -- interval charging -------------------------------------------------
    def charge(self, t: float) -> None:
        """Close the open wait interval into ``label``."""
        if t > self.last_t:
            self.comp[self.label] += t - self.last_t
        self.last_t = t

    def charge_active_gap(self, t: float) -> None:
        """Close an active-phase gap: checkpoint writes first (they are
        charged to the busy horizon right after the step), then tier
        fetch/publish cost, residual to ``batch_stall``."""
        gap = t - self.last_t
        if gap > 0:
            c = min(gap, self.pend_ckpt)
            self.comp["checkpoint_wait"] += c
            self.pend_ckpt -= c
            rem = gap - c
            e = min(rem, self.pend_tier)
            self.comp["tier_wait"] += e
            self.pend_tier -= e
            self.comp["batch_stall"] += rem - e
        self.last_t = t

    def close(self, t: float) -> None:
        if self.phase == _ACTIVE:
            self.charge_active_gap(t)
        else:
            self.charge(t)
        self.end = t

    def total(self) -> float:
        return sum(self.comp.values())

    def dominant(self) -> str:
        return max(self.comp, key=lambda k: self.comp[k])

    def record(self) -> dict:
        return {
            "kind": "span", "rid": self.rid, "t": self.end,
            "arrival": self.arrival, "end": self.end, "slo": self.slo,
            "resolution": list(self.resolution), "outcome": self.outcome,
            "slo_met": self.slo_met, "requeues": self.requeues,
            "components": {k: v for k, v in self.comp.items() if v > 0.0},
            "denoise_bands": self.bands,
            "dominant": self.dominant(),
            "latency": (self.end - self.arrival)
            if self.end is not None else None,
            "predicted_finish": self.predicted_finish,
            "residual": (self.end - self.predicted_finish)
            if self.predicted_finish is not None and self.end is not None
            and self.outcome == "completed" else None,
        }


class Tracer:
    """Enabled tracer: event bus + span folding + aggregates + exporters.

    Emission order within one sim instant is meaningful (the driver
    processes crashes before dispatch before ticks); ``events()`` returns
    the retained log stably sorted by ``(t, seq)`` so the export is
    globally non-decreasing in sim time while same-instant records keep
    their emission order."""
    enabled = True

    def __init__(self, cfg: Optional[TraceConfig] = None,
                 step_bands: int = 4):
        self.cfg = cfg or TraceConfig()
        self.step_bands = step_bands
        self._seq = 0
        self._events: List[dict] = []          # retained log
        self._buffers: Dict[int, List[dict]] = {}   # violations mode
        self._sampled: set = set()
        self._rng = np.random.default_rng(self.cfg.seed)
        self.spans: Dict[int, _Span] = {}      # open spans by rid
        self.finished: List[_Span] = []
        self._residents: Dict[int, set] = {}   # replica rid -> request rids
        self._migrating: set = set()           # replica rids draining
        self.n_emitted = 0
        self._event_subs: List = []            # live bus subscribers
        self._span_subs: List = []             # closed-span subscribers

    # ---------------- bus plumbing ----------------

    def subscribe(self, on_event=None, on_span=None) -> None:
        """Register live callbacks: ``on_event(rec)`` sees **every**
        emitted record (before the retention policy — sampling bounds the
        stored log, not the stream), ``on_span(span)`` each finished
        request's closed ``_Span``. The fleet monitor builds its windowed
        timeseries from exactly this stream."""
        if on_event is not None:
            self._event_subs.append(on_event)
        if on_span is not None:
            self._span_subs.append(on_span)

    def _emit(self, rec: dict, rid: Optional[int] = None,
              bulk: bool = False) -> None:
        self._seq += 1
        rec["seq"] = self._seq
        self.n_emitted += 1
        for cb in self._event_subs:
            cb(rec)
        mode = self.cfg.mode
        if bulk:                      # batch-level (multi-request) events
            if mode == "all":
                self._events.append(rec)
            return
        if rid is None or mode == "all":
            self._events.append(rec)
        elif mode == "sample":
            if rid in self._sampled:
                self._events.append(rec)
        else:                         # violations: buffer until verdict
            self._buffers.setdefault(rid, []).append(rec)

    def _settle_retention(self, span: _Span) -> None:
        """Violations mode: flush or discard a finished request's buffered
        lifecycle events now that its verdict is known."""
        if self.cfg.mode != "violations":
            return
        buf = self._buffers.pop(span.rid, [])
        if span.outcome == "dropped" or not span.slo_met:
            self._events.extend(buf)

    def events(self) -> List[dict]:
        """Retained log, stably sorted by (sim time, emission order)."""
        return sorted(self._events, key=lambda e: (e["t"], e["seq"]))

    # ---------------- request lifecycle ----------------

    def submit(self, req) -> None:
        span = _Span(req.rid, req.arrival, req.slo, tuple(req.resolution),
                     req.total_steps, self.step_bands)
        self.spans[req.rid] = span
        if self.cfg.mode == "sample" \
                and self._rng.random() < self.cfg.sample_rate:
            self._sampled.add(req.rid)
        self._emit({"t": req.arrival, "kind": "submit", "rid": req.rid,
                    "resolution": list(req.resolution), "slo": req.slo},
                   rid=req.rid)

    def dispatch(self, req, rep, now: float,
                 predicted_finish: Optional[float] = None) -> None:
        span = self.spans.get(req.rid)
        if span is None:
            return
        was_escalation = span.label == "escalation"
        span.charge(now)
        span.phase = _REPLICA
        if rep.rid in self._migrating:
            span.label = "migration_drain"
        elif was_escalation:
            # still paying for the cascade re-entry: the escalation charge
            # runs until the higher tier actually admits the request
            span.label = "escalation"
        else:
            span.label = "replica_wait"
        span.replica = rep.rid
        span.predicted_finish = predicted_finish
        self._residents.setdefault(rep.rid, set()).add(req.rid)
        self._emit({"t": now, "kind": "dispatch", "rid": req.rid,
                    "replica": rep.rid,
                    "predicted_finish": predicted_finish}, rid=req.rid)

    def batch_hold(self, req, now: float) -> None:
        """The batch former deliberately deferred a dispatchable request to
        grow a gang: from here until dispatch its queue time is charged to
        ``batch_wait`` instead of ``frontend_wait``/``requeue_wait`` —
        chosen delay, not capacity starvation. Emitted once per hold
        decision (conservation is untouched: the label switch closes the
        open interval first)."""
        span = self.spans.get(req.rid)
        if span is None or span.phase != _FRONTEND:
            return
        span.charge(now)
        span.label = "batch_wait"
        self._emit({"t": now, "kind": "batch_hold", "rid": req.rid},
                   rid=req.rid)

    def gang_dispatch(self, now: float, rep, reqs: Sequence,
                      step_cost: float) -> None:
        """One former gang shipped to ``rep`` (batch-level event, like
        ``step``); the per-request ``dispatch`` events follow it on the
        bus."""
        self._emit({"t": now, "kind": "gang", "replica": rep.rid,
                    "zone": rep.zone, "batch": len(reqs),
                    "rids": [r.rid for r in reqs],
                    "predicted_step_cost": step_cost}, bulk=True)

    def admit(self, req, rep, now: float) -> None:
        span = self.spans.get(req.rid)
        if span is None:
            return
        span.charge(now)
        span.phase = _ACTIVE
        span.label = "batch_stall"
        span.pend_ckpt = span.pend_tier = 0.0
        self._emit({"t": now, "kind": "admit", "rid": req.rid,
                    "replica": rep.rid, "steps_done": req.steps_done},
                   rid=req.rid)

    def step(self, rep, now: float, dt: float, ckpt_cost: float,
             tier_cost: float, reqs: Sequence) -> None:
        """One replica denoise step: ``dt`` of denoising for every request
        in the batch, then ``ckpt_cost`` + ``tier_cost`` extending the busy
        horizon (charged to the *next* inter-step gap of still-active
        requests)."""
        rids = []
        for r in reqs:
            rids.append(r.rid)
            span = self.spans.get(r.rid)
            if span is None or span.phase != _ACTIVE:
                continue
            span.charge_active_gap(now)
            span.comp["denoise"] += dt
            span.step_dts.append(dt)
            band = min(int(max(r.steps_done - 1, 0)
                           / max(r.total_steps, 1) * self.step_bands),
                       self.step_bands - 1)
            span.bands[band] += dt
            span.last_t = now + dt
            span.pend_ckpt = ckpt_cost
            span.pend_tier = tier_cost
        self._emit({"t": now, "kind": "step", "replica": rep.rid,
                    "zone": rep.zone, "dt": dt, "ckpt_cost": ckpt_cost,
                    "tier_cost": tier_cost, "batch": len(rids),
                    "rids": rids}, bulk=True)

    def complete(self, req, rep, t: float) -> None:
        span = self.spans.pop(req.rid, None)
        if span is None:
            return
        span.close(t)
        span.outcome = "completed"
        span.slo_met = t <= req.slo
        self.finished.append(span)
        for cb in self._span_subs:
            cb(span)
        self._residents.get(rep.rid, set()).discard(req.rid)
        self._emit({"t": t, "kind": "complete", "rid": req.rid,
                    "replica": rep.rid, "slo_met": span.slo_met,
                    "latency": t - span.arrival}, rid=req.rid)
        self._settle_retention(span)

    def drop(self, req, t: float, where: str,
             rep=None) -> None:
        span = self.spans.pop(req.rid, None)
        if span is None:
            return
        span.close(t)
        span.outcome = "dropped"
        span.slo_met = False
        self.finished.append(span)
        for cb in self._span_subs:
            cb(span)
        if rep is not None:
            self._residents.get(rep.rid, set()).discard(req.rid)
        self._emit({"t": t, "kind": "drop", "rid": req.rid, "where": where,
                    "replica": rep.rid if rep is not None else None},
                   rid=req.rid)
        self._settle_retention(span)

    def requeue(self, req, t: float, steps_lost: int,
                replica_rid: int, cause: str) -> None:
        """Crash-orphaned request returned to the router head. Rolls an
        in-flight step charge back to the crash instant (the sim advances
        step state at tick start, so a kill can land inside the step's wall
        interval) and relabels the ``steps_lost`` invalidated step
        durations from ``denoise`` to ``denoise_lost`` — both preserve the
        conservation sum."""
        span = self.spans.get(req.rid)
        if span is None:
            return
        if span.phase == _ACTIVE:
            if t < span.last_t:
                over = span.last_t - t
                span.comp["denoise"] -= over
                if span.step_dts:
                    span.step_dts[-1] = max(span.step_dts[-1] - over, 0.0)
                clip = over
                for i in range(len(span.bands) - 1, -1, -1):
                    cut = min(span.bands[i], clip)
                    span.bands[i] -= cut
                    clip -= cut
                    if clip <= 0:
                        break
                span.last_t = t
            else:
                span.charge_active_gap(t)
            lost = 0.0
            for _ in range(min(steps_lost, len(span.step_dts))):
                lost += span.step_dts.pop()
            span.comp["denoise"] -= lost
            span.comp["denoise_lost"] += lost
            clip = lost
            for i in range(len(span.bands) - 1, -1, -1):
                cut = min(span.bands[i], clip)
                span.bands[i] -= cut
                clip -= cut
                if clip <= 0:
                    break
        else:
            span.charge(t)
        if span.replica is not None:
            self._residents.get(span.replica, set()).discard(req.rid)
        span.phase = _FRONTEND
        span.label = "requeue_wait"
        span.replica = None
        span.pend_ckpt = span.pend_tier = 0.0
        span.requeues += 1
        self._emit({"t": t, "kind": "requeue", "rid": req.rid,
                    "replica": replica_rid, "cause": cause,
                    "steps_lost": steps_lost,
                    "steps_resumed": req.steps_done,
                    "arrival": span.arrival}, rid=req.rid)

    def escalate(self, req, t: float, replica_rid: int,
                 min_quality: float) -> None:
        """Confidence-gated escalation: a cheap-tier completion was
        rejected and the request re-enters the frontend queue targeted at
        the next model tier up. Unlike a crash requeue nothing is rolled
        back or relabeled — the cheap tier's denoise time really elapsed
        and stays ``denoise``; from here until the higher tier *admits*
        the request (re-dispatch keeps the label) the wait is charged to
        ``escalation`` (so the decomposition still sums to end-to-end
        latency exactly)."""
        span = self.spans.get(req.rid)
        if span is None:
            return
        if span.phase == _ACTIVE:
            # escalation fires at the completing step's end, so the active
            # gap is zero — this just closes the interval bookkeeping
            span.charge_active_gap(t)
        else:
            span.charge(t)
        if span.replica is not None:
            self._residents.get(span.replica, set()).discard(req.rid)
        span.phase = _FRONTEND
        span.label = "escalation"
        span.replica = None
        span.pend_ckpt = span.pend_tier = 0.0
        self._emit({"t": t, "kind": "escalate", "rid": req.rid,
                    "replica": replica_rid, "min_quality": min_quality,
                    "arrival": span.arrival}, rid=req.rid)

    # ---------------- fleet lifecycle ----------------

    def replica_spawn(self, rep, t: float, cause: str = "init") -> None:
        self._emit({"t": t, "kind": "replica_spawn", "replica": rep.rid,
                    "zone": rep.zone, "ready_at": rep.ready_at,
                    "cause": cause,
                    "resolutions": [list(r) for r in rep.resolutions]})

    def replica_retiring(self, rep, t: float, predictive: bool) -> None:
        self._emit({"t": t, "kind": "replica_retiring", "replica": rep.rid,
                    "zone": rep.zone, "predictive": predictive})

    def replica_retired(self, rep, t: float) -> None:
        self._emit({"t": t, "kind": "replica_retired", "replica": rep.rid,
                    "zone": rep.zone})

    def replica_crash(self, rep, t: float, cause: str, orphans: int,
                      steps_resumed: int, replaced: bool) -> None:
        self._emit({"t": t, "kind": "replica_crash", "replica": rep.rid,
                    "zone": rep.zone, "cause": cause, "requeued": orphans,
                    "steps_resumed": steps_resumed, "replaced": replaced})
        self._migrating.discard(rep.rid)
        for rid in self._residents.pop(rep.rid, set()):
            span = self.spans.get(rid)
            if span is not None and span.replica == rep.rid:
                span.replica = None

    def migrate_start(self, rep, t: float,
                      block: Sequence[Resolution]) -> None:
        """Replica begins drain-before-switch: residents still waiting in
        its queue are now blocked on the drain, not ordinary queueing."""
        self._migrating.add(rep.rid)
        for rid in self._residents.get(rep.rid, ()):
            span = self.spans.get(rid)
            if span is not None and span.phase == _REPLICA:
                span.charge(t)
                span.label = "migration_drain"
        self._emit({"t": t, "kind": "migrate_start", "replica": rep.rid,
                    "zone": rep.zone, "block": [list(r) for r in block]})

    def migrate_end(self, rep, t: float, switch_cost: float) -> None:
        self._migrating.discard(rep.rid)
        for rid in self._residents.get(rep.rid, ()):
            span = self.spans.get(rid)
            if span is not None and span.phase == _REPLICA:
                span.charge(t)
                span.label = "replica_wait"
        self._emit({"t": t, "kind": "migrate_end", "replica": rep.rid,
                    "zone": rep.zone, "switch_cost": switch_cost,
                    "resolutions": [list(r) for r in rep.resolutions]})

    def checkpoint_write(self, rep, t: float, wrote: int,
                         cost: float) -> None:
        self._emit({"t": t, "kind": "checkpoint_write", "replica": rep.rid,
                    "snapshots": wrote, "cost": cost}, bulk=True)

    def zone_outage(self, t: float, zone: int, killed: int,
                    down_until: float, degraded: bool = False) -> None:
        self._emit({"t": t, "kind": "zone_outage", "zone": zone,
                    "killed": killed, "down_until": down_until,
                    "degraded": degraded})

    def repartition(self, t: float, entry: dict) -> None:
        self._emit({"t": t, "kind": "repartition", **entry})

    def scale(self, t: float, action: int, reason: str) -> None:
        self._emit({"t": t, "kind": "scale", "action": action,
                    "reason": reason})

    def tier_commit(self, t: float, key, nbytes: int, owner: int) -> None:
        self._emit({"t": t, "kind": "tier_commit", "owner": owner,
                    "nbytes": nbytes,
                    "key": [list(key[0]), *key[1:]]}, bulk=True)

    def tier_evict(self, t: float, key, nbytes: int) -> None:
        self._emit({"t": t, "kind": "tier_evict", "nbytes": nbytes,
                    "key": [list(key[0]), *key[1:]]}, bulk=True)

    def tier_abort(self, t: float, owner: int, dropped: int) -> None:
        if dropped:
            self._emit({"t": t, "kind": "tier_abort", "owner": owner,
                        "writes_dropped": dropped})

    def tier_fetch(self, t: float, key, hit: bool) -> None:
        """One steady-state L2 fetch probe (``CacheTier.lookup``):
        batch-level volume like ``step``, so it is retained only in
        ``all`` mode — but the live stream still carries it, which is how
        the monitor computes per-window tier hit rates."""
        self._emit({"t": t, "kind": "tier_fetch", "hit": hit,
                    "key": [list(key[0]), *key[1:]]}, bulk=True)

    # ---------------- monitor loop-back ----------------

    def alert(self, t: float, **fields) -> None:
        """Burn-rate alert looped back from the fleet monitor; retained
        in every mode (fleet-lifecycle record, like ``replica_spawn``)."""
        self._emit({"t": t, "kind": "alert", **fields})

    def anomaly(self, t: float, **fields) -> None:
        """Changepoint detection looped back from the fleet monitor;
        retained in every mode."""
        self._emit({"t": t, "kind": "anomaly", **fields})

    def tier_prefetch(self, t: float, rep, keys: int, nbytes: int,
                      transfer: float, ready_at: float) -> None:
        """Warm-boot spawn prefetch: a fleet-lifecycle event (one per
        spawn, like replica_spawn — retained in every mode). The transfer
        overlaps the cold start, so no request span is open on the new
        replica yet and no ``tier_wait`` is charged: boot delay surfaces as
        ``frontend_wait``/``replica_wait`` exactly like the cold start it
        extends."""
        self._emit({"t": t, "kind": "tier_prefetch", "replica": rep.rid,
                    "zone": rep.zone, "keys": keys, "nbytes": nbytes,
                    "transfer": transfer, "ready_at": ready_at})

    # ---------------- aggregates ----------------

    def conservation_errors(self) -> List[Tuple[int, float]]:
        """(rid, |sum(components) - (end - arrival)|) per finished span —
        the invariant the tests assert to 1e-9."""
        return [(s.rid, abs(s.total() - (s.end - s.arrival)))
                for s in self.finished]

    def attribution_summary(self) -> dict:
        """Fleet 'where the misses come from' histogram: for every missed
        or dropped request, the dominant latency component."""
        dominant: Counter = Counter()
        time_by_comp = dict.fromkeys(COMPONENTS, 0.0)
        missed = dropped = ok = 0
        for s in self.finished:
            if s.outcome == "dropped":
                dropped += 1
            elif s.slo_met:
                ok += 1
                continue
            else:
                missed += 1
            dominant[s.dominant()] += 1
            for k, v in s.comp.items():
                time_by_comp[k] += v
        return {
            "requests": len(self.finished),
            "completed_ok": ok,
            "missed": missed,
            "dropped": dropped,
            "dominant": dict(dominant.most_common()),
            "violation_time_by_component": {
                k: round(v, 4) for k, v in time_by_comp.items() if v > 0.0},
        }

    def predictor_summary(self) -> dict:
        """Predicted-vs-actual finish-time calibration of the dispatch-time
        latency surrogate, over completed requests that were dispatched
        with a prediction. Residual = actual - predicted (positive bias:
        the predictor is optimistic)."""
        pairs = [(s.end - s.predicted_finish, s.end - s.arrival)
                 for s in self.finished
                 if s.outcome == "completed"
                 and s.predicted_finish is not None]
        if not pairs:
            return {"n": 0, "mae": 0.0, "p95_abs_err": 0.0, "bias": 0.0,
                    "rolling_bias": 0.0, "drift": False}
        res = np.asarray([p[0] for p in pairs], np.float64)
        lat = np.asarray([p[1] for p in pairs], np.float64)
        w = min(self.cfg.predictor_window, len(res))
        roll = res[-w:]
        roll_lat = lat[-w:]
        thresh = self.cfg.drift_bias_frac * float(roll_lat.mean())
        rolling_bias = float(roll.mean())
        return {
            "n": len(res),
            "mae": round(float(np.abs(res).mean()), 6),
            "p95_abs_err": round(float(np.quantile(np.abs(res), 0.95)), 6),
            "bias": round(float(res.mean()), 6),
            "rolling_bias": round(rolling_bias, 6),
            "rolling_window": w,
            "drift": bool(abs(rolling_bias) > thresh),
            "drift_threshold_s": round(thresh, 6),
            "mean_actual_latency": round(float(lat.mean()), 6),
        }

    @property
    def n_events(self) -> int:
        return len(self._events)

    # ---------------- exporters ----------------

    def _span_records(self) -> List[dict]:
        mode = self.cfg.mode
        out = []
        for s in self.finished:
            if mode == "sample" and s.rid not in self._sampled:
                continue
            if mode == "violations" and s.outcome != "dropped" and s.slo_met:
                continue
            out.append(s.record())
        return out

    def write_jsonl(self, path) -> int:
        """One JSON record per line: a ``trace_meta`` header, the retained
        event log in (t, seq) order, then one ``span`` record per finished
        request (subject to the sampling mode). Returns records written."""
        spans = self._span_records()
        events = self.events()
        n = 0
        with open(path, "w") as fh:
            fh.write(json.dumps({
                "kind": "trace_meta", "mode": self.cfg.mode,
                "events": len(events), "spans": len(spans),
                "events_emitted": self.n_emitted,
                "components": list(COMPONENTS)}) + "\n")
            n += 1
            for rec in events:
                fh.write(json.dumps(rec) + "\n")
                n += 1
            for rec in spans:
                fh.write(json.dumps(rec) + "\n")
                n += 1
        return n

    def write_chrome_trace(self, path) -> int:
        """Chrome-trace/Perfetto JSON: zones as process groups (pid =
        zone + 1; pid 0 is the fleet-control pseudo-process), replicas as
        threads (tid = replica rid + 1), denoise steps as duration slices,
        cold starts and migrations as slices, crashes / outages /
        repartitions / scale actions as instant events. Load via
        chrome://tracing or https://ui.perfetto.dev. Most useful with
        ``mode='all'`` (other modes elide step slices)."""
        US = 1e6
        out: List[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "fleet"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "control"}},
        ]
        seen_zone: set = set()
        zone_of: Dict[int, int] = {}
        mig_open: Dict[int, float] = {}
        for e in self.events():
            k = e["kind"]
            zone = e.get("zone")
            rep = e.get("replica")
            if zone is not None and rep is not None:
                zone_of.setdefault(rep, zone)
            zone = zone if zone is not None else zone_of.get(rep, 0)
            pid = zone + 1
            tid = (rep + 1) if rep is not None else 0
            if zone not in seen_zone:
                seen_zone.add(zone)
                out.append({"ph": "M", "pid": pid, "tid": 0,
                            "name": "process_name",
                            "args": {"name": f"zone-{zone}"}})
            if k == "replica_spawn":
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"replica-{rep}"}})
                if e["ready_at"] > e["t"]:
                    out.append({"ph": "X", "pid": pid, "tid": tid,
                                "ts": e["t"] * US,
                                "dur": (e["ready_at"] - e["t"]) * US,
                                "name": "cold_start",
                                "args": {"cause": e["cause"]}})
            elif k == "step":
                out.append({"ph": "X", "pid": pid, "tid": tid,
                            "ts": e["t"] * US, "dur": e["dt"] * US,
                            "name": "step",
                            "args": {"batch": e["batch"],
                                     "ckpt_cost": e["ckpt_cost"],
                                     "tier_cost": e["tier_cost"]}})
            elif k == "migrate_start":
                mig_open[rep] = e["t"]
            elif k == "migrate_end":
                t0 = mig_open.pop(rep, e["t"])
                out.append({"ph": "X", "pid": pid, "tid": tid,
                            "ts": t0 * US, "dur": (e["t"] - t0) * US,
                            "name": "migration",
                            "args": {"switch_cost": e["switch_cost"]}})
            elif k == "replica_crash":
                out.append({"ph": "i", "pid": pid, "tid": tid,
                            "ts": e["t"] * US, "s": "t", "name": "crash",
                            "args": {"cause": e["cause"],
                                     "requeued": e["requeued"]}})
            elif k == "zone_outage":
                out.append({"ph": "i", "pid": pid, "tid": 0,
                            "ts": e["t"] * US, "s": "p",
                            "name": "zone_outage",
                            "args": {"killed": e["killed"],
                                     "down_until": e["down_until"]}})
            elif k == "repartition":
                out.append({"ph": "i", "pid": 0, "tid": 0,
                            "ts": e["t"] * US, "s": "g",
                            "name": "repartition",
                            "args": {"reason": e.get("reason"),
                                     "migrations": e.get("migrations")}})
            elif k == "scale":
                out.append({"ph": "i", "pid": 0, "tid": 0,
                            "ts": e["t"] * US, "s": "g",
                            "name": "scale_up" if e["action"] > 0
                            else "scale_down",
                            "args": {"reason": e["reason"]}})
        doc = {"traceEvents": out, "displayTimeUnit": "ms"}
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(out)
