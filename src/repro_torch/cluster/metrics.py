"""Cluster-wide metric aggregation: fleet + per-replica SLO satisfaction,
goodput, utilization, and queue-depth / replica-count time series.

Fleet numbers fold every replica's engine ``Metrics`` together with
router-level drops (requests that died in the frontend queue because no
replica could ever take them). Utilization charges a replica's whole
lifetime — cold start included — as capacity, so aggressive scaling that
thrashes replicas shows up as poor utilization rather than being hidden.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.serving import Metrics


@dataclass
class ReplicaReport:
    metrics: Metrics
    patch: int
    resolutions: List[Tuple[int, int]]
    busy_time: float
    alive_time: float
    migrations: int = 0                # affinity-block switches survived
    failed: bool = False               # killed by failure injection
    zone: int = 0                      # fault domain (driver-assigned)
    tier: Optional[str] = None         # model tier name (tiered fleets)

    @property
    def utilization(self) -> float:
        return self.busy_time / self.alive_time if self.alive_time else 0.0

    @property
    def cache_hit_rate(self) -> float:
        """Mean per-step patch-cache hit rate: measured reuse-mask means on
        the real tensor path, the modeled hit rate under the cache-aware sim
        surrogate (0.0 when neither is active)."""
        s = self.metrics.compute_savings
        return float(np.mean(s)) if s else 0.0


@dataclass
class ClusterMetrics:
    per_replica: Dict[int, ReplicaReport] = field(default_factory=dict)
    router_dropped: int = 0
    span: float = 0.0
    # (t, frontend depth, queued-in-replicas, dispatchable replicas)
    queue_ts: List[Tuple[float, int, int, int]] = field(default_factory=list)
    # drift- and resize-triggered repartition events
    # (driver.repartition_log entries)
    repartitions: List[dict] = field(default_factory=list)
    # failure injection / recovery (driver.failure_log entries)
    failures: List[dict] = field(default_factory=list)
    replicas_failed: int = 0
    recoveries: int = 0                # replacement replicas spawned
    requests_requeued: int = 0
    # seconds each crash-orphaned request had already waited when it was
    # requeued — the latency the failure added on top of normal queueing
    requeue_delays: List[float] = field(default_factory=list)
    # partial-progress checkpointing: snapshots written, sim seconds spent
    # writing them, and denoise steps crash orphans did NOT have to redo
    # because they resumed from a checkpoint
    checkpoint_writes: int = 0
    checkpoint_time: float = 0.0
    steps_resumed: int = 0
    # correlated fault-domain failures (driver.zone_outage_log entries) and
    # per-zone fraction of the run the zone was up
    zone_outages: List[dict] = field(default_factory=list)
    zone_availability: Dict[int, float] = field(default_factory=dict)
    # fleet patch-cache tier: folded TierClient stats (l1/l2 hit rates,
    # fetch/write clock time) + the CacheTier store summary (bytes,
    # entries, evictions, aborted in-flight writes). Empty dict when no
    # tier is configured.
    cache_tier: dict = field(default_factory=dict)
    # batch former (ClusterConfig.batcher): gang counts/sizes, hold
    # decisions, and the two structural guards the --batching benchmark
    # asserts (min_hold_slack_s, deadline_overshoot_max). Empty dict when
    # no former is configured.
    batching: dict = field(default_factory=dict)
    # driver event-loop iterations this run took — the sim-throughput
    # denominator for the nightly perf trajectory (always recorded)
    sim_events: int = 0
    # tracing (ClusterConfig.trace): SLO-violation attribution histogram,
    # predictor calibration, and retained bus events. Empty when disabled.
    attribution: dict = field(default_factory=dict)
    predictor: dict = field(default_factory=dict)
    trace_events: int = 0
    # heterogeneous model cascade (ClusterConfig.tiers): escalation gate
    # counters + per-tier replica/throughput/utilization breakdown
    # (driver-built). None when the fleet is homogeneous.
    cascade: Optional[dict] = None
    # fleet health monitor (ClusterConfig.monitor): alerts fired (total +
    # per rule), changepoints per watched signal, and incident
    # precision/recall counters (FleetMonitor.summary()). Empty dict when
    # monitoring is off.
    monitor: dict = field(default_factory=dict)

    # -- fleet aggregates --------------------------------------------------
    @property
    def completed(self) -> int:
        return sum(r.metrics.completed for r in self.per_replica.values())

    @property
    def dropped(self) -> int:
        return self.router_dropped + sum(
            r.metrics.dropped for r in self.per_replica.values())

    @property
    def slo_met(self) -> int:
        return sum(r.metrics.slo_met for r in self.per_replica.values())

    @property
    def slo_satisfaction(self) -> float:
        total = self.completed + self.dropped
        return self.slo_met / total if total else 1.0

    @property
    def slo_quality_attainment(self) -> float:
        """Fraction of requests that met their latency SLO *with* output
        quality at or above their difficulty. On a homogeneous fleet this
        equals ``slo_satisfaction``; on a cascade it discounts completions
        the confidence gate gave up on (cheap output accepted under
        quality) — the headline an always-cheap fleet cannot game."""
        low_q = self.cascade["slo_met_low_quality"] if self.cascade else 0
        total = self.completed + self.dropped
        return (self.slo_met - low_q) / total if total else 1.0

    @property
    def goodput(self) -> float:
        return self.slo_met / self.span if self.span else 0.0

    @property
    def utilization(self) -> float:
        busy = sum(r.busy_time for r in self.per_replica.values())
        alive = sum(r.alive_time for r in self.per_replica.values())
        return busy / alive if alive else 0.0

    @property
    def cache_hit_rate(self) -> float:
        """Fleet patch-cache hit rate: per-replica step hit rates weighted
        by how many steps each replica executed."""
        num = den = 0.0
        for r in self.per_replica.values():
            steps = len(r.metrics.compute_savings)
            num += r.cache_hit_rate * steps
            den += steps
        return num / den if den else 0.0

    @property
    def migrations(self) -> int:
        return sum(r.migrations for r in self.per_replica.values())

    @property
    def latencies(self) -> List[float]:
        out: List[float] = []
        for r in self.per_replica.values():
            out.extend(r.metrics.latencies)
        return out

    def latency_quantile(self, q: float) -> float:
        lats = self.latencies
        return float(np.quantile(lats, q)) if lats else 0.0

    def replica_count_stats(self) -> Dict[str, float]:
        if not self.queue_ts:
            return {"min": 0, "max": 0, "mean": 0.0, "final": 0}
        counts = np.asarray([p[3] for p in self.queue_ts], np.float64)
        return {"min": float(counts.min()), "max": float(counts.max()),
                "mean": float(counts.mean()), "final": float(counts[-1])}

    # -- JSON --------------------------------------------------------------
    def summary(self, full_timeseries: bool = False) -> dict:
        """JSON-ready fleet summary. By default the queue/replica time
        series is reduced to stats so sweep artifacts stay small —
        ``queue_ts_points_dropped`` says how many samples that reduction
        discarded. ``full_timeseries=True`` additionally emits the raw
        ``queue_timeseries`` rows ``[t, frontend_depth,
        queued_in_replicas, dispatchable_replicas]`` (what ``--trace-dir``
        persists)."""
        depths = np.asarray([p[1] + p[2] for p in self.queue_ts], np.float64) \
            if self.queue_ts else np.zeros(1)
        out = {
            "completed": self.completed,
            "dropped": self.dropped,
            "router_dropped": self.router_dropped,
            "slo_met": self.slo_met,
            "slo_satisfaction": round(self.slo_satisfaction, 4),
            "goodput": round(self.goodput, 4),
            "utilization": round(self.utilization, 4),
            "span": round(self.span, 3),
            "latency_p50": round(self.latency_quantile(0.5), 4),
            "latency_p95": round(self.latency_quantile(0.95), 4),
            "queue_depth_mean": round(float(depths.mean()), 3),
            "queue_depth_max": int(depths.max()),
            "replicas": self.replica_count_stats(),
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "migrations": self.migrations,
            "repartitions": self.repartitions,
            "failures": {
                "replicas_failed": self.replicas_failed,
                "recoveries": self.recoveries,
                "requests_requeued": self.requests_requeued,
                "requeue_delay_mean": round(float(
                    np.mean(self.requeue_delays)), 4)
                if self.requeue_delays else 0.0,
                "requeue_delay_p95": round(float(
                    np.quantile(self.requeue_delays, 0.95)), 4)
                if self.requeue_delays else 0.0,
                "zone_outages": self.zone_outages,
                "zone_availability": {str(z): a for z, a in
                                      sorted(self.zone_availability.items())},
                "events": self.failures,
            },
            "checkpoint": {
                "writes": self.checkpoint_writes,
                "overhead_s": round(self.checkpoint_time, 4),
                "steps_resumed": self.steps_resumed,
            },
            "cache_tier": self.cache_tier,
            "sim_events": self.sim_events,
            "per_replica": {
                str(rid): {
                    "patch": rep.patch,
                    "resolutions": [list(r) for r in rep.resolutions],
                    "completed": rep.metrics.completed,
                    "dropped": rep.metrics.dropped,
                    "slo_satisfaction": round(rep.metrics.slo_satisfaction, 4),
                    "utilization": round(rep.utilization, 4),
                    "cache_hit_rate": round(rep.cache_hit_rate, 4),
                    "migrations": rep.migrations,
                    "failed": rep.failed,
                    "zone": rep.zone,
                    **({"tier": rep.tier} if rep.tier is not None else {}),
                } for rid, rep in sorted(self.per_replica.items())},
        }
        if self.cascade is not None:
            out["cascade"] = self.cascade
            out["slo_quality_attainment"] = round(
                self.slo_quality_attainment, 4)
        if self.batching:
            out["batching"] = self.batching
        if self.attribution:
            out["attribution"] = self.attribution
        if self.predictor:
            out["predictor"] = self.predictor
        if self.trace_events:
            out["trace_events"] = self.trace_events
        if self.monitor:
            out["monitor"] = self.monitor
        if full_timeseries:
            out["queue_timeseries"] = [
                [round(t, 6), f, q, n] for t, f, q, n in self.queue_ts]
            out["queue_ts_points_dropped"] = 0
        else:
            # the mean/max reduction above discarded this many samples;
            # summary(full_timeseries=True) recovers them
            out["queue_ts_points_dropped"] = len(self.queue_ts)
        return out
