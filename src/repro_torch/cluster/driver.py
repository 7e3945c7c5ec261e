"""Cluster driver — interleaves many steppable ``PatchedServeEngine``s on
one discrete-event sim clock.

The driver owns global time. Per event it: (1) delivers Poisson arrivals to
the router frontend, (2) finalizes drained retiring replicas, (3) lets the
autoscaler add/retire replicas, (4) dispatches the frontend queue —
form-then-dispatch when a batch former is configured
(``ClusterConfig.batcher``): the former picks *what* ships (patch-
compatible gangs under per-request eligibility windows), the policy picks
*where*, and each gang is admitted atomically — (5) ticks every ready,
free replica that has work (one non-preemptible denoising step each,
exactly the single-engine iteration), then advances to the next arrival /
step-completion / warm-up / hold-release instant.

Replica construction is policy-aware: under the affinity policies
(``resolution_affinity`` and its zone-spread variant) the fleet's
resolution ladder is partitioned (``partition_resolutions``) and each
replica's engine is built over one block only — so its GCD patch is larger
and its patch cache sees fewer distinct shapes. All other policies build
uniform replicas over the full ladder.

With a ``RepartitionConfig`` the affinity partition is no longer frozen at
construction: the driver keeps a windowed resolution-mix histogram
(``MixTracker``) over frontend arrivals, and when the observed mix drifts
past an L1 threshold from the mix the current partition was built for, it
recomputes the partition for the *observed* mix and migrates surplus
replicas to their new blocks — drain-before-switch (in-flight requests
finish on the old block) with an honest ``switch_cost`` charged on the sim
clock before the migrated replica serves again.

The elastic fleet controller extends the same machinery along two axes:

- **Fleet-size-aware repartitioning** (``RepartitionConfig.on_resize``,
  default on): every autoscaler fleet-size change — spawn, retirement,
  crash — re-derives the *block structure* for the new replica count
  (``partition_resolutions`` / ``allocate_replica_counts`` at the new
  ``k``), not just the replica-to-block assignment, and migrates the
  surplus replicas drain-before-switch. GCD patch size and cache locality
  stay optimal as the fleet grows and shrinks; at a stable fleet size the
  plan is a fixed point and no further migration fires.
- **Failure injection + recovery** (``FailureConfig``): each replica draws
  an exponential lifetime at spawn (memoryless, so the fleet sees Poisson
  crashes on the sim clock). A crash kills the replica without draining;
  the driver requeues everything it held through the router head (the dead
  replica is excluded automatically — retired replicas are never dispatch
  candidates) and, when ``recover`` is set, immediately spawns a
  cold-started replacement over the dead replica's block so its
  resolutions never become unroutable.

The fault-tolerance layer on top (this module + ``replica.py``):

- **Partial-progress checkpointing** (``ClusterConfig.checkpoint``):
  replicas snapshot per-request denoise progress every ``every_k_steps``
  (write cost charged on the sim clock); on crash, orphans are requeued
  with ``steps_done`` restored to the last checkpoint instead of 0, so the
  fleet redoes only the steps since the snapshot. Exactly-once accounting
  is untouched — a request still completes on exactly one replica — and
  every latency/slack estimate already prices ``remaining_steps`` only, so
  a resumed request is priced for the remainder, not the full denoise.
- **Correlated zone failures** (``FailureConfig.zones`` +
  ``zone_mtbf``): replicas are assigned to ``zones`` fault domains
  round-robin at spawn; each zone draws recurrent outage times
  (Poisson, mean ``zone_mtbf``). An outage kills every replica in the
  zone at the same instant and leaves the zone down for
  ``zone_downtime`` seconds; a replacement blindly placed into a down
  zone cannot boot until the zone recovers (its cold start only begins
  then) — which is precisely what fault-domain-aware placement avoids.
- **Zone-aware placement** (``zone_spread`` /
  ``resolution_affinity_spread`` policies): spawns — initial, autoscaler,
  and crash replacements — go to the live zone with the fewest replicas of
  the same block, so no resolution's capacity is concentrated in one fault
  domain and recovery lands in surviving zones.

The fleet patch-cache tier (``ClusterConfig.cache_tier``, this module +
``cachetier.py`` + ``replica.py``): replicas model a bounded L1 of warm
(resolution, patch, step-band) keys and share a byte-capacity L2 store.
Cold keys fetch a sibling's committed warm entries (``fetch_cost`` on the
step's busy horizon) or self-warm over ``warmup_steps`` and publish back
(``write_cost``, two-phase — the driver settles due commits each event
*after* the crash pass, so an in-flight write orphaned by a crash is
aborted, never half-committed). The ``cache_affinity`` dispatch policy
routes each request to the replica warmest for its resolution.
``summary()["cache_tier"]`` reports L1/L2 hit rates, bytes, evictions.

Warm-boot elastic spawns (``CacheTierConfig.prefetch_on_spawn``): every
spawn — initial, autoscaler scale-up, crash replacement — bulk-prefetches
its block's committed tier entries into the new replica's L1 during the
cold start (``TierClient.prefetch_block``). The transfer is size-dependent
(``fetch_time`` per entry) and overlaps boot: ``ready_at`` extends only if
the transfer outlasts the cold start. The driver also flags the autoscaler
``warm_boot`` so predictive pre-spawns are priced with the shorter
effective cold start (``AutoscalerConfig.warm_boot_factor``) — the
elastic controller and the cache tier composing is exactly the regime the
``--warmboot`` benchmark section asserts.

Engines must be sim-clock (``EngineConfig.clock == "sim"``); for large
sweeps build them with ``sim_synthetic=True`` (see
``repro_torch.cluster.simtools``).
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.requests import Request
from repro_torch.core.serving import TickEvents
from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.cluster.batcher import BatchFormer, BatchFormerConfig
from repro_torch.cluster.cachetier import (CacheTier, CacheTierConfig, TierClient,
                                           aggregate_client_stats)
from repro_torch.cluster.metrics import ClusterMetrics, ReplicaReport
from repro_torch.cluster.replica import (MODEL_TIERS, CheckpointConfig, ModelTier,
                                         Replica, tier_ladder)
from repro_torch.cluster.router import (MixTracker, Router,
                                        allocate_replica_counts, make_policy,
                                        mix_drift, partition_resolutions)
from repro_torch.cluster.monitor import FleetMonitor, MonitorConfig
from repro_torch.cluster.trace import NULL_TRACER, TraceConfig, Tracer

Resolution = Tuple[int, int]
EngineFactory = Callable[[Sequence[Resolution]], "object"]


@dataclass
class RepartitionConfig:
    """Drift- and resize-triggered affinity repartitioning
    (resolution_affinity / resolution_affinity_spread only)."""
    drift_threshold: float = 0.3     # L1(observed mix, built-for mix), in
    #                                  [0, 2]; drift fires above it
    window: float = 10.0             # arrival-mix histogram window (s)
    min_samples: int = 30            # arrivals before drift is trusted
    cooldown: float = 8.0            # min seconds between repartitions
    switch_cost: float = 1.0         # sim-seconds a replica is unavailable
    #                                  while swapping blocks (post-drain)
    max_concurrent: int = 1          # replicas draining-to-migrate at once
    # recompute the block structure whenever the dispatchable fleet size
    # changes (autoscaler spawn/retire, crash) — the elastic controller's
    # placement half; off keeps drift-only repartitioning
    on_resize: bool = True


@dataclass
class FailureConfig:
    """Failure injection on the sim clock: independent Poisson replica
    crashes (``mtbf``) and, with ``zones`` > 1 and ``zone_mtbf`` set,
    correlated fault-domain outages that kill every replica in a zone at
    the same instant and keep the zone down for ``zone_downtime`` seconds.
    Every replica draws an exponential lifetime when it spawns (memoryless,
    so the fleet failure process is Poisson); the driver detects a due
    crash at the next event, requeues the dead replica's queued + in-flight
    requests through the router, and — when ``recover`` — replaces it with
    a cold-started engine over the same resolution block. Replicas are
    assigned to zones round-robin at spawn unless a zone-aware policy asks
    the driver for balanced placement across *live* zones."""
    mtbf: Optional[float] = 30.0     # mean seconds to crash, per replica
    #                                  (None: no independent crashes)
    recover: bool = True             # spawn a replacement on detection
    # replacement warm-up; None -> autoscaler cold_start (or 2.0 s without
    # an autoscaler)
    cold_start: Optional[float] = None
    # stop injecting *independent* crashes after this many (zone kills have
    # their own budget below and still fire — an outage wipes its zone even
    # when the Poisson crash budget is spent)
    max_failures: Optional[int] = None
    # -- correlated fault-domain outages --------------------------------
    zones: int = 1                   # fault domains; replicas round-robin
    zone_mtbf: Optional[float] = None    # mean seconds between outages,
    #                                      per zone (None: no outages)
    zone_downtime: float = 6.0       # seconds a zone stays down per outage
    max_zone_outages: Optional[int] = None   # stop injecting after this many
    # probability that a due zone outage is a *partial degradation* instead
    # of a wipe: replicas in the zone keep serving their in-flight work but
    # accept no new dispatches until the zone recovers (think: network
    # brown-out / control-plane loss, not host death). 0.0 (default) keeps
    # every outage a full wipe, bit-identical with earlier behavior.
    zone_degrade_prob: float = 0.0
    seed: int = 0                    # RNG seed for every failure draw


@dataclass
class ClusterConfig:
    """Top-level fleet configuration. Scalar knobs live here; each
    optional subsystem is switched on by handing its config object
    (every ``None`` default keeps the corresponding layer off with the
    simpler behavior bit-identical). Overview + knob table:
    docs/ARCHITECTURE.md."""
    n_replicas: int = 2              # initial fleet size (replicas)
    policy: str = "round_robin"      # dispatch policy name (router.py
    #                                  POLICIES: round_robin /
    #                                  join_shortest_queue / least_slack /
    #                                  resolution_affinity / zone_spread /
    #                                  resolution_affinity_spread /
    #                                  cache_affinity[_spread] / cascade)
    # heterogeneous model cascade: tier name -> replica count, each name a
    # ``replica.MODEL_TIERS`` entry (e.g. {"lite": 2, "base": 1, "max": 1}).
    # When set, the fleet size is the sum of the counts (``n_replicas`` is
    # ignored), every replica serves the full resolution ladder at its
    # tier's step cost, and the driver installs the escalation gate: an
    # under-quality completion re-enters the frontend targeted at the next
    # tier up when its remaining slack can cover the re-run. None (default)
    # keeps the homogeneous fleet bit-identical.
    tiers: Optional[Dict[str, int]] = None
    # elasticity: reactive + predictive scaling (None: fixed fleet)
    autoscaler: Optional[AutoscalerConfig] = None
    # resolution mix the initial affinity partition is provisioned for
    # (uniform if None — the paper's workload assumption)
    initial_mix: Optional[Sequence[float]] = None
    # drift-/resize-triggered affinity repartitioning (None: frozen blocks)
    repartition: Optional[RepartitionConfig] = None
    # crash / zone-outage injection (None: failure-free fleet)
    failures: Optional[FailureConfig] = None
    # partial-progress checkpointing of in-flight requests (None: crash
    # orphans restart from denoise step 0)
    checkpoint: Optional[CheckpointConfig] = None
    # fleet patch-cache tier (cachetier.py): per-replica L1 warmth dynamics
    # + a shared L2 store replicas fetch from / publish to. None keeps the
    # always-warm cache surrogate; capacity_bytes=0 models
    # L1 warmth with NO fleet tier (the honest no-tier baseline).
    cache_tier: Optional[CacheTierConfig] = None
    # sim-clock event bus + per-request span tracer (trace.py). None keeps
    # tracing disabled — a guarded no-op with bit-identical metrics.
    trace: Optional[TraceConfig] = None
    # streaming fleet health monitor (monitor.py): windowed timeseries over
    # the trace bus + SLO burn-rate alerting + changepoint detection. None
    # keeps monitoring off with bit-identical metrics (same guard style as
    # ``trace``); when set without ``trace`` the driver runs an internal
    # violations-mode tracer as the bus (trace outputs stay disabled).
    monitor: Optional[MonitorConfig] = None
    # router-side batch former (batcher.py): gang-dispatch patch-compatible
    # frontend work under per-request eligibility windows and the target
    # replica's batch-latency budget. None keeps per-request dispatch.
    batcher: Optional[BatchFormerConfig] = None
    record_timeseries: bool = True     # keep per-event queue/fleet series
    #                                    (off saves memory on long sweeps)
    max_events: int = 2_000_000        # runaway-loop backstop (sim events)


class Escalator:
    """Confidence gate for tiered fleets (the cascade's second half; the
    ``cascade`` dispatch policy is the first). Installed by the driver into
    every replica: ``Replica.tick`` hands it each tick's completions, and
    any completion whose tier quality falls short of the request's
    difficulty is either **escalated** — pulled back out of the completed
    set (its engine-metrics completion retracted), reset to step 0, floored
    at the next tier up (``Request.min_quality``), and scheduled to
    re-enter the frontend at the completion instant — or **given up on**:
    the cheap output is accepted as-is when no higher tier exists or the
    request's *remaining* slack cannot cover a full re-run anywhere
    upstream. Escalation is priced against remaining slack honestly: the
    re-run is predicted with the target replicas' own tier-scaled latency
    surrogates plus their current backlogs.

    Runs tracer-independent (it never emits events itself), so headline
    metrics are bit-identical with tracing on or off."""

    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster
        self.escalations = 0         # completions sent up a tier
        self.give_ups = 0            # had a tier above, but slack too tight
        self.quality_unmet = 0       # under-quality outputs accepted as-is
        self.slo_met_low_quality = 0  # ...of which met their latency SLO
        self.gate_checks = 0         # completions the gate inspected
        self._seq = 0                # heap tie-break (stable FIFO order)

    def _next_tier(self, tier: ModelTier) -> Optional[ModelTier]:
        ladder = self.cluster._tier_ladder
        for i, t in enumerate(ladder):
            if t.name == tier.name:
                return ladder[i + 1] if i + 1 < len(ladder) else None
        return None

    def _fits(self, req: Request, floor: ModelTier, end: float) -> bool:
        """Can any live replica of quality >= ``floor`` finish a full
        re-run of ``req`` inside its remaining slack? Priced exactly like
        ``Replica.predicted_finish`` — backlog ahead of it plus its steps
        at the candidate's own (tier-scaled) predicted step latency — but
        from the escalation instant and for the full denoise (escalation
        restarts at step 0 on the bigger model)."""
        best = None
        for rep in self.cluster.replicas:
            if rep.retired_at is not None or rep.retiring:
                continue
            t = rep.model_tier
            if t is None or t.quality < floor.quality \
                    or not rep.supports(req.resolution):
                continue
            eng = rep.engine
            t0 = max(end, rep.ready_at)
            pf = t0 + rep.backlog(end) \
                + eng._predict_step_latency(eng.active + [req]) \
                * req.total_steps
            if best is None or pf < best:
                best = pf
        return best is not None and best <= req.slo

    def intercept(self, rep: Replica, ev: TickEvents) -> List[Request]:
        """Gate ``ev.completed`` in place; returns the requests escalated
        this tick (already scheduled for frontend re-entry)."""
        tier = rep.model_tier
        if tier is None:
            return []
        end = ev.end
        out: List[Request] = []
        for req in list(ev.completed):
            self.gate_checks += 1
            if tier.quality >= req.difficulty:
                continue             # confident: output accepted
            nxt = self._next_tier(tier)
            if nxt is not None and self._fits(req, nxt, end):
                ev.completed.remove(req)
                rep._retract_completion(req)
                req.state = "waiting"
                req.steps_done = 0
                req.latent = None
                req.text = None
                req.finish = None
                req.min_quality = nxt.quality
                self.escalations += 1
                self._seq += 1
                heapq.heappush(self.cluster._esc_pending,
                               (end, self._seq, req))
                out.append(req)
            else:
                # no tier above, or remaining slack cannot cover the
                # re-run: accept the under-quality output as final
                self.quality_unmet += 1
                if end <= req.slo:
                    self.slo_met_low_quality += 1
                if nxt is not None:
                    self.give_ups += 1
        return out


class Cluster:
    def __init__(self, engine_factory: EngineFactory,
                 resolutions: Sequence[Resolution], cfg: ClusterConfig):
        self.make_engine = engine_factory
        self.resolutions = sorted({tuple(r) for r in resolutions})
        self.cfg = cfg
        self.policy = make_policy(cfg.policy)
        # capability flags come from the policy registry (declared by
        # @register_policy), not string-set membership
        self._affinity = self.policy.affinity
        self._zone_aware = self.policy.zone_aware
        # heterogeneous model cascade: resolve zoo names -> ModelTier, keep
        # the ladder (cheap-to-expensive) as the escalation order
        self.tiers: Dict[str, int] = dict(cfg.tiers) if cfg.tiers else {}
        self._tier_ladder: List[ModelTier] = []
        self._escalator: Optional[Escalator] = None
        self._esc_pending: List[Tuple[float, int, Request]] = []
        if self.tiers:
            unknown = sorted(n for n in self.tiers if n not in MODEL_TIERS)
            if unknown:
                raise ValueError(
                    f"unknown model tier(s) {unknown}; available: "
                    f"{sorted(MODEL_TIERS)}")
            if any(c < 1 for c in self.tiers.values()):
                raise ValueError("every tier count must be >= 1")
            if self._affinity:
                raise ValueError(
                    "model tiers and resolution-affinity partitioning are "
                    "mutually exclusive (tiered replicas serve the full "
                    "ladder so any tier can take any resolution)")
            self._tier_ladder = tier_ladder(
                MODEL_TIERS[n] for n in self.tiers)
            self._escalator = Escalator(self)
        if self.policy.needs_tier and not self.tiers:
            raise ValueError(
                f"policy {self.policy.name!r} requires a tiered fleet — "
                "set ClusterConfig.tiers")
        # event bus / span tracer (must exist before the first _spawn and
        # before router/autoscaler/tier wiring below). Denoise-band
        # sub-decomposition aligns with the tier's step bands when a tier
        # is configured.
        self._trace_requested = cfg.trace is not None
        if cfg.trace is not None or cfg.monitor is not None:
            bands = cfg.cache_tier.step_bands if cfg.cache_tier is not None \
                else 4
            # monitor without trace: the monitor still needs the bus, so
            # run an internal tracer in the bounded ``violations`` mode;
            # ``_trace_requested`` keeps every trace-only output (summary
            # attribution/predictor/trace_events) gated off
            tcfg = cfg.trace if cfg.trace is not None \
                else TraceConfig(mode="violations")
            self.tracer = Tracer(tcfg, step_bands=bands)
        else:
            self.tracer = NULL_TRACER
        self.monitor = FleetMonitor(cfg.monitor, self.tracer) \
            if cfg.monitor is not None else None
        self.router = Router(self.policy)
        self.router.tracer = self.tracer
        self.autoscaler = Autoscaler(cfg.autoscaler) if cfg.autoscaler else None
        if self.autoscaler is not None:
            self.autoscaler.tracer = self.tracer
        self.replicas: List[Replica] = []
        self._next_rid = 0
        # failure injection (must exist before the first _spawn below)
        fcfg = cfg.failures
        if fcfg is not None:
            if fcfg.zones < 1:
                raise ValueError(f"zones must be >= 1, got {fcfg.zones}")
            if fcfg.zone_mtbf is not None and fcfg.zones < 2:
                raise ValueError(
                    "zone outages need zones >= 2 (a 1-zone outage is just "
                    "a fleet wipe; set mtbf for independent crashes)")
            if not 0.0 <= fcfg.zone_degrade_prob <= 1.0:
                raise ValueError("zone_degrade_prob must be in [0, 1]")
        self._failure_rng = np.random.default_rng(
            fcfg.seed) if fcfg else None
        # fleet patch-cache tier (must exist before the first _spawn below
        # so initial replicas get their TierClients)
        self.cache_tier = CacheTier(cfg.cache_tier) \
            if cfg.cache_tier is not None else None
        if self.cache_tier is not None:
            self.cache_tier.tracer = self.tracer
            if cfg.cache_tier.prefetch_on_spawn \
                    and cfg.cache_tier.capacity_bytes > 0 \
                    and self.autoscaler is not None:
                # spawns boot warm (tier prefetch below): let the predictive
                # autoscaler price them with the shorter effective cold
                # start (AutoscalerConfig.warm_boot_factor)
                self.autoscaler.warm_boot = True
        self._n_crashes = 0          # independent crashes (max_failures cap)
        self._recoveries = 0
        self._requeue_delays: List[float] = []
        self._steps_resumed = 0          # checkpointed steps not redone
        self.failure_log: List[dict] = []
        # fault domains: round-robin counter (blind placement), per-zone
        # down-until horizon, and the recurrent outage schedule
        self._zone_counter = 0
        self._zone_down_until: Dict[int, float] = {}
        # partial degradation: zone -> recovery instant. A degraded zone's
        # replicas stay alive and finish in-flight work but take no new
        # dispatches (Replica.dispatchable, refreshed each event).
        self._zone_degraded_until: Dict[int, float] = {}
        self._zone_outage_at: Dict[int, float] = {}
        self._n_zone_outages = 0
        self.zone_outage_log: List[dict] = []
        if fcfg is not None and fcfg.zone_mtbf is not None:
            # separate stream so per-replica crash draws stay bit-identical
            # with and without the zone-outage process enabled
            self._zone_rng = np.random.default_rng(fcfg.seed + 1)
            for z in range(fcfg.zones):
                self._zone_outage_at[z] = float(
                    self._zone_rng.exponential(fcfg.zone_mtbf))
        if cfg.initial_mix is not None:
            mix0 = np.asarray(cfg.initial_mix, np.float64)
            if len(mix0) != len(self.resolutions) or (mix0 < 0).any() \
                    or mix0.sum() <= 0:
                raise ValueError(
                    f"initial_mix must be {len(self.resolutions)} "
                    f"non-negative shares (one per resolution in "
                    f"{self.resolutions}), got {cfg.initial_mix!r}")
        else:
            mix0 = np.full(len(self.resolutions),
                           1.0 / max(len(self.resolutions), 1))
        mix0 = mix0 / mix0.sum()
        self._built_mix = mix0
        mix_map = self._mix_map(mix0) if cfg.initial_mix is not None else None
        if self._affinity:
            self._blocks = partition_resolutions(self.resolutions,
                                                 cfg.n_replicas, mix=mix_map)
            counts = allocate_replica_counts(self._blocks, cfg.n_replicas,
                                             mix=mix_map)
        else:
            self._blocks = [list(self.resolutions)]
            counts = [cfg.n_replicas]
        # batch former: gang compatibility is keyed by the same GCD-patch
        # partition affinity placement uses. Non-affinity fleets serve the
        # full ladder per replica, so the former cuts its *own* max-GCD
        # partition over the ladder (per-resolution blocks on the default
        # one) purely as the gang key; affinity fleets share the driver's
        # live blocks, re-synced on every repartition.
        self.former: Optional[BatchFormer] = None
        if cfg.batcher is not None:
            self.former = BatchFormer(cfg.batcher)
            self.former.set_blocks(
                self._blocks if self._affinity else partition_resolutions(
                    self.resolutions, len(self.resolutions)))
            self.router.former = self.former
        if self.tiers:
            # tiered fleets: every replica serves the full ladder at its
            # tier's step cost; spawn cheap-to-expensive for stable rids
            for tier in self._tier_ladder:
                for _ in range(self.tiers[tier.name]):
                    self._spawn(list(self.resolutions), now=0.0, cold=0.0,
                                tier=tier)
        else:
            for block, c in zip(self._blocks, counts):
                for _ in range(c):
                    self._spawn(block, now=0.0, cold=0.0)
        # drift-/resize-triggered repartitioning state
        self._built_k = len(self.replicas)  # fleet size blocks were cut for
        self.mix_tracker: Optional[MixTracker] = None
        self._migration_queue: Deque[Tuple[Replica, List[Resolution]]] = \
            deque()
        self._last_repartition = -1e18
        self.repartition_log: List[dict] = []
        if cfg.repartition and self._affinity:
            self.mix_tracker = MixTracker(self.resolutions,
                                          window=cfg.repartition.window)

    def _mix_map(self, mix: Sequence[float]) -> Dict[Resolution, float]:
        return {res: float(m) for res, m in zip(self.resolutions, mix)}

    # ---------------- fleet mutation ----------------

    def _zone_down(self, zone: int, now: float) -> bool:
        return self._zone_down_until.get(zone, -1e18) > now

    def _zone_degraded(self, zone: int, now: float) -> bool:
        return self._zone_degraded_until.get(zone, -1e18) > now

    def _assign_zone(self, block: Sequence[Resolution], now: float) -> int:
        """Fault domain for a new replica. Blind (default): round-robin over
        all zones, down or not — the realistic no-anti-affinity baseline —
        EXCEPT when the fleet has drifted lopsided (crash/replacement churn
        can concentrate a blind fleet): then even a zone-unaware spawn path
        self-corrects into the least-occupied live zone. The trigger
        compares the fullest zone against the emptiest *live* zone, so a
        zone that is merely down (its replicas dead) never trips it — a
        blind fleet keeps paying the down-zone respawn stall that
        zone-aware placement avoids. Zone-aware policies: the live zone
        holding the fewest replicas of the same block (then fewest
        overall), so each resolution block is spread across surviving
        fault domains."""
        fcfg = self.cfg.failures
        zones = fcfg.zones if fcfg is not None else 1
        if zones <= 1:
            return 0
        if not self._zone_aware:
            occ = {z: 0 for z in range(zones)}
            for r in self._dispatchable():
                occ[r.zone] += 1
            live = [z for z in range(zones) if not self._zone_down(z, now)
                    and not self._zone_degraded(z, now)]
            if live and max(occ.values()) - min(occ[z] for z in live) >= 2:
                # drifted lopsided: place where live occupancy is lowest
                # (round-robin drift is at most 1, so a gap of 2+ is real)
                return min(live, key=lambda z: (occ[z], z))
            z = self._zone_counter % zones
            self._zone_counter += 1
            return z
        live = [z for z in range(zones) if not self._zone_down(z, now)
                and not self._zone_degraded(z, now)]
        cand = live or list(range(zones))
        want = {tuple(r) for r in block}
        in_block: Dict[int, int] = {z: 0 for z in cand}
        total: Dict[int, int] = {z: 0 for z in cand}
        for r in self._dispatchable():
            if r.zone in total:
                total[r.zone] += 1
                if {tuple(x) for x in r.resolutions} == want:
                    in_block[r.zone] += 1
        return min(cand, key=lambda z: (in_block[z], total[z], z))

    def _spawn(self, resolutions: Sequence[Resolution], now: float,
               cold: float, cause: str = "init",
               tier: Optional[ModelTier] = None) -> Replica:
        eng = self.make_engine(list(resolutions))
        if eng.cfg.clock != "sim":
            raise ValueError("cluster driver requires sim-clock engines")
        if tier is not None:
            # tier the engine's latency surrogate: every predicted AND
            # executed step costs step_cost x the baseline. Standalone
            # latencies (SLO normalizers) stay baseline on purpose — an
            # SLO means the same thing on every tier.
            lm = getattr(eng, "latency_model", None)
            if lm is not None and hasattr(lm, "scale"):
                lm.scale = lm.scale * tier.step_cost
            else:
                base = eng._predict_step_latency
                eng._predict_step_latency = \
                    lambda reqs, _b=base, _c=tier.step_cost: _b(reqs) * _c
        zone = self._assign_zone(resolutions, now)
        if self._zone_down(zone, now):
            # blindly placed into a dead zone: the instance cannot boot
            # until the zone recovers, so cold start only begins then
            cold += self._zone_down_until[zone] - now
        rep = Replica(self._next_rid, eng, spawn_at=now, cold_start=cold,
                      zone=zone, checkpoint=self.cfg.checkpoint,
                      model_tier=tier)
        rep.tracer = self.tracer
        rep.escalator = self._escalator
        rep.dispatchable = not self._zone_degraded(zone, now)
        if self.cache_tier is not None:
            client = TierClient(self.cache_tier, rep.rid)
            rep.attach_tier(client)
            if self.cfg.cache_tier.prefetch_on_spawn:
                # warm boot: bulk-fetch the block's committed tier entries
                # into the new replica's L1 *during* the cold start. The
                # transfer overlaps boot — ready_at only moves if the
                # transfer outlasts the boot itself (tiny entries on a
                # multi-second cold start never delay readiness).
                n, nbytes, transfer = client.prefetch_block(
                    rep.resolutions, now)
                if n:
                    rep.ready_at = max(rep.ready_at, now + transfer)
                    rep.next_free = max(rep.next_free, rep.ready_at)
                    if self.tracer.enabled:
                        self.tracer.tier_prefetch(now, rep, n, nbytes,
                                                  transfer, rep.ready_at)
        fcfg = self.cfg.failures
        if self._failure_rng is not None and fcfg.mtbf is not None:
            # exponential lifetime drawn at spawn == memoryless per-replica
            # crash hazard == Poisson fleet failures (replacements included)
            rep.crash_at = now + self._failure_rng.exponential(fcfg.mtbf)
        self._next_rid += 1
        self.replicas.append(rep)
        if self.tracer.enabled:
            self.tracer.replica_spawn(rep, now, cause)
        return rep

    def _dispatchable(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.retired_at is None and not r.retiring]

    def _scale_up(self, now: float) -> None:
        cold = self.autoscaler.cfg.cold_start if self.autoscaler else 0.0
        if self.tiers:
            # cross-tier split: the autoscaler picks the tier with the
            # largest demand deficit from the windowed arrival-difficulty
            # mix and the learned per-tier service rates; the spawn pays
            # that tier's own cold start (weight load scales with size)
            tier = self.autoscaler.spawn_tier(
                now, self._tier_ladder, self._dispatchable()) \
                if self.autoscaler else self._tier_ladder[0]
            self._spawn(list(self.resolutions), now=now,
                        cold=tier.cold_start, cause="scale_up", tier=tier)
            return
        if self._affinity:
            # join the partition block with the worst backlog per server
            # (uncovered blocks first)
            def pressure(block):
                servers = [r for r in self._dispatchable()
                           if {tuple(x) for x in r.resolutions}
                           == {tuple(x) for x in block}]
                if not servers:
                    return float("inf")
                return sum(r.backlog(now) for r in servers) / len(servers)
            block = max(self._blocks, key=pressure)
        else:
            block = list(self.resolutions)
        self._spawn(block, now=now, cold=cold, cause="scale_up")

    def _scale_down(self, now: float) -> bool:
        """Mark the cheapest legal victim retiring; False when no replica
        may retire (so the caller can roll the autoscaler's decision
        back — a retirement that never happened must not be reported or
        consume cooldown)."""
        # replicas in (or queued for) a repartition migration already have a
        # block assignment the plan depends on — retiring one would leave
        # its target block unserved
        queued = {id(rep) for rep, _ in self._migration_queue}
        cands = [r for r in self._dispatchable()
                 if r.migrating_to is None and id(r) not in queued]
        if self._affinity:
            # never retire a block's last server: its resolutions would
            # become unroutable
            by_block = {}
            for r in cands:
                by_block.setdefault(
                    frozenset(tuple(x) for x in r.resolutions), []).append(r)
            cands = [r for grp in by_block.values() if len(grp) > 1
                     for r in grp]
        if self.tiers:
            # never retire a tier's last replica: the cascade ladder would
            # lose a rung (escalations above it become give-ups, and the
            # arrival mix it serves has nowhere cheaper to go)
            by_tier: Dict[str, List[Replica]] = {}
            for r in cands:
                if r.model_tier is not None:
                    by_tier.setdefault(r.model_tier.name, []).append(r)
            cands = [r for grp in by_tier.values() if len(grp) > 1
                     for r in grp]
            if cands and self.autoscaler is not None:
                # retire from the tier the difficulty mix says is most
                # over-provisioned, when it has a legal victim
                pick = self.autoscaler.retire_tier(
                    now, self._tier_ladder, self._dispatchable())
                if pick is not None:
                    narrowed = [r for r in cands
                                if r.model_tier.name == pick.name]
                    cands = narrowed or cands
        if not cands:
            return False
        victim = min(cands, key=lambda r: (r.queue_depth, r.backlog(now),
                                           -r.rid))
        victim.retiring = True             # drains, then retires
        if self.tracer.enabled:
            asc = self.autoscaler
            predictive = bool(asc is not None and asc.predictive_retirements
                              and asc.predictive_retirements[-1] == now)
            self.tracer.replica_retiring(victim, now, predictive)
        return True

    # ---------------- failure injection + recovery ----------------

    def _maybe_zone_outage(self, now: float) -> None:
        """Fire every zone outage whose scheduled instant is due: mark the
        zone down for ``zone_downtime`` seconds, schedule its next outage,
        and force a crash (at the outage instant) on every replica it
        hosts — the correlated kill ``_maybe_fail`` then processes in one
        batched requeue pass."""
        fcfg = self.cfg.failures
        if fcfg is None or fcfg.zone_mtbf is None:
            return
        for z, t in sorted(self._zone_outage_at.items()):
            if t > now:
                continue
            if fcfg.max_zone_outages is not None \
                    and self._n_zone_outages >= fcfg.max_zone_outages:
                del self._zone_outage_at[z]
                continue
            self._n_zone_outages += 1
            if fcfg.zone_degrade_prob > 0.0 and float(
                    self._zone_rng.uniform()) < fcfg.zone_degrade_prob:
                # partial degradation: the zone's replicas stay alive and
                # finish what they hold, but take no new dispatches until
                # recovery (Replica.dispatchable, refreshed per event).
                # The draw only happens when the knob is on, so the
                # default outage stream stays bit-identical.
                self._zone_degraded_until[z] = t + fcfg.zone_downtime
                self._zone_outage_at[z] = t + fcfg.zone_downtime + float(
                    self._zone_rng.exponential(fcfg.zone_mtbf))
                self.zone_outage_log.append({
                    "t": round(t, 3), "zone": z, "killed": 0,
                    "degraded": True,
                    "down_until": round(t + fcfg.zone_downtime, 3)})
                if self.tracer.enabled:
                    self.tracer.zone_outage(t, z, 0, t + fcfg.zone_downtime,
                                            degraded=True)
                continue
            self._zone_down_until[z] = t + fcfg.zone_downtime
            # next outage only after the zone is back up — a down zone
            # cannot fail again, and non-overlapping intervals keep the
            # availability accounting exact
            self._zone_outage_at[z] = t + fcfg.zone_downtime + float(
                self._zone_rng.exponential(fcfg.zone_mtbf))
            killed = 0
            for rep in self.replicas:
                if rep.retired_at is None and rep.zone == z:
                    rep.crash_at = t if rep.crash_at is None \
                        else min(rep.crash_at, t)
                    rep.zone_killed_at = t
                    killed += 1
            self.zone_outage_log.append({
                "t": round(t, 3), "zone": z, "killed": killed,
                "down_until": round(t + fcfg.zone_downtime, 3)})
            if self.tracer.enabled:
                self.tracer.zone_outage(t, z, killed,
                                        t + fcfg.zone_downtime)

    def _maybe_fail(self, now: float) -> bool:
        """Kill every replica whose scheduled crash is due — independent
        Poisson crashes and correlated zone kills alike: requeue the work it
        held through the router head (progress restored from the last
        checkpoint when checkpointing is on) and, under ``recover``, spawn a
        cold-started replacement over its block (its migration target if it
        died mid-migration — the repartition plan counted on that block
        being served)."""
        fcfg = self.cfg.failures
        if fcfg is None:
            return False
        self._maybe_zone_outage(now)
        progress = False
        tr = self.tracer
        all_orphans: List[Request] = []
        # (crash t, request, steps the crash rolled back, replica, cause)
        orphan_info: List[tuple] = []
        for rep in list(self.replicas):
            if rep.retired_at is not None or rep.crash_at is None \
                    or rep.crash_at > now:
                continue
            t = rep.crash_at
            # which process kills it: the correlated wipe owns the kill
            # whenever its instant is the one due (an earlier independent
            # crash_at in the same pass stays an independent crash)
            zone_kill = rep.zone_killed_at is not None \
                and rep.zone_killed_at <= t
            if not zone_kill and fcfg.max_failures is not None \
                    and self._n_crashes >= fcfg.max_failures:
                # the capped independent crash is cancelled — but if this
                # replica's zone has been wiped, the outage still kills it
                # (the cap only budgets the Poisson process)
                if rep.zone_killed_at is None:
                    rep.crash_at = None
                    continue
                t = rep.zone_killed_at
                zone_kill = True
            # a queued-but-unstarted migration also pins this replica's
            # planned target block — the replacement must honor it, or the
            # plan's block can lose its only intended server (the fleet
            # size is unchanged by recovery, so no resize replan would
            # ever repair the hole)
            target = rep.migrating_to
            for i, (qrep, qblock) in enumerate(self._migration_queue):
                if qrep is rep:
                    target = qblock
                    del self._migration_queue[i]
                    break
            block = [tuple(r) for r in (target or rep.resolutions)]
            # a crashed scale-down victim stays down: respawning it would
            # silently undo a retirement the autoscaler already decided
            # (and logged); its block is safe — _scale_down never picks a
            # block's last server
            was_retiring = rep.retiring
            if tr.enabled:
                # pre-crash progress, to price the steps the kill rolls
                # back (checkpoint restore happens inside fail())
                pre_steps = {r.rid: r.steps_done
                             for r in rep.engine.wait + rep.engine.active}
            orphans = rep.fail(t)
            if not zone_kill:
                # zone kills have their own budget (max_zone_outages);
                # only independent crashes consume the max_failures cap
                self._n_crashes += 1
            all_orphans.extend(orphans)
            resumed = sum(r.steps_done for r in orphans)
            self._steps_resumed += resumed
            if orphans:
                self._requeue_delays.extend(t - r.arrival for r in orphans)
            replaced = False
            if fcfg.recover and not was_retiring:
                cold = fcfg.cold_start
                if cold is None:
                    # tier-specific boot when the dead replica was tiered
                    # (a bigger model reloads slower); explicit
                    # FailureConfig.cold_start always wins
                    if rep.model_tier is not None:
                        cold = rep.model_tier.cold_start
                    else:
                        cold = self.autoscaler.cfg.cold_start \
                            if self.autoscaler else 2.0
                cap = self.autoscaler.cfg.max_replicas \
                    if self.autoscaler else None
                if cap is None or len(self._dispatchable()) < cap:
                    self._spawn(block, now=t, cold=cold, cause="recovery",
                                tier=rep.model_tier)
                    self._recoveries += 1
                    replaced = True
            cause = "zone" if zone_kill else "crash"
            self.failure_log.append({
                "t": round(t, 3), "rid": rep.rid, "zone": rep.zone,
                "cause": cause,
                "requeued": len(orphans), "steps_resumed": resumed,
                "replaced": replaced})
            if tr.enabled:
                tr.replica_crash(rep, t, cause, len(orphans), resumed,
                                 replaced)
                orphan_info.extend(
                    (t, r, pre_steps[r.rid] - r.steps_done, rep.rid, cause)
                    for r in orphans)
            progress = True
        if all_orphans:
            # one batched requeue so orphans of *different* same-pass
            # crashes still re-enter in global arrival order
            self.router.requeue(all_orphans)
            if tr.enabled:
                # requeue events in the router's order — (crash t, arrival)
                # — so the sorted bus keeps same-instant orphans of a zone
                # outage in arrival order
                for t, r, lost, rrid, cause in sorted(
                        orphan_info, key=lambda x: (x[0], x[1].arrival)):
                    tr.requeue(r, t, lost, rrid, cause)
        if progress and self._migration_queue:
            # a crash may have killed the actively migrating replica; the
            # queued movers must not wait on a drain that can no longer
            # finish (nothing else would ever restart them — the replan
            # gates block while the queue is non-empty)
            self._start_migrations(now)
        return progress

    # ---------------- drift-/resize-triggered repartitioning ----------------

    def _maybe_repartition(self, now: float) -> bool:
        """Recompute the affinity partition when the windowed arrival mix
        has drifted past the threshold from the mix the current partition
        was built for; queue drain-before-switch migrations for replicas
        whose block changed."""
        rcfg = self.cfg.repartition
        if self.mix_tracker is None or rcfg is None:
            return False
        if self._migration_queue or \
                any(r.migrating_to is not None for r in self.replicas):
            return False                   # previous plan still in flight
        if now - self._last_repartition < rcfg.cooldown:
            return False
        # mix(now) trims the window first — after an idle gap the stale
        # pre-trim sample count must not satisfy the min_samples gate
        mix = self.mix_tracker.mix(now)
        if self.mix_tracker.n_samples < rcfg.min_samples:
            return False
        drift = mix_drift(mix, self._built_mix)
        if drift <= rcfg.drift_threshold:
            return False
        return self._plan_repartition(now, mix, reason="drift", drift=drift)

    def _plan_mix(self, now: float) -> np.ndarray:
        """Mix to plan a repartition for: the windowed observed mix when the
        tracker has enough samples to trust, else the mix the current
        partition was built for."""
        rcfg = self.cfg.repartition
        if self.mix_tracker is not None and rcfg is not None:
            mix = self.mix_tracker.mix(now)
            if self.mix_tracker.n_samples >= rcfg.min_samples:
                return mix
        return self._built_mix

    def _maybe_resize_repartition(self, now: float) -> bool:
        """Recompute the block structure when the dispatchable fleet size no
        longer matches the size the current blocks were cut for (autoscaler
        spawn/retire or crash). At a stable fleet size the plan is a fixed
        point — ``_built_k`` tracks the planned-for size, so this never
        ping-pongs migrations without an actual size change."""
        rcfg = self.cfg.repartition
        if rcfg is None or not rcfg.on_resize or not self._affinity:
            return False
        if self._migration_queue or \
                any(r.migrating_to is not None for r in self.replicas):
            return False                   # previous plan still in flight
        if now - self._last_repartition < rcfg.cooldown:
            return False
        k = len(self._dispatchable())
        if k == 0 or k == self._built_k:
            return False
        return self._plan_repartition(now, self._plan_mix(now),
                                      reason="resize")

    def _plan_repartition(self, now: float, mix: Sequence[float],
                          reason: str,
                          drift: Optional[float] = None) -> bool:
        """Cut blocks + replica counts for the current dispatchable fleet
        over ``mix`` and queue drain-before-switch migrations for replicas
        whose block changed (replicas already on a target block stay put, so
        loaded replicas keep serving and fresh/cold ones do the moving)."""
        movers = self._dispatchable()
        k = len(movers)
        if k == 0:
            return False
        mix = np.asarray(mix, np.float64)
        mix_map = self._mix_map(mix)
        blocks = partition_resolutions(self.resolutions, k, mix=mix_map)
        counts = allocate_replica_counts(blocks, k, mix=mix_map)
        # match replicas to target blocks, keeping ones already in place
        targets: List[List[Resolution]] = []
        for block, c in zip(blocks, counts):
            targets.extend([list(block)] * c)
        moving: List[Replica] = []
        remaining = list(targets)
        for rep in movers:
            have = sorted(tuple(r) for r in rep.resolutions)
            hit = next((i for i, t in enumerate(remaining)
                        if [tuple(x) for x in t] == have), None)
            if hit is not None:
                remaining.pop(hit)
            else:
                moving.append(rep)
        self._blocks = blocks
        self._built_mix = mix
        self._built_k = k
        if self.former is not None and self._affinity:
            # gang compatibility must track the live partition, or a gang
            # cut for the old blocks could straddle the new ones
            self.former.set_blocks(blocks)
        self._last_repartition = now
        self._migration_queue = deque(zip(moving, remaining))
        entry = {
            "t": round(now, 3), "reason": reason,
            "mix": [round(float(m), 4) for m in mix],
            "blocks": [[list(r) for r in b] for b in blocks],
            "counts": counts, "k": k, "migrations": len(moving)}
        if drift is not None:
            entry["drift"] = round(drift, 4)
        self.repartition_log.append(entry)
        if self.tracer.enabled:
            self.tracer.repartition(now, entry)
        self._start_migrations(now)
        return True

    def _start_migrations(self, now: float) -> None:
        active = sum(1 for r in self.replicas if r.migrating_to is not None)
        limit = self.cfg.repartition.max_concurrent if self.cfg.repartition \
            else 1
        while self._migration_queue and active < limit:
            rep, block = self._migration_queue.popleft()
            if rep.retiring or rep.retired_at is not None:
                continue                   # victim vanished; drop the move
            rep.migrating_to = [tuple(r) for r in block]
            if self.tracer.enabled:
                self.tracer.migrate_start(rep, now, rep.migrating_to)
            active += 1

    def _finish_migrations(self, now: float) -> bool:
        """Swap engines on drained migrating replicas (switch cost charged)
        and start the next queued migration."""
        progress = False
        cost = self.cfg.repartition.switch_cost if self.cfg.repartition \
            else 0.0
        for rep in self.replicas:
            if rep.migrating_to is not None and rep.retired_at is None \
                    and not rep.has_work:
                eng = self.make_engine(list(rep.migrating_to))
                rep.switch_engine(eng, now, switch_cost=cost)
                if self.tracer.enabled:
                    self.tracer.migrate_end(rep, now, cost)
                progress = True
        if progress:
            self._start_migrations(now)
        return progress

    # ---------------- event loop ----------------

    def run(self, workload: List[Request]) -> ClusterMetrics:
        """Serve one workload to completion; single-use per Cluster."""
        pending = sorted(workload, key=lambda r: r.arrival)
        mts = ClusterMetrics()
        start = pending[0].arrival if pending else 0.0
        now = start
        events = 0

        while pending or self.router.queue or self._esc_pending \
                or any(r.has_work for r in self.replicas):
            events += 1
            if events > self.cfg.max_events:
                break
            progress = False

            while pending and pending[0].arrival <= now:
                req = pending.pop(0)
                self.router.enqueue(req)
                if self.mix_tracker is not None:
                    self.mix_tracker.observe(req.arrival, req.resolution)
                if self.autoscaler:
                    self.autoscaler.observe_arrival(
                        req.arrival,
                        difficulty=req.difficulty if self.tiers else None)
                progress = True

            # escalations re-enter the frontend at their completion
            # instant (straight into the queue — their trace span is still
            # open, so no second enqueue event; re-entries are not new
            # arrivals for the forecaster or the mix tracker either)
            while self._esc_pending and self._esc_pending[0][0] <= now:
                _, _, req = heapq.heappop(self._esc_pending)
                self.router.queue.append(req)
                progress = True

            if self._maybe_fail(now):
                progress = True

            if self._zone_degraded_until:
                # refresh per-replica dispatchability against the degraded
                # zones; pruning expired entries last means recovery still
                # gets one refresh pass that re-opens the zone's replicas
                for rep in self.replicas:
                    rep.dispatchable = not self._zone_degraded(rep.zone, now)
                for z in [z for z, u in self._zone_degraded_until.items()
                          if u <= now]:
                    del self._zone_degraded_until[z]

            if self.cache_tier is not None:
                # commit due in-flight L2 writes — after the crash pass, so
                # a write whose owner crashed before its commit instant has
                # already been aborted and can never half-commit
                self.cache_tier.settle(now)

            for rep in self.replicas:
                if rep.retiring and rep.retired_at is None \
                        and not rep.has_work:
                    rep.retired_at = now
                    if self.tracer.enabled:
                        self.tracer.replica_retired(rep, now)
                    progress = True

            if self._finish_migrations(now):
                progress = True

            if self.autoscaler:
                act = self.autoscaler.decide(now, self.router.depth,
                                             self.replicas)
                if act > 0:
                    self._scale_up(now)
                    progress = True
                elif act < 0:
                    if self._scale_down(now):
                        progress = True
                    else:
                        self.autoscaler.cancel_retirement(now)

            if self._maybe_repartition(now):
                progress = True

            if self._maybe_resize_repartition(now):
                progress = True

            if self.router.dispatch(self._dispatchable(), now):
                progress = True

            ticked = []
            ticked_tiers: List[str] = []
            for rep in self.replicas:
                if (rep.retired_at is None and rep.ready_at <= now
                        and rep.next_free <= now and rep.has_work):
                    ev = rep.tick(now)
                    ticked.append(ev)
                    ticked_tiers.append(rep.model_tier.name
                                        if rep.model_tier else "")
                    if ev.stepped or ev.admitted or ev.dropped:
                        progress = True
            if self.autoscaler and ticked:
                if self.tiers:
                    self.autoscaler.observe(now, ticked, tiers=ticked_tiers)
                else:
                    self.autoscaler.observe(now, ticked)

            if self.cfg.record_timeseries:
                mts.queue_ts.append((
                    now, self.router.depth,
                    sum(r.queue_depth for r in self.replicas
                        if r.retired_at is None),
                    len([r for r in self.replicas if r.ready(now)])))

            if self.monitor is not None:
                # end-of-iteration heartbeat: every event for sim-time
                # ``now`` has been delivered, so the monitor may close and
                # evaluate every window bin strictly before ``now``'s
                self.monitor.pulse(
                    now, queue_depth=self.router.depth,
                    replicas=sum(1 for r in self.replicas if r.ready(now)))

            # next event: arrival, step completion / warm-up of a loaded
            # replica, warm-up that could unblock the frontend, or the next
            # autoscaler decision while work is parked
            nxt = []
            if pending:
                nxt.append(pending[0].arrival)
            if self._esc_pending:
                nxt.append(self._esc_pending[0][0])
            for rep in self.replicas:
                if rep.retired_at is None and rep.has_work:
                    nxt.append(max(rep.next_free, rep.ready_at))
            if self.router.queue:
                nxt.extend(rep.ready_at for rep in self._dispatchable()
                           if rep.ready_at > now)
                # a degraded zone re-opening may unblock parked dispatches
                nxt.extend(u for u in self._zone_degraded_until.values()
                           if u > now)
                if self.autoscaler:
                    nxt.append(max(
                        self.autoscaler._last_action
                        + self.autoscaler.cfg.cooldown, now))
                if self.former is not None:
                    # held-for-batching requests release at their
                    # eligibility deadlines — sim events, so a hold can
                    # never be overshot by a quiet stretch of the clock
                    nxt.extend(self.former.deadlines(now))
            # scheduled crashes and zone outages are sim events too — but
            # only while real future work exists (a crash never un-sticks a
            # dead queue, so it must not keep the loop alive past the drop
            # branch)
            if self.cfg.failures is not None and (
                    pending or any(r.has_work for r in self.replicas
                                   if r.retired_at is None)):
                nxt.extend(r.crash_at for r in self.replicas
                           if r.retired_at is None
                           and r.crash_at is not None and r.crash_at > now)
                nxt.extend(t for t in self._zone_outage_at.values()
                           if t > now)

            future = [t for t in nxt if t > now]
            if progress and nxt:
                now = max(now, min(nxt))
            elif future:
                now = min(future)
            else:
                # a replica that finished draining for a migration this very
                # iteration is invisible to nxt (no work, not dispatchable):
                # swap it now — its post-switch warm-up may serve the queue
                if self._finish_migrations(now):
                    continue
                # nothing can ever serve what's left
                for r in self.router.queue:
                    r.state = "dropped"
                    if self.tracer.enabled:
                        self.tracer.drop(r, now, "frontend")
                mts.router_dropped += len(self.router.queue)
                self.router.queue.clear()
                break

        mts.span = now
        mts.sim_events = events
        if self.monitor is not None:
            # before the shutdown tier drain below: settle(inf) emits
            # post-run commit events that belong to no health window
            self.monitor.finalize(now)
            mts.monitor = self.monitor.summary()
        if self.cache_tier is not None:
            # graceful shutdown: every staged write belongs to a live
            # replica whose busy window completes (crashed owners were
            # aborted at kill time), so drain them all before reporting.
            # This settle runs BEFORE the tracer counters are snapshotted —
            # it emits tier_commit events, and summary()["trace_events"]
            # must agree with what the JSONL exporter writes.
            self.cache_tier.settle(float("inf"))
            mts.cache_tier = {
                **aggregate_client_stats([r.tier for r in self.replicas]),
                "tier": self.cache_tier.summary()}
        if self._trace_requested:
            # the monitor-only internal tracer must not change the summary
            # shape: trace outputs appear only when tracing was asked for
            mts.attribution = self.tracer.attribution_summary()
            mts.predictor = self.tracer.predictor_summary()
            mts.trace_events = self.tracer.n_events
        if self.former is not None:
            mts.batching = self.former.stats()
        mts.repartitions = list(self.repartition_log)
        mts.failures = list(self.failure_log)
        mts.replicas_failed = sum(1 for r in self.replicas
                                  if r.failed_at is not None)
        mts.recoveries = self._recoveries
        mts.requests_requeued = self.router.requeued
        mts.requeue_delays = list(self._requeue_delays)
        mts.steps_resumed = self._steps_resumed
        mts.checkpoint_writes = sum(r.checkpoint_writes
                                    for r in self.replicas)
        mts.checkpoint_time = sum(r.checkpoint_time for r in self.replicas)
        mts.zone_outages = list(self.zone_outage_log)
        mts.zone_availability = self._zone_availability(start, now)
        for rep in self.replicas:
            mts.per_replica[rep.rid] = ReplicaReport(
                metrics=rep.merged_metrics, patch=rep.patch,
                resolutions=[tuple(r) for r in rep.resolutions],
                busy_time=rep.busy_time, alive_time=rep.alive_span(now),
                migrations=rep.migrations,
                failed=rep.failed_at is not None, zone=rep.zone,
                tier=rep.model_tier.name if rep.model_tier else None)
        if self._escalator is not None:
            esc = self._escalator
            per_tier = {}
            for tier in self._tier_ladder:
                reps = [r for r in self.replicas if r.model_tier is not None
                        and r.model_tier.name == tier.name]
                alive = sum(r.alive_span(now) for r in reps)
                busy = sum(r.busy_time for r in reps)
                per_tier[tier.name] = {
                    "replicas": len(reps),
                    "completed": sum(r.merged_metrics.completed
                                     for r in reps),
                    "utilization": round(busy / alive, 4) if alive else 0.0,
                    "quality": tier.quality,
                    "step_cost": tier.step_cost,
                }
            mts.cascade = {
                "escalations": esc.escalations,
                "give_ups": esc.give_ups,
                "quality_unmet": esc.quality_unmet,
                "slo_met_low_quality": esc.slo_met_low_quality,
                "gate_checks": esc.gate_checks,
                "escalation_rate": round(
                    esc.escalations / max(esc.gate_checks, 1), 4),
                "per_tier": per_tier,
            }
        return mts

    def _zone_availability(self, start: float, end: float) -> Dict[int, float]:
        """Fraction of the run each fault domain was up, from the outage
        log (empty when no zone process is configured)."""
        fcfg = self.cfg.failures
        if fcfg is None or fcfg.zone_mtbf is None or end <= start:
            return {}
        down = {z: 0.0 for z in range(fcfg.zones)}
        for e in self.zone_outage_log:
            if e.get("degraded"):
                continue             # degraded zones are up (just closed
                #                      to new dispatches), not down
            t0 = max(e["t"], start)
            t1 = min(e["down_until"], end)
            if t1 > t0:
                down[e["zone"]] += t1 - t0
        span = end - start
        return {z: round(1.0 - d / span, 4) for z, d in down.items()}
