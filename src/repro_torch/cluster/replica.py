"""Replica — one steppable ``PatchedServeEngine`` plus the cluster-side
state the router and autoscaler need: readiness (cold start), busy horizon,
resolution coverage, and utilization accounting.

The cluster driver (``repro_torch.cluster.driver``) owns the sim clock; a replica
only executes when the driver calls ``tick(now)`` and is considered busy
until ``next_free = now + dt`` (one denoising step is non-preemptible, as in
the single-engine loop). Cold start is charged honestly: a freshly spawned
replica has ``ready_at = spawn_at + cold_start`` and the router will not
dispatch to it before then — arrivals keep waiting in the frontend queue.

Repartition migration uses the same drain-before-switch honesty: a replica
marked ``migrating_to`` takes nothing new, finishes its in-flight work on
the old affinity block, then swaps engines and pays ``switch_cost`` on the
sim clock before serving again. Metrics accumulated on retired engines are
folded into ``merged_metrics`` so nothing a replica served is lost across
migrations.

Failure injection (elastic controller): ``crash_at`` holds the replica's
scheduled crash instant (drawn by the driver at spawn under a
``FailureConfig``); ``fail(now)`` kills the replica *without* draining —
everything it held is orphaned back to the caller for router requeue.

Partial-progress checkpointing (``CheckpointConfig``): the replica
periodically snapshots each in-flight request's denoise progress to durable
storage — conceptually the latent plus its step index, written off the
critical path but *charged* on the sim clock (``write_cost`` extends the
step's busy horizon). On crash the snapshots survive the process: ``fail``
restores every orphan's ``steps_done`` to its last checkpoint instead of 0,
so the requeued request pays only the steps since the snapshot again. The
replica's ``zone`` is its fault domain (assigned by the driver at spawn);
a correlated zone outage kills every replica sharing it at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.requests import Request
from repro_torch.core.serving import Metrics, PatchedServeEngine, TickEvents
from repro_torch.cluster.trace import NULL_TRACER


@dataclass(frozen=True)
class ModelTier:
    """One rung of the heterogeneous-fleet model ladder (DiffServe-style
    cascade, PAPERS.md), a zoo of named instances.

    - ``step_cost``  — denoise step latency multiplier vs. the baseline
      model the SLOs are normalized against; it is also the tier's GPU-cost
      weight (a 2x-slower model is a 2x-bigger model), which is what the
      cascade benchmark's equal-cost fleets are balanced in.
    - ``quality``    — output quality score in (0, 1]; a completion
      satisfies a request iff ``quality >= request.difficulty``. The
      driver's confidence gate escalates the rest.
    - ``cold_start`` — tier-specific boot (weight load + compile) charged
      to scale-up spawns and crash replacements of this tier."""
    name: str
    step_cost: float
    quality: float
    cold_start: float

    def __post_init__(self) -> None:
        if self.step_cost <= 0:
            raise ValueError("step_cost must be > 0")
        if not 0.0 < self.quality <= 1.0:
            raise ValueError("quality must be in (0, 1]")
        if self.cold_start < 0:
            raise ValueError("cold_start must be >= 0")


#: the model-tier zoo: a distilled/turbo cheap tier, the baseline, and a
#: large high-fidelity tier. step_cost doubles per rung (the usual
#: parameter-count spread); quality is the tier's CLIP/FID-style score
#: rescaled to (0, 1] so it composes with Request.difficulty directly.
MODEL_TIERS: Dict[str, ModelTier] = {
    "lite": ModelTier("lite", step_cost=0.5, quality=0.55, cold_start=1.0),
    "base": ModelTier("base", step_cost=1.0, quality=0.80, cold_start=2.0),
    "max": ModelTier("max", step_cost=2.0, quality=1.00, cold_start=4.0),
}


def tier_ladder(tiers) -> List[ModelTier]:
    """Distinct tiers sorted cheap-to-expensive (by quality, then cost) —
    the escalation order: 'next tier up' is the next entry."""
    return sorted({t for t in tiers},
                  key=lambda t: (t.quality, t.step_cost, t.name))


@dataclass
class CheckpointConfig:
    """Partial-progress checkpointing of in-flight requests.

    Every ``every_k_steps`` denoise steps a request's latent + step index is
    snapshotted to durable storage; each snapshot costs ``write_cost``
    seconds on the sim clock (charged to the replica's busy horizon, so
    checkpointing honestly slows the replica that does it — the
    checkpoint-vs-restart benchmark only wins when the redone-work saved
    outweighs this tax). On a crash the driver requeues orphans with
    ``steps_done`` restored to the last snapshot instead of 0.

    With ``cost_per_byte`` > 0 the snapshot cost is latent-size-aware: a
    request's snapshot additionally costs ``cost_per_byte`` x the bytes of
    its latent (H x W x ``channels`` x ``itemsize``), so High-resolution
    snapshots are priced honestly instead of flat. The default (0.0)
    preserves the original flat-``write_cost`` behavior exactly."""
    every_k_steps: int = 2
    write_cost: float = 1e-4         # async snapshot stall, per request
    cost_per_byte: float = 0.0       # extra stall per latent byte snapshot
    channels: int = 4                # latent channels for byte accounting
    itemsize: int = 4                # float32

    def __post_init__(self) -> None:
        if self.every_k_steps < 1:
            raise ValueError("every_k_steps must be >= 1")
        if self.write_cost < 0:
            raise ValueError("write_cost must be >= 0")
        if self.cost_per_byte < 0:
            raise ValueError("cost_per_byte must be >= 0")

    def snapshot_cost(self, resolution: Tuple[int, int]) -> float:
        """Sim-clock stall for one request's snapshot at ``resolution``."""
        if self.cost_per_byte <= 0.0:
            return self.write_cost
        from repro_torch.cluster.cachetier import latent_bytes
        return self.write_cost + self.cost_per_byte * latent_bytes(
            resolution, self.channels, self.itemsize)


class Replica:
    #: shared no-op tracer; the driver swaps in a live one when tracing is
    #: enabled (class attribute so directly-constructed replicas need no
    #: wiring and the disabled path costs one attribute load + branch)
    tracer = NULL_TRACER

    def __init__(self, rid: int, engine: PatchedServeEngine,
                 spawn_at: float = 0.0, cold_start: float = 0.0,
                 zone: int = 0,
                 checkpoint: Optional[CheckpointConfig] = None,
                 model_tier: Optional[ModelTier] = None):
        self.rid = rid
        self.engine = engine
        self.spawn_at = spawn_at
        self.ready_at = spawn_at + cold_start
        self.next_free = self.ready_at
        self.zone = zone                      # fault domain (driver-assigned)
        #: model tier on a heterogeneous fleet (None = untiered). The
        #: engine's latency model is already tier-scaled by the driver;
        #: this records identity for dispatch/escalation/metrics.
        self.model_tier = model_tier
        #: cleared by the driver while this replica's zone is partially
        #: degraded (serves in-flight work, receives no new dispatches)
        self.dispatchable = True
        #: driver-installed confidence gate (tiered fleets): intercepts
        #: engine completions in tick() for escalation to the next tier up
        self.escalator = None
        self.retiring = False                 # drains, accepts nothing new
        self.retired_at: Optional[float] = None
        self.crash_at: Optional[float] = None  # scheduled failure injection
        self.failed_at: Optional[float] = None
        self.zone_killed_at: Optional[float] = None  # correlated-outage kill
        self.busy_time = 0.0
        self._res_set = {tuple(r) for r in engine.resolutions}
        # repartition migration: target affinity block while draining
        self.migrating_to: Optional[List[Tuple[int, int]]] = None
        self.migrations = 0
        self._metrics_hist: List[Metrics] = []
        # partial-progress checkpointing: rid -> (steps_done, latent) at the
        # last snapshot. The dict models durable storage — it outlives
        # fail() on purpose, and it holds the latent itself (None in
        # synthetic sims, the actual array on tensor paths) so a resumed
        # request really continues from the snapshotted state instead of
        # skipping denoise steps on fresh noise.
        self.ckpt_cfg = checkpoint
        self._ckpt: Dict[int, tuple] = {}
        self.checkpoint_writes = 0            # per-request snapshots written
        self.checkpoint_time = 0.0            # sim seconds spent writing
        # fleet patch-cache tier: per-replica L1 warmth + L2 protocol
        # (attached by the driver when ClusterConfig.cache_tier is set)
        self.tier = None
        # gang admissions (cluster.batcher): pre-formed patch batches
        # accepted atomically via submit_gang
        self.gangs_admitted = 0
        self.gang_requests = 0

    # -- identity / coverage ----------------------------------------------
    @property
    def resolutions(self) -> List[Tuple[int, int]]:
        return self.engine.resolutions

    @property
    def patch(self) -> int:
        """The engine's GCD patch size — larger under resolution-affinity
        partitioning, which is exactly the point (paper §4.1)."""
        return self.engine.patch

    def supports(self, resolution: Tuple[int, int]) -> bool:
        return tuple(resolution) in self._res_set

    # -- fleet patch-cache tier -------------------------------------------
    def attach_tier(self, client) -> None:
        """Wire a ``cachetier.TierClient`` into this replica: the client
        models the engine's L1 working set, and the engine's cache-aware
        latency surrogate (if any) gates its reuse discount by the
        client's warmth."""
        self.tier = client
        client.patch = self.patch
        # L1/L2 warmth is keyed per-(model tier, resolution): a lite
        # replica's warm patches say nothing about a max replica's
        client.model_tier = self.model_tier.name if self.model_tier else ""
        self._attach_tier_to_engine()

    def _attach_tier_to_engine(self) -> None:
        lm = getattr(self.engine, "latency_model", None)
        if self.tier is not None and hasattr(lm, "attach_tier"):
            lm.attach_tier(self.tier)

    def cache_warmth(self, resolution: Tuple[int, int]) -> float:
        """Mean L1 warmth for ``resolution`` in [0, 1] — the
        ``cache_affinity`` dispatch signal (0.0 without a tier, which
        makes that policy degrade to join-shortest-queue)."""
        return self.tier.warmth(resolution) if self.tier is not None else 0.0

    # -- dispatchability ---------------------------------------------------
    def ready(self, now: float) -> bool:
        """May the router send new work here at ``now``?"""
        return self.ready_at <= now and not self.retiring \
            and self.retired_at is None and self.migrating_to is None

    @property
    def has_work(self) -> bool:
        return self.engine.has_work

    @property
    def queue_depth(self) -> int:
        return self.engine.queue_depth

    def backlog(self, now: float) -> float:
        """Predicted seconds of work ahead of a new arrival: the remainder
        of the in-flight step plus the engine's drain estimate."""
        return max(self.next_free - now, 0.0) + self.engine.backlog_estimate()

    def admission_slack(self, req: Request, now: float) -> float:
        """Slack ``req`` would have on this replica, after queueing behind
        everything already here (in-flight step + queued work, so one
        dispatch round spreads a burst instead of herding it onto whichever
        replica is momentarily idle) — priced by this replica's own latency
        predictor."""
        return self.engine.scheduler.admission_slack(
            req, self.engine.active, now, queue_delay=self.backlog(now))

    def predicted_finish(self, req: Request, now: float) -> float:
        """Absolute finish time this replica's own latency surrogate
        predicts for ``req`` if dispatched here at ``now``: drain the
        backlog ahead of it, then its remaining steps at the predicted
        batch step latency. The tracer records this at dispatch and scores
        the residual at completion (``summary()["predictor"]``) — the same
        quantities ``admission_slack`` prices, exposed as a time."""
        eng = self.engine
        step = eng._predict_step_latency(eng.active + [req])
        return now + self.backlog(now) + step * req.remaining_steps

    # -- execution ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        if not self.supports(req.resolution):
            raise ValueError(
                f"replica {self.rid} serves {sorted(self._res_set)}, "
                f"got {req.resolution}")
        if self.ckpt_cfg is not None:
            # a requeued request arrives with its restored progress, which
            # is itself durable (it came from a checkpoint) — seed the store
            # so a second crash never restores below it
            self._ckpt[req.rid] = (req.steps_done, req.latent)
        self.engine.submit(req)

    def submit_gang(self, reqs: List[Request]) -> None:
        """Atomically admit a pre-formed patch gang (``cluster.batcher``):
        every member is validated against this replica's coverage *before*
        any is accepted, so a bad gang leaves the engine untouched. Members
        enter the engine wait queue together — the scheduler sees the whole
        gang in its next admission pass, and a crash orphans it whole
        (``fail`` returns everything the engine held, so the driver
        requeues the gang exactly once, together)."""
        bad = [tuple(r.resolution) for r in reqs
               if not self.supports(r.resolution)]
        if bad:
            raise ValueError(
                f"replica {self.rid} serves {sorted(self._res_set)}, "
                f"gang contains {sorted(set(bad))}")
        for r in reqs:
            self.submit(r)
        if len(reqs) >= 2:
            self.gangs_admitted += 1
            self.gang_requests += len(reqs)

    def tick(self, now: float) -> TickEvents:
        ev = self.engine.tick(now)
        if self.ckpt_cfg is not None:
            # GC finished/dropped snapshots on *every* tick — the engine
            # can drop hopeless waiting requests on a tick that never steps
            for r in ev.completed:
                self._ckpt.pop(r.rid, None)
            for r in ev.dropped:
                self._ckpt.pop(r.rid, None)
        tr = self.tracer
        if ev.stepped:
            dt = ev.dt
            ckpt_cost = tier_cost = 0.0
            ckpt_wrote = 0
            if self.ckpt_cfg is not None:
                wrote0 = self.checkpoint_writes
                ckpt_cost = self._write_checkpoints()
                ckpt_wrote = self.checkpoint_writes - wrote0
                dt += ckpt_cost
            stepped = self.engine.active + ev.completed \
                if (self.tier is not None or tr.enabled) else None
            if self.tier is not None:
                # tier protocol for the batch that just stepped: L2 fetches
                # for cold keys and publishes for freshly self-warmed ones,
                # both charged to this step's busy horizon (in-flight
                # publishes commit only at the end of it)
                tier_cost = self.tier.on_step(stepped, now, now + dt)
                dt += tier_cost
            self.busy_time += dt
            self.next_free = now + dt
            escalated: List[Request] = []
            if self.escalator is not None and ev.completed:
                # confidence gate: under-quality completions whose
                # remaining slack covers a re-run at the next tier up are
                # pulled out of ev.completed (their completion retracted
                # from the engine's metrics) and re-enter the frontend at
                # the step end. Runs tracer-independent — headline metrics
                # are bit-identical with tracing on or off.
                escalated = self.escalator.intercept(self, ev)
            if tr.enabled:
                for r in ev.dropped:
                    tr.drop(r, now, "replica", rep=self)
                for r in ev.admitted:
                    tr.admit(r, self, now)
                tr.step(self, now, ev.dt, ckpt_cost, tier_cost, stepped)
                if ckpt_wrote:
                    tr.checkpoint_write(self, now, ckpt_wrote, ckpt_cost)
                for r in escalated:
                    tr.escalate(r, ev.end, self.rid, r.min_quality)
                for r in ev.completed:
                    # finish is the engine step end (ckpt/tier cost extends
                    # the replica's busy horizon, not the request's finish)
                    tr.complete(r, self, ev.end)
        elif tr.enabled:
            for r in ev.dropped:
                tr.drop(r, now, "replica", rep=self)
            for r in ev.admitted:
                tr.admit(r, self, now)
            for r in ev.completed:
                tr.complete(r, self, ev.end)
        return ev

    def _retract_completion(self, req: Request) -> None:
        """Reverse the completion the engine just recorded for ``req`` at
        ``req.finish`` (escalation: the cheap-tier output was rejected, so
        the request is still in flight for every fleet metric). The engine
        appended this completion's latency on this very tick, so removal
        is exact — latency values for equal (finish, arrival) are
        interchangeable."""
        m = self.engine.metrics
        m.completed -= 1
        if req.finish <= req.slo:
            m.slo_met -= 1
        lat = req.finish - req.arrival
        for i in range(len(m.latencies) - 1, -1, -1):
            if m.latencies[i] == lat:
                del m.latencies[i]
                break

    def _write_checkpoints(self) -> float:
        """Snapshot every active request whose progress since its last
        checkpoint reached ``every_k_steps``. Returns the sim-clock cost of
        this tick's writes (``write_cost`` per snapshotted request; 0.0
        when nothing was due)."""
        cfg = self.ckpt_cfg
        wrote, cost = 0, 0.0
        for r in self.engine.active:
            last = self._ckpt.get(r.rid, (0, None))[0]
            if r.steps_done - last >= cfg.every_k_steps:
                # the latent reference IS the snapshot: step outputs are
                # fresh arrays, so the stored one keeps snapshot-time state
                self._ckpt[r.rid] = (r.steps_done, r.latent)
                wrote += 1
                # flat write_cost by default; with cost_per_byte set the
                # snapshot is priced by its latent's H x W x C bytes
                cost += cfg.snapshot_cost(r.resolution)
        if not wrote:
            return 0.0
        self.checkpoint_writes += wrote
        self.checkpoint_time += cost
        return cost

    # -- failure injection ------------------------------------------------
    def fail(self, now: float) -> List[Request]:
        """Crash this replica at ``now``. Unlike retirement there is no
        drain: the replica dies holding work, and that work is returned to
        the caller so the driver can requeue it through the router. Without
        checkpointing, progress is lost — orphans restart from step 0 (their
        latents lived in the dead process). With a ``CheckpointConfig`` each
        orphan resumes from its last durable snapshot: ``steps_done`` is
        restored to the checkpointed value, never beyond the progress it
        actually had at crash time. The engine's own metrics keep only what
        it actually finished, so a requeued request is never counted here
        and again wherever it eventually completes."""
        self.failed_at = now
        self.retired_at = now
        self.retiring = True
        self.migrating_to = None
        if self.tier is not None:
            # L1 working set dies with the process; in-flight L2 writes
            # that had not committed by the crash instant are aborted so
            # the fleet store never holds a half-written entry
            self.tier.on_crash(now)
        orphans = self.engine.wait + self.engine.active
        self.engine.wait.clear()
        self.engine.active.clear()
        for r in orphans:
            r.state = "waiting"
            if self.ckpt_cfg is not None:
                steps, latent = self._ckpt.get(r.rid, (0, None))
                if steps <= r.steps_done:
                    # restore progress AND the snapshotted latent together,
                    # so a tensor-path resume continues from real state
                    r.steps_done = steps
                    r.latent = latent
                else:       # monotone guard: never restore past true state
                    r.steps_done = 0
                    r.latent = None
            else:
                r.steps_done = 0
                r.latent = None
            r.finish = None
            r.text = None
        return orphans

    # -- repartition migration --------------------------------------------
    def switch_engine(self, engine: PatchedServeEngine, now: float,
                      switch_cost: float = 0.0) -> None:
        """Swap to an engine over a new affinity block. Only legal once the
        old engine is drained (in-flight work finished where it started).
        ``switch_cost`` — cache flush + shape-set recompile — is charged on
        the clock; it never shortcuts a still-pending cold start."""
        if self.engine.has_work:
            raise RuntimeError(
                f"replica {self.rid}: cannot switch engines with work "
                "in flight")
        self._metrics_hist.append(self.engine.metrics)
        self.engine = engine
        self._res_set = {tuple(r) for r in engine.resolutions}
        self.ready_at = max(self.ready_at, now + switch_cost)
        self.next_free = max(self.next_free, self.ready_at)
        self.migrating_to = None
        self.migrations += 1
        if self.tier is not None:
            # the local patch cache restarts cold over the new block's
            # patch size; committed tier entries (and writes already in
            # flight) stand — the replica is alive and the data was real
            self.tier.on_switch(self.patch)
            self._attach_tier_to_engine()

    @property
    def merged_metrics(self) -> Metrics:
        """Engine metrics folded across every engine this replica ran
        (migrations replace the engine; served work must not vanish)."""
        if not self._metrics_hist:
            return self.engine.metrics
        out = Metrics()
        for m in self._metrics_hist + [self.engine.metrics]:
            out.completed += m.completed
            out.dropped += m.dropped
            out.slo_met += m.slo_met
            out.latencies.extend(m.latencies)
            out.step_latencies.extend(m.step_latencies)
            out.compute_savings.extend(m.compute_savings)
            out.cache_samples.extend(m.cache_samples)
            out.span = max(out.span, m.span)
        return out

    def alive_span(self, end: float) -> float:
        """Seconds this replica existed (cold start included — it is paid
        for even while warming)."""
        return max((self.retired_at if self.retired_at is not None else end)
                   - self.spawn_at, 0.0)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Replica(rid={self.rid}, res={self.resolutions}, "
                f"patch={self.patch}, q={self.queue_depth}, "
                f"zone={self.zone}, retiring={self.retiring})")
