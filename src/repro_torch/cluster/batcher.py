"""Batch former — router-side gang scheduling of compatible patch work.

The paper's core insight is that patches, not images, are the batching
unit. Inside one engine that already holds: the scheduler admits a mixed
batch and the denoise step executes all of its patches together. At fleet
scale the insight was unapplied: the router dispatched whole requests one
at a time, so each replica only ever batched whatever the dispatch policy
happened to co-locate — a load-balancing accident, not a decision. Under
``join_shortest_queue`` a burst of same-resolution requests is *spread*
across replicas, each paying the full per-step base cost and a
mixed-resolution group overhead, when stacking them on one replica would
amortize both and concentrate its patch cache.

``BatchFormer`` closes the gap. Every dispatch round it scans the frontend
queue and groups requests whose resolutions share a compatible patch shape
— the same GCD-patch partition blocks ``resolution_affinity`` placement
uses (``router.partition_resolutions``), so a gang always stitches on one
patch grid. Each group is released as a *gang* to a single replica, subject
to two budgets:

- **Eligibility window** (per request, from ``admission_slack``): a request
  may be held for batching only while it can afford the wait. With
  ``slack_s`` its admission slack in seconds on the gang's target replica,
  it is held only if ``slack_s > max_wait`` (strictly — a request whose
  slack is exactly at its max-wait is dispatched immediately, alone if
  need be) and never past ``first_held + max_wait``. The driver treats
  each held request's deadline as a sim event, so a hold can never be
  overshot by a long gap between arrivals. Tight-SLO requests are by
  construction never delayed: urgency always wins over batch efficiency
  (the BatchEngine eligibility/max-wait design, SNIPPETS.md §3).

- **Gang size from the batch-latency curve** (per gang, from the replica's
  own predictor): the gang grows while its predicted one-step latency
  stays under ``max_step_cost``, priced by
  ``PatchAwareLatency.marginal_patch_cost`` — the *marginal patch*, not
  the request count, bounds the gang. The step curve is sublinear in
  patches (``core.latency_model``), so each added request is cheaper per
  patch than the last; the cap is therefore a budget on the *total* step
  the gang's members will share, i.e. on how much every member's steps
  are slowed in exchange for amortization. Urgent requests are exempt —
  they ship even when the urgent set alone exceeds the cap, because
  splitting them would only delay some of them further.

Composition with dispatch policies is deliberate: the former picks *what*
to batch (which requests form a gang, and when it must ship), the policy
picks *where* (the gang's target replica, selected for the gang's head
request exactly as for single-request dispatch). ``Replica.submit_gang``
then admits the pre-formed gang atomically — all members validated before
any is accepted, and on a crash the whole gang is orphaned and requeued
together (``Replica.fail`` returns everything the engine held).

Held time is observable: the tracer charges it to the ``batch_wait``
component (``trace.COMPONENTS``), preserving span conservation, and
``ClusterMetrics.summary()["batching"]`` reports gang counts/sizes plus
the two structural guards (``min_hold_slack_s``, ``deadline_overshoot_max``)
the ``--batching`` benchmark asserts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.requests import Request

Resolution = Tuple[int, int]


@dataclass
class BatchFormerConfig:
    """Gang-forming budgets. Units: sim-seconds throughout.

    ``max_wait`` — longest a surplus-slack request may be held for batching
    (sim-seconds). A request is held only while its admission slack in
    seconds strictly exceeds ``max_wait`` (so the full window can be spent
    without endangering its SLO) and is always released by
    ``first_held + max_wait``. ``max_wait = 0.0`` degrades the former to a
    pass-through that still gang-dispatches whatever is *simultaneously*
    queued but never deliberately waits — the benchmark's ablation arm.

    ``max_step_cost`` — budget on a gang's predicted one-step latency
    (sim-seconds), evaluated on the target replica's own batch-latency
    curve via ``PatchAwareLatency.marginal_patch_cost``. Bounds how much
    one gang may slow the shared step in exchange for amortization; it
    never splits urgent requests (they ship regardless).
    """
    max_wait: float = 0.25           # sim-seconds a held request may wait
    max_step_cost: float = 0.030     # sim-seconds per gang denoise step

    def __post_init__(self) -> None:
        if self.max_wait < 0:
            raise ValueError("max_wait must be >= 0")
        if self.max_step_cost <= 0:
            raise ValueError("max_step_cost must be > 0")


class BatchFormer:
    """Forms patch-compatible gangs over the router queue (see module
    docstring). One instance per cluster; the driver wires it into the
    ``Router`` and keeps its partition blocks in sync across
    repartitions."""

    def __init__(self, cfg: Optional[BatchFormerConfig] = None):
        self.cfg = cfg or BatchFormerConfig()
        self._block_of: Dict[Resolution, int] = {}
        # rid -> sim time the former first chose to hold the request
        self._held: Dict[int, float] = {}
        # -- stats (ClusterMetrics.summary()["batching"]) ----------------
        self.gangs = 0                   # dispatches with >= 2 members
        self.gang_requests = 0           # requests shipped in those gangs
        self.singles = 0                 # requests dispatched alone
        self.holds = 0                   # hold decisions (first-time only)
        self.gang_sizes: List[int] = []
        # structural guards: smallest slack (seconds) any request had when
        # the former chose to hold it — must exceed max_wait by
        # construction; and the worst overshoot past a held request's
        # eligibility deadline — ~0 because deadlines are sim events
        self.min_hold_slack_s = float("inf")
        self.deadline_overshoot_max = 0.0

    # ---------------- partition blocks (gang compatibility) -------------

    def set_blocks(self, blocks: Sequence[Sequence[Resolution]]) -> None:
        """(Re)define gang compatibility: requests gang together iff their
        resolutions share a partition block — the same GCD-patch blocks
        affinity placement uses, re-synced by the driver after every
        repartition."""
        self._block_of = {tuple(r): i for i, block in enumerate(blocks)
                          for r in block}

    def _key(self, resolution: Resolution) -> int:
        # unknown resolutions (never partitioned) gang only with themselves
        return self._block_of.get(tuple(resolution),
                                  -1 - hash(tuple(resolution)) % (1 << 30))

    # ---------------- pricing -------------------------------------------

    @staticmethod
    def _gang_cost(rep, reqs: Sequence[Request]) -> float:
        """Predicted one-step latency of ``reqs`` as one batch on ``rep``,
        from the replica's own latency model."""
        lm = getattr(rep.engine, "latency_model", None)
        if hasattr(lm, "batch_step_cost"):
            return lm.batch_step_cost(reqs)
        return rep.engine._predict_step_latency(list(reqs))

    def _fits(self, rep, gang: List[Request], cand: Request) -> bool:
        """Would adding ``cand`` keep the gang under ``max_step_cost``?
        Priced marginally per patch when the model supports it."""
        lm = getattr(rep.engine, "latency_model", None)
        if hasattr(lm, "marginal_patch_cost"):
            base = lm.batch_step_cost(gang) if gang else 0.0
            marg = lm.marginal_patch_cost(gang, cand)
            n = cand.patches(rep.patch)
            return base + marg * n <= self.cfg.max_step_cost
        return self._gang_cost(rep, gang + [cand]) <= self.cfg.max_step_cost

    @staticmethod
    def _slack_seconds(rep, req: Request, now: float) -> float:
        """Admission slack on ``rep`` converted from normalized units back
        to sim-seconds (the scheduler normalizes by the resolution's
        standalone latency)."""
        sched = rep.engine.scheduler
        return rep.admission_slack(req, now) \
            * max(sched.sa[tuple(req.resolution)], 1e-9)

    # ---------------- forming -------------------------------------------

    def deadlines(self, now: float) -> List[float]:
        """Future release instants of currently held requests — the driver
        folds these into its next-event time so a hold is released exactly
        at its eligibility deadline, never overshot by an event gap."""
        w = self.cfg.max_wait
        return [t + w for t in self._held.values() if t + w > now]

    def plan(self, queue: Sequence[Request], replicas, now: float,
             policy, tracer) -> Tuple[List[tuple], List[Request]]:
        """One forming pass over the frontend queue. Returns
        ``(dispatches, kept)``: ``dispatches`` is a list of
        ``(replica, gang)`` pairs to submit atomically, ``kept`` the
        requests staying queued (held for batching, or undispatchable) in
        their original queue order."""
        cfg = self.cfg
        qrids = {r.rid for r in queue}
        self._held = {rid: t for rid, t in self._held.items()
                      if rid in qrids}
        groups: Dict[int, List[Request]] = {}
        order: List[int] = []
        for req in queue:
            k = self._key(req.resolution)
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(req)

        dispatches: List[tuple] = []
        released: set = set()
        for k in order:
            group = groups[k]
            rep = policy.select(group[0], replicas, now)
            if rep is None:
                continue            # no ready replica: frontend wait, not a hold
            members = [r for r in group if rep.supports(r.resolution)]
            if not members:
                continue
            urgent: List[Request] = []
            holdable: List[Request] = []
            for r in members:
                slack_s = self._slack_seconds(rep, r, now)
                held_since = self._held.get(r.rid, now)
                if slack_s <= cfg.max_wait \
                        or now >= held_since + cfg.max_wait - 1e-12:
                    if r.rid in self._held:
                        over = now - (held_since + cfg.max_wait)
                        if over > self.deadline_overshoot_max:
                            self.deadline_overshoot_max = over
                    urgent.append(r)
                else:
                    holdable.append((r, slack_s))
            if urgent:
                # urgency wins: ship every urgent member now (the step-cost
                # budget never splits them), then fill the gang with held
                # work while the batch-latency curve stays under budget
                gang = list(urgent)
                for r, _ in holdable:
                    if self._fits(rep, gang, r):
                        gang.append(r)
                self._release(rep, gang, now, dispatches, released, tracer)
            elif holdable:
                # nobody must go: release only a cost-full gang (waiting
                # longer could not improve it); otherwise keep holding
                gang = []
                full = False
                for r, _ in holdable:
                    if self._fits(rep, gang, r):
                        gang.append(r)
                    else:
                        full = True
                if full and gang:
                    self._release(rep, gang, now, dispatches, released,
                                  tracer)
            # whatever stays queued from this group is a deliberate former
            # hold: start (or keep) its eligibility clock so its release
            # deadline is a sim event the driver cannot skip past
            for r, slack_s in holdable:
                if r.rid in released or r.rid in self._held:
                    continue
                self._held[r.rid] = now
                self.holds += 1
                if slack_s < self.min_hold_slack_s:
                    self.min_hold_slack_s = slack_s
                if tracer.enabled:
                    tracer.batch_hold(r, now)
        kept = [r for r in queue if r.rid not in released]
        return dispatches, kept

    def _release(self, rep, gang: List[Request], now: float,
                 dispatches: List[tuple], released: set, tracer) -> None:
        gang = sorted(gang, key=lambda r: r.arrival)
        dispatches.append((rep, gang))
        for r in gang:
            released.add(r.rid)
            self._held.pop(r.rid, None)
        if len(gang) >= 2:
            self.gangs += 1
            self.gang_requests += len(gang)
        else:
            self.singles += 1
        self.gang_sizes.append(len(gang))
        if tracer.enabled:
            tracer.gang_dispatch(now, rep, gang,
                                 self._gang_cost(rep, gang))

    # ---------------- reporting -----------------------------------------

    def stats(self) -> dict:
        sizes = self.gang_sizes
        return {
            "gangs": self.gangs,
            "gang_requests": self.gang_requests,
            "singles": self.singles,
            "holds": self.holds,
            "mean_gang_size": round(sum(sizes) / len(sizes), 3)
            if sizes else 0.0,
            "max_gang_size": max(sizes) if sizes else 0,
            "min_hold_slack_s": round(self.min_hold_slack_s, 6)
            if self.holds else None,
            "deadline_overshoot_max": round(self.deadline_overshoot_max, 9),
        }
