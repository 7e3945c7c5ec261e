"""Cluster frontend: arrival queue + pluggable dispatch policies.

Policies (DiffServe-style SLO-aware routing, TetriServe-style
resolution-aware placement — see PAPERS.md):

- ``round_robin``        — cycle over ready replicas; load-blind baseline.
- ``join_shortest_queue``— fewest queued+active requests, tie-broken by
                           predicted backlog seconds.
- ``least_slack``        — send where the request would retain the MOST
                           slack (Algorithm 1's normalized urgency), i.e.
                           the replica whose own latency predictor says it
                           can absorb the request with most headroom.
- ``resolution_affinity``— resolutions are partitioned across replicas to
                           maximize each replica's GCD patch size (bigger
                           patches -> less halo/stitch overhead and better
                           patch-cache locality); within the replicas of a
                           partition block, fall back to shortest-queue.
- ``zone_spread``        — fault-domain-aware: send to the zone currently
                           holding the least outstanding work (then
                           shortest-queue inside it), so a correlated zone
                           outage orphans the smallest possible slice of
                           in-flight work. The driver also places this
                           policy's replicas (and crash replacements)
                           zone-balanced, avoiding zones that are down.
- ``cascade``            — query-aware model cascade over a tiered fleet
                           (``ClusterConfig.tiers``): each request goes to
                           the cheapest model tier whose predicted finish
                           fits its SLO slack; confidence-gated cheap-tier
                           completions re-enter the queue targeted at the
                           next tier up (see ``docs/CASCADE.md``).
- ``resolution_affinity_spread`` — affinity partitioning *plus* the zone
                           spreading above: each resolution block's
                           replicas land in distinct zones where possible,
                           so one outage cannot take a whole resolution's
                           capacity off the air.
- ``cache_affinity``     — patch-cache-tier-aware: among replicas whose
                           queue depth is within a small bound of the
                           shortest, prefer the one whose L1 patch cache
                           is warmest for the request's resolution
                           (``repro_torch.cluster.cachetier``); with no tier
                           state it degrades to join-shortest-queue.
- ``cache_affinity_spread`` — warmth first, then least-loaded zone, then
                           shortest-queue; placement is zone-balanced
                           like ``zone_spread``.

A policy returns ``None`` when no ready replica can take the request (e.g.
every covering replica is still cold-starting); the request then stays in
the frontend queue and is retried at the next dispatch round.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.csp import gcd_patch_size
from repro_torch.core.requests import Request
from repro_torch.cluster.replica import Replica
from repro_torch.cluster.trace import NULL_TRACER

Resolution = Tuple[int, int]


# ---------------- workload mix tracking (drift detection) -----------------

class MixTracker:
    """Windowed resolution-mix histogram over arrivals. The cluster driver
    feeds every frontend arrival in; drift-triggered repartitioning compares
    the windowed empirical mix against the mix the current affinity
    partition was built for."""

    def __init__(self, resolutions: Sequence[Resolution],
                 window: float = 10.0):
        self.resolutions = [tuple(r) for r in resolutions]
        self._index = {r: i for i, r in enumerate(self.resolutions)}
        self.window = window
        self._events: Deque[Tuple[float, int]] = deque()
        # histogram maintained incrementally: mix() runs every sim event
        self._counts = np.zeros(len(self.resolutions), np.float64)

    def observe(self, now: float, resolution: Resolution) -> None:
        i = self._index.get(tuple(resolution))
        if i is None:
            return                          # unroutable shapes don't count
        self._events.append((now, i))
        self._counts[i] += 1
        self._trim(now)

    def _trim(self, now: float) -> None:
        horizon = now - self.window
        while self._events and self._events[0][0] < horizon:
            _, i = self._events.popleft()
            self._counts[i] -= 1

    @property
    def n_samples(self) -> int:
        return len(self._events)

    def mix(self, now: Optional[float] = None) -> np.ndarray:
        """Empirical per-resolution arrival shares in ladder order (uniform
        when the window is empty)."""
        if now is not None:
            self._trim(now)
        total = self._counts.sum()
        if total == 0:
            return np.full(len(self.resolutions),
                           1.0 / len(self.resolutions))
        return self._counts / total


def mix_drift(a: Sequence[float], b: Sequence[float]) -> float:
    """L1 distance between two mixes, in [0, 2]."""
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum())


# ---------------- resolution partitioning (affinity placement) -----------

def _set_partitions(items: List[Resolution]) -> Iterator[List[List[Resolution]]]:
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in _set_partitions(rest):
        for i in range(len(part)):
            yield part[:i] + [[first] + part[i]] + part[i + 1:]
        yield [[first]] + part


def partition_resolutions(resolutions: Sequence[Resolution], k: int,
                          mix: Optional[Dict[Resolution, float]] = None
                          ) -> List[List[Resolution]]:
    """Split the resolution set into at most ``k`` blocks maximizing the
    smallest per-block GCD patch (ties: larger summed patch, then fewer
    blocks). With an observed ``mix`` (resolution -> arrival share) the
    summed-patch tie-break is traffic-weighted, so the resolutions carrying
    the load land in the large-patch blocks. Exhaustive over set
    partitions — resolution ladders are tiny (the paper serves 3-5), so
    Bell-number enumeration is fine."""
    res = sorted({tuple(r) for r in resolutions})
    if k <= 1 or len(res) <= 1:
        return [list(res)]
    best, best_score = None, None
    for part in _set_partitions(list(res)):
        if len(part) > k:
            continue
        gcds = [gcd_patch_size(block) for block in part]
        if mix:
            weighted = sum(g * sum(mix.get(tuple(r), 0.0) for r in block)
                           for g, block in zip(gcds, part))
        else:
            weighted = sum(gcds)
        score = (min(gcds), weighted, -len(part))
        if best_score is None or score > best_score:
            best, best_score = part, score
    return [sorted(block) for block in best]


def allocate_replica_counts(blocks: Sequence[Sequence[Resolution]], k: int,
                            mix: Optional[Dict[Resolution, float]] = None
                            ) -> List[int]:
    """Give each partition block >=1 replica and spread the remaining
    ``k - len(blocks)`` by latent-pixel load. ``mix`` (resolution ->
    arrival share) weights each resolution's pixels by observed traffic;
    without it the paper's uniform-mix workload is assumed — which is
    exactly what drift-triggered repartitioning replaces with the windowed
    empirical mix."""
    def share(r: Resolution) -> float:
        return mix.get(tuple(r), 0.0) if mix else 1.0

    weights = [max(sum(share(r) * r[0] * r[1] for r in block), 1e-9)
               for block in blocks]
    counts = [1] * len(blocks)
    for _ in range(k - len(blocks)):
        i = max(range(len(blocks)),
                key=lambda j: weights[j] / counts[j])
        counts[i] += 1
    return counts


# ---------------- dispatch policies --------------------------------------

#: name -> policy class; populated by ``@register_policy``. The driver and
#: ``make_policy`` consume this — adding a policy is one decorator, no
#: parallel string sets to keep in sync.
POLICIES: Dict[str, type] = {}


def register_policy(name: str, *, zone_aware: bool = False,
                    affinity: bool = False, needs_tier: bool = False):
    """Class decorator registering a dispatch policy under ``name`` with
    its capability flags:

    - ``affinity``   — the driver builds this policy's replicas over
      partitioned resolution blocks (one engine per block -> larger GCD
      patch).
    - ``zone_aware`` — the driver places replicas zone-balanced and steers
      crash replacements away from down zones.
    - ``needs_tier`` — the policy dispatches on per-replica ``ModelTier``
      state; the driver refuses to build it without a tiered fleet
      (``ClusterConfig.tiers``).

    The string API stays: ``ClusterConfig.policy`` / ``make_policy(name)``
    resolve through the registry, and the legacy ``AFFINITY_POLICIES`` /
    ``ZONE_AWARE_POLICIES`` sets below are derived views of it."""
    def deco(cls):
        cls.name = name
        cls.zone_aware = zone_aware
        cls.affinity = affinity
        cls.needs_tier = needs_tier
        POLICIES[name] = cls
        return cls
    return deco


class DispatchPolicy:
    name = "base"
    # capability flags consulted by the driver (set by @register_policy)
    zone_aware = False
    affinity = False
    needs_tier = False

    def _candidates(self, req: Request, replicas: Sequence[Replica],
                    now: float) -> List[Replica]:
        return [r for r in replicas
                if r.ready(now) and r.dispatchable
                and r.supports(req.resolution)]

    def select(self, req: Request, replicas: Sequence[Replica],
               now: float) -> Optional[Replica]:
        raise NotImplementedError


@register_policy("round_robin")
class RoundRobin(DispatchPolicy):

    def __init__(self) -> None:
        self._i = 0

    def select(self, req, replicas, now):
        cands = self._candidates(req, replicas, now)
        if not cands:
            return None
        rep = cands[self._i % len(cands)]
        self._i += 1
        return rep


@register_policy("join_shortest_queue")
class JoinShortestQueue(DispatchPolicy):

    def select(self, req, replicas, now):
        cands = self._candidates(req, replicas, now)
        if not cands:
            return None
        return min(cands, key=lambda r: (r.queue_depth, r.backlog(now),
                                         r.rid))


@register_policy("least_slack")
class LeastSlack(DispatchPolicy):
    """Max-remaining-slack placement: each candidate replica prices the
    request with its own latency predictor (scheduler.admission_slack) and
    the request goes where it keeps the most slack."""

    def select(self, req, replicas, now):
        cands = self._candidates(req, replicas, now)
        if not cands:
            return None
        return max(cands, key=lambda r: (r.admission_slack(req, now),
                                         -r.queue_depth, -r.rid))


@register_policy("resolution_affinity", affinity=True)
class ResolutionAffinity(JoinShortestQueue):
    """Placement is decided at replica-construction time (the driver builds
    replicas over ``partition_resolutions`` blocks), so ``supports`` already
    restricts candidates to the request's block; within the block this is
    shortest-queue."""


@register_policy("zone_spread", zone_aware=True)
class ZoneSpread(DispatchPolicy):
    """Fault-domain-aware dispatch: candidates are ranked by how much
    outstanding work their *zone* already holds (queued + active across
    every live replica in it, candidate or not), then shortest-queue within
    the zone. Spreading outstanding work across fault domains bounds what a
    single correlated zone outage can orphan; the driver pairs this with
    zone-balanced placement so capacity itself is spread too. Candidates
    inherit the base ``dispatchable`` filter, so a partially degraded zone
    (serving in-flight work, rejecting new dispatches) is skipped."""

    def select(self, req, replicas, now):
        cands = self._candidates(req, replicas, now)
        if not cands:
            return None
        zone_load: Dict[int, int] = {}
        for r in replicas:
            if r.retired_at is None:
                zone_load[r.zone] = zone_load.get(r.zone, 0) + r.queue_depth
        return min(cands, key=lambda r: (zone_load.get(r.zone, 0),
                                         r.queue_depth, r.backlog(now),
                                         r.rid))


@register_policy("cache_affinity")
class CacheAffinity(DispatchPolicy):
    """Cache-warmth-directed dispatch for fleets running the shared patch
    cache tier (``repro_torch.cluster.cachetier``): among candidates whose queue
    depth is within ``max_imbalance`` of the shortest, send the request to
    the replica whose L1 patch cache is warmest for its resolution — warm
    replicas serve it at the full reuse discount while cold ones would pay
    a fleet-tier fetch or a from-scratch warmup. The imbalance bound keeps
    locality from herding a burst onto one warm replica; without tier state
    (or when every candidate is equally cold) warmth ties and the policy
    degrades to join-shortest-queue exactly."""
    max_imbalance = 2                   # queue-depth slack traded for warmth

    def _pool(self, cands: Sequence[Replica]) -> List[Replica]:
        dmin = min(r.queue_depth for r in cands)
        return [r for r in cands
                if r.queue_depth <= dmin + self.max_imbalance]

    def select(self, req, replicas, now):
        cands = self._candidates(req, replicas, now)
        if not cands:
            return None
        return max(self._pool(cands),
                   key=lambda r: (r.cache_warmth(req.resolution),
                                  -r.queue_depth, -r.backlog(now), -r.rid))


@register_policy("cache_affinity_spread", zone_aware=True)
class CacheAffinitySpread(CacheAffinity):
    """Cache-warmth dispatch composed with fault-domain spreading: warmth
    still leads (it is the tier's whole point), but ties — a burst of a
    resolution nobody is warm for yet, or several equally-warm replicas —
    break toward the zone holding the least outstanding work, then
    shortest-queue. The driver places this policy's spawns and crash
    replacements zone-balanced like ``zone_spread``."""

    def select(self, req, replicas, now):
        cands = self._candidates(req, replicas, now)
        if not cands:
            return None
        zone_load: Dict[int, int] = {}
        for r in replicas:
            if r.retired_at is None:
                zone_load[r.zone] = zone_load.get(r.zone, 0) + r.queue_depth
        return max(self._pool(cands),
                   key=lambda r: (r.cache_warmth(req.resolution),
                                  -zone_load.get(r.zone, 0),
                                  -r.queue_depth, -r.backlog(now), -r.rid))


@register_policy("resolution_affinity_spread", affinity=True,
                 zone_aware=True)
class ResolutionAffinitySpread(ZoneSpread):
    """Affinity partitioning with fault-domain spreading: ``supports``
    restricts candidates to the request's resolution block (the driver
    builds replicas over partition blocks exactly as for
    ``resolution_affinity``) and dispatch inside the block prefers the
    least-loaded zone. The driver additionally places each block's replicas
    across distinct zones, so an outage degrades every resolution a little
    instead of silencing one entirely."""


@register_policy("cascade", needs_tier=True)
class Cascade(DispatchPolicy):
    """Query-aware model cascade over a heterogeneous (tiered) fleet
    (DiffServe, PAPERS.md): every replica carries a ``ModelTier`` (step
    cost multiplier x quality score) and the request goes to the cheapest
    tier whose predicted finish fits its SLO — within that tier,
    shortest-queue. When no tier fits, the request goes wherever it is
    predicted to finish soonest (best effort beats queueing forever).

    Escalated requests (``req.min_quality`` > 0, set by the driver's
    confidence gate when a cheap-tier completion was not good enough) only
    consider tiers of at least that quality, so the re-run lands at the
    next tier up — or any tier above it, if the next one is saturated and
    a bigger one fits the remaining slack."""

    def select(self, req, replicas, now):
        cands = [r for r in self._candidates(req, replicas, now)
                 if r.model_tier is not None
                 and r.model_tier.quality >= req.min_quality]
        if not cands:
            return None
        by_tier: Dict[Tuple[float, float, str], List[Replica]] = {}
        for r in cands:
            t = r.model_tier
            by_tier.setdefault((t.step_cost, t.quality, t.name),
                               []).append(r)
        for key in sorted(by_tier):
            best = min(by_tier[key],
                       key=lambda r: (r.queue_depth, r.backlog(now), r.rid))
            if best.predicted_finish(req, now) <= req.slo:
                return best
        return min(cands,
                   key=lambda r: (r.predicted_finish(req, now), r.rid))


#: legacy derived views of the registry, kept for back-compat — the driver
#: now consults the capability flags on the policy instance instead
AFFINITY_POLICIES = frozenset(
    n for n, p in POLICIES.items() if p.affinity)
ZONE_AWARE_POLICIES = frozenset(
    n for n, p in POLICIES.items() if p.zone_aware)


def make_policy(name: str) -> DispatchPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown dispatch policy {name!r}; have {sorted(POLICIES)}")


# ---------------- frontend ------------------------------------------------

class Router:
    """FIFO frontend queue feeding the dispatch policy. Requests that no
    ready replica covers stay queued and are retried every round.

    With a batch former attached (``former``, wired by the driver from
    ``ClusterConfig.batcher``) dispatch becomes form-then-dispatch: the
    former scans the queue and decides *what* ships now — patch-compatible
    gangs, released under per-request eligibility windows and the target
    replica's batch-latency budget — while the policy still decides
    *where* each gang lands. Gangs are admitted atomically via
    ``Replica.submit_gang``."""

    #: no-op by default; the cluster driver swaps in a live tracer
    tracer = NULL_TRACER

    def __init__(self, policy: DispatchPolicy):
        self.policy = policy
        self.queue: List[Request] = []
        self.dispatched = 0
        self.requeued = 0
        #: batch former (repro_torch.cluster.batcher.BatchFormer) or None
        self.former = None

    @property
    def depth(self) -> int:
        return len(self.queue)

    def enqueue(self, req: Request) -> None:
        self.queue.append(req)
        if self.tracer.enabled:
            self.tracer.submit(req)

    def requeue(self, reqs: Sequence[Request]) -> None:
        """Put requests orphaned by a replica crash back at the *head* of
        the frontend queue (they are the oldest work in the system), in
        arrival order. The next dispatch round re-routes them; the dead
        replica is excluded automatically because a retired replica is
        never a policy candidate."""
        self.queue[:0] = sorted(reqs, key=lambda r: r.arrival)
        self.requeued += len(reqs)

    def dispatch(self, replicas: Sequence[Replica],
                 now: float) -> List[Tuple[Request, Replica]]:
        if self.former is not None:
            return self._dispatch_gangs(replicas, now)
        sent, kept = [], []
        tr = self.tracer
        for req in self.queue:
            rep = self.policy.select(req, replicas, now)
            if rep is None:
                kept.append(req)
                continue
            if tr.enabled:
                # prediction sampled before submit so it prices the batch
                # the dispatch decision saw (admission_slack's view)
                tr.dispatch(req, rep, now, rep.predicted_finish(req, now))
            rep.submit(req)
            self.dispatched += 1
            sent.append((req, rep))
        self.queue = kept
        return sent

    def _dispatch_gangs(self, replicas: Sequence[Replica],
                        now: float) -> List[Tuple[Request, Replica]]:
        """Form-then-dispatch: the former picks what ships (and what keeps
        waiting — charged to ``batch_wait``), the policy already picked
        where inside ``plan``; each gang is admitted atomically."""
        tr = self.tracer
        plan, kept = self.former.plan(self.queue, replicas, now,
                                      self.policy, tr)
        sent: List[Tuple[Request, Replica]] = []
        for rep, gang in plan:
            if tr.enabled:
                # prediction sampled before submit so it prices the batch
                # the dispatch decision saw (admission_slack's view)
                for req in gang:
                    tr.dispatch(req, rep, now,
                                rep.predicted_finish(req, now))
            rep.submit_gang(gang)
            self.dispatched += len(gang)
            sent.extend((req, rep) for req in gang)
        self.queue = kept
        return sent
