"""Autoscaler — reactive replica scaling from queue slack and SLO
attainment (DiffServe-style query-aware scaling; see PAPERS.md), plus an
optional **predictive** path that pre-spawns ahead of arrival ramps.

Reactive signals, evaluated by the driver at every sim event:

- **backlog pressure**: mean predicted drain seconds per dispatchable
  replica (from each engine's latency predictor via
  ``Replica.backlog``);
- **frontend pressure**: requests parked in the router queue per
  dispatchable replica (covers the cold-start window, when work exists
  but nobody can take it);
- **SLO attainment** over a sliding window of recent outcomes
  (completions met/missed + drops).

Predictive path (``AutoscalerConfig.predictive``): a short-horizon
arrival-rate forecaster (Holt double exponential smoothing — EWMA level +
linear trend over fixed time bins) projects the arrival rate one cold-start
ahead. When the forecast says demand will exceed what the current fleet
(warming replicas included) can sustain, a replica is spawned *before* the
backlog materializes, so cold start lands before the wave. Replicas that
cannot possibly be serving by the forecast horizon — e.g. a crash
replacement stalled behind a zone outage — are not counted as horizon
capacity, so the fleet provisions around them instead of waiting out the
stall. The forecaster self-monitors: its one-bin-ahead relative error is
tracked, and while that error is high (or too few bins have been seen)
the predictive path stands down and only the reactive signals act.

Warm-boot pricing (``warm_boot_factor``, elastic x cache tier): when the
driver marks the fleet warm-bootable — every spawn bulk-prefetches its
block's committed cache-tier entries during boot (``cachetier.py``) — the
predictive path prices spawns with ``cold_start * warm_boot_factor``
instead of the full cold start. A warm-booted replica needs no post-boot
cache-warmup ramp, so pre-spawning is cheaper to be wrong about and the
controller triggers earlier in a ramp (shorter horizon, tighter
mid-boot-capacity cutoff).

Predictive **scale-down** (``predictive_down``, elastic controller): the
same reliability-gated forecast also retires capacity *ahead* of a
ramp-down. When the projected rate — priced with a retirement headroom
``down_headroom`` larger than the spawn headroom, so the two thresholds
form a hysteresis band that cannot flap — would leave the fleet
over-provisioned by a whole replica, and that stays true continuously for
``down_hold`` seconds, one replica is marked retiring before the reactive
idle signal (which needs the queues to actually empty) would ever fire.
The victim drains first, exactly like reactive scale-down: predictive
retirement never kills in-flight work.

Scale-up spawns a replica that serves traffic only after ``cold_start``
seconds — the model-load/compile penalty is charged honestly: arrivals
keep queueing meanwhile. Scale-down marks a victim as *retiring*: it
takes nothing new, drains, and is only then retired. A shared cooldown
prevents up/down flapping.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.replica import ModelTier, Replica
from repro_torch.cluster.trace import NULL_TRACER
from repro_torch.core.serving import TickEvents


class ArrivalForecaster:
    """Holt linear smoothing over binned arrival counts: level tracks the
    current rate, trend its drift; ``forecast(h)`` extrapolates ``h``
    seconds out. Tracks its own one-bin-ahead relative error so callers can
    fall back to reactive scaling when the forecast is unreliable."""

    def __init__(self, bin_s: float = 1.0, alpha: float = 0.5,
                 beta: float = 0.3, err_decay: float = 0.7):
        self.bin_s = bin_s
        self.alpha = alpha
        self.beta = beta
        self.err_decay = err_decay
        self.level: Optional[float] = None   # arrivals per second
        self.trend = 0.0                     # rate drift per second
        self.rel_err: Optional[float] = None
        self.bins_seen = 0
        self._bin_start = 0.0
        self._bin_count = 0

    def _close_bin(self) -> None:
        rate = self._bin_count / self.bin_s
        if self.level is None:
            self.level = rate
        else:
            pred = self.forecast(self.bin_s)
            err = abs(pred - rate) / max(rate, 1.0 / self.bin_s)
            self.rel_err = err if self.rel_err is None else (
                self.err_decay * self.rel_err + (1 - self.err_decay) * err)
            prev = self.level
            self.level = (self.alpha * rate
                          + (1 - self.alpha) * (self.level
                                                + self.trend * self.bin_s))
            self.trend = (self.beta * (self.level - prev) / self.bin_s
                          + (1 - self.beta) * self.trend)
        self.bins_seen += 1
        self._bin_count = 0
        self._bin_start += self.bin_s

    def advance(self, now: float) -> None:
        """Close every bin that ended at or before ``now`` (empty bins
        count: silence is evidence of a falling rate)."""
        while now >= self._bin_start + self.bin_s:
            self._close_bin()

    def observe(self, t: float) -> None:
        """Record one arrival at time ``t`` (non-decreasing)."""
        self.advance(t)
        self._bin_count += 1

    def forecast(self, horizon_s: float) -> float:
        """Predicted arrival rate (req/s) ``horizon_s`` seconds from the
        current bin; never negative."""
        if self.level is None:
            return 0.0
        return max(self.level + self.trend * horizon_s, 0.0)

    def reliable(self, min_bins: int, max_rel_err: float) -> bool:
        return (self.bins_seen >= min_bins
                and self.rel_err is not None
                and self.rel_err <= max_rel_err)


@dataclass
class AutoscalerConfig:
    """Elasticity knobs: reactive thresholds, the predictive (Holt
    forecast) pre-spawn/early-retire path, and warm-boot spawn pricing.
    Mechanism walk-through: docs/ARCHITECTURE.md section 8."""
    min_replicas: int = 1            # fleet floor (replicas)
    max_replicas: int = 8            # fleet ceiling (replicas)
    cold_start: float = 2.0          # seconds before a new replica serves
    scale_up_backlog: float = 1.5    # spawn above this mean backlog
    #                                  (drain-seconds per replica)
    scale_up_frontend: float = 2.0   # spawn above this frontend depth
    #                                  (queued requests per replica)
    scale_down_backlog: float = 0.2  # "idle" below this mean backlog
    #                                  (drain-seconds per replica)
    slo_target: float = 0.95         # windowed attainment below this
    #                                  fraction also triggers a spawn
    # hysteresis: retiring needs near-perfect recent attainment AND the idle
    # condition to hold continuously, else constant load oscillates
    # (capacity drops -> SLO dips -> scale back up, forever)
    scale_down_attainment: float = 0.99  # retire-eligible attainment floor
    scale_down_hold: float = 8.0     # seconds the idle condition must hold
    window: float = 10.0             # attainment sliding window (seconds)
    cooldown: float = 4.0            # min seconds between actions
    # -- predictive pre-spawning (off by default: pure reactive) ----------
    predictive: bool = False         # enable the Holt forecast pre-spawn path
    forecast_bin: float = 1.0        # forecaster bin width (seconds)
    forecast_horizon: Optional[float] = None   # look-ahead (seconds);
    #                                  default: effective cold start + bin
    forecast_min_bins: int = 4       # bins before the forecast is trusted
    forecast_max_err: float = 0.5    # EWMA one-bin-ahead rel. error gate
    #                                  (fraction; above it: stand down)
    headroom: float = 1.15           # provision factor above the forecast
    # per-replica sustainable throughput (req/s); None = learn online from
    # the completion rate while the fleet is under pressure
    service_rate: Optional[float] = None
    # -- warm-boot pricing (elastic x cache tier) --------------------------
    # when the driver flags the fleet warm-bootable (tier enabled with
    # prefetch_on_spawn: a spawn's L1 is bulk-warmed from committed tier
    # entries during boot), a new replica is productive the moment it is
    # ready — no post-boot cache-warmup ramp. The predictive path then
    # prices spawns with cold_start * warm_boot_factor: the forecast
    # horizon shrinks (triggering on nearer, more certain demand) and the
    # capacity cutoff tightens, so pre-spawns fire earlier in a ramp and
    # keep firing while mid-boot replicas would otherwise look like
    # horizon capacity they cannot cash in cold. 1.0 (default) keeps the
    # original pricing bit-identical.
    warm_boot_factor: float = 1.0    # fraction of cold_start priced for
    #                                  warm-bootable spawns, in (0, 1]
    # -- predictive scale-down (elastic controller; needs predictive) ------
    predictive_down: bool = False    # enable forecast-gated early retirement
    # retire only while forecast * down_headroom still fits in n-1 replicas;
    # down_headroom > headroom keeps a hysteresis band between the spawn and
    # retire thresholds so forecast noise cannot flap the fleet
    down_headroom: float = 1.4       # retirement provision factor
    down_hold: float = 5.0           # seconds the over-provision must persist

    def __post_init__(self) -> None:
        # early retirement is forecast-gated: asking for predictive_down
        # alone implies the predictive path (otherwise the flag would be
        # silently inert — the forecaster never even sees arrivals)
        if self.predictive_down:
            self.predictive = True
        if not 0.0 < self.warm_boot_factor <= 1.0:
            raise ValueError("warm_boot_factor must be in (0, 1]")


class Autoscaler:
    #: no-op by default; the cluster driver swaps in a live tracer
    tracer = NULL_TRACER

    def __init__(self, cfg: AutoscalerConfig):
        self.cfg = cfg
        #: set True by the cluster driver when spawns boot warm (cache tier
        #: with prefetch_on_spawn) — gates warm_boot_factor pricing
        self.warm_boot = False
        self._last_action = -1e18
        self._idle_since: Optional[float] = None
        # (t, slo_met, completed, tier name — "" on homogeneous fleets)
        self._outcomes: Deque[Tuple[float, bool, bool, str]] = deque()
        # (t, difficulty) of recent arrivals — the cross-tier demand mix
        self._difficulties: Deque[Tuple[float, float]] = deque()
        self._mu_tier: Dict[str, float] = {}   # learned req/s/replica, per tier
        self._tiered = False         # saw tier-tagged outcomes/arrivals
        self.actions: list = []      # (now, +1 | -1) decision log
        self.forecaster = ArrivalForecaster(bin_s=cfg.forecast_bin)
        self.predictive_spawns: List[float] = []   # pre-spawn times
        self.predictive_retirements: List[float] = []  # early-retire times
        self._down_since: Optional[float] = None   # over-provision onset
        self._last_action_prev = -1e18   # for cancel_retirement rollback
        self._mu: Optional[float] = None           # learned req/s/replica

    # -- signals -----------------------------------------------------------
    def observe_arrival(self, t: float,
                        difficulty: Optional[float] = None) -> None:
        """Feed one frontend arrival (its arrival timestamp) to the
        forecaster. The driver calls this as it delivers arrivals; on a
        tiered fleet it also passes the request's ``difficulty`` so the
        cross-tier split can track the demand mix."""
        self.forecaster.observe(t)
        if difficulty is not None:
            self._tiered = True
            self._difficulties.append((t, difficulty))
            horizon = t - self.cfg.window
            while self._difficulties and self._difficulties[0][0] < horizon:
                self._difficulties.popleft()

    def observe(self, now: float, events: Sequence[TickEvents],
                tiers: Optional[Sequence[str]] = None) -> None:
        """Fold a tick's completions/drops into the attainment window.
        Entries are (t, slo_met, completed, tier): drops count against
        attainment but are not served throughput. ``tiers`` (driver-passed
        on tiered fleets) tags each event with its replica's tier name so
        per-tier service rates can be learned."""
        for i, ev in enumerate(events):
            tag = tiers[i] if tiers is not None else ""
            if tag:
                self._tiered = True
            for r in ev.completed:
                self._outcomes.append(
                    (now, r.finish is not None and r.finish <= r.slo, True,
                     tag))
            for r in ev.dropped:
                self._outcomes.append((now, False, False, tag))
        horizon = now - self.cfg.window
        while self._outcomes and self._outcomes[0][0] < horizon:
            self._outcomes.popleft()

    def attainment(self) -> Optional[float]:
        if not self._outcomes:
            return None
        return sum(met for _, met, _, _ in self._outcomes) \
            / len(self._outcomes)

    # -- capacity estimate (predictive path) -------------------------------
    def service_rate(self) -> Optional[float]:
        """Per-replica sustainable throughput: configured value, else the
        online estimate learned while the fleet was under pressure."""
        return self.cfg.service_rate if self.cfg.service_rate is not None \
            else self._mu

    def down_service_rate(self) -> Optional[float]:
        """Capacity estimate for *retirement* decisions: the conservative
        min of the configured rate and the online-learned one. Spawning on
        an optimistic estimate costs idle capacity; retiring on one costs
        an instant overload plus a cold start to undo it — and worse, the
        pair flaps forever. So the down path only trusts the configured
        rate as far as observation has not contradicted it."""
        rates = [r for r in (self.cfg.service_rate, self._mu) if r]
        return min(rates) if rates else None

    def _learn_service_rate(self, now: float, backlog: float,
                            ready: int) -> None:
        """EWMA of fleet completions/s per ready replica, sampled only when
        backlog shows the fleet is saturated (completions then measure
        capacity, not demand)."""
        if not ready or backlog < 0.5 * self.cfg.scale_up_backlog:
            return
        done = sum(1 for _, _, completed, _ in self._outcomes if completed)
        if not done:
            return
        span = now - self._outcomes[0][0]
        if span < self.cfg.forecast_bin:
            return                # too little evidence: rate would explode
        rate = done / min(span, self.cfg.window) / ready
        self._mu = rate if self._mu is None else 0.7 * self._mu + 0.3 * rate

    def _learn_tier_rates(self, now: float, backlog: float,
                          pool: Sequence[Replica]) -> None:
        """Per-tier EWMA of completions/s per ready replica of that tier —
        the same saturation-gated estimator as ``_learn_service_rate``,
        split by the tier tag ``observe`` recorded with each outcome."""
        if backlog < 0.5 * self.cfg.scale_up_backlog or not self._outcomes:
            return
        span = now - self._outcomes[0][0]
        if span < self.cfg.forecast_bin:
            return
        ready: Dict[str, int] = {}
        for r in pool:
            if r.model_tier is not None and r.ready_at <= now:
                ready[r.model_tier.name] = ready.get(r.model_tier.name,
                                                     0) + 1
        done: Dict[str, int] = {}
        for _, _, completed, tag in self._outcomes:
            if completed and tag:
                done[tag] = done.get(tag, 0) + 1
        for name, d in done.items():
            n = ready.get(name, 0)
            if not n:
                continue
            rate = d / min(span, self.cfg.window) / n
            prev = self._mu_tier.get(name)
            self._mu_tier[name] = rate if prev is None \
                else 0.7 * prev + 0.3 * rate

    # -- cross-tier split (heterogeneous fleets) ---------------------------
    def _tier_rate(self, tier: ModelTier) -> float:
        """Best per-replica throughput estimate for ``tier``: learned
        per-tier rate, else the fleet rate scaled by the tier's step cost,
        else the step-cost reciprocal (right *relative* weights even with
        no throughput evidence at all)."""
        mu = self._mu_tier.get(tier.name)
        if mu:
            return mu
        base = self.service_rate()
        if base:
            return base / tier.step_cost
        return 1.0 / tier.step_cost

    def _demand_weights(self, ladder: Sequence[ModelTier]
                        ) -> Dict[str, float]:
        """Replica-demand weight per tier: the windowed arrival-difficulty
        mix mapped to the cheapest satisfying tier, divided by that tier's
        service rate (a tier serving 20% of arrivals at half speed needs as
        many replicas as one serving 40% at full speed). Uniform shares
        when no difficulties have been observed yet."""
        shares = {t.name: 0.0 for t in ladder}
        if self._difficulties:
            for _, d in self._difficulties:
                tier = next((t for t in ladder if t.quality >= d),
                            ladder[-1])
                shares[tier.name] += 1.0
            total = sum(shares.values())
            shares = {n: s / total for n, s in shares.items()}
        else:
            shares = {t.name: 1.0 / len(ladder) for t in ladder}
        return {t.name: shares[t.name] / max(self._tier_rate(t), 1e-9)
                for t in ladder}

    def spawn_tier(self, now: float, ladder: Sequence[ModelTier],
                   replicas: Sequence[Replica]) -> ModelTier:
        """Which tier the +1 the driver is about to execute should spawn
        into: the tier whose demand-weighted target count exceeds its
        current count by the most (ties: cheaper tier — a wrong cheap
        spawn costs less)."""
        pool = [r for r in replicas
                if not r.retiring and r.retired_at is None
                and r.model_tier is not None]
        counts = {t.name: 0 for t in ladder}
        for r in pool:
            counts[r.model_tier.name] = counts.get(r.model_tier.name, 0) + 1
        weights = self._demand_weights(ladder)
        total_w = sum(weights.values()) or 1.0
        target = len(pool) + 1
        deficits = {t.name: weights[t.name] / total_w * target
                    - counts[t.name] for t in ladder}
        return max(ladder, key=lambda t: (deficits[t.name], -t.step_cost))

    def retire_tier(self, now: float, ladder: Sequence[ModelTier],
                    replicas: Sequence[Replica]) -> Optional[ModelTier]:
        """Which tier the -1 should retire from: the tier most
        over-provisioned against the demand mix, among tiers that can lose
        a replica without emptying (the driver enforces the last-of-tier
        guard regardless). None when no tier has two replicas."""
        pool = [r for r in replicas
                if not r.retiring and r.retired_at is None
                and r.model_tier is not None]
        counts = {t.name: 0 for t in ladder}
        for r in pool:
            counts[r.model_tier.name] = counts.get(r.model_tier.name, 0) + 1
        cands = [t for t in ladder if counts[t.name] >= 2]
        if not cands:
            return None
        weights = self._demand_weights(ladder)
        total_w = sum(weights.values()) or 1.0
        target = max(len(pool) - 1, 1)
        surplus = {t.name: counts[t.name]
                   - weights[t.name] / total_w * target for t in ladder}
        return max(cands, key=lambda t: (surplus[t.name], t.step_cost))

    def effective_cold_start(self) -> float:
        """The cold start the predictive path prices spawns with: the
        configured ``cold_start``, discounted by ``warm_boot_factor`` when
        the driver flagged the fleet warm-bootable. A tier-prefetched
        replica serves at full cache speed from its first dispatch, so its
        time-to-*useful* is genuinely shorter than a stone-cold boot's even
        though the boot itself takes as long."""
        if self.warm_boot:
            return self.cfg.cold_start * self.cfg.warm_boot_factor
        return self.cfg.cold_start

    # -- decision ----------------------------------------------------------
    def decide(self, now: float, frontend_depth: int,
               replicas: Sequence[Replica]) -> int:
        """Returns +1 (spawn), -1 (retire one), or 0. The driver picks the
        concrete victim / resolution block."""
        cfg = self.cfg
        pool = [r for r in replicas if not r.retiring and r.retired_at is None]
        n = len(pool)
        backlog = (sum(r.backlog(now) for r in pool) / n) if n else 0.0
        att = self.attainment()
        self.forecaster.advance(now)
        if cfg.predictive:
            n_ready = sum(1 for r in pool if r.ready_at <= now)
            self._learn_service_rate(now, backlog, n_ready)
        if self._tiered:
            self._learn_tier_rates(now, backlog, pool)

        idle = (backlog < cfg.scale_down_backlog and frontend_depth == 0
                and (att is None or att >= cfg.scale_down_attainment))
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        if now - self._last_action < cfg.cooldown:
            return 0
        if n == 0:
            self._last_action = now
            self.actions.append((now, +1))
            if self.tracer.enabled:
                self.tracer.scale(now, +1, "bootstrap")
            return +1

        pressured = (backlog > cfg.scale_up_backlog
                     or frontend_depth > cfg.scale_up_frontend * n
                     or (att is not None and att < cfg.slo_target))
        if pressured:
            self._down_since = None
        if pressured and n < cfg.max_replicas:
            self._idle_since = None
            self._last_action = now
            self.actions.append((now, +1))
            if self.tracer.enabled:
                self.tracer.scale(now, +1, "reactive")
            return +1

        ecs = self.effective_cold_start()
        horizon = cfg.forecast_horizon if cfg.forecast_horizon \
            is not None else ecs + cfg.forecast_bin

        # predictive pre-spawn: provision for the rate one cold-start out,
        # counting replicas already warming; reliability-gated so a bad
        # forecast degrades to pure reactive scaling
        if cfg.predictive and n < cfg.max_replicas:
            mu = self.service_rate()
            if mu and self.forecaster.reliable(cfg.forecast_min_bins,
                                               cfg.forecast_max_err):
                lam = self.forecaster.forecast(horizon)
                desired = min(int(math.ceil(lam * cfg.headroom / mu)),
                              cfg.max_replicas)
                # a replica that cannot be up by the horizon — e.g. a crash
                # replacement stalled behind a zone outage — is not
                # capacity at the horizon; plan with the ones that will be.
                # Cold fleets never let the cutoff undercut one cold start
                # (a normally-warming spawn is always counted); warm-boot
                # fleets price it at the shorter effective cold start, so a
                # still-booting replica only counts once it is nearly up —
                # spawns trigger earlier and refill faster, and the extras
                # arrive warm instead of adding cold-ramp drag
                cutoff = now + max(horizon, ecs)
                n_h = sum(1 for r in pool if r.ready_at <= cutoff)
                if desired > n_h:
                    self._idle_since = None
                    self._down_since = None
                    self._last_action = now
                    self.actions.append((now, +1))
                    self.predictive_spawns.append(now)
                    if self.tracer.enabled:
                        self.tracer.scale(now, +1, "predictive")
                    return +1

        # predictive early retirement: the forecast (with the larger
        # retirement headroom) says n-1 replicas will still cover demand at
        # the horizon — start draining one *before* the queues empty, so
        # capacity tracks a ramp-down instead of trailing it by the whole
        # reactive idle window
        if cfg.predictive and cfg.predictive_down and not pressured \
                and n > cfg.min_replicas:
            mu = self.down_service_rate()
            over = False
            if mu and self.forecaster.reliable(cfg.forecast_min_bins,
                                               cfg.forecast_max_err):
                lam = self.forecaster.forecast(horizon)
                needed = max(int(math.ceil(lam * cfg.down_headroom / mu)),
                             cfg.min_replicas)
                over = needed < n
            if not over:
                self._down_since = None
            else:
                if self._down_since is None:
                    self._down_since = now
                if now - self._down_since >= cfg.down_hold:
                    self._down_since = None
                    self._last_action_prev = self._last_action
                    self._last_action = now
                    self.actions.append((now, -1))
                    self.predictive_retirements.append(now)
                    if self.tracer.enabled:
                        self.tracer.scale(now, -1, "predictive")
                    return -1

        if (idle and n > cfg.min_replicas
                and now - self._idle_since >= cfg.scale_down_hold):
            self._last_action_prev = self._last_action
            self._last_action = now
            self.actions.append((now, -1))
            if self.tracer.enabled:
                self.tracer.scale(now, -1, "idle")
            return -1
        return 0

    def cancel_retirement(self, now: float) -> None:
        """The driver found no retirable victim for the -1 just issued at
        ``now`` (e.g. every candidate is its block's last server): undo the
        decision log and the consumed cooldown, so phantom retirements are
        neither reported (``predictive_retirements`` feeds benchmark
        assertions) nor allowed to throttle the next real action."""
        if self.actions and self.actions[-1] == (now, -1):
            self.actions.pop()
        if self.predictive_retirements \
                and self.predictive_retirements[-1] == now:
            self.predictive_retirements.pop()
        self._last_action = self._last_action_prev
        if self.tracer.enabled:
            self.tracer.scale(now, 0, "retirement_cancelled")
