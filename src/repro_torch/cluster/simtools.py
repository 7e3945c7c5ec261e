"""Sim-clock engine factories for cluster experiments.

Every replica gets a ``PatchedServeEngine`` on the sim clock, by default in
``sim_synthetic`` mode (no tensors; a step is pure accounting; without it
the replica runs the model step on its device), with a **patch-aware**
latency surrogate
(``repro_torch.core.latency_model.patch_aware_step_latency``): compute priced in
latent pixels, overhead in patch count — so replicas built over an affinity
block (larger GCD patch) are honestly faster, and replicas with different
resolution sets remain comparable on one clock.

Standalone latencies (SLO normalizers, Clockwork convention) are always
computed on the *baseline* full-ladder GCD patch so SLOs mean the same
thing fleet-wide regardless of how replicas are partitioned.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, KeysView, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.csp import gcd_patch_size
from repro_torch.core.latency_model import (CacheHitModel, patch_aware_step_latency,
                                            resolution_concentration)
from repro_torch.core.requests import Request, poisson_workload
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.serving import EngineConfig, PatchedServeEngine
from repro_torch.device import resolve_device
from repro_torch.models import diffusion as dm

Resolution = Tuple[int, int]

#: latent Low / Medium / High ladder of the cluster experiments
DEFAULT_RES: List[Resolution] = [(16, 16), (24, 24), (32, 32)]

#: elastic-controller reference scenario for ``piecewise_rate_workload``:
#: the arrival rate ramps 8 -> 140 qps over 35 s, then back down to 6 by
#: 65 s. Shared by the benchmark, the example and the tests so the regime
#: they validate cannot silently drift apart (see the adaptive-cluster
#: tuning notes: predictive wins need a visible trend, not a step).
UPDOWN_KNOTS: List[Tuple[float, float]] = [(0.0, 8.0), (35.0, 140.0),
                                           (65.0, 6.0)]


@dataclass
class Scenario:
    """One shared benchmark regime as a single object: the scenario
    constants, the workload builder, the per-arm fleet configurations
    (keyword arguments of a ``make_cluster`` helper), the seeds the win is
    asserted on, and a one-line statement of what the headline arm must
    beat. Consolidates the helper *pairs* that used to grow alongside
    each regime dict (``<regime>_workload`` + ``<regime>_cluster_kwargs``)
    so the benchmark, the example and the regression tests keep running
    literally the same fleets by construction.

    A ``Scenario`` also speaks the mapping protocol over ``params``
    (``sc["qps"]``, ``sc.items()``, ``{**sc}`` ...), so code written
    against the old plain-dict regimes keeps working unchanged.
    """
    name: str
    params: Dict[str, object]
    workload_fn: Callable[[int], List[Request]]
    arm_fns: Dict[str, Callable[[], dict]] = field(default_factory=dict)
    seeds: Tuple[int, ...] = (0, 1, 2)
    win: str = ""

    # -- the consolidated helper pair -----------------------------------
    def workload(self, seed: int = 0) -> List[Request]:
        """The shared workload (regenerate per run — ``Request`` objects
        mutate while served)."""
        return self.workload_fn(seed)

    def cluster_kwargs(self, arm: str) -> dict:
        """``make_cluster`` keyword arguments for one arm."""
        try:
            fn = self.arm_fns[arm]
        except KeyError:
            raise ValueError(
                f"unknown {self.name} arm {arm!r} "
                f"(have {sorted(self.arm_fns)})") from None
        return fn()

    @property
    def arms(self) -> List[str]:
        return list(self.arm_fns)

    # -- mapping protocol over params (plain-dict back-compat) ----------
    def __getitem__(self, key: str):
        return self.params[key]

    def __contains__(self, key: object) -> bool:
        return key in self.params

    def __iter__(self) -> Iterator[str]:
        return iter(self.params)

    def __len__(self) -> int:
        return len(self.params)

    def keys(self) -> KeysView[str]:
        return self.params.keys()

    def values(self):
        return self.params.values()

    def items(self):
        return self.params.items()

    def get(self, key: str, default=None):
        return self.params.get(key, default)

#: fault-tolerance reference scenarios, shared by the ``--faults`` sweep,
#: the example and the tests so the regimes they validate cannot silently
#: drift apart. ``CRASH_FAULTS``: long-denoise requests on a fleet with
#: headroom, under frequent independent crashes — SLO misses are
#: crash-caused (redone denoise work), exactly what checkpointed resume
#: removes; at saturation the win drowns in load shedding instead.
#: ``ZONE_FAULTS``: a near-capacity fleet spread over 3 fault domains with
#: recurrent correlated outages — the regime where zone-blind placement
#: parks replacements in still-down zones and concentrates exposure.
CRASH_FAULTS = {"qps": 24.0, "duration": 40.0, "n_replicas": 4,
                "mtbf": 6.0, "cold_start": 1.0, "steps": 30,
                "slo_scale": 4.0}
ZONE_FAULTS = {"qps": 104.0, "duration": 40.0, "n_replicas": 6,
               "zones": 3, "zone_mtbf": 25.0, "zone_downtime": 12.0,
               "cold_start": 1.0}

#: healthy-baseline regime for the ``--monitor`` sweep and the monitor
#: tests: the ``CRASH_FAULTS`` fleet with the failure process removed —
#: same load, same headroom, no injected incidents — so the burn-rate
#: rules' false-positive rate is measured against exactly the fleet the
#: alerts must trip on once crashes are switched back on.
HEALTHY_BASELINE = {"qps": 24.0, "duration": 40.0, "n_replicas": 4,
                    "steps": 30, "slo_scale": 4.0}

#: load for the monitored zone-outage regime: the ``ZONE_FAULTS`` fleet
#: run closer to capacity (120 qps vs 104) so that losing a zone is
#: always an SLO-threatening incident. At 104 qps a lucky outage draw is
#: absorbed by fleet headroom and the burn-rate rules (correctly) stay
#: quiet — which would make "every injected incident pages" untestable
#: as ground truth.
MONITOR_ZONE_QPS = 120.0


def monitor_config(window: float = 1.0, slo_target: float = 0.9):
    """The shared ``MonitorConfig`` for the fault regimes (the
    ``--monitor`` sweep, the example and the tests): 1 s windows are fine
    enough to localize a crash inside a 40 s run and ``slo_target=0.9``
    budgets 10% misses. The rule thresholds are calibrated against the
    measured regimes (seeds 0-5): the healthy baseline
    (``HEALTHY_BASELINE``) peaks at 3.2x budget over its worst full
    12 s window and 2.7x over its worst 24 s window, while every crash /
    zone-outage / flash-crowd incident sustains >=4.1x (12 s) and
    >=3.5x (24 s) — so the fast rule pages at 3.5x over 3 s/12 s and the
    slow rule at 3x over 6 s/24 s: quiet on the baseline, tripped inside
    every injected incident."""
    from repro_torch.cluster.monitor import AlertRule, MonitorConfig
    return MonitorConfig(window=window, slo_target=slo_target,
                         rules=(AlertRule("fast_burn", short_window=3.0,
                                          long_window=12.0, burn_rate=3.5,
                                          repeat=5.0),
                                AlertRule("slow_burn", short_window=6.0,
                                          long_window=24.0, burn_rate=3.0,
                                          repeat=10.0)))

#: fleet patch-cache-tier reference scenario, shared by the ``--cachetier``
#: sweep, the example and the tests. Repeat-heavy hybrid-resolution
#: traffic: each phase concentrates almost all arrivals on one end of the
#: ladder (requests repeat the same resolution over and over — warm patch
#: content pays), and the dominant end flips between phases with
#: phase-specific rates (a cheap-resolution burst is much denser than the
#: High-resolution phase it alternates with). No static block allocation
#: covers both phases — a Low-provisioned partition drowns in the High
#: phase and vice versa — while warmth-directed dispatch
#: (``cache_affinity``) retargets the whole uniform fleet each phase,
#: cold recruits warming instantly from the fleet tier instead of from
#: scratch.
def _cachetier_workload(seed: int = 0) -> List[Request]:
    sc = CACHE_TIER
    return phased_workload(list(sc["phases"]), steps=sc["steps"],
                           slo_scale=sc["slo_scale"], seed=seed)


def _cachetier_arm(arm: str) -> dict:
    """Headline pair of the cachetier regime: ``no_tier`` (cache_affinity
    dispatch, identical L1 warmth dynamics, no fleet L2 — the dispatch-only
    ablation) vs ``tier`` (the full fleet patch-cache tier)."""
    cap = {"no_tier": 0, "tier": None}[arm]
    sc = CACHE_TIER
    return dict(n_replicas=sc["n_replicas"], policy="cache_affinity",
                steps=sc["steps"], cache=True,
                cache_tier=cachetier_config(cap))


CACHE_TIER = Scenario(
    name="cachetier",
    params={"phases": [(15.0, 160.0, (0.9, 0.05, 0.05)),
                       (15.0, 75.0, (0.075, 0.075, 0.85)),
                       (15.0, 160.0, (0.9, 0.05, 0.05))],
            "n_replicas": 4, "steps": 12, "slo_scale": 5.0},
    workload_fn=_cachetier_workload,
    arm_fns={"no_tier": lambda: _cachetier_arm("no_tier"),
             "tier": lambda: _cachetier_arm("tier")},
    win="fleet patch-cache tier + cache_affinity dispatch beats the best "
        "no-tier PR-4 policy on fleet SLO satisfaction")


def cachetier_workload(seed: int = 0) -> List[Request]:
    """Deprecated thin wrapper — use ``CACHE_TIER.workload(seed)``."""
    warnings.warn("cachetier_workload() is deprecated; use "
                  "CACHE_TIER.workload(seed)", DeprecationWarning,
                  stacklevel=2)
    return CACHE_TIER.workload(seed)


def cachetier_mean_mix() -> Tuple[float, ...]:
    """Arrival-weighted mean resolution mix of the reference scenario —
    the best *static* provisioning a frozen affinity partition could be
    given (used as the strongest no-tier baseline)."""
    sc = CACHE_TIER
    tot = sum(d * q for d, q, _ in sc["phases"])
    return tuple(sum(d * q * m[i] for d, q, m in sc["phases"]) / tot
                 for i in range(len(sc["phases"][0][2])))


def cachetier_config(capacity_bytes: Optional[int] = None):
    """The shared ``CacheTierConfig`` for the reference scenario.
    ``capacity_bytes=0`` is the no-tier baseline: identical L1 warmth
    dynamics, no fleet L2 to fetch from. ``l1_entries=4`` holds exactly
    one resolution's step bands — a warmth-focused replica is stable, one
    juggling the whole ladder thrashes; ``warmup_steps=8`` (two thirds of
    the scenario's 12-step denoise) makes from-scratch warmup genuinely
    slow, which is what a fleet-tier fetch short-circuits."""
    from repro_torch.cluster.cachetier import CacheTierConfig
    kw = {} if capacity_bytes is None else \
        {"capacity_bytes": capacity_bytes}
    return CacheTierConfig(fetch_cost=2e-3, write_cost=1e-3,
                           l1_entries=4, warmup_steps=8, **kw)


#: warm-boot (elastic x cache-tier) reference scenario, shared by the
#: ``--warmboot`` sweep, the example and the tests. A flash crowd: steady
#: repeat-heavy traffic two replicas serve comfortably (long enough to warm
#: their L1s and publish into the fleet L2), then the arrival rate steps up
#: ~14x for 15 s and back down. The elastic fleet spawns through the spike
#: either way; the regime isolates what the new replicas are worth the
#: moment they come up. Tuning notes (how each constant earns its place):
#: the spike rate sits just under the *warm* fleet's max-replica capacity,
#: so the backlog drains at a rate set by how fast the new replicas serve
#: — a cold spawn ramps its patch cache from scratch for seconds of loaded
#: serving while a tier-warmed one is at full cache speed from its first
#: dispatch; and ``slo_scale`` is loose enough that queued spike requests
#: are still servable when capacity arrives (with tight SLOs every queued
#: request is equally dead in all arms and warmth cannot move attainment).
#: Duplicate-time knots express the step edges
#: (``piecewise_rate_workload`` keeps their order).
def _flash_crowd_workload(seed: int = 0) -> List[Request]:
    sc = FLASH_CROWD
    return piecewise_rate_workload(list(sc["knots"]), mix=sc["mix"],
                                   steps=sc["steps"],
                                   slo_scale=sc["slo_scale"], seed=seed)


def _warmboot_arm(arm: str) -> dict:
    if arm == "cold":
        tier = warmboot_tier_config(prefetch=False, capacity_bytes=0)
    elif arm == "noprefetch":
        tier = warmboot_tier_config(prefetch=False)
    elif arm == "warm":
        tier = warmboot_tier_config(prefetch=True)
    else:
        raise ValueError(f"unknown warmboot arm {arm!r}")
    sc = FLASH_CROWD
    return dict(n_replicas=sc["n_replicas"], policy="cache_affinity",
                autoscaler=warmboot_autoscaler(), steps=sc["steps"],
                cache=True, cache_tier=tier)


FLASH_CROWD = Scenario(
    name="warmboot",
    params={"knots": [(0.0, 14.0), (10.0, 14.0), (10.0, 200.0),
                      (25.0, 200.0), (25.0, 14.0), (35.0, 14.0)],
            "mix": (0.85, 0.10, 0.05),
            "steps": 12, "slo_scale": 12.0,
            "n_replicas": 2, "max_replicas": 6, "cold_start": 2.0,
            "cooldown": 1.0, "service_rate": 35.0},
    workload_fn=_flash_crowd_workload,
    arm_fns={"cold": lambda: _warmboot_arm("cold"),
             "noprefetch": lambda: _warmboot_arm("noprefetch"),
             "warm": lambda: _warmboot_arm("warm")},
    win="tier-warmed elastic fleet beats the cold elastic fleet on fleet "
        "SLO satisfaction on every seed")


def flash_crowd_workload(seed: int = 0) -> List[Request]:
    """Deprecated thin wrapper — use ``FLASH_CROWD.workload(seed)``."""
    warnings.warn("flash_crowd_workload() is deprecated; use "
                  "FLASH_CROWD.workload(seed)", DeprecationWarning,
                  stacklevel=2)
    return FLASH_CROWD.workload(seed)


def warmboot_tier_config(prefetch: bool = True,
                         capacity_bytes: Optional[int] = None):
    """The shared ``CacheTierConfig`` for the flash-crowd scenario.
    ``l1_entries=12`` holds the whole ladder's step bands, so the regime
    isolates cold-start warmup (not working-set thrash — that is the
    ``--cachetier`` regime's axis); ``warmup_steps=160`` prices a
    production-sized reuse predictor that needs seconds of loaded serving
    before from-scratch reuse fires, which is exactly the ramp a tier
    fetch (or boot prefetch) short-circuits. Size-dependent fetch pricing
    is on (``fetch_cost_per_byte``): a High entry costs ~4x a Low one to
    pull, and a full boot prefetch still transfers in tens of
    milliseconds — far inside the 2 s cold start it overlaps.
    ``prefetch=False`` is the ablation arm (tier on, spawns boot cold);
    ``capacity_bytes=0`` the no-tier baseline."""
    from repro_torch.cluster.cachetier import CacheTierConfig
    kw = {} if capacity_bytes is None else \
        {"capacity_bytes": capacity_bytes}
    return CacheTierConfig(fetch_cost=1e-3, fetch_cost_per_byte=5e-7,
                           write_cost=1e-3, l1_entries=12, warmup_steps=160,
                           prefetch_on_spawn=prefetch, **kw)


def warmboot_autoscaler(warm_boot_factor: float = 0.5):
    """The shared elastic controller for the flash-crowd scenario:
    reactive + predictive spawning over ``FLASH_CROWD``'s fleet envelope,
    with a short cooldown so the fleet can actually chase an 8 s spike.
    ``warm_boot_factor`` only takes effect when the driver flags the fleet
    warm-bootable (tier with ``prefetch_on_spawn``) — identical configs
    can be passed to every benchmark arm."""
    from repro_torch.cluster.autoscaler import AutoscalerConfig
    sc = FLASH_CROWD
    return AutoscalerConfig(min_replicas=sc["n_replicas"],
                            max_replicas=sc["max_replicas"],
                            cold_start=sc["cold_start"],
                            cooldown=sc["cooldown"],
                            predictive=True,
                            service_rate=sc["service_rate"],
                            warm_boot_factor=warm_boot_factor)


def warmboot_cluster_kwargs(arm: str) -> dict:
    """Deprecated thin wrapper — use ``FLASH_CROWD.cluster_kwargs(arm)``
    (arms: ``"warm"`` tier + spawn prefetch, ``"noprefetch"`` tier with
    cold-booting spawns — the ablation, ``"cold"`` no fleet L2 at all)."""
    warnings.warn("warmboot_cluster_kwargs() is deprecated; use "
                  "FLASH_CROWD.cluster_kwargs(arm)", DeprecationWarning,
                  stacklevel=2)
    return FLASH_CROWD.cluster_kwargs(arm)


#: gang-batching reference scenario, shared by the ``--batching`` sweep
#: section and the tests. A steady hybrid-resolution Poisson stream near
#: the fleet's knee: per-request dispatch (``join_shortest_queue``)
#: spreads each resolution thin across the replicas, so every step is a
#: small mixed batch — full per-group overhead, low resolution
#: concentration, weak cache hits. The batch former stacks same-patch
#: work into gangs instead: each replica steps fewer, fuller,
#: single-resolution batches (amortized base + group cost, concentrated
#: patch cache), which is the paper's patches-are-the-batching-unit
#: insight applied at fleet scale. ``max_wait`` spends only surplus
#: admission slack (``slo_scale`` leaves several step-times of headroom);
#: ``max_step_cost`` caps how much one gang may slow the shared step.
def _batch_mix_workload(seed: int = 0) -> List[Request]:
    sc = BATCH_MIX
    return cluster_workload(sc["qps"], sc["duration"], steps=sc["steps"],
                            slo_scale=sc["slo_scale"], mix=sc["mix"],
                            seed=seed)


def _batch_arm(arm: str) -> dict:
    if arm == "per_request":
        former = None
    elif arm == "nowait":
        former = batch_former_config(max_wait=0.0)
    elif arm == "gang":
        former = batch_former_config()
    else:
        raise ValueError(f"unknown batching arm {arm!r}")
    sc = BATCH_MIX
    return dict(n_replicas=sc["n_replicas"], policy=sc["policy"],
                steps=sc["steps"], cache=True, batcher=former)


BATCH_MIX = Scenario(
    name="batching",
    params={"qps": 105.0, "duration": 25.0, "n_replicas": 4, "steps": 10,
            "slo_scale": 8.0, "mix": (1 / 3, 1 / 3, 1 / 3),
            "policy": "join_shortest_queue",
            "max_wait": 0.06, "max_step_cost": 0.060},
    workload_fn=_batch_mix_workload,
    arm_fns={"per_request": lambda: _batch_arm("per_request"),
             "nowait": lambda: _batch_arm("nowait"),
             "gang": lambda: _batch_arm("gang")},
    win="batch-former gang dispatch beats per-request dispatch at equal "
        "fleet size on fleet SLO satisfaction")


def batch_mix_workload(seed: int = 0) -> List[Request]:
    """Deprecated thin wrapper — use ``BATCH_MIX.workload(seed)``."""
    warnings.warn("batch_mix_workload() is deprecated; use "
                  "BATCH_MIX.workload(seed)", DeprecationWarning,
                  stacklevel=2)
    return BATCH_MIX.workload(seed)


def batch_former_config(max_wait: Optional[float] = None):
    """The shared ``BatchFormerConfig`` for the gang-batching scenario.
    ``max_wait=0.0`` is the ablation arm: the former still gang-dispatches
    whatever is simultaneously queued but never deliberately holds a
    request."""
    from repro_torch.cluster.batcher import BatchFormerConfig
    sc = BATCH_MIX
    return BatchFormerConfig(
        max_wait=sc["max_wait"] if max_wait is None else max_wait,
        max_step_cost=sc["max_step_cost"])


def batch_cluster_kwargs(arm: str) -> dict:
    """Deprecated thin wrapper — use ``BATCH_MIX.cluster_kwargs(arm)``
    (arms: ``"per_request"`` no former, ``"nowait"`` former with
    ``max_wait=0.0`` — the ablation, ``"gang"`` the full former)."""
    warnings.warn("batch_cluster_kwargs() is deprecated; use "
                  "BATCH_MIX.cluster_kwargs(arm)", DeprecationWarning,
                  stacklevel=2)
    return BATCH_MIX.cluster_kwargs(arm)


# -- query-aware model cascade ------------------------------------------
#
# Hybrid-resolution Poisson stream where each request carries a hidden
# *difficulty* (the minimum model quality that makes its output
# acceptable): most requests are easy enough for a distilled cheap model,
# a quarter need the base model, a hard tail needs the largest one. Four
# fleets at equal tier-weighted GPU cost (fleet cost = sum of replica
# ``ModelTier.step_cost``): the cascade (mostly-lite fleet with one base
# and one max replica, ``cascade`` dispatch + confidence-gated
# escalation), ``always_cheap`` (all lite — huge raw capacity, but 40% of
# requests come back under quality), ``always_base`` (the strongest
# homogeneous competitor — still gives up on the hard tail) and
# ``always_big`` (all max — every output is good, but at this cost the
# fleet drowns in its own service time). The headline metric is
# *quality-adjusted* SLO attainment (``slo_quality_attainment``): met the
# deadline AND met the request's difficulty — the number an always-cheap
# fleet cannot game. ``slo_scale`` leaves room for an escalated request
# to pay two (or three) passes plus queueing; the qps sits inside the
# cascade's work capacity but ~2x over always_big's.
def _cascade_workload(seed: int = 0) -> List[Request]:
    sc = CASCADE_MIX
    reqs = cluster_workload(sc["qps"], sc["duration"], steps=sc["steps"],
                            slo_scale=sc["slo_scale"], seed=seed)
    levels, probs = zip(*sc["difficulties"])
    # separate stream so difficulty is i.i.d. of arrival order/resolution
    rng = np.random.default_rng(seed + 7919)
    for req, i in zip(reqs, rng.choice(len(levels), size=len(reqs),
                                       p=np.asarray(probs, np.float64))):
        req.difficulty = float(levels[i])
    return reqs


def _cascade_arm(arm: str) -> dict:
    sc = CASCADE_MIX
    fleets = {"cascade": sc["tiers"], **sc["homogeneous"]}
    if arm not in fleets:
        raise ValueError(f"unknown cascade arm {arm!r}")
    return dict(policy="cascade", tiers=dict(fleets[arm]),
                steps=sc["steps"])


def cascade_fleet_cost(tiers: Dict[str, int]) -> float:
    """Tier-weighted GPU cost of a fleet spec: replica count times the
    tier's ``step_cost`` (the bigger model occupies the bigger GPU). The
    ``--cascade`` sweep asserts every arm prices out identically."""
    from repro_torch.cluster.replica import MODEL_TIERS
    return float(sum(MODEL_TIERS[name].step_cost * count
                     for name, count in tiers.items()))


CASCADE_MIX = Scenario(
    name="cascade",
    params={"qps": 45.0, "duration": 25.0, "steps": 10, "slo_scale": 10.0,
            # (difficulty, probability): easy / medium / hard tail
            "difficulties": ((0.3, 0.60), (0.7, 0.25), (0.95, 0.15)),
            "tiers": {"lite": 2, "base": 1, "max": 1},
            "homogeneous": {"always_cheap": {"lite": 8},
                            "always_base": {"base": 4},
                            "always_big": {"max": 2}}},
    workload_fn=_cascade_workload,
    arm_fns={"cascade": lambda: _cascade_arm("cascade"),
             "always_cheap": lambda: _cascade_arm("always_cheap"),
             "always_base": lambda: _cascade_arm("always_base"),
             "always_big": lambda: _cascade_arm("always_big")},
    win="cascade dispatch + confidence-gated escalation beats every "
        "equal-cost homogeneous fleet on quality-adjusted SLO attainment")


class PatchAwareLatency:
    """Adapter giving one engine's composition features to the patch-aware
    surrogate (plugs into ``PatchedServeEngine.latency_model``).

    With a ``CacheHitModel`` attached the surrogate is also *cache-aware*:
    each step's predicted latency is discounted by the modeled patch-cache
    hit rate, which grows with the replica's resolution-set concentration
    and the batch's step fraction — so affinity placement is rewarded for
    cache locality, not just for its larger GCD patch.

    With a fleet cache tier additionally attached (``attach_tier`` — done
    by the cluster driver when ``ClusterConfig.cache_tier`` is set) the
    discount is *warmth-gated*: the plain model's hit rate only applies to
    the fraction of the batch's patch keys this replica's L1 is actually
    warm for, and the cold remainder is partially recovered through the
    fleet L2 store at a fetch-latency discount
    (``CacheHitModel.two_level_hit_rate``). A replica that has never
    served a resolution is honestly cold for it until it fetches a
    sibling's warm entries or warms itself up."""

    def __init__(self, resolutions: Sequence[Resolution], patch: int,
                 scale: float = 1.0, cache: Optional[CacheHitModel] = None):
        self.resolutions = [tuple(r) for r in resolutions]
        self.patch = patch
        self.scale = scale
        self.cache = cache
        self.tier = None                # TierClient once attach_tier runs
        self._last_hit = 0.0            # effective rate of the last predict
        self.patches_per_res = [(h // patch) * (w // patch)
                                for h, w in self.resolutions]

    def attach_tier(self, client) -> None:
        """Gate the cache discount by the replica's L1/L2 warmth
        (``repro_torch.cluster.cachetier.TierClient``)."""
        self.tier = client

    def modeled_hit_rate(self, concentration: float,
                         step_frac: float) -> float:
        """Hit probability for one step — read back by the engine tick for
        fleet hit-rate metrics. The engine only calls this when ``cache``
        is set (a surrogate advertises cache-awareness by exposing a truthy
        ``cache`` alongside this method). With a tier attached this is the
        two-level effective rate of the batch the engine just priced via
        ``predict_batch`` (the engine calls the two back to back)."""
        if self.tier is not None:
            return self._last_hit
        return self.cache.hit_rate(concentration, step_frac)

    def _latency(self, counts: Sequence[float], hit: float) -> float:
        return patch_aware_step_latency(
            counts, self.resolutions, self.patch,
            cache_hit_rate=hit) * self.scale

    def predict(self, feats) -> float:
        counts = [max(float(c), 0.0) for c in feats[:len(self.resolutions)]]
        return self._latency(counts, 0.0)

    def predict_batch(self, counts: Sequence[int], reqs) -> float:
        counts = [max(float(c), 0.0) for c in counts]
        if self.cache is None or not reqs:
            return self._latency(counts, 0.0)
        conc = resolution_concentration(counts, self.patches_per_res)
        frac = float(np.mean([r.steps_done / max(r.total_steps, 1)
                              for r in reqs]))
        if self.tier is None:
            return self._latency(counts, self.cache.hit_rate(conc, frac))
        l1, l2 = self.tier.warm_fractions(reqs)
        self._last_hit = self.cache.two_level_hit_rate(
            conc, frac, l1, l2, l2_discount=self.tier.cfg.l2_discount)
        return self._latency(counts, self._last_hit)

    # -- gang sizing (cluster batch former) -----------------------------

    def _batch_counts(self, reqs) -> List[float]:
        counts = [0.0] * len(self.resolutions)
        idx = {r: i for i, r in enumerate(self.resolutions)}
        for r in reqs:
            i = idx.get(tuple(r.resolution))
            if i is not None:
                counts[i] += 1.0
        return counts

    def batch_step_cost(self, reqs) -> float:
        """Predicted one-step latency (sim-seconds) of ``reqs`` served as a
        single batch — the batch-latency *curve* point the cluster batch
        former prices gangs on (``repro_torch.cluster.batcher``)."""
        return self.predict_batch(self._batch_counts(reqs), list(reqs))

    def marginal_patch_cost(self, reqs, req) -> float:
        """Step-latency increase *per patch* (sim-seconds/patch) from
        appending ``req`` to the batch ``reqs``. The step curve is
        sublinear in patches, so this falls as the batch grows — which is
        why the former bounds gangs by marginal-patch-priced total step
        cost instead of request count (``BatchFormerConfig.max_step_cost``
        budgets ``batch_step_cost``; each candidate is admitted at its own
        marginal price)."""
        base = self.batch_step_cost(reqs) if reqs else 0.0
        extra = self.batch_step_cost(list(reqs) + [req]) - base
        h, w = req.resolution
        n = max((h // self.patch) * (w // self.patch), 1)
        return extra / n


def standalone_latencies(resolutions: Sequence[Resolution] = None,
                         steps: int = 10,
                         scale: float = 1.0) -> Dict[Resolution, float]:
    """Full-request standalone latency per resolution on the baseline
    (full-ladder GCD) configuration — the fleet-wide SLO normalizer."""
    res = [tuple(r) for r in (resolutions or DEFAULT_RES)]
    patch = gcd_patch_size(res)
    return {
        r: patch_aware_step_latency(
            [1 if rr == r else 0 for rr in res], res, patch) * steps * scale
        for r in res}


def sim_engine_factory(resolutions: Sequence[Resolution] = None,
                       steps: int = 10, scale: float = 1.0,
                       sched_policy: str = "slo",
                       synthetic: bool = True,
                       model_builder: Optional[Callable] = None,
                       cache: Optional[CacheHitModel] = None,
                       device=None
                       ) -> Callable[[Sequence[Resolution]],
                                     PatchedServeEngine]:
    """Returns ``factory(replica_resolutions) -> engine`` for
    ``Cluster(engine_factory=...)``. One diffusion model is shared by every
    replica: a tiny UNet drawn from seed 0, or ``model_builder()``'s
    ``(config, params)``. Synthetic engines never run it (a step is pure
    accounting); with ``synthetic=False`` every replica runs the real
    tensor step under the fleet's sim clock. ``device`` (``None``: the CUDA
    card, raising without one) holds the default model and every engine's
    tensors; pass ``device="cpu"`` for the CPU. Pass
    ``cache=CacheHitModel()`` for a cache-aware surrogate (replica steps get
    faster with resolution concentration and step fraction); SLO
    normalizers stay cache-free either way so deadlines mean the same thing
    across configurations."""
    dev = resolve_device(device)
    fleet_res = [tuple(r) for r in (resolutions or DEFAULT_RES)]
    sa = standalone_latencies(fleet_res, steps=steps, scale=scale)
    if model_builder is None:
        mcfg = dm.DiffusionConfig(kind="unet", width=16, levels=2,
                                  blocks_per_level=1, n_heads=2, groups=4,
                                  d_text=8, n_text=2, use_kernels=False)
        params = dm.init_diffusion(mcfg, torch.Generator().manual_seed(0),
                                   device=dev)
    else:
        mcfg, params = model_builder()

    def factory(replica_res: Sequence[Resolution]) -> PatchedServeEngine:
        res = [tuple(r) for r in replica_res]
        ecfg = EngineConfig(clock="sim", sim_synthetic=synthetic,
                            scheduler=SchedulerConfig(policy=sched_policy))
        eng = PatchedServeEngine(mcfg, params, ecfg, dict(sa), res,
                                 device=dev)
        eng.latency_model = PatchAwareLatency(res, eng.patch, scale,
                                              cache=cache)
        return eng

    return factory


def cluster_workload(qps: float, duration: float,
                     resolutions: Sequence[Resolution] = None,
                     slo_scale: float = 5.0, steps: int = 10,
                     scale: float = 1.0, seed: int = 0,
                     mix: Optional[Sequence[float]] = None) -> List[Request]:
    """Poisson fleet workload with SLOs normalized on the baseline system
    (same ``standalone_latencies`` every replica's scheduler sees)."""
    res = [tuple(r) for r in (resolutions or DEFAULT_RES)]
    sa = standalone_latencies(res, steps=steps, scale=scale)
    return poisson_workload(qps, duration, res, slo_scale, sa,
                            steps=steps, seed=seed, mix=mix)


def phased_workload(phases: Sequence[Tuple[float, float,
                                           Optional[Sequence[float]]]],
                    resolutions: Sequence[Resolution] = None,
                    slo_scale: float = 5.0, steps: int = 10,
                    scale: float = 1.0, seed: int = 0) -> List[Request]:
    """Drifting workload: concatenated Poisson phases, each
    ``(duration, qps, mix)`` — the resolution mix (and rate) shifts at phase
    boundaries while SLOs stay normalized on the same baseline standalone
    latencies. This is the workload where a frozen affinity partition loses
    to drift-triggered repartitioning."""
    res = [tuple(r) for r in (resolutions or DEFAULT_RES)]
    sa = standalone_latencies(res, steps=steps, scale=scale)
    out: List[Request] = []
    t0 = 0.0
    for i, (duration, qps, mix) in enumerate(phases):
        part = poisson_workload(qps, duration, res, slo_scale, sa,
                                steps=steps, seed=seed + i, mix=mix)
        for r in part:
            r.arrival += t0
            r.slo += t0
        out.extend(part)
        t0 += duration
    out.sort(key=lambda r: r.arrival)
    for rid, r in enumerate(out):
        r.rid = rid
    return out


def piecewise_rate_workload(knots: Sequence[Tuple[float, float]],
                            resolutions: Sequence[Resolution] = None,
                            slo_scale: float = 5.0, steps: int = 10,
                            scale: float = 1.0, seed: int = 0,
                            mix: Optional[Sequence[float]] = None
                            ) -> List[Request]:
    """Non-homogeneous Poisson arrivals whose rate follows the piecewise-
    linear curve through ``knots`` = [(t, qps), ...] (thinning
    construction). This is the general form behind ``ramp_workload``; an
    up-then-down knot sequence is the elastic-controller scenario — the
    predictive autoscaler should pre-spawn into the rising edge and retire
    ahead of the falling one."""
    # stable sort on time only: duplicate-time knots express step changes
    # and must keep their caller-given order, not be reordered by qps
    knots = sorted(((float(t), float(q)) for t, q in knots),
                   key=lambda k: k[0])
    if len(knots) < 2:
        raise ValueError("need at least two (t, qps) knots")
    res = [tuple(r) for r in (resolutions or DEFAULT_RES)]
    sa = standalone_latencies(res, steps=steps, scale=scale)
    rng = np.random.default_rng(seed)
    qmax = max(max(q for _, q in knots), 1e-9)
    duration = knots[-1][0]

    def rate(t: float) -> float:
        for (t0, q0), (t1, q1) in zip(knots, knots[1:]):
            if t <= t1:
                if t1 <= t0:
                    return q1
                return q0 + (q1 - q0) * (t - t0) / (t1 - t0)
        return knots[-1][1]

    p = np.asarray(mix if mix is not None else [1 / len(res)] * len(res),
                   np.float64)
    p = p / p.sum()
    out: List[Request] = []
    t, rid = knots[0][0], 0
    while True:
        t += rng.exponential(1.0 / qmax)
        if t > duration:
            break
        if rng.uniform() > rate(t) / qmax:
            continue                        # thinned-out candidate arrival
        r = tuple(res[rng.choice(len(res), p=p)])
        out.append(Request(rid=rid, resolution=r, arrival=t,
                           slo=t + slo_scale * sa[r], total_steps=steps,
                           prompt=f"prompt-{rid}"))
        rid += 1
    return out


def ramp_workload(qps0: float, qps1: float, duration: float,
                  resolutions: Sequence[Resolution] = None,
                  slo_scale: float = 5.0, steps: int = 10,
                  scale: float = 1.0, seed: int = 0,
                  mix: Optional[Sequence[float]] = None) -> List[Request]:
    """Non-homogeneous Poisson arrivals whose rate ramps linearly from
    ``qps0`` to ``qps1`` over ``duration`` (thinning construction) — the
    arrival trend a predictive autoscaler can see coming, unlike a step
    change."""
    return piecewise_rate_workload([(0.0, qps0), (duration, qps1)],
                                   resolutions=resolutions,
                                   slo_scale=slo_scale, steps=steps,
                                   scale=scale, seed=seed, mix=mix)
