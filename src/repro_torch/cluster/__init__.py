"""Multi-replica cluster serving on top of the steppable PatchedServe
engine: the port of the reference's fleet layer, with the same modules and
public names. It is numpy above the engine; with ``synthetic=False`` its
replicas run the torch engine's real tensor step on the device.

Layers:

- ``replica``    — one engine + cluster-side state (cold start, busy
                   horizon, utilization, drain-before-switch migration),
                   plus the ``ModelTier`` zoo for heterogeneous fleets
                   (per-tier step cost / output quality / cold start);
- ``router``     — frontend queue with pluggable dispatch policies
                   (declarative ``@register_policy`` registry:
                   round_robin / join_shortest_queue / least_slack /
                   resolution_affinity / ... / cascade), the affinity
                   partitioner, and the windowed arrival-mix tracker for
                   drift detection;
- ``autoscaler`` — reactive replica scaling from queue-slack and SLO
                   attainment, plus an optional predictive path (Holt
                   arrival-rate forecaster) that pre-spawns ahead of ramps;
                   cold start charged honestly either way;
- ``batcher``    — router-side batch former: groups patch-compatible
                   frontend requests into gangs under per-request
                   eligibility windows (admission slack) and a marginal-
                   patch step-cost budget, dispatched atomically to one
                   replica (the former picks *what* to batch, the dispatch
                   policy picks *where*);
- ``driver``     — the discrete-event loop interleaving all replicas on
                   one sim clock (tick order: form gangs, then dispatch);
                   owns drift-triggered repartitioning (recompute affinity
                   blocks when the resolution mix drifts, migrate replicas
                   drain-before-switch) and keeps the batch former's
                   compatibility blocks in sync;
- ``metrics``    — fleet + per-replica aggregation (SLO satisfaction,
                   goodput, utilization, patch-cache hit rates, queue and
                   repartition time series);
- ``trace``      — opt-in sim-clock event bus + per-request span tracer:
                   latency decomposition with a conservation invariant,
                   SLO-violation attribution, predictor calibration, and
                   JSONL / Chrome-trace exporters (zero-cost when off);
- ``monitor``    — opt-in streaming fleet health monitor over the trace
                   bus: sim-clock-windowed counters/gauges/histograms,
                   SLO error-budget burn-rate alerting (alerts carry the
                   dominant latency component), EWMA+CUSUM changepoint
                   detection, Prometheus / JSONL exporters (zero-cost
                   when off);
- ``simtools``   — patch-aware (optionally cache-aware) sim engine
                   factories plus steady / phased-drift / ramp workload
                   generators shared by tests, benchmarks and examples.

Quick start::

    from repro_torch.cluster import Cluster, ClusterConfig, sim_engine_factory
    from repro_torch.cluster.simtools import DEFAULT_RES, cluster_workload

    # device=None (the default) is the CUDA card
    cl = Cluster(sim_engine_factory(device="cpu"), DEFAULT_RES,
                 ClusterConfig(n_replicas=4, policy="least_slack"))
    fleet = cl.run(cluster_workload(qps=24.0, duration=30.0))
    print(fleet.summary())
"""
from repro_torch.cluster.autoscaler import (ArrivalForecaster, Autoscaler,
                                            AutoscalerConfig)
from repro_torch.cluster.batcher import BatchFormer, BatchFormerConfig
from repro_torch.cluster.cachetier import (CacheTier, CacheTierConfig, TierClient,
                                           latent_bytes)
from repro_torch.cluster.driver import (Cluster, ClusterConfig, Escalator,
                                        FailureConfig, RepartitionConfig)
from repro_torch.cluster.metrics import ClusterMetrics, ReplicaReport
from repro_torch.cluster.monitor import (AlertRule, FleetMonitor, MonitorConfig,
                                         WindowedHistogram, default_rules)
from repro_torch.cluster.replica import (MODEL_TIERS, CheckpointConfig, ModelTier,
                                         Replica, tier_ladder)
from repro_torch.cluster.router import (POLICIES, CacheAffinity,
                                        CacheAffinitySpread, Cascade,
                                        DispatchPolicy, JoinShortestQueue,
                                        LeastSlack, MixTracker,
                                        ResolutionAffinity,
                                        ResolutionAffinitySpread, RoundRobin,
                                        Router, ZoneSpread,
                                        allocate_replica_counts, make_policy,
                                        mix_drift, partition_resolutions,
                                        register_policy)
from repro_torch.cluster.trace import (COMPONENTS, NULL_TRACER, NullTracer,
                                       TraceConfig, Tracer)
from repro_torch.cluster.simtools import (BATCH_MIX, CACHE_TIER, CASCADE_MIX,
                                          DEFAULT_RES, FLASH_CROWD,
                                          PatchAwareLatency, Scenario,
                                          batch_cluster_kwargs,
                                          batch_former_config, batch_mix_workload,
                                          cachetier_config, cachetier_mean_mix,
                                          cachetier_workload, cascade_fleet_cost,
                                          cluster_workload, flash_crowd_workload,
                                          phased_workload,
                                          piecewise_rate_workload, ramp_workload,
                                          sim_engine_factory,
                                          standalone_latencies,
                                          warmboot_autoscaler,
                                          warmboot_cluster_kwargs,
                                          warmboot_tier_config)

__all__ = [
    "ArrivalForecaster", "Autoscaler", "AutoscalerConfig",
    "BatchFormer", "BatchFormerConfig", "BATCH_MIX",
    "batch_cluster_kwargs", "batch_former_config", "batch_mix_workload",
    "CacheTier", "CacheTierConfig", "TierClient", "latent_bytes",
    "CheckpointConfig", "Cluster", "ClusterConfig", "Escalator",
    "FailureConfig",
    "RepartitionConfig", "ClusterMetrics", "ReplicaReport", "Replica",
    "ModelTier", "MODEL_TIERS", "tier_ladder",
    "Router", "DispatchPolicy", "RoundRobin", "JoinShortestQueue",
    "LeastSlack", "ResolutionAffinity", "ResolutionAffinitySpread",
    "ZoneSpread", "CacheAffinity", "CacheAffinitySpread", "Cascade",
    "POLICIES", "register_policy",
    "make_policy", "MixTracker", "mix_drift", "partition_resolutions",
    "allocate_replica_counts", "DEFAULT_RES", "PatchAwareLatency",
    "Scenario", "CACHE_TIER", "CASCADE_MIX", "FLASH_CROWD",
    "cachetier_config", "cachetier_mean_mix", "cachetier_workload",
    "cascade_fleet_cost",
    "cluster_workload", "flash_crowd_workload", "phased_workload",
    "piecewise_rate_workload", "ramp_workload", "sim_engine_factory",
    "standalone_latencies", "warmboot_autoscaler", "warmboot_cluster_kwargs",
    "warmboot_tier_config",
    "COMPONENTS", "NULL_TRACER", "NullTracer", "TraceConfig", "Tracer",
    "AlertRule", "FleetMonitor", "MonitorConfig", "WindowedHistogram",
    "default_rules",
]
