"""Cluster serving demo on the sim clock: one Poisson fleet workload through
every dispatch policy, an autoscaled run from a single replica, the
workload-adaptive layer (drift-triggered repartitioning on a mix flip,
predictive autoscaling on an arrival ramp), the elastic controller on an
up/down wave, crash-requeue and respawn under Poisson replica failures,
partial-progress checkpointing, correlated zone outages (zone-blind against
``zone_spread``), the fleet patch-cache tier, the warm-boot elastic fleet on
a flash crowd, router-side gang batching, the query-aware model cascade
and fleet tracing.

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_cluster --device cpu \\
        --only policies tracing --cut 5 --trace-dir build/cluster_trace

Each section is a function whose defaults are the demo's rates, durations
and seeds; it prints its lines and returns ``{arm: {"summary":
ClusterMetrics.summary(), ...}}``. ``cut`` keeps only the arrivals of the
workload's first ``cut`` seconds. The engines are synthetic (no tensors),
so ``device`` only holds the tiny model that they never run.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from pathlib import Path

from repro_torch.cluster import (AutoscalerConfig, CheckpointConfig, Cluster, ClusterConfig,
                                 FailureConfig, MonitorConfig, RepartitionConfig, TraceConfig,
                                 cachetier_config, cachetier_mean_mix, sim_engine_factory)
from repro_torch.cluster.simtools import (BATCH_MIX, CACHE_TIER, CASCADE_MIX, CRASH_FAULTS,
                                          DEFAULT_RES, FLASH_CROWD, UPDOWN_KNOTS, ZONE_FAULTS,
                                          cascade_fleet_cost, cluster_workload,
                                          phased_workload, piecewise_rate_workload,
                                          ramp_workload)
from repro_torch.core.latency_model import CacheHitModel

QPS, DURATION, SEED = 48.0, 30.0, 1
MIX = (0.2, 0.2, 0.6)              # skewed toward High resolution
MIX_A, MIX_B = (0.6, 0.3, 0.1), (0.1, 0.3, 0.6)
POLICIES = ("round_robin", "join_shortest_queue", "least_slack", "resolution_affinity")


def _cut(wl, cut):
    return wl if cut is None else [r for r in wl if r.arrival < cut]


def policies(qps=QPS, duration=DURATION, seed=SEED, mix=MIX, cut=None, device=None) -> dict:
    factory = sim_engine_factory(DEFAULT_RES, device=device)
    print(f"fleet workload: qps={qps} duration={duration}s mix={mix}")
    out = {}
    for policy in POLICIES:
        cl = Cluster(factory, DEFAULT_RES, ClusterConfig(n_replicas=3, policy=policy))
        t0 = time.time()
        m = cl.run(_cut(cluster_workload(qps=qps, duration=duration, seed=seed, mix=mix), cut))
        patches = [rep.patch for rep in m.per_replica.values()]
        print(f"{policy:22s} slo={m.slo_satisfaction:.3f} "
              f"goodput={m.goodput:6.2f} req/s util={m.utilization:.2f} "
              f"p95={m.latency_quantile(0.95):.3f}s "
              f"replica patches={patches} wall={time.time() - t0:.1f}s")
        out[policy] = {"summary": m.summary()}
    return out


def autoscaled(qps=QPS, duration=40.0, seed=SEED + 1, mix=MIX, cut=None, device=None) -> dict:
    print("\nautoscaling from 1 replica (cold start charged):")
    cl = Cluster(sim_engine_factory(DEFAULT_RES, device=device), DEFAULT_RES,
                 ClusterConfig(n_replicas=1, policy="join_shortest_queue",
                               autoscaler=AutoscalerConfig(max_replicas=6)))
    m = cl.run(_cut(cluster_workload(qps=qps, duration=duration, seed=seed, mix=mix), cut))
    stats = m.replica_count_stats()
    print(f"replicas min={stats['min']:.0f} max={stats['max']:.0f} "
          f"mean={stats['mean']:.2f} final={stats['final']:.0f} | "
          f"slo={m.slo_satisfaction:.3f} util={m.utilization:.2f}")
    actions = [(round(t, 1), a) for t, a in cl.autoscaler.actions]
    print("scaling actions (t, +1 up / -1 down):", actions)
    return {"jsq autoscaled": {"summary": m.summary(), "actions": actions}}


def drift(qps=128.0, phase_s=30.0, seed=SEED, cut=None, device=None) -> dict:
    print(f"\ndrifting mix (Low-heavy -> High-heavy at t={phase_s:.0f}s), cache-aware sim, "
          "partition provisioned for the opening mix:")
    factory = sim_engine_factory(DEFAULT_RES, cache=CacheHitModel(), device=device)
    out = {}
    for tag, rcfg in (("static affinity", None),
                      ("adaptive (drift-repartition)", RepartitionConfig())):
        cl = Cluster(factory, DEFAULT_RES,
                     ClusterConfig(n_replicas=4, policy="resolution_affinity",
                                   initial_mix=MIX_A, repartition=rcfg))
        m = cl.run(_cut(phased_workload([(phase_s, qps, MIX_A), (phase_s, qps, MIX_B)],
                                        seed=seed), cut))
        print(f"{tag:30s} slo={m.slo_satisfaction:.3f} goodput={m.goodput:6.1f} "
              f"cache_hit={m.cache_hit_rate:.3f} migrations={m.migrations} "
              f"repartitions={[e['t'] for e in m.repartitions]}")
        out[tag] = {"summary": m.summary()}
    return out


def ramp(qps0=8.0, qps1=140.0, duration=35.0, seed=SEED + 2, cut=None, device=None) -> dict:
    print(f"\narrival ramp ({qps0:.0f} -> {qps1:.0f} qps over {duration:.0f}s), reactive vs "
          "predictive autoscaler:")
    factory = sim_engine_factory(DEFAULT_RES, device=device)
    out = {}
    for tag, predictive in (("reactive", False), ("predictive", True)):
        cfg = AutoscalerConfig(min_replicas=2, max_replicas=8, cold_start=5.0,
                               cooldown=2.0, predictive=predictive, service_rate=24.0)
        cl = Cluster(factory, DEFAULT_RES,
                     ClusterConfig(n_replicas=2, policy="join_shortest_queue", autoscaler=cfg))
        m = cl.run(_cut(ramp_workload(qps0, qps1, duration, seed=seed), cut))
        spawns = [round(t, 1) for t, a in cl.autoscaler.actions if a > 0]
        pre = [round(t, 1) for t in cl.autoscaler.predictive_spawns]
        print(f"{tag:10s} slo={m.slo_satisfaction:.3f} "
              f"p95={m.latency_quantile(0.95):.3f}s spawns={spawns} pre-spawns={pre}")
        out[tag] = {"summary": m.summary(), "spawns": spawns, "pre_spawns": pre}
    return out


def updown(knots=tuple(UPDOWN_KNOTS), seed=SEED + 2, cut=None, device=None) -> dict:
    print("\nup/down arrival wave (8 -> 140 -> 6 qps), frozen baseline vs elastic controller\n"
          "(predictive retirement + resize-triggered repartitioning), resolution_affinity:")
    factory = sim_engine_factory(DEFAULT_RES, device=device)
    base = AutoscalerConfig(min_replicas=2, max_replicas=8, cold_start=5.0,
                            cooldown=2.0, service_rate=24.0)
    out = {}
    for tag, asc, rcfg in (
            ("frozen baseline", base, None),
            ("elastic controller", replace(base, predictive=True, predictive_down=True),
             RepartitionConfig(cooldown=3.0, switch_cost=0.5))):
        cl = Cluster(factory, DEFAULT_RES,
                     ClusterConfig(n_replicas=2, policy="resolution_affinity",
                                   autoscaler=asc, repartition=rcfg))
        m = cl.run(_cut(piecewise_rate_workload(list(knots), seed=seed), cut))
        stats = m.replica_count_stats()
        retires = [round(t, 1) for t in cl.autoscaler.predictive_retirements]
        print(f"{tag:20s} slo={m.slo_satisfaction:.3f} "
              f"p95={m.latency_quantile(0.95):.3f}s "
              f"final-fleet={stats['final']:.0f} early-retires={retires} "
              f"resize-repartitions="
              f"{len([e for e in m.repartitions if e['reason'] == 'resize'])}")
        out[tag] = {"summary": m.summary(), "early_retires": retires}
    return out


def crashes(qps=56.0, duration=40.0, mtbf=25.0, seed=SEED + 4, cut=None, device=None) -> dict:
    print(f"\nPoisson replica crashes (mtbf={mtbf:.0f}s/replica) at constant {qps:.0f} qps, "
          "with and without recovery:")
    factory = sim_engine_factory(DEFAULT_RES, device=device)
    out = {}
    for tag, recover in (("no recovery", False), ("crash-requeue + respawn", True)):
        cl = Cluster(factory, DEFAULT_RES,
                     ClusterConfig(n_replicas=4, policy="join_shortest_queue",
                                   failures=FailureConfig(mtbf=mtbf, recover=recover,
                                                          seed=seed)))
        m = cl.run(_cut(cluster_workload(qps=qps, duration=duration, seed=seed), cut))
        delay = (sum(m.requeue_delays) / len(m.requeue_delays) if m.requeue_delays else 0.0)
        print(f"{tag:24s} slo={m.slo_satisfaction:.3f} "
              f"crashed={m.replicas_failed} respawned={m.recoveries} "
              f"requeued={m.requests_requeued} requeue-delay-mean={delay:.3f}s")
        out[tag] = {"summary": m.summary()}
    return out


def checkpointing(sc=CRASH_FAULTS, seed=SEED + 6, cut=None, device=None) -> dict:
    print(f"\npartial-progress checkpointing ({sc['steps']}-step requests, "
          f"mtbf={sc['mtbf']}s/replica): crash orphans restart from step 0 vs "
          "resume from the last snapshot:")
    factory = sim_engine_factory(DEFAULT_RES, steps=sc["steps"], device=device)
    out = {}
    for tag, ckpt in (("restart from zero", None), ("checkpointed resume", CheckpointConfig())):
        cl = Cluster(factory, DEFAULT_RES,
                     ClusterConfig(n_replicas=sc["n_replicas"], policy="join_shortest_queue",
                                   failures=FailureConfig(mtbf=sc["mtbf"], recover=True,
                                                          cold_start=sc["cold_start"],
                                                          seed=seed),
                                   checkpoint=ckpt))
        m = cl.run(_cut(cluster_workload(qps=sc["qps"], duration=sc["duration"],
                                         steps=sc["steps"], slo_scale=sc["slo_scale"],
                                         seed=seed), cut))
        print(f"{tag:20s} slo={m.slo_satisfaction:.3f} "
              f"crashed={m.replicas_failed} requeued={m.requests_requeued} "
              f"steps-resumed={m.steps_resumed} "
              f"snapshot-overhead={m.checkpoint_time:.2f}s")
        out[tag] = {"summary": m.summary()}
    return out


def zones(sc=ZONE_FAULTS, seed=SEED + 6, cut=None, device=None) -> dict:
    print(f"\ncorrelated zone outages ({sc['zones']} zones, "
          f"mtbf={sc['zone_mtbf']}s/zone, downtime={sc['zone_downtime']}s) at "
          f"{sc['qps']} qps — zone-blind vs zone_spread dispatch:")
    factory = sim_engine_factory(DEFAULT_RES, device=device)
    out = {}
    for tag, pol in (("zone-blind (jsq)", "join_shortest_queue"), ("zone_spread", "zone_spread")):
        cl = Cluster(factory, DEFAULT_RES,
                     ClusterConfig(n_replicas=sc["n_replicas"], policy=pol,
                                   failures=FailureConfig(
                                       mtbf=None, recover=True, cold_start=sc["cold_start"],
                                       zones=sc["zones"], zone_mtbf=sc["zone_mtbf"],
                                       zone_downtime=sc["zone_downtime"], seed=seed)))
        m = cl.run(_cut(cluster_workload(qps=sc["qps"], duration=sc["duration"], seed=seed),
                        cut))
        avail = {z: f"{a:.2f}" for z, a in sorted(m.zone_availability.items())}
        print(f"{tag:18s} slo={m.slo_satisfaction:.3f} "
              f"outages={len(m.zone_outages)} killed={m.replicas_failed} "
              f"zone-availability={avail}")
        out[tag] = {"summary": m.summary()}
    return out


def cache_tier(sc=CACHE_TIER, seed=SEED + 6, cut=None, device=None) -> dict:
    print(f"\nfleet patch-cache tier on the repeat-heavy hybrid workload "
          f"(dominant resolution flips each {sc['phases'][0][0]:.0f}s phase); "
          "every run prices the same per-replica L1 warmth dynamics:")
    factory = sim_engine_factory(DEFAULT_RES, steps=sc["steps"], cache=CacheHitModel(),
                                 device=device)
    out = {}
    for tag, pol, cap, mix0 in (
            ("least_slack (no tier)", "least_slack", 0, None),
            ("resolution_affinity (no tier)", "resolution_affinity", 0, cachetier_mean_mix()),
            ("cache_affinity (no tier)", "cache_affinity", 0, None),
            ("cache_affinity + tier", "cache_affinity", None, None)):
        cl = Cluster(factory, DEFAULT_RES,
                     ClusterConfig(n_replicas=sc["n_replicas"], policy=pol, initial_mix=mix0,
                                   cache_tier=cachetier_config(cap)))
        m = cl.run(_cut(sc.workload(seed=seed), cut))
        s = m.summary()
        ct = s["cache_tier"]
        print(f"{tag:30s} slo={m.slo_satisfaction:.3f} "
              f"goodput={m.goodput:6.1f} l1-hit={ct['l1_hit_rate']:.3f} "
              f"l2-hit={ct['l2_hit_rate']:.3f} "
              f"tier-bytes={ct['tier']['bytes_peak']} "
              f"evictions={ct['tier']['evictions']}")
        out[tag] = {"summary": s}
    return out


def warm_boot(sc=FLASH_CROWD, seed=SEED, cut=None, device=None) -> dict:
    print(f"\nwarm-boot elastic fleet on the flash-crowd spike "
          f"({sc['knots'][1][1]:.0f} -> {sc['knots'][2][1]:.0f} qps at "
          f"t={sc['knots'][1][0]:.0f}s, cold_start={sc['cold_start']}s): cold "
          "spawns vs tier-warmed spawns (prefetch overlapped with boot, "
          "autoscaler prices the shorter effective cold start):")
    out = {}
    for tag, arm in (("cold elastic (no tier)", "cold"),
                     ("tier, no spawn prefetch", "noprefetch"),
                     ("warm-boot elastic", "warm")):
        kw = sc.cluster_kwargs(arm)
        factory = sim_engine_factory(DEFAULT_RES, steps=kw.pop("steps"),
                                     cache=CacheHitModel() if kw.pop("cache") else None,
                                     device=device)
        cl = Cluster(factory, DEFAULT_RES, ClusterConfig(**kw))
        m = cl.run(_cut(sc.workload(seed=seed), cut))
        s = m.summary()
        tier = s["cache_tier"].get("tier", {})
        spawns = len([a for _, a in cl.autoscaler.actions if a > 0])
        print(f"{tag:26s} slo={m.slo_satisfaction:.3f} "
              f"p95={m.latency_quantile(0.95):.3f}s spawns={spawns} "
              f"prefetches={tier.get('prefetches', 0)} "
              f"l2-writes={tier.get('writes', 0)} "
              f"warm-priced={cl.autoscaler.warm_boot}")
        out[tag] = {"summary": s, "spawns": spawns}
    return out


def batching(sc=BATCH_MIX, seed=SEED, cut=None, device=None) -> dict:
    print(f"\nrouter-side gang batching at {sc['qps']:.0f} qps on {sc['n_replicas']} replicas "
          "(per-request dispatch vs the batch former without and with its wait):")
    out = {}
    for arm in sc.arms:
        kw = sc.cluster_kwargs(arm)
        factory = sim_engine_factory(DEFAULT_RES, steps=kw.pop("steps"),
                                     cache=CacheHitModel() if kw.pop("cache") else None,
                                     device=device)
        cl = Cluster(factory, DEFAULT_RES, ClusterConfig(**kw))
        m = cl.run(_cut(sc.workload(seed=seed), cut))
        s = m.summary()
        b = s.get("batching", {})
        print(f"{arm:12s} slo={m.slo_satisfaction:.3f} "
              f"p95={m.latency_quantile(0.95):.3f}s util={m.utilization:.2f} "
              f"hit={m.cache_hit_rate:.3f} gangs={b.get('gangs', 0)} "
              f"mean_gang={b.get('mean_gang_size', 0.0):.2f} holds={b.get('holds', 0)}")
        out[arm] = {"summary": s}
    return out


def cascade(sc=CASCADE_MIX, seed=SEED, cut=None, device=None) -> dict:
    fleets = {"cascade": sc["tiers"], **sc["homogeneous"]}
    print(f"\nquery-aware model cascade at {sc['qps']:.0f} qps (difficulty mix "
          f"{[f'{p:.0%}@{d}' for d, p in sc['difficulties']]}): heterogeneous "
          "tiered fleet + confidence-gated escalation vs homogeneous fleets, "
          "all at equal tier-weighted GPU cost; quality-slo counts a request "
          "only if it met its deadline AND its difficulty:")
    factory = sim_engine_factory(DEFAULT_RES, steps=sc["steps"], device=device)
    out = {}
    for tag, arm in (("always lite (cheap)", "always_cheap"),
                     ("always base", "always_base"),
                     ("always max (big)", "always_big"),
                     ("cascade + escalation", "cascade")):
        kw = sc.cluster_kwargs(arm)
        kw.pop("steps")
        cl = Cluster(factory, DEFAULT_RES, ClusterConfig(**kw))
        m = cl.run(_cut(sc.workload(seed=seed), cut))
        s = m.summary()
        c = s["cascade"]
        per_tier = {t: p["completed"] for t, p in c["per_tier"].items()}
        print(f"{tag:22s} quality-slo={s['slo_quality_attainment']:.3f} "
              f"slo={m.slo_satisfaction:.3f} "
              f"cost={cascade_fleet_cost(fleets[arm]):.1f} "
              f"esc={c['escalations']} give-ups={c['give_ups']} "
              f"per-tier-completed={per_tier}")
        out[tag] = {"summary": s}
    return out


def tracing(qps=60.0, duration=12.0, seed=SEED + 8, cut=None, device=None,
            trace_dir=None) -> dict:
    """With ``trace_dir`` the fleet also runs the health monitor, and the
    tracer's and the monitor's JSONL go to ``trace.jsonl`` and
    ``monitor.jsonl`` there (``scripts/trace_report.py`` and
    ``scripts/fleet_dashboard.py`` read them)."""
    print("\nfleet tracing on a crashy checkpointed regime (per-request "
          "latency decomposition; components sum to end-to-end latency):")
    cl = Cluster(sim_engine_factory(DEFAULT_RES, device=device), DEFAULT_RES,
                 ClusterConfig(n_replicas=3, policy="least_slack",
                               failures=FailureConfig(mtbf=10.0, recover=True, seed=seed),
                               checkpoint=CheckpointConfig(), trace=TraceConfig(),
                               monitor=MonitorConfig() if trace_dir else None))
    m = cl.run(_cut(cluster_workload(qps=qps, duration=duration, seed=seed), cut))
    att, pred = m.attribution, m.predictor
    print(f"requests={att['requests']} ok={att['completed_ok']} "
          f"missed={att['missed']} dropped={att['dropped']}")
    for comp, cnt in att["dominant"].items():
        print(f"  violations dominated by {comp:16s} {cnt}")
    print(f"dispatch predictor: n={pred['n']} mae={pred['mae']:.4f}s "
          f"bias={pred['bias']:+.4f}s drift={pred['drift']}")
    worst = max(cl.tracer.finished, key=lambda s: s.end - s.arrival)
    print(f"slowest request {worst.rid}: latency="
          f"{worst.end - worst.arrival:.3f}s requeues={worst.requeues} -> "
          + " ".join(f"{k}={v:.3f}" for k, v in worst.comp.items() if v > 0))
    if trace_dir:
        d = Path(trace_dir)
        d.mkdir(parents=True, exist_ok=True)
        cl.tracer.write_jsonl(d / "trace.jsonl")
        cl.monitor.write_jsonl(d / "monitor.jsonl")
        print(f"trace and health log -> {d / 'trace.jsonl'}, {d / 'monitor.jsonl'}")
    return {"least_slack traced": {"summary": m.summary(), "slowest": worst.rid}}


SECTIONS = {"policies": policies, "autoscaled": autoscaled, "drift": drift, "ramp": ramp,
            "updown": updown, "crashes": crashes, "checkpointing": checkpointing,
            "zones": zones, "cache_tier": cache_tier, "warm_boot": warm_boot,
            "batching": batching, "cascade": cascade, "tracing": tracing}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(SECTIONS), default=list(SECTIONS))
    ap.add_argument("--cut", type=float, default=None,
                    help="keep only each workload's first CUT seconds of arrivals")
    ap.add_argument("--trace-dir", default=None,
                    help="write the tracing section's trace and health log here")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)
    out = {}
    for name in args.only:
        kw = {"trace_dir": args.trace_dir} if name == "tracing" else {}
        out[name] = SECTIONS[name](cut=args.cut, device=args.device, **kw)
    return out


if __name__ == "__main__":
    main()
