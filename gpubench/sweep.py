"""Measurements that fix a traffic file's numbers, made once on the card and
pasted into the file; no run of the benchmark reads them.

    python3 gpubench/sweep.py base --workload NAME [--repeats 3]
    python3 gpubench/sweep.py knee --workload NAME --rates 0.5,0.7,0.9 --seconds 40 --seeds 1,2
    python3 gpubench/sweep.py control --workload NAME --seeds 1,2,3 --seconds S

``base``: each resolution's standalone latency, one request alone through
the engine for the traffic's steps, warm, the median of ``repeats``; with
the reference's readings of those requests (``latent_err``) and of the
control (the reference in TF32). ``knee``: one engine, the cell's traffic at
each rate in turn for each of ``--seeds`` (lead-in, window, drain; arrivals
and inputs drawn from that seed), each rate's SLO attainment,
latency-over-budget p90, goodput, drops and backlog. ``control``: per seed, the
control's readings on the requests a run of that seed would check (the
window's requests of each resolution, as the run draws them, whether or not
the engine would complete them). One JSON line per measurement on stdout.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def base(entry, repeats: int, device="cuda") -> None:
    import torch
    from gpubench import cell, check, inputs, serve, traffic as tm
    cfg, traffic = entry["cfg"], entry["traffic"]
    cell.set_precision(cfg)
    engine = serve.build_engine(cfg, traffic, 0, device)
    engine.calibrate(total_steps_hint=traffic["steps"])
    res = tm.resolutions(traffic)
    arrivals = [tm.Arrival(i, 0.0, r, 1e9, "window") for i, r in enumerate(res)]
    ins = inputs.request_inputs(cfg, res, 0, device)
    out = {}
    for i, r in enumerate(res):
        times = []
        for rep in range(repeats + 1):
            req = serve.make_request(arrivals[i], 0.0, traffic["steps"], ins[i])
            serve.sync(device)
            t0 = time.perf_counter()
            engine.submit(req)
            while engine.has_work:
                engine.tick(time.perf_counter() - t0)
            times.append(time.perf_counter() - t0)
        served = {i: {"latent": req.latent, "image": engine.outputs[i]}}
        prog = check.reference_readings(cfg, traffic, 0, arrivals, [i], served, device)
        ctl = check.reference_readings(cfg, traffic, 0, arrivals, [i], served, device, tf32=True)
        out[tm.res_key(r)] = statistics.median(times[1:])
        emit({"res": tm.res_key(r), "base_s": out[tm.res_key(r)], "runs_s": times,
              "program": prog, "control": ctl})
    emit({"base_s": out, "card": cell.card_state(), "torch": torch.__version__})


def knee(entry, rates, seconds: float, seeds, device="cuda") -> None:
    import torch
    from gpubench import cell, inputs, reduce, serve, traffic as tm
    cfg, traffic = entry["cfg"], entry["traffic"]
    cell.set_precision(cfg)
    parts = serve.set_up(cfg, traffic, seconds, seeds[0], device)
    engine = parts["engine"]
    for seed, rate in [(s, r) for s in seeds for r in rates]:
        engine.wait.clear()
        engine.active.clear()
        engine.outputs.clear()
        arrivals = tm.schedule(traffic, seconds, rate=rate, arrival_seed=seed)
        ins = inputs.request_inputs(cfg, [a.res for a in arrivals], seed, device)
        run = serve.Run(entry["name"], cfg, {**traffic, "rate": rate}, seconds, seed, 0.0)
        with torch.no_grad():
            serve.drive(engine, arrivals, ins, run)
        counted = run.counted
        t_close = run.t_open + seconds
        backlog = [sum(1 for s in run.served if s.submitted <= t and
                       (s.done or 1e18) > t and (s.dropped or 1e18) > t)
                   for t in (run.t_open, run.t_open + seconds / 2, t_close)]
        ticks = run.window_ticks
        slow = sum(t.dt > 2 * t.pred for t in ticks)
        emit({"seed": seed, "rate": rate, "counted": len(counted), "met": sum(s.met for s in counted),
              "dropped": sum(s.dropped is not None for s in counted),
              "slo_attainment": reduce.attainment(run), "slo_ratio_p90": reduce.ratio_p90(run),
              "goodput": sum(s.met for s in counted) / seconds,
              "backlog_open_mid_close": backlog,
              "batch_mean": statistics.mean(len(t.stepped) for t in ticks) if ticks else 0,
              "step_ms_mean": 1e3 * statistics.mean(t.dt for t in ticks) if ticks else 0,
              "steps_over_twice_predicted": slow, "steps": len(ticks)})
    emit({"card": cell.card_state()})


def control(entry, seeds, seconds: float, device="cuda") -> None:
    from gpubench import cell, check, traffic as tm
    cfg, traffic = entry["cfg"], entry["traffic"]
    cell.set_precision(cfg)
    for seed in seeds:
        arrivals = tm.schedule(traffic, seconds)
        fake = [type("S", (), {"arrival": a, "done": 1.0}) for a in arrivals]
        run = type("R", (), {"seed": seed, "served": fake})
        picks = [s.arrival.index for s in check.draw_sample(run, traffic["check"]["per_resolution"])]
        t0 = time.perf_counter()
        got = check.reference_readings(cfg, traffic, seed, arrivals, picks, {}, device, tf32=True)
        emit({"seed": seed, "control": got, "requests": len(picks),
              "seconds": time.perf_counter() - t0})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("base", "knee", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args()
    from gpubench import manifest
    entry = manifest.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.what == "base":
        base(entry, args.repeats)
    elif args.what == "knee":
        knee(entry, [float(r) for r in args.rates.split(",")], args.seconds, seeds)
    else:
        control(entry, seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
