"""Set-up and the open-loop drive of one cell: the program's engine, built
from a configuration file and a traffic file, driven through ``submit`` and
``tick`` on the host's ``perf_counter`` clock.

A run: set-up (kernel library, weights and inputs drawn on the card,
engine, the engine's own ``calibrate``); a lead-in of load as
long as the largest SLO budget; the window of ``seconds``, whose arrivals
are the counted ones; a drain, under load that keeps arriving, until every
counted request has completed, been dropped or passed its deadline. Every
``Request.arrival`` and ``Request.slo`` is the due time and deadline that
the traffic file fixes, on the same clock as the ``now`` handed to ``tick``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from gpubench import inputs, traffic as traffic_mod
from gpubench.trace import Tracer
from gpubench.traffic import Arrival


@dataclass
class Served:
    """One submitted request as the harness saw it (times on perf_counter)."""
    arrival: Arrival
    due: float                      # absolute due time
    submitted: float
    request: object                 # the program's Request
    done: Optional[float] = None    # host clock after the tick that completed it
    dropped: Optional[float] = None
    image: object = None            # the program's decoded image, once completed

    @property
    def deadline(self) -> float:
        return self.due + self.arrival.budget

    @property
    def latency(self) -> Optional[float]:
        return None if self.done is None else self.done - self.due

    @property
    def met(self) -> bool:
        return self.done is not None and self.done <= self.deadline


@dataclass
class TickRec:
    start: float
    end: float
    dt: float                       # the engine's own step time (0 when idle)
    pred: float                     # the engine's prediction for what it stepped
    stepped: List[Served]           # real requests advanced one step
    events: object                  # the tick's TickEvents: its spans and counters


@dataclass
class Run:
    """What one run saw; the metric readers take their numbers from it."""
    cell: str
    cfg: dict
    traffic: dict
    seconds: float
    seed: int
    setup_s: float
    t_open: float = 0.0
    t_end: float = 0.0              # when the drain ended
    served: List[Served] = field(default_factory=list)
    ticks: List[TickRec] = field(default_factory=list)
    profile: Optional[dict] = None
    lateness: List[float] = field(default_factory=list)
    arrivals: List[Arrival] = field(default_factory=list)

    @property
    def counted(self) -> List[Served]:
        return [s for s in self.served if s.arrival.counted]

    @property
    def window_ticks(self) -> List[TickRec]:
        """Ticks that stepped and started inside the window."""
        t1 = self.t_open + self.seconds
        return [t for t in self.ticks if t.stepped and self.t_open <= t.start < t1]


def diffusion_config(cfg: dict):
    """The program's ``DiffusionConfig`` from a configuration file's fields."""
    from repro_torch.models.diffusion import DiffusionConfig
    kw = {f.name: cfg[f.name] for f in dataclasses.fields(DiffusionConfig) if f.name in cfg}
    kw["attn_levels"] = tuple(kw.get("attn_levels", ()))
    return DiffusionConfig(**kw)


def build_engine(cfg: dict, traffic: dict, seed: int, device):
    """The program's engine of ``cfg`` on the traffic's resolutions, with the
    benchmark's weights; the standalone latencies start from the traffic
    file's ``base_s`` (``calibrate`` replaces them with its own)."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.serving import EngineConfig, PatchedServeEngine
    e = traffic["engine"]
    ecfg = EngineConfig(clock="real", use_cache=e["use_cache"],
                        scheduler=SchedulerConfig(policy=e["policy"],
                                                  max_batch_requests=e["max_batch_requests"],
                                                  max_batch_patches=e["max_batch_patches"]))
    res = traffic_mod.resolutions(traffic)
    base = {r: traffic["base_s"][traffic_mod.res_key(r)] for r in res}
    return PatchedServeEngine(diffusion_config(cfg), inputs.model_weights(cfg, seed, device), ecfg,
                              base, res, device=device,
                              vae_params=inputs.vae_weights(cfg, seed, device))


def make_request(a: Arrival, due: float, steps: int, ins: Dict[str, torch.Tensor]):
    """The program's ``Request`` of arrival ``a``: a copy of its latent, and
    each of its conditioning tensors as the keyword of the same name."""
    from repro_torch.core.requests import Request
    return Request(rid=a.index, resolution=a.res, arrival=due, slo=due + a.budget,
                   total_steps=steps, latent=ins["latent"].clone(), **inputs.conditioning(ins))


def set_up(cfg: dict, traffic: dict, seconds: float, seed: int, device) -> dict:
    """Everything before the load starts: engine, its calibration (whose
    probe steps warm the device) and every request's inputs. A step's first
    run at a new composition costs what later runs cost (PERF.md), so no
    other warm steps are taken. Returns the parts the drive needs."""
    from repro_torch.kernels import build
    if torch.device(device).type == "cuda":
        build.library()
    engine = build_engine(cfg, traffic, seed, device)
    steps = traffic["steps"]
    engine.calibrate(total_steps_hint=steps)
    arrivals = traffic_mod.schedule(traffic, seconds)
    reqs = inputs.request_inputs(cfg, [a.res for a in arrivals], seed, device)
    sync(device)
    return {"engine": engine, "arrivals": arrivals, "inputs": reqs}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive(engine, arrivals: List[Arrival], reqs: List[dict], run: Run,
          tracer: Optional[Tracer] = None) -> Run:
    """Offer the schedule's load on the real clock and tick the engine until
    every counted request is resolved; fills ``run``."""
    steps = run.traffic["steps"]
    lead = traffic_mod.lead_in_s(run.traffic)
    t_open = time.perf_counter() + lead
    run.t_open = t_open
    run.arrivals = arrivals
    t_close = t_open + run.seconds
    pending = list(arrivals)
    nxt = 0
    live: Dict[int, Served] = {}          # submitted, neither completed nor dropped
    by_index: Dict[int, Served] = {}
    counted_left = {a.index for a in arrivals if a.counted}
    hard_stop = t_close + lead + 5.0
    span = tracer.span if tracer is not None else lambda name: contextlib.nullcontext()
    while True:
        now = time.perf_counter()
        while nxt < len(pending) and t_open + pending[nxt].due <= now:
            a = pending[nxt]
            nxt += 1
            due = t_open + a.due
            req = make_request(a, due, steps, reqs[a.index])
            engine.submit(req)
            s = Served(a, due, time.perf_counter(), req)
            run.served.append(s)
            live[a.index] = by_index[a.index] = s
            run.lateness.append(s.submitted - due)
        for i in [i for i in counted_left if i in by_index and
                  (i not in live or now > by_index[i].deadline)]:
            counted_left.discard(i)
        if (now >= t_close and not counted_left) or now > hard_stop:
            break
        if tracer is not None:
            tracer.maybe_toggle(now)
        if not engine.has_work:
            wait = (t_open + pending[nxt].due - now) if nxt < len(pending) else 0.01
            with span("gpubench.idle"):
                time.sleep(max(min(wait, 0.05), 0.0))
            continue
        before = {i: s.request.steps_done for i, s in live.items()}
        t0 = time.perf_counter()
        with span("gpubench.tick"):
            ev = engine.tick(t0)
        t1 = time.perf_counter()
        stepped = [live[i] for i, n in before.items() if live[i].request.steps_done > n]
        pred = engine.scheduler.predict([s.request for s in stepped]) if stepped else 0.0
        run.ticks.append(TickRec(t0, t1, ev.dt, pred, stepped, ev))
        if tracer is not None:
            tracer.note_tick(bool(stepped), bool(engine.active))
        for r in ev.completed:
            live.pop(r.rid).done = t1
        for r in ev.dropped:
            live.pop(r.rid).dropped = t1
        if not (ev.stepped or ev.admitted or ev.dropped):
            time.sleep(0.001)
    run.t_end = time.perf_counter()
    if tracer is not None:
        tracer.stop()
    return run
