"""PatchedServe engine — request lifecycle, 3 stages, patch batching, cache,
SLO scheduling (paper Fig. 2).

Two clocks:
- ``real``: executes the diffusion model per step on the engine's device
  (the CUDA card by default) and measures wall time, synchronising the
  device before every clock read so a step's time is its execution, not its
  enqueue;
- ``sim``: virtual clock driven by a latency surrogate. With
  ``sim_synthetic`` requests carry no tensors and a step is pure accounting;
  without it the engine runs the same model step on its device as the real
  clock does, and charges the surrogate's time for it.

Per engine iteration (continuous batching at step granularity, no
preemption):
  1. move arrivals into the wait queue; run Algorithm 1 to admit;
  2. Preparation for newly admitted (noise init + prompt-embedding stub);
  3. build the CSP batch from every active request's current latent
     (patch = GCD of active resolutions), run ONE denoising step for all —
     requests at different step indices batch together (Fig. 1);
  4. patch-level cache reuse around every block (optional);
  5. finished requests -> Postprocessing (VAE decode stub), record SLO;
  6. straggler mitigation: if a step ran > straggler_factor x predicted,
     re-estimate active requests and drop newly-hopeless ones.

The engine is **steppable**: an external caller (a cluster layer) owns the
clock and interleaves many engines by calling ``submit(req)`` and
``tick(now)`` — one engine iteration that returns a ``TickEvents`` record —
while ``run()`` is a thin single-engine wrapper around the same loop.

Each tick records its host phases as ``Span``s on ``TickEvents.spans``, in
order: ``tick.schedule`` (Algorithm 1 and the drop and admit bookkeeping),
``tick.prepare`` (the admitted requests' noise and text), ``tick.predict``
(the step prediction, composition and locality features, the synchronise
before the step), ``tick.split`` (bucket padding, ``split``, the step-index
and text gathers), ``tick.step`` (``sampler_step``: the host's enqueue of the
model step), ``tick.merge`` (``merge_by_request``, the latent writes),
``tick.sync`` (the synchronise after the step) and ``tick.complete`` (the
straggler rule and the completions), which holds one ``tick.decode`` per
completed request (its ``rid``: postprocess, decode, copy to the host). An
idle tick records ``tick.schedule`` only. The spans are on ``span_clock``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core.cache_predictor import ThresholdPredictor
from repro_torch.core.csp import gcd_patch_size
from repro_torch.core.latency_model import (analytic_step_latency, make_features,
                                            resolution_concentration)
from repro_torch.core.patching import merge_by_request, split
from repro_torch.core.requests import Request
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.device import resolve_device
from repro_torch.models import diffusion as dm
from repro_torch.models import sampler as sampler_mod
from repro_torch.models import vae as vae_mod
from repro_torch.models.layers import tree_to


#: The clock of the engine's spans: the wall clock in ns, which is the time
#: base of torch.profiler's device trace, so that a host phase and the device
#: activity under it line up. ``TickEvents.now`` and ``dt`` stay on the
#: caller's clock.
span_clock = time.time_ns


class Span(NamedTuple):
    """One host phase of a tick, from ``start_ns`` to ``end_ns`` on
    ``span_clock``; ``rid`` is the request a per-request phase
    (``tick.decode``) belongs to."""
    name: str
    start_ns: int
    end_ns: int
    rid: Optional[int] = None


def _close(spans: List[Span], name: str, start_ns: int) -> int:
    """Record the phase ``name``, begun at ``start_ns``, as ending now;
    returns its end, where the next phase begins."""
    end = span_clock()
    spans.append(Span(name, start_ns, end))
    return end


@dataclass
class EngineConfig:
    clock: str = "real"                 # real | sim
    use_cache: bool = False
    cache_tau: float = 5e-3
    cache_capacity: int = 8192
    patch_cap: int = 0                  # 0 = pure GCD (paper default)
    straggler_factor: float = 3.0
    # sim-clock only: skip latent/text allocation, the model step, patch
    # split/merge and VAE decode entirely — requests carry no tensors and a
    # step just advances steps_done. Makes large cluster sweeps cheap;
    # latency accounting is identical (the predictor only sees batch
    # compositions).
    sim_synthetic: bool = False
    # Composition bucketing: per-resolution counts are padded up to this
    # ladder with dummy requests, as the reference does to bound its compiled
    # shapes; the port keeps it so both engines run the same batches. The
    # padding overhead is charged to the latency predictor.
    bucket_ladder: Tuple[int, ...] = (0, 1, 2, 4, 6, 8, 12)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    seed: int = 0


@dataclass
class Metrics:
    completed: int = 0
    dropped: int = 0
    slo_met: int = 0
    latencies: List[float] = field(default_factory=list)
    step_latencies: List[float] = field(default_factory=list)
    compute_savings: List[float] = field(default_factory=list)
    # per-step (resolution concentration, step fraction, cache hit rate)
    # triples — the calibration feed for fit_cache_hit_model
    cache_samples: List[Tuple[float, float, float]] = field(
        default_factory=list)
    span: float = 0.0

    @property
    def slo_satisfaction(self) -> float:
        total = self.completed + self.dropped
        return self.slo_met / total if total else 1.0

    @property
    def goodput(self) -> float:
        return self.slo_met / self.span if self.span else 0.0


@dataclass
class TickEvents:
    """What one engine iteration did — the steppable-API return value."""
    now: float                                   # clock at tick start
    admitted: List[Request] = field(default_factory=list)
    dropped: List[Request] = field(default_factory=list)
    completed: List[Request] = field(default_factory=list)
    dt: float = 0.0                              # step duration (0 if idle)
    stepped: bool = False
    spans: List[Span] = field(default_factory=list)   # host phases, in start order

    @property
    def end(self) -> float:
        return self.now + self.dt


class PatchedServeEngine:
    """``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU. ``vae_params`` replaces the VAE params the
    engine would otherwise draw from seed 7."""

    def __init__(self, model_cfg: dm.DiffusionConfig, params,
                 engine_cfg: EngineConfig,
                 standalone_latency: Dict[Tuple[int, int], float],
                 resolutions: Sequence[Tuple[int, int]],
                 device=None, vae_params=None):
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.params = tree_to(params, self.device)
        self.cfg = engine_cfg
        self.resolutions = [tuple(r) for r in resolutions]
        self.sa = standalone_latency
        base_patch = gcd_patch_size(self.resolutions, cap=engine_cfg.patch_cap)
        self.patch = base_patch
        self.patches_per_res = [
            (h // base_patch) * (w // base_patch) for h, w in self.resolutions]
        self.scheduler = Scheduler(engine_cfg.scheduler, base_patch,
                                   standalone_latency,
                                   self._predict_step_latency)
        self.vae = (tree_to(vae_params, self.device) if vae_params is not None
                    else vae_mod.init_vae(torch.Generator().manual_seed(7),
                                          model_cfg.latent_channels, device=self.device))
        self.rng = np.random.default_rng(engine_cfg.seed)
        self.caches: Dict[str, cache_mod.PatchCache] = {}
        self.predictor = ThresholdPredictor(engine_cfg.cache_tau)
        self._uid_base: Dict[int, int] = {}   # rid -> uid namespace
        self.outputs: Dict[int, np.ndarray] = {}
        # steppable state (owned here so an external caller can interleave
        # many engines; run() resets metrics but keeps the shape caches)
        self.wait: List[Request] = []
        self.active: List[Request] = []
        self.metrics = Metrics()
        self._seen_shapes: set = set()

    def _sync(self) -> None:
        """Wait for the device, so that a host clock read after it measures
        the work and not its enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- latency prediction ----------------

    def _counts(self, reqs: List[Request]) -> List[int]:
        return [sum(1 for r in reqs if r.resolution == res)
                for res in self.resolutions]

    def _bucket(self, n: int) -> int:
        for b in self.cfg.bucket_ladder:
            if n <= b:
                return b
        return n

    def _predict_step_latency(self, reqs: List[Request]) -> float:
        if not reqs:
            return 0.0
        # predict for the *bucketed* composition — what actually executes
        counts = [self._bucket(c) for c in self._counts(reqs)]
        lm = getattr(self, "latency_model", None)
        if lm is not None:
            if hasattr(lm, "predict_batch"):
                # cache-aware surrogates also need the requests' step state
                # (reuse probability grows as denoising converges)
                return max(lm.predict_batch(counts, reqs), 1e-5)
            return max(lm.predict(
                make_features(counts, self.patches_per_res)), 1e-5)
        return analytic_step_latency(counts, self.patches_per_res)

    # ---------------- calibration (paper §6.1 Throughput Analyzer) ----------

    def calibrate(self, steps_per_probe: int = 2,
                  combos: Optional[List[List[int]]] = None,
                  total_steps_hint: int = 50) -> Dict:
        """Measure real step latencies for probe compositions, fit a linear
        latency model (lat ~ a + b*patches + c*distinct + per-res terms), warm
        the device (first-call allocations, kernel loads), and set standalone
        latencies. Returns the fit info."""
        if combos is None:
            eye = [[1 if i == j else 0 for j in range(len(self.resolutions))]
                   for i in range(len(self.resolutions))]
            combos = eye + [[1] * len(self.resolutions)] \
                + [[2 if i == j else 0 for j in range(len(self.resolutions))]
                   for i in range(len(self.resolutions))]
        feats, lats = [], []
        for counts in combos:
            reqs = []
            rid = 10_000_000
            for res, c in zip(self.resolutions, counts):
                for _ in range(c):
                    r = Request(rid=rid, resolution=res, arrival=0.0,
                                slo=1e9, total_steps=steps_per_probe)
                    self._prepare(r)
                    reqs.append(r)
                    rid += 1
            if not reqs:
                continue
            lat = None
            for s in range(steps_per_probe):
                self._sync()
                t0 = time.perf_counter()
                self._denoise_step(reqs)
                self._sync()
                lat = time.perf_counter() - t0   # keep last (warm) step
            feats.append(np.concatenate([
                np.asarray(counts, np.float64),
                [float(np.sum(np.asarray(counts) > 0)),
                 float(np.sum(np.asarray(counts) * self.patches_per_res))]]))
            lats.append(lat)
        X = np.stack(feats)
        X1 = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        y = np.asarray(lats)
        coef, *_ = np.linalg.lstsq(X1, y, rcond=None)
        self._lin_coef = coef

        class _Lin:
            def __init__(self, coef):
                self.coef = coef

            def predict(self, f):
                f1 = np.concatenate([np.asarray(f, np.float64), [1.0]])
                return float(np.maximum(f1 @ self.coef, 1e-5))

        self.latency_model = _Lin(coef)
        # standalone FULL-request latency per resolution (slack normalizer)
        for i, res in enumerate(self.resolutions):
            f = make_features([1 if j == i else 0
                               for j in range(len(self.resolutions))],
                              self.patches_per_res)
            self.sa[res] = self.latency_model.predict(f) * total_steps_hint
        return {"coef": coef, "probe_latencies": lats}

    # ---------------- stages ----------------

    def _prepare(self, req: Request) -> None:
        self._uid_base[req.rid] = req.rid * (1 << 20)
        if self.cfg.clock == "sim" and self.cfg.sim_synthetic:
            return
        if req.latent is None:
            # fresh request; a checkpoint-resumed one arrives with its
            # snapshotted latent and must NOT be re-noised — it continues
            # mid-denoise from the restored state
            h, w = req.resolution
            req.latent = torch.as_tensor(
                self.rng.normal(size=(h, w, self.mcfg.latent_channels)),
                dtype=torch.float32, device=self.device)
        if req.text is None:
            req.text = vae_mod.encode_prompt(req.prompt, self.mcfg.n_text,
                                             self.mcfg.d_text, device=self.device)

    def _postprocess(self, req: Request) -> None:
        if self.cfg.clock == "sim" and self.cfg.sim_synthetic:
            return
        img = vae_mod.vae_decode(self.vae, req.latent[None])[0]
        self.outputs[req.rid] = img.cpu().numpy()

    # ---------------- cache plumbing ----------------

    def _block_hook(self, csp, step_frac):
        """Patch-level cache reuse (paper Fig. 10) wired around each block."""
        # uid = request namespace + patch grid position: stable across engine
        # iterations regardless of batch composition
        uids_per_patch = np.array(
            [self._uid_base[int(csp.req_ids[csp.patch_req[j]])]
             + int(csp.patch_rc[j, 0]) * 4096 + int(csp.patch_rc[j, 1])
             for j in range(csp.total)], np.int64)
        savings = []

        def hook(name, kind, fn, x):
            key = f"{name}:{tuple(x.shape[1:])}"
            c = self.caches.get(key)
            if c is None:
                c = cache_mod.PatchCache(self.cfg.cache_capacity)
                self.caches[key] = c
            sync = c.sync(uids_per_patch.tolist())
            mask_t = c.reuse_mask(x, sync, self.predictor)
            mask = mask_t.cpu().numpy()
            if mask.all():
                y = c.cached_outputs(sync)
            else:
                if mask.any():
                    # context blocks: fill masked inputs with the cached
                    # inputs from the previous step (paper §5.1), run dense,
                    # then restore cached outputs for masked patches.
                    x_in = torch.where(
                        mask_t.reshape((-1,) + (1,) * (x.dim() - 1)),
                        c.cached_inputs(sync).to(x.dtype), x)
                else:
                    x_in = x
                y_full = fn(x_in)
                if mask.any():
                    y = torch.where(
                        mask_t.reshape((-1,) + (1,) * (y_full.dim() - 1)),
                        c.cached_outputs(sync).to(y_full.dtype), y_full)
                else:
                    y = y_full
            c.update(sync, x, y, ~mask_t)
            savings.append(float(mask.mean()))
            return y

        return hook, savings

    # ---------------- steppable API ----------------

    def submit(self, req: Request) -> None:
        """Enqueue an arrived request; it is considered by Algorithm 1 on the
        next ``tick``."""
        self.wait.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.wait or self.active)

    @property
    def queue_depth(self) -> int:
        return len(self.wait) + len(self.active)

    def backlog_estimate(self) -> float:
        """Predicted seconds until this engine drains everything it holds,
        assuming all of it batches together (upper-bounds composition; the
        router only needs a comparable load signal, not an exact forecast)."""
        reqs = self.active + self.wait
        if not reqs:
            return 0.0
        step = self._predict_step_latency(reqs)
        return step * max(r.remaining_steps for r in reqs)

    def reset_metrics(self) -> None:
        """Fresh Metrics; keeps the shape caches so warm engines stay
        warm across runs."""
        self.metrics = Metrics()

    def tick(self, now: float) -> TickEvents:
        """One engine iteration at clock time ``now``: admit via Algorithm 1,
        run one denoising step for the active batch, retire completions.
        The caller owns the clock and should advance it by ``events.dt``."""
        ev = TickEvents(now=now)
        m = self.metrics
        spans = ev.spans
        tick_ns = span_clock()

        admitted, dropped = self.scheduler.schedule(self.wait, self.active, now)
        for r in dropped:
            self.wait.remove(r)
            r.state = "dropped"
            m.dropped += 1
            ev.dropped.append(r)
        for r in admitted:
            self.wait.remove(r)
            r.state = "active"
            r.admitted = now
            self.active.append(r)
            ev.admitted.append(r)
        t = _close(spans, "tick.schedule", tick_ns)
        if not self.active:
            return ev
        for r in admitted:
            self._prepare(r)
        t = _close(spans, "tick.prepare", t)

        # one denoising step for the whole mixed-resolution batch
        step_pred = self._predict_step_latency(self.active)
        comp = tuple(self._bucket(c) for c in self._counts(self.active))
        is_cold = comp not in self._seen_shapes
        self._seen_shapes.add(comp)
        # batch locality features, captured before steps_done advances —
        # consumed by the real-path cache calibrator and the cache-aware sim
        # surrogate's hit-rate metric; skipped when neither is active.
        # A surrogate advertises cache-awareness by exposing a truthy
        # ``cache`` attribute alongside ``modeled_hit_rate``.
        lm = getattr(self, "latency_model", None)
        mh = getattr(lm, "modeled_hit_rate", None) \
            if self.cfg.clock == "sim" and getattr(lm, "cache", None) \
            is not None else None
        conc = step_frac = 0.0
        if mh is not None or (self.cfg.use_cache and self.cfg.clock == "real"):
            # concentration of the *bucketed* composition (what executes,
            # dummy padding included) — matches what a cache-aware
            # surrogate's predict_batch prices, so the reported hit rate
            # agrees with the one that shaped the latency
            conc = resolution_concentration(comp, self.patches_per_res)
            step_frac = float(np.mean([r.steps_done / max(r.total_steps, 1)
                                       for r in self.active]))
        self._sync()
        _close(spans, "tick.predict", t)
        t0 = time.perf_counter()
        savings = self._denoise_step(self.active, spans)
        self._sync()
        step_real = time.perf_counter() - t0
        t = _close(spans, "tick.sync", spans[-1].end_ns)
        if savings:
            # measured tensor-path reuse: also feed the hit-model calibrator
            m.compute_savings.append(float(np.mean(savings)))
            m.cache_samples.append((conc, step_frac, float(np.mean(savings))))
        elif mh is not None:
            # sim clock: a cache-aware surrogate reports its *modeled* hit
            # rate so fleet metrics can aggregate locality per replica
            m.compute_savings.append(mh(conc, step_frac))

        ev.dt = step_real if self.cfg.clock == "real" else step_pred
        ev.stepped = True
        m.step_latencies.append(ev.dt)
        end = ev.end

        # straggler mitigation: a step far over prediction triggers
        # re-estimation; newly hopeless actives are dropped at once.
        # Cold (first-seen) compositions are exempt.
        if (self.cfg.clock == "real" and not is_cold
                and step_real > self.cfg.straggler_factor * max(step_pred, 1e-9)):
            for r in list(self.active):
                if end + step_real * r.remaining_steps > r.slo:
                    self.active.remove(r)
                    r.state = "dropped"
                    m.dropped += 1
                    ev.dropped.append(r)

        # completions: on the real clock a request finishes on the caller's
        # clock once its decode is on the host; the sim clock at the step end
        complete_at = len(spans)
        for r in list(self.active):
            if r.steps_done >= r.total_steps:
                self.active.remove(r)
                d0 = span_clock()
                self._postprocess(r)
                r.decode_span = Span("tick.decode", d0, span_clock(), r.rid)
                spans.append(r.decode_span)
                r.state = "done"
                r.finish = (now + (r.decode_span.end_ns - tick_ns) * 1e-9
                            if self.cfg.clock == "real" else end)
                m.completed += 1
                m.latencies.append(r.finish - r.arrival)
                if r.finish <= r.slo:
                    m.slo_met += 1
                ev.completed.append(r)
        spans.insert(complete_at, Span("tick.complete", t, span_clock()))
        return ev

    def drain(self, now: float = 0.0,
              max_wall: float = 1e9) -> Tuple[float, List[TickEvents]]:
        """Tick until both queues are empty (or no progress is possible).
        Returns the clock time at idle and the event trail."""
        t0 = time.perf_counter()
        start_now = now
        events: List[TickEvents] = []
        while self.has_work:
            ev = self.tick(now)
            events.append(ev)
            if self.cfg.clock == "sim":
                now += ev.dt
            else:
                now = start_now + (time.perf_counter() - t0)
            if not (ev.stepped or ev.admitted or ev.dropped):
                break                      # starved: nothing admissible
            if time.perf_counter() - t0 > max_wall:
                break
        return now, events

    # ---------------- main loop (thin wrapper over the steppable API) ------

    def run(self, workload: List[Request], max_wall: float = 1e9) -> Metrics:
        pending = sorted(workload, key=lambda r: r.arrival)
        # each run() is self-contained: discard anything a previous
        # max_wall-truncated run (or external submit/tick use) left queued
        self.wait.clear()
        self.active.clear()
        self.reset_metrics()
        m = self.metrics
        now = 0.0
        t_start = time.perf_counter()

        def clock() -> float:
            return (time.perf_counter() - t_start
                    if self.cfg.clock == "real" else now)

        while pending or self.has_work:
            t = clock()
            if (self.cfg.clock == "sim" and not self.has_work and pending):
                now = max(now, pending[0].arrival)
                t = now
            while pending and pending[0].arrival <= t:
                self.submit(pending.pop(0))
            if not self.has_work:
                if self.cfg.clock == "real" and pending:
                    time.sleep(max(pending[0].arrival - t, 0))
                continue

            ev = self.tick(t)
            if self.cfg.clock == "sim":
                if ev.stepped:
                    now = ev.end
                elif not self.active and pending:
                    now = pending[0].arrival
            if time.perf_counter() - t_start > max_wall:
                break
        m.span = clock()
        return m

    DUMMY_BASE = 1 << 40

    def _dummy(self, res: Tuple[int, int], slot: int) -> Request:
        key = (res, slot)
        pool = getattr(self, "_dummy_pool", None)
        if pool is None:
            pool = self._dummy_pool = {}
        r = pool.get(key)
        if r is None:
            h, w = res
            r = Request(rid=self.DUMMY_BASE + hash(key) % (1 << 30),
                        resolution=res, arrival=0.0, slo=1e18, total_steps=1)
            r.latent = torch.zeros((h, w, self.mcfg.latent_channels),
                                   dtype=torch.float32, device=self.device)
            r.text = torch.zeros((self.mcfg.n_text, self.mcfg.d_text),
                                 dtype=torch.float32, device=self.device)
            self._uid_base[r.rid] = r.rid * (1 << 20) % (1 << 62)
            pool[key] = r
        return r

    def _denoise_step(self, active: List[Request],
                      spans: Optional[List[Span]] = None) -> List[float]:
        """One model step of ``active``; appends its ``tick.split``,
        ``tick.step`` and ``tick.merge`` to ``spans`` (None: not kept)."""
        if self.cfg.clock == "sim" and self.cfg.sim_synthetic:
            # synthetic sim: no tensors exist; a step is pure accounting
            for r in active:
                r.steps_done += 1
            return []
        spans = [] if spans is None else spans
        t = span_clock()
        # bucket-pad per resolution (the reference's bounded shape lattice)
        padded = list(active)
        for res, c in zip(self.resolutions, self._counts(active)):
            for j in range(self._bucket(c) - c):
                padded.append(self._dummy(tuple(res), j))
        csp, patches = split([r.latent for r in padded],
                             patch=self.patch,
                             req_ids=[r.rid for r in padded])
        by_rid = {r.rid: r for r in padded}
        step_req = torch.as_tensor([by_rid[int(rid)].steps_done
                                    for rid in csp.req_ids], dtype=torch.int64)
        text = torch.stack([by_rid[int(rid)].text for rid in csp.req_ids])
        total_steps = active[0].total_steps

        savings: List[float] = []
        hook = None
        if self.cfg.use_cache and self.cfg.clock == "real":
            frac = float(np.mean([r.steps_done for r in active])) / total_steps
            hook, savings = self._block_hook(csp, frac)
        t = _close(spans, "tick.split", t)

        # the model step runs on both clocks; the sim clock charges the
        # surrogate's time for it (the reference's sim clock skips it)
        new_patches = sampler_mod.sampler_step(
            self.mcfg, self.params, csp, patches, step_req, total_steps,
            text, block_hook=hook)
        t = _close(spans, "tick.step", t)
        outs = merge_by_request(csp, new_patches)
        for r in active:                # dummies' outputs are discarded
            r.latent = outs[r.rid]
            r.steps_done += 1
        _close(spans, "tick.merge", t)
        return savings
