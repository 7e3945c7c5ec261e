"""The engine's spans inside a tick (``TickEvents.spans``), ``Request.admitted``
and ``Request.finish`` on the real clock, and what the benchmark reads from
them: the readers of ``queue_wait_ms``, ``queue_wait_ms.overload`` and
``decode_ms``, and the reductions of a traced stretch in ``gpubench/spans.py``
(idle gaps named by the phase they fall in, the idle share inside the step,
the CSP phases' time).

    PYTHONPATH=src python -m pytest tests/test_torch_tick_spans.py
"""
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from gpubench import cell, manifest, spans as gspans  # noqa: E402
from gpubench.tests.gpubench_tiny import TINY_DIT, TINY_UNET, tiny_entry  # noqa: E402
from repro_torch.core import serving as tsrv  # noqa: E402
from repro_torch.core.requests import Request  # noqa: E402
from repro_torch.models import diffusion as tdm  # noqa: E402

RES = [(16, 16), (24, 24), (32, 32)]
TINY = dict(kind="unet", width=16, levels=2, blocks_per_level=1, n_heads=2, groups=4,
            d_text=8, n_text=2)
STEP_PHASES = ["tick.schedule", "tick.prepare", "tick.predict", "tick.split", "tick.step",
               "tick.merge", "tick.sync", "tick.complete"]
NEW_METRICS = ("queue_wait_ms", "queue_wait_ms.overload", "decode_ms")


def _engine(clock="real"):
    cfg = tdm.DiffusionConfig(**TINY)
    params = tdm.init_diffusion(cfg, torch.Generator().manual_seed(0), device="cpu")
    return tsrv.PatchedServeEngine(cfg, params, tsrv.EngineConfig(clock=clock),
                                   dict.fromkeys(RES, 1.0), RES, device="cpu")


def _req(rid, res=RES[0], steps=2, arrival=0.0, slo=1e9):
    return Request(rid=rid, resolution=res, arrival=arrival, slo=slo, total_steps=steps)


@pytest.fixture(scope="module")
def served():
    """Three requests of two lengths, ticked to completion on the real
    clock: each tick's events with the wall clock read around it."""
    eng = _engine()
    for i, (res, steps) in enumerate(zip(RES, (2, 3, 3))):
        eng.submit(_req(i, res, steps))
    ticks = []
    now = 100.0
    while eng.has_work:
        before = time.time_ns()
        ev = eng.tick(now)
        ticks.append((before, ev, time.time_ns()))
        now += 1.0
    return eng, ticks


def _top(ev):
    return [s for s in ev.spans if s.name != "tick.decode"]


def test_a_stepping_ticks_spans_come_in_order_disjoint_and_inside_the_tick(served):
    _, ticks = served
    assert len(ticks) == 3 and all(ev.stepped for _, ev, _ in ticks)
    for before, ev, after in ticks:
        top = _top(ev)
        assert [s.name for s in top] == STEP_PHASES
        assert all(s.rid is None for s in top)
        assert before <= top[0].start_ns and top[-1].end_ns <= after
        for s in ev.spans:
            assert s.start_ns <= s.end_ns
        for a, b in zip(top, top[1:]):
            assert a.end_ns <= b.start_ns
        # spans come in start order, each decode inside its tick.complete
        assert [s.start_ns for s in ev.spans] == sorted(s.start_ns for s in ev.spans)
        done = top[-1]
        for d in ev.spans:
            if d.name == "tick.decode":
                assert done.start_ns <= d.start_ns <= d.end_ns <= done.end_ns


def test_the_step_phases_sum_to_the_step_time(served):
    _, ticks = served
    for _, ev, _ in ticks:
        d = {s.name: s for s in ev.spans}
        assert abs((d["tick.sync"].end_ns - d["tick.split"].start_ns) * 1e-9 - ev.dt) < 1e-3
        inside = sum(d[n].end_ns - d[n].start_ns
                     for n in ("tick.split", "tick.step", "tick.merge", "tick.sync"))
        assert abs(inside * 1e-9 - ev.dt) < 1e-3


def test_each_completed_request_has_one_decode_span_with_its_rid(served):
    eng, ticks = served
    completed = [r for _, ev, _ in ticks for r in ev.completed]
    assert sorted(r.rid for r in completed) == [0, 1, 2]
    for _, ev, _ in ticks:
        decodes = [s for s in ev.spans if s.name == "tick.decode"]
        assert sorted(s.rid for s in decodes) == sorted(r.rid for r in ev.completed)
        for r in ev.completed:
            assert r.decode_span in decodes and r.decode_span.rid == r.rid
            assert r.rid in eng.outputs


def test_admission_is_stamped_with_the_ticks_now(served):
    _, ticks = served
    first = ticks[0][1]
    assert sorted(r.rid for r in first.admitted) == [0, 1, 2]
    assert all(r.admitted == first.now == 100.0 for r in first.admitted)


@pytest.mark.parametrize("case", ["idle", "dropped"])
def test_a_tick_that_steps_nothing_records_the_schedule_only(case):
    eng = _engine()
    if case == "dropped":
        late = _req(7, slo=1.0)           # hopeless: its deadline has passed
        eng.submit(late)
    ev = eng.tick(5.0)
    assert not ev.stepped and [s.name for s in ev.spans] == ["tick.schedule"]
    if case == "dropped":
        assert ev.dropped == [late] and late.state == "dropped" and late.admitted is None


def test_calibrate_steps_keep_no_spans():
    eng = _engine()
    eng.calibrate(steps_per_probe=1, combos=[[1, 1, 0]])
    spans = []
    r = _req(3)
    eng._prepare(r)
    eng._denoise_step([r], spans)
    assert [s.name for s in spans] == ["tick.split", "tick.step", "tick.merge"]


@pytest.mark.parametrize("clock", ["real", "sim"])
def test_finish_is_the_callers_clock_after_the_decode(monkeypatch, clock):
    """On the real clock ``finish`` is ``now`` plus the wall time from the
    tick's start to the end of the request's decode; the sim clock keeps the
    step end, which the fleet simulator advances by."""
    eng = _engine(clock)
    ns = iter(range(0, 10 ** 12, 10 ** 6))        # every span clock read: 1 ms on
    monkeypatch.setattr(tsrv, "span_clock", lambda: next(ns))
    eng.submit(_req(0, steps=1, arrival=49.0))
    ev = eng.tick(50.0)
    (r,) = ev.completed
    tick_start = ev.spans[0].start_ns
    if clock == "real":
        assert r.finish == pytest.approx(50.0 + (r.decode_span.end_ns - tick_start) * 1e-9)
        assert r.finish > ev.end - ev.dt       # the host phases before the step count
    else:
        assert r.finish == ev.end
    assert eng.metrics.latencies == [r.finish - r.arrival]
    assert eng.metrics.slo_met == 1


def test_finish_on_the_real_clock_counts_the_decode(monkeypatch):
    """A decode that takes 0.3 s of the caller's clock moves the request's
    finish, its latency and whether it met its deadline."""
    eng = _engine()
    slow = eng._postprocess

    def postprocess(req):
        slow(req)
        time.sleep(0.3)
    monkeypatch.setattr(eng, "_postprocess", postprocess)
    eng.submit(_req(0, steps=1, arrival=0.0, slo=0.25 + 1e-9))
    ev = eng.tick(0.0)
    (r,) = ev.completed
    assert r.finish >= 0.3 and r.finish > ev.end
    assert eng.metrics.latencies[0] >= 0.3 and eng.metrics.slo_met == 0


# ---------------- what the benchmark reads ----------------

@pytest.fixture
def two_threads():
    """The tiny cells serve on the real clock: with every core per worker,
    several workers starve each other and Algorithm 1 drops what it cannot
    finish in time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _entry(cfg):
    # deadlines of 20 s a request: the readers are under test, not the CPU's speed
    e = tiny_entry(cfg, rate=4.0, base_s={"16x16": 4.0, "24x24": 4.0, "32x32": 4.0})
    e["per_layer"] = e["per_layer"] + [dict(name=n, unit="ms") for n in NEW_METRICS]
    return e


@pytest.mark.parametrize("cfg", [TINY_UNET, TINY_DIT], ids=["unet", "dit"])
def test_a_traced_tiny_run_reports_the_new_metrics_in_range(cfg, two_threads):
    r = cell.run_cell(_entry(cfg), 2 ** 31 + 17, 3.0, True, "cpu", time.perf_counter())
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW_METRICS) <= set(m)
    assert m["queue_wait_ms"] == m["queue_wait_ms.overload"]
    assert 0.0 <= m["queue_wait_ms"] < 1e3 * (1.0 + 3.0 + 20.0)
    assert 0.0 < m["decode_ms"] < 1e3


def _fake_run(**request_fields):
    req = SimpleNamespace(**request_fields)
    s = SimpleNamespace(request=req, due=10.0, done=11.0)
    return SimpleNamespace(counted=[s])


def test_the_readers_report_nothing_from_a_program_without_spans():
    bare = _fake_run()
    for name in NEW_METRICS:
        assert manifest.reader(name).read(bare) is None
    unadmitted = _fake_run(admitted=None, decode_span=None)
    assert gspans.queue_wait_ms(unadmitted) is None and gspans.decode_ms(unadmitted) is None
    ev = SimpleNamespace(stepped=True)                # a TickEvents without spans
    assert gspans.csp_ms([ev]) is None
    assert gspans.step_idle_share([(0.0, 1.0)], [ev], 0.0, 1.0) is None
    assert gspans.busy_in_ticks_share([(0.0, 1.0)], [ev]) is None
    full = _fake_run(admitted=10.25, decode_span=tsrv.Span("tick.decode", 0, 4_000_000, 0))
    assert gspans.queue_wait_ms(full) == pytest.approx(250.0)
    assert gspans.decode_ms(full) == pytest.approx(4.0)


def _tick(t0, phases):
    """A made-up TickEvents whose phases (name, ms) run back to back from t0 s."""
    out, t = [], int(t0 * 1e9)
    for name, ms in phases:
        out.append(tsrv.Span(name, t, t + int(ms * 1e6)))
        t += int(ms * 1e6)
    return SimpleNamespace(spans=out, stepped=True)


STEP = [("tick.schedule", 2), ("tick.prepare", 1), ("tick.predict", 1), ("tick.split", 3),
        ("tick.step", 10), ("tick.merge", 1), ("tick.sync", 80), ("tick.complete", 2)]


def test_step_idle_share_csp_time_and_busy_inside_the_ticks():
    events = [_tick(1.0, STEP), _tick(1.2, STEP)]
    # step intervals: 1.004..1.098 and 1.204..1.298; busy all of them but 10 ms each
    busy = [(1.004, 1.050), (1.060, 1.098), (1.204, 1.250), (1.260, 1.298), (1.5, 1.6)]
    assert gspans.step_intervals(events) == [pytest.approx((1.004, 1.098)),
                                             pytest.approx((1.204, 1.298))]
    assert gspans.step_idle_share(busy, events, 0.0, 9.0) == pytest.approx(100 * 20 / 188)
    assert gspans.step_idle_share(busy, events, 1.1, 9.0) == pytest.approx(100 * 10 / 94)
    assert gspans.csp_ms(events) == pytest.approx(4.0)
    assert gspans.busy_in_ticks_share(busy, events) == pytest.approx(100 * 168 / 268)


@pytest.mark.parametrize("t,want", [
    (1.0055, "tick.split"),              # inside a program phase
    (1.0985, "tick.complete"),           # the complete phase, no decode open
    (1.0995, "tick.decode"),             # the innermost: a decode inside complete
    (1.1015, "engine.tick"),             # in the harness's tick, past the program's spans
    (1.150, "harness.wait_for_arrivals"),
    (1.190, "harness.loop"),             # no span open at all
])
def test_gaps_are_named_by_the_innermost_span_open_at_their_midpoint(t, want):
    ev = _tick(1.0, STEP[:-1] + [("tick.complete", 3)])
    ev.spans.append(tsrv.Span("tick.decode", int(1.099e9), int(1.1e9), 4))
    program = gspans.tick_spans(ev)
    harness = [(0.999, 1.102, "gpubench.tick"), (1.12, 1.17, "gpubench.idle")]
    assert gspans.name_at(t, program, harness) == want
    gaps = [(t - 1e-4, t + 1e-4), (t - 1e-5, t + 1e-5)]
    assert gspans.name_gaps(gaps, program, harness) == [(want, pytest.approx(2e-4)),
                                                        (want, pytest.approx(2e-5))]


def test_without_program_spans_the_gaps_keep_the_harness_names():
    harness = [(0.0, 1.0, "gpubench.tick"), (1.0, 2.0, "gpubench.idle")]
    assert [n for n, _ in gspans.name_gaps([(0.2, 0.4), (1.2, 1.4), (2.2, 2.4)], [], harness)] \
        == ["engine.tick", "harness.wait_for_arrivals", "harness.loop"]


def test_the_probe_runs_a_tiny_cell_on_the_cpu(two_threads):
    from gpubench import tick_probe
    out = tick_probe.probe(_entry(TINY_UNET), 2 ** 31 + 3, 3.0, "cpu", time.perf_counter())
    assert set(NEW_METRICS) <= set(out["metrics"])
    assert out["csp_ms"] is not None and out["csp_ms"] > 0
    assert set(STEP_PHASES) <= set(out["phase_ms_mean"])
    assert 0 < out["span_ns"] < 1e5 and out["spans_a_tick"] >= len(STEP_PHASES)
    # the CPU run records no device activity: every step is idle on the device,
    # and the longest gaps fall in the model step's enqueue, which runs it
    assert out["sync_debug"] is None and out["busy_in_tick_spans_pct"] is None
    assert out["step_idle_share"] == 100.0
    assert out["idle_gaps"][0][0] == "tick.step"
    assert {n for n, _ in out["idle_gaps"]} <= set(STEP_PHASES) | {
        "tick.decode", "engine.tick", "harness.loop"}
