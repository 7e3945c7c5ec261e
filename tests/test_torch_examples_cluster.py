"""Port parity of the fleet and calibration entry points on the CPU, with
the reference's params carried across by ``convert.py``:

- the cache-hit calibration: the samples of the first two compositions
  equal the reference's ``real_engine(use_cache=True)``'s, concentration
  and step fraction exactly, hit rate at 1e-6;
- every ``serve_cluster`` section on its workload's first 3 s: the returned
  ``summary()`` (and what else the section prints) equals the same section
  run on ``repro.cluster`` — the module's own source with its imports
  pointed at the reference, so both run one text;
- the sections' defaults: run with them, the sections build the workloads,
  engine factories and fleets that ``examples/serve_cluster.py`` builds,
  argument for argument and in order;
- ``scripts/trace_report.py`` and ``scripts/fleet_dashboard.py`` (stdlib
  only) print the same report for the port's trace and health log as for
  the reference's of the same run."""
import dataclasses
import math
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.cluster as jcluster  # noqa: E402
import repro.cluster.simtools as jsim  # noqa: E402
import repro_torch.cluster.simtools as tsim  # noqa: E402
from benchmarks.common import make_requests as j_make_requests  # noqa: E402
from benchmarks.common import real_engine as j_real_engine  # noqa: E402
from repro_torch.convert import diffusion_params_from_numpy  # noqa: E402
from repro_torch.examples import calibrate_cache_hit_model as tcal  # noqa: E402
from repro_torch.examples import serve_cluster as tsc  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CUT = 3.0          # seconds of each section's workload that are served
ARGS_KEEP = 2      # requests of each workload served where only arguments are held
WORKLOADS = ("cluster_workload", "phased_workload", "ramp_workload", "piecewise_rate_workload")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _canon(x):
    """Exact, order-keeping form of a summary: NaN equals NaN, and any value
    that is not a plain number, string or container fails."""
    if isinstance(x, dict):
        return ("dict", [(k, _canon(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_canon(v) for v in x])
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    assert x is None or isinstance(x, (bool, int, float, str, np.integer, np.floating)), type(x)
    return x


def test_calibration_samples_match_reference():
    """scripts/calibrate_cache_hit_model.py's first two compositions."""
    want, jparams = [], None
    for counts in tcal.COMBOS[:2]:
        eng = j_real_engine(use_cache=True)
        for r in j_make_requests(counts, steps=tcal.STEPS):
            eng.submit(r)
        eng.drain(0.0)
        want.extend(eng.metrics.cache_samples)
        jparams = eng.params
    tparams = diffusion_params_from_numpy(_np_tree(jparams), device="cpu")
    got = tcal.collect_samples(tcal.COMBOS[:2], device="cpu", params=tparams,
                               log=lambda msg: None)
    assert len(got) == len(want) == 2 * tcal.STEPS
    for g, w in zip(got, want):
        assert g[:2] == w[:2], (g, w)
        assert abs(g[2] - w[2]) <= 1e-6, (g, w)


def _reference_serve_cluster():
    """``serve_cluster``'s source with ``repro_torch.`` imports pointed at
    ``repro.``; the reference's engine factory takes no device."""
    src = Path(tsc.__file__).read_text().replace("from repro_torch.", "from repro.")
    mod = types.ModuleType("reference_serve_cluster")
    exec(compile(src, "reference_serve_cluster", "exec"), mod.__dict__)
    assert mod.Cluster.__module__.startswith("repro.cluster")
    mod.sim_engine_factory = lambda *a, device=None, **kw: jsim.sim_engine_factory(*a, **kw)
    return mod


def _plain(x):
    """Dataclasses as (class name, fields), containers as lists and dicts,
    so that the two packages' configs compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _record(monkeypatch, calls, fleet, builders, scenario):
    """Log, in call order, the arguments of every workload builder (from
    ``builders`` and ``scenario.workload``) and every fleet (from
    ``fleet``) with those of its engine factory; each workload keeps its
    first ``ARGS_KEEP`` requests. A builder that another calls is not logged."""
    factory_args, depth = {}, [0]

    def outer(entry, build, *a, **kw):
        if not depth[0]:
            calls.append(entry)
        depth[0] += 1
        try:
            return build(*a, **kw)[:ARGS_KEEP]
        finally:
            depth[0] -= 1

    def builder(name, fn):
        return lambda *a, **kw: outer((name, _plain(a), _plain(kw)), fn, *a, **kw)

    def factory(*a, **kw):
        made = make_factory(*a, **kw)
        factory_args[id(made)] = (_plain(a), _plain({k: v for k, v in kw.items()
                                                     if k != "device"}))
        return made

    def cluster(engine_factory, res, cfg):
        calls.append(("Cluster", factory_args[id(engine_factory)], _plain(res), _plain(cfg)))
        return make_cluster(engine_factory, res, cfg)

    def scenario_workload(sc, seed=0):
        return outer(("workload", sc.name, seed), make_workload, sc, seed)

    make_factory, make_cluster = fleet.sim_engine_factory, fleet.Cluster
    make_workload = scenario.workload
    monkeypatch.setattr(fleet, "sim_engine_factory", factory)
    monkeypatch.setattr(fleet, "Cluster", cluster)
    monkeypatch.setattr(scenario, "workload", scenario_workload)
    for name in WORKLOADS:
        monkeypatch.setattr(builders, name, builder(name, getattr(builders, name)))


def test_serve_cluster_defaults_are_the_reference_scripts(monkeypatch, capsys):
    """The sections with their defaults against ``examples/serve_cluster.py``
    itself; ``batching`` has no counterpart there."""
    want, got = [], []
    with monkeypatch.context() as m:
        _record(m, want, jcluster, jsim, jsim.Scenario)
        src = (ROOT / "examples" / "serve_cluster.py").read_text()
        exec(compile(src, "examples/serve_cluster.py", "exec"), {"__name__": "reference"})
    with monkeypatch.context() as m:
        _record(m, got, tsc, tsc, tsim.Scenario)
        for name, section in tsc.SECTIONS.items():
            if name != "batching":
                section(device="cpu")
    capsys.readouterr()
    assert len(want) > 40
    assert got == want


@pytest.fixture(scope="module")
def jsc():
    return _reference_serve_cluster()


@pytest.mark.parametrize("section", list(tsc.SECTIONS))
def test_serve_cluster_section_matches_reference(jsc, section, capsys):
    got = tsc.SECTIONS[section](cut=CUT, device="cpu")
    port_lines = capsys.readouterr().out.splitlines()
    want = jsc.SECTIONS[section](cut=CUT)
    ref_lines = capsys.readouterr().out.splitlines()
    assert got and got.keys() == want.keys()
    assert _canon(got) == _canon(want)
    # the printed lines too, but for the wall-clock column of the policies
    assert ([s.split(" wall=")[0] for s in port_lines]
            == [s.split(" wall=")[0] for s in ref_lines])


def test_trace_report_and_dashboard_read_the_ports_logs(jsc, tmp_path, capsys):
    got = tsc.tracing(cut=CUT, device="cpu", trace_dir=tmp_path / "torch")
    want = jsc.tracing(cut=CUT, trace_dir=tmp_path / "jax")
    capsys.readouterr()
    assert _canon(got) == _canon(want) and "monitor" in got["least_slack traced"]["summary"]
    for script, name in (("trace_report.py", "trace.jsonl"),
                         ("fleet_dashboard.py", "monitor.jsonl")):
        outs = [subprocess.run([sys.executable, str(ROOT / "scripts" / script),
                                str(tmp_path / side / name)],
                               capture_output=True, text=True, timeout=60, check=True).stdout
                for side in ("torch", "jax")]
        assert outs[0] == outs[1] and len(outs[0].splitlines()) > 3, script
