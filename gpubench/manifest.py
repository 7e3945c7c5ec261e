"""``BENCHMARK.json`` and the files it names: a cell's configuration and
traffic files and the readers of its metrics, each found by its name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, manifest: dict | None = None) -> dict:
    """The workload entry with its ``cfg`` (the configuration file), its
    ``traffic`` (``traffic/<name>.json``) and the entries of the metrics it
    reports with ``--trace 0`` (``end_to_end``) and ``--trace 1`` (``per_layer``)."""
    m = load() if manifest is None else manifest
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in m['workloads']]}")
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    e2e = [e for e in m["end_to_end"] if name in e.get("workloads", [name])]
    names = {e["name"] for e in e2e}
    layer = [e for e in m["per_layer"]
             if (name in e["workloads"] if "workloads" in e else e["moves"] in names)]
    return {**w, "cfg": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer}


def reader(metric: str) -> ModuleType:
    """The module ``metrics/<metric>.py``, whose ``read(run)`` gives the value."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(entries: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds a value."""
    out = {}
    for e in entries:
        v = reader(e["name"]).read(run)
        if v is not None:
            out[e["name"]] = {"value": float(v), "unit": e["unit"]}
    return out
