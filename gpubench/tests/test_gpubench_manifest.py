"""BENCHMARK.json against the rules its format keeps, and the files it names."""
import json
import re
from pathlib import Path

import pytest

from gpubench import manifest, traffic as tm

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(_dim|_rank)$|width|hidden|intermediate|latent|state|proj|head|expan|per_tok")


def line_ok(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_paths_and_command():
    assert set(M) == KEYS
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(M["command"]) <= 32 and all(line_ok(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in M["configs"]]
    cells = [w["name"] for w in M["workloads"]]
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line_ok(w["why"]) and w["config"] in names
        assert NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(cells)
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(m["layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert {c["config"] for c in M["workloads"]} == set(names)
    assert next(m for m in M["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_every_cell_reports_what_its_metrics_need():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in M["workloads"]:
        c = manifest.cell(w["name"], M)
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in names, (w["name"], m["name"])
    for m in M["per_layer"]:
        moves = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", [w["name"] for w in M["workloads"]]))
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_each_cells_files_are_found_by_name(w):
    c = manifest.cell(w["name"], M)
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
    t = c["traffic"]
    assert t["slo_scale"] == 5 and t["steps"] == 20 and t["rate"] > 0
    assert isinstance(t["arrival_seed"], int)
    assert set(t["base_s"]) == {tm.res_key(r) for r in tm.resolutions(t)}
    assert t["lead_in_s"] == pytest.approx(max(tm.budgets(t).values()))
    assert set(t["check"]["limits"]) == {"latent_err", "decode_err"}
    cfg = c["cfg"]
    for k in ("source", "reduced", "assumed", "departures", "precision"):
        assert k in cfg
    conf = next(x for x in M["configs"] if x["name"] == w["config"])
    assert cfg["source"] == conf["source"] and set(cfg["reduced"]) == set(conf["reduced"])
    assert all(k in cfg for k in conf["reduced"])


def test_every_file_lies_under_paths():
    for c in M["configs"]:
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in M["paths"])
