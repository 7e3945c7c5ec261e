"""Port parity: the dry-run on a fake 256/512-rank process group
(``repro_torch.launch.dryrun``) and the roofline (``launch.roofline``).

The dry-run replaces its process's default group, so it runs in a
subprocess; the reference's side (its ``model_flops`` and the shard shapes
of its ``build_cell`` shardings) runs in another, with 512 forced host
devices.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 420
FLOP_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
# (arch, shape, mesh, reduced): the cells whose argument bytes are compared;
# "reduced" is the reduced config with 16 heads and FSDP
BYTE_CELLS = [("internlm2-1.8b", "train_4k", "single", True),
              ("internlm2-1.8b", "decode_32k", "single", False),
              ("internlm2-1.8b", "decode_32k", "multi", False)]

_REF = """
import json, sys
import numpy as np, jax
from repro.configs import ARCHS, SHAPES
from repro.launch import roofline, sharding as shd, steps
from repro.launch.mesh import dp_axes, make_production_mesh
FLOP_SHAPES, BYTE_CELLS = json.loads(sys.argv[1])
out = {"model_flops": {f"{a}|{s}": roofline.model_flops(ARCHS[a], SHAPES[s])
                       for a in ARCHS for s in FLOP_SHAPES}, "arg_bytes": {}}

def nbytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(leaves, shs))

for arch, sname, mname, reduced in BYTE_CELLS:
    cfg = ARCHS[arch].reduced(n_heads=16, fsdp=True) if reduced else ARCHS[arch]
    shape = SHAPES[sname]
    mesh = make_production_mesh(multi_pod=mname == "multi")
    p, specs = steps.abstract_params(cfg)
    n = nbytes(p, shd.param_shardings(cfg, mesh, p, specs))
    b = steps.input_specs(cfg, shape)
    n += nbytes(b, steps.batch_shardings(cfg, mesh, b))
    if shape.kind == "train":
        o = steps.abstract_opt(cfg, p)
        n += nbytes(o, shd.opt_shardings(cfg, mesh, o, specs))
    elif shape.kind == "decode":
        dp_total = int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))
        c = steps.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        c = {"blocks": c["blocks"]}      # the port keeps cur_len on the host
        n += nbytes(c, {"blocks": shd.cache_shardings(
            cfg, mesh, {"blocks": c["blocks"]}, shape.global_batch,
            seq_shard=shape.global_batch < dp_total)["blocks"]})
    out["arg_bytes"][f"{arch}|{sname}|{mname}|{reduced}"] = n
json.dump(out, open(sys.argv[2], "w"))
print("REF-OK")
"""

_PORT = """
import json, subprocess, sys
from pathlib import Path
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.models.layers import tree_map
from repro_torch.optim import opt_init
BYTE_CELLS, tmp = json.loads(sys.argv[1]), Path(sys.argv[2])
out = {"records": {}}
for arch, sname, mname, reduced in BYTE_CELLS:
    cfg = ARCHS[arch].reduced(n_heads=16, fsdp=True) if reduced else None
    rec = dryrun.run_cell(arch, sname, mname == "multi", tmp / "records",
                          config_override=cfg)
    out["records"][f"{arch}|{sname}|{mname}|{reduced}"] = rec
# the plain single-device step of the reduced train cell, counted alike
cfg, shape = ARCHS["internlm2-1.8b"].reduced(n_heads=16, fsdp=True), SHAPES["train_4k"]
with FakeTensorMode():
    p = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), steps.abstract_params(cfg)[0])
    b = {k: torch.zeros(v.shape, dtype=v.dtype)
         for k, v in steps.input_specs(cfg, shape).items()}
    with FlopCounterMode(display=False) as fc:
        steps.make_train_step(cfg, device="cpu")(p, opt_init(cfg, p), b)
out["plain_flops"] = fc.get_total_flops()
out["roofline"] = roofline.analyze_cell("internlm2-1.8b", "decode_32k", tmp / "records")
json.dump(out, open(tmp / "port.json", "w"))
print("PORT-OK")
"""


def _env(tmp, **extra):
    return {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": str(tmp), "OMP_NUM_THREADS": "2", **extra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF), json.dumps([FLOP_SHAPES, BYTE_CELLS]),
         str(tmp / "ref.json")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(tmp, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=512"))
    port = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_PORT), json.dumps(BYTE_CELLS), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(tmp))
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in (ref, port)]
    finally:
        for p in (ref, port):
            if p.poll() is None:
                p.kill()
    assert ref.returncode == 0 and "REF-OK" in outs[0][0], outs[0][1][-4000:]
    assert port.returncode == 0 and "PORT-OK" in outs[1][0], outs[1][1][-4000:]
    return (json.loads((tmp / "ref.json").read_text()),
            json.loads((tmp / "port.json").read_text()), tmp)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_reference(runs, arch):
    """``roofline.model_flops`` (arithmetic on the abstract params) is the
    reference's, for train_4k, prefill_32k and decode_32k."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import roofline
    ref, _, _ = runs
    for s in FLOP_SHAPES:
        assert roofline.model_flops(ARCHS[arch], SHAPES[s]) == ref["model_flops"][f"{arch}|{s}"]


@pytest.mark.parametrize("cell", BYTE_CELLS, ids=lambda c: "-".join(map(str, c)))
def test_argument_bytes_equal_reference_shards(runs, cell):
    """Per-device argument bytes of a cell (the local shards of params,
    optimizer state, batch and cache) are the sum of the reference's shard
    shapes under its ``build_cell`` shardings."""
    ref, port, _ = runs
    key = "|".join(map(str, cell))
    rec = port["records"][key]
    assert rec["status"] == "ok" and rec["devices"] == (512 if cell[2] == "multi" else 256)
    assert rec["memory"]["argument_size_in_bytes"] == ref["arg_bytes"][key]


def test_global_flops_equal_the_plain_step(runs):
    """The fake 16x16 trace of reduced internlm2-1.8b (16 heads, so that
    they split over "model"; FSDP) x train_4k (forward, backward with flash,
    AdamW): each device does exactly 1/256 of the flops that
    ``FlopCounterMode`` counts on the plain single-device step, so the 256
    ranks together do the plain step's work and no product is repeated
    across ranks (an FSDP weight is gathered, not the activations; a
    row-parallel partial sum is reduced before the norm)."""
    _, port, _ = runs
    rec = port["records"]["internlm2-1.8b|train_4k|single|True"]
    assert port["plain_flops"] > 0
    assert rec["cost"]["flops"] * 256 == port["plain_flops"]
    assert rec["periods_counted"] == [1, 2] and rec["n_periods"] == 2


def test_full_size_decode_cell_and_roofline(runs):
    """internlm2-1.8b x decode_32k at full size on both meshes: flops,
    bytes and collectives by kind, and the H100 roofline terms of the
    single-mesh record, whose memory term is the floor of the arguments
    read once and the outputs written once, the cache written in place
    counted once (the record's eager op bytes stay out of the terms)."""
    from repro_torch.launch import roofline
    _, port, tmp = runs
    for mesh in ("single", "multi"):
        rec = port["records"][f"internlm2-1.8b|decode_32k|{mesh}|False"]
        assert rec["n_periods"] == 24 and rec["cost"]["flops"] > 0
        assert rec["cost"]["bytes_eager"] > 0 and "bytes accessed" not in rec["cost"]
        mem = rec["memory"]
        assert 0 < mem["alias_size_in_bytes"] < mem["output_size_in_bytes"]
        coll = rec["collectives"]
        assert coll["total_bytes"] == pytest.approx(sum(coll["bytes_by_kind"].values()))
        assert set(coll["count_by_kind"]) == set(coll["bytes_by_kind"]) and coll["count_by_kind"]
        assert (tmp / "records" / f"internlm2-1.8b__decode_32k__{mesh}.json").exists()
    r = port["roofline"]
    assert set(r["terms_s"]) == {"compute_s", "memory_s", "collective_s"}
    mem = port["records"]["internlm2-1.8b|decode_32k|single|False"]["memory"]
    assert r["terms_s"]["memory_s"] == (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                                        - mem["alias_size_in_bytes"]) / roofline.HBM_BW
    assert r["dominant"] in r["terms_s"] and r["step_s_bound"] == max(r["terms_s"].values())
    assert 0 < r["roofline_frac"] <= 1 and r["useful_flops_ratio"] > 0


def test_parse_collectives_traffic_factors():
    """The reference's traffic factors: an all-reduce moves its bytes twice."""
    c = dryrun.parse_collectives([("all-reduce", 100), ("all-gather", 10),
                                  ("all-reduce", 1), ("reduce-scatter", 4)])
    assert c["bytes_by_kind"] == {"all-reduce": 202.0, "all-gather": 10.0,
                                  "reduce-scatter": 4.0}
    assert c["count_by_kind"] == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1}
    assert c["total_bytes"] == 216.0
