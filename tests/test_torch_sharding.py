"""Port parity: logical-axis specs, the sharding rules and their DTensor
placements (``repro_torch.launch.sharding``, ``steps.batch_shardings``)
against the JAX reference's PartitionSpecs.

The reference's shardings need a mesh of 256 or 512 devices, so they are
computed in one subprocess with 512 forced host devices (as
``tests/test_distributed.py`` forces its devices) and written as JSON; the
port's run in this process on mesh records, which need no process group.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch.steps import abstract_params as jabstract_params  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2": (("data", "model"), (2, 2)),
    "1x4": (("data", "model"), (1, 4)),
}
# every arch, plus two with tp_mode="dp" (the "model" axis carries batch)
VARIANTS = {a: (a, None) for a in ARCHS}
VARIANTS.update({"internlm2-1.8b+dp": ("internlm2-1.8b", "dp"),
                 "falcon-mamba-7b+dp": ("falcon-mamba-7b", "dp")})
CACHES = [(128, 32768, False), (1, 32768, True), (4, 4096, True)]


def _norm(spec):
    """A spec as JSON: 1-tuples as their name, trailing Nones dropped."""
    out = [None if e is None else e if isinstance(e, str)
           else e[0] if len(e) == 1 else list(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _flat(tree, fn, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, fn, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: fn(tree)}


def _cfg(variant, archs):
    arch, mode = VARIANTS[variant]
    cfg = archs[arch]
    return dataclasses.replace(cfg, tp_mode=mode) if mode else cfg


_REF = """
import dataclasses, json, sys
import jax
from repro.configs import ARCHS, SHAPES
from repro.launch import sharding as shd, steps
MESHES, VARIANTS, CACHES = json.loads(sys.argv[1])

def norm(spec):
    out = [None if e is None else e if isinstance(e, str)
           else e[0] if len(e) == 1 else list(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out

def flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(p, "key", p)) for p in path): norm(s.spec)
            for path, s in leaves}

res = {}
for mname, (axes, sizes) in MESHES.items():
    n = 1
    for s in sizes:
        n *= s
    mesh = jax.make_mesh(tuple(sizes), tuple(axes), devices=jax.devices()[:n])
    for vname, (arch, mode) in VARIANTS.items():
        cfg = ARCHS[arch]
        if mode:
            cfg = dataclasses.replace(cfg, tp_mode=mode)
        p, specs = steps.abstract_params(cfg)
        r = {"params": flat(shd.param_shardings(cfg, mesh, p, specs))}
        for o in ("adamw", "adafactor"):
            c = dataclasses.replace(cfg, opt=o)
            r["opt_" + o] = flat(shd.opt_shardings(c, mesh, steps.abstract_opt(c, p), specs))
        r["cache"] = {f"{b}_{L}_{s}": flat(shd.cache_shardings(
            cfg, mesh, steps.abstract_cache(cfg, b, L), b, seq_shard=s))
            for b, L, s in CACHES}
        r["batch"] = {sh: flat(steps.batch_shardings(cfg, mesh, steps.input_specs(cfg, SHAPES[sh])))
                      for sh in SHAPES}
        res[f"{mname}|{vname}"] = r
json.dump(res, open(sys.argv[2], "w"))
print("REF-OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    arg = json.dumps([{k: [list(a), list(s)] for k, (a, s) in MESHES.items()},
                      {k: list(v) for k, v in VARIANTS.items()}, CACHES])
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF), arg, str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": str(out.parent), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=512"})
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, proc.stderr[-4000:]
    return json.loads(out.read_text())


@functools.lru_cache(maxsize=None)
def _port(mname, vname):
    axes, sizes = MESHES[mname]
    mesh = Mesh(axes, sizes)
    cfg = _cfg(vname, ARCHS)
    p, specs = steps.abstract_params(cfg)

    def flat(tree):
        return _flat(tree, lambda s: _norm(s.spec))
    r = {"params": flat(shd.param_shardings(cfg, mesh, p, specs))}
    for o in ("adamw", "adafactor"):
        c = dataclasses.replace(cfg, opt=o)
        r["opt_" + o] = flat(shd.opt_shardings(c, mesh, steps.abstract_opt(c, p), specs))
    r["cache"] = {f"{b}_{L}_{s}": flat(shd.cache_shardings(
        cfg, mesh, steps.abstract_cache(cfg, b, L), b, seq_shard=s)) for b, L, s in CACHES}
    r["batch"] = {sh: flat(steps.batch_shardings(cfg, mesh, steps.input_specs(cfg, SHAPES[sh])))
                  for sh in SHAPES}
    return mesh, r


@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_tree_equals_reference(arch):
    """Every leaf's logical axes, at full size: the reference's from
    ``jax.eval_shape``, the port's on the meta device (no allocation)."""
    _, jspecs = jabstract_params(JARCHS[arch])
    params, specs = steps.abstract_params(ARCHS[arch])
    assert _flat(specs, tuple) == _flat(jspecs, tuple)
    assert all(t.device.type == "meta" for t in _flat(params, lambda t: t).values())


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("part", ["params", "opt_adamw", "opt_adafactor", "cache", "batch"])
def test_shardings_equal_reference(ref, mname, part):
    """param_shardings (spec_for on every leaf), opt_shardings (AdamW
    mirrors, Adafactor's factored moments), cache_shardings (with and
    without seq_shard) and batch_shardings (with tp_mode="dp") on each mesh,
    for every arch."""
    for vname in VARIANTS:
        _, got = _port(mname, vname)
        assert got[part] == ref[f"{mname}|{vname}"][part], (mname, vname, part)


@pytest.mark.parametrize("mname", list(MESHES))
def test_placements_round_trip(mname):
    """Every spec of every arch's params, caches and batches -> placements
    -> spec; a dim split over two axes takes a Shard of it on both."""
    from torch.distributed.tensor import Replicate, Shard
    for vname in VARIANTS:
        mesh, r = _port(mname, vname)
        specs = [s for part in r.values() for leaf in part.values()
                 for s in (leaf.values() if isinstance(leaf, dict) else [leaf])]
        for s in specs:
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in s)
            pl = shd.placements(mesh, spec)
            assert len(pl) == len(mesh.axis_names)
            assert _norm(shd.spec_of(mesh, pl, max(len(spec), 1))) == s
    mesh = Mesh(*MESHES[mname])
    pl = shd.placements(mesh, (None, ("data", "model")))
    assert pl[-2:] == [Shard(1), Shard(1)]
    assert shd.placements(mesh, ()) == [Replicate()] * len(mesh.axis_names)


def test_placements_refuse_a_split_against_the_mesh_order():
    """JAX orders the shards of ("model", "data") model-major, DTensor by
    mesh dim: the translation refuses the spec rather than reorder data."""
    mesh = Mesh(("data", "model"), (2, 2))
    with pytest.raises(AssertionError, match="order"):
        shd.placements(mesh, (("model", "data"),))


def test_local_shapes_divide_evenly():
    mesh = Mesh(("pod", "data", "model"), (2, 16, 16))
    assert shd.local_shape(mesh, (("pod", "data"), None, "model"), (64, 3, 32)) == (2, 3, 2)
    assert shd.local_shape(mesh, (), (5, 7)) == (5, 7)


def test_place_keeps_card_tensors_off_a_cpu_mesh(tmp_path):
    """A gloo group's mesh is a CPU mesh: ``place`` cuts a host tensor on it
    and makes empty shards of a meta one, but refuses a tensor on the card
    rather than copy it to the host (the card's tensor is a fake one here,
    so that the refusal shows without a card)."""
    import datetime
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_local_mesh()
        assert mesh.device_mesh.device_type == "cpu"
        sh = shd.NamedSharding(mesh, (None, "model"))
        x = torch.arange(8.0).reshape(2, 4)
        assert torch.equal(shd.place(x, sh).full_tensor(), x)
        assert shd.place(torch.empty(2, 4, device="meta"), sh).shape == (2, 4)
        with FakeTensorMode():
            card = torch.empty(2, 4, device="cuda")
            with pytest.raises(ValueError, match="cannot be placed on a cpu mesh"):
                shd.place(card, sh)
            with pytest.raises(ValueError, match="cannot be placed on a cpu mesh"):
                shd.tree_place({"w": card}, {"w": sh})
    finally:
        dist.destroy_process_group()
