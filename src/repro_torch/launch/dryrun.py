"""Dry-run of one (arch x shape x mesh) cell on a fake process group, the
port of the reference's ``repro/launch/dryrun.py``.

``python -m repro_torch.launch.dryrun --arch all --shape train_4k --mesh
single`` runs, for each cell, ``steps.build_cell`` on the 16x16 (single) or
2x16x16 (multi) production mesh over a fake process group of 256 or 512 ranks
(``torch.testing._internal``'s "fake" backend: every collective returns at
once) under ``FakeTensorMode`` (no tensor holds memory or values), and runs
the step once on this rank's shards. The record, under the reference's key
names, is rank 0's view:

- ``memory``: ``argument_size_in_bytes`` (the local shards of params,
  optimizer state, batch and cache), ``output_size_in_bytes`` and
  ``alias_size_in_bytes`` (the outputs written in place into an argument:
  a decode step's cache);
- ``cost``: ``flops`` (the matmul flops of this rank's local ops, from
  ``torch.utils.flop_counter``'s formulas) and ``bytes_eager`` (every
  non-view local op's input and output bytes: what eager execution moves,
  with no fusion, and so a count that moves with the torch version; it is
  not the reference's ``bytes accessed``, XLA's estimate after fusion, and
  the record has no key of that name);
- ``collectives``: counts (``CommDebugMode``) and per-device bytes by kind,
  each collective's output bytes times the reference's traffic factor
  (all-reduce x2).

The step runs twice under the fake mode and the second run is counted: on
its first sight of a sharding, DTensor runs the op once more at the global
shapes to learn the output's, which would count as local work. The eager
trace counts every period it runs, so the reference's re-inflation of a
``while`` body that XLA counts once has no counterpart; for speed, a cell
is counted with one period and with two, and extrapolated linearly to its
``n_periods`` (``run_cell``). ``compile_s`` holds the seconds of the whole
cell.

The default process group is one per process: a cell of the other mesh
size replaces the group, and callers that hold a group of their own run the
dry-run in a subprocess. Records go under ``build/`` by default.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh

# ICI traffic factor per output byte (ring algorithms, n large):
_TRAFFIC_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                   "all-to-all": 1.0, "collective-permute": 1.0}
_KIND = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
# aten ops that move no bytes: allocation and metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "_unsafe_view", "detach", "lift_fresh", "alias", "resize_"}


def parse_collectives(records: Iterable[Tuple[str, int]]) -> Dict[str, Any]:
    """Sum per-device bytes by collective kind from (kind, output bytes)
    records, with the reference's traffic factors."""
    by_kind: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for kind, nbytes in records:
        by_kind[kind] = by_kind.get(kind, 0.0) + nbytes * _TRAFFIC_FACTOR[kind]
        count[kind] = count.get(kind, 0) + 1
    return {"bytes_by_kind": by_kind, "count_by_kind": count,
            "total_bytes": sum(by_kind.values())}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _counter_class():
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import flop_registry

    class StepCounter(CommDebugMode):
        """``CommDebugMode`` (collective counts) that also tallies flops,
        op bytes and collective bytes. A DTensor op is seen first, at its
        global shapes, and counted only by ``CommDebugMode``; its local ops
        then arrive as plain ones."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.colls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            pkt = getattr(func, "_overloadpacket", None)
            if any(issubclass(t, DTensor) for t in types):
                return super().__torch_dispatch__(func, types, args, kwargs)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = getattr(pkt, "__name__", "")
            if name in _KIND:
                self.colls.append((_KIND[name], sum(_nbytes(t) for t in _tensors(out))))
            elif pkt in flop_registry:
                self.flops += int(flop_registry[pkt](*args, **kwargs, out_val=out))
            if (isinstance(func, torch._ops.OpOverload) and func.namespace == "aten"
                    and not func.is_view and name not in _NO_TRAFFIC):
                self.bytes += sum(_nbytes(t) for t in _tensors(args))
                self.bytes += sum(_nbytes(t) for t in _tensors(out))
            return out

    return StepCounter


def _fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _local_bytes(tree, shardings) -> int:
    if isinstance(tree, dict):
        return sum(_local_bytes(v, shardings[k]) for k, v in tree.items())
    if not isinstance(tree, torch.Tensor):
        return 0
    n = 1
    for s in shd.local_shape(shardings.mesh, shardings.spec, tree.shape):
        n *= s
    return n * tree.element_size()


def _count(cfg, shape, mesh):
    """The step of one cell, run twice under ``FakeTensorMode``; the counter
    of the second run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fn, args, _ = steps.build_cell(cfg, shape, mesh)
        fn(*args)                                   # warm DTensor's sharding caches
        counter = _counter_class()()
        with counter:
            fn(*args)
    return counter


def _totals(counter) -> Dict[str, float]:
    coll = parse_collectives(counter.colls)
    t = {"flops": float(counter.flops), "bytes_eager": float(counter.bytes)}
    for k, v in coll["bytes_by_kind"].items():
        t["bytes:" + k] = v
    for k, v in coll["count_by_kind"].items():
        t["count:" + k] = float(v)
    return t


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             config_override=None) -> dict:
    """The record of one cell (module docstring). Every period of layers
    does the same work, so the step is counted with one period and with two,
    and the totals are extrapolated to the config's ``n_periods`` (exact:
    each count is linear in the periods); the argument and output bytes are
    the full config's."""
    cfg = config_override or ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if not ok:
        return {"cell": tag, "status": "skipped", "reason": why}

    t0 = time.time()
    world = 512 if multi_pod else 256
    _fake_group(world)
    mesh = make_production_mesh(multi_pod=multi_pod)
    P = cfg.n_periods
    runs = [1, 2] if P > 1 else [1]
    counts = []
    for n in runs:
        counts.append(_totals(_count(dataclasses.replace(cfg, n_layers=cfg.period * n),
                                     shape, mesh)))
    total = counts[0] if P == 1 else {
        k: counts[0].get(k, 0.0) + (P - 1) * (counts[1].get(k, 0.0) - counts[0].get(k, 0.0))
        for k in set(counts[0]) | set(counts[1])}
    arg_bytes, out_bytes, alias_bytes = _abstract_bytes(cfg, shape, mesh)
    by_kind = {k[6:]: v for k, v in total.items() if k.startswith("bytes:")}
    coll = {"bytes_by_kind": by_kind,
            "count_by_kind": {k[6:]: int(round(v)) for k, v in total.items()
                              if k.startswith("count:")},
            "total_bytes": sum(by_kind.values())}
    rec = {
        "cell": tag, "status": "ok",
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "devices": world,
        "compile_s": round(time.time() - t0, 1),
        "periods_counted": runs, "n_periods": P,
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": int(out_bytes),
                   "alias_size_in_bytes": int(alias_bytes)},
        "cost": {"flops": total["flops"], "bytes_eager": total["bytes_eager"]},
        "collectives": coll,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def _abstract_bytes(cfg, shape, mesh) -> Tuple[int, int, int]:
    """Per-device bytes of a cell's arguments, its outputs and those of its
    outputs written in place into an argument, from the full config's
    abstract trees and the cell's shardings."""
    fn, args, info = steps.build_cell(cfg, shape, mesh)
    arg_bytes = sum(_local_bytes(a, s) for a, s in zip(args, info["in_shardings"]))
    p_abs = args[0]
    if shape.kind == "train":
        outs = (p_abs, args[1], {"loss": torch.empty((), device="meta")})
    else:
        cache = args[1] if shape.kind == "decode" else steps.abstract_cache(
            cfg, shape.global_batch, shape.seq_len)
        outs = (torch.empty((shape.global_batch, cfg.padded_vocab),
                            dtype=p_abs["embed"].dtype, device="meta"), cache)
    out_bytes = sum(_local_bytes(o, s) for o, s in zip(outs, info["out_shardings"]))
    alias_bytes = _local_bytes(args[1], info["out_shardings"][1]) if shape.kind == "decode" else 0
    return arg_bytes, out_bytes, alias_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun_results")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)

    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    rec = run_cell(arch, shape, mp, out_dir)
                except Exception:
                    failures += 1
                    tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                    print(f"FAIL {tag}", flush=True)
                    traceback.print_exc()
                    continue
                if rec["status"] == "skipped":
                    print(f"SKIP {rec['cell']}: {rec['reason']}", flush=True)
                else:
                    print(f"OK   {rec['cell']} compile={rec['compile_s']}s "
                          f"flops/dev={rec['cost']['flops']:.3e} "
                          f"coll_bytes/dev={rec['collectives']['total_bytes']:.3e}", flush=True)
    print(f"\ndry-run complete, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
