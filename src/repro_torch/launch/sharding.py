"""Logical-axis -> mesh-axis mapping, the port of the reference's
``repro/launch/sharding.py``, with DTensor placements in place of
``NamedSharding``s over a TPU mesh.

Every parameter records logical axis names per dim (``ParamBuilder``); this
module turns those into shardings for a given mesh and config:

- TP over "model": heads / flattened kv / ff / vocab / experts / d_inner
- FSDP (cfg.fsdp): "embed" additionally sharded over "data" (ZeRO-3 style;
  pods hold replicas -> hierarchical DP all-reduce across the pod axis)
- EP: "experts" claims "model" when the expert count divides the axis,
  otherwise expert-internal "ff" claims it (mixtral: 8 experts < 16 chips)
- Any assignment whose dim is not divisible by the mesh-axis extent is
  dropped (conservative fallback to replication).

A spec is the reference's PartitionSpec as a tuple with one entry per tensor
dim: None, a mesh axis name, or a tuple of names that split the dim together
(``(None, ("data", "model"))``). ``placements`` turns it into one DTensor
placement per mesh dim. Where one tensor dim is split over several mesh axes,
DTensor orders the shards by mesh dim and JAX by the tuple's order; the two
agree only while the tuple follows the mesh's order, which ``placements``
asserts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh, dp_axes

Spec = Tuple[Any, ...]


def _parts(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Mesh
    spec: Spec

    @property
    def placements(self) -> List[Any]:
        return placements(self.mesh, self.spec)


def placements(mesh: Mesh, spec: Spec) -> List[Any]:
    """One DTensor placement per mesh dim: ``Shard(d)`` on each mesh axis
    that splits tensor dim d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out: List[Any] = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(spec):
        parts = _parts(entry)
        idx = [mesh.axis_names.index(a) for a in parts]
        assert idx == sorted(idx), (
            f"spec entry {entry!r} splits dim {d} over mesh axes out of the mesh's "
            f"order {mesh.axis_names}: DTensor would order its shards otherwise")
        for i in idx:
            assert isinstance(out[i], Replicate), (spec, mesh.axis_names)
            out[i] = Shard(d)
    return out


def spec_of(mesh: Mesh, places: Sequence[Any], ndim: int) -> Spec:
    """The inverse of ``placements``: a spec of ``ndim`` entries."""
    from torch.distributed.tensor import Replicate, Shard
    dims: List[List[str]] = [[] for _ in range(ndim)]
    for name, p in zip(mesh.axis_names, places):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"no spec for placement {p!r}")
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d) for d in dims)


def local_shape(mesh: Mesh, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of one rank's shard (every split is even)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _parts(entry))
        assert out[d] % n == 0, (shape, spec)
        out[d] //= n
    return tuple(out)


def place(x, sharding: NamedSharding):
    """``x`` as a DTensor placed by ``sharding``.

    - a DTensor is redistributed (the reshard of a jit's ``in_shardings``);
    - a tensor holding values (every rank holds the same) is cut locally,
      with no communication; a host tensor moves to the mesh's device (a
      batch made with numpy), a tensor on another device than the mesh's
      raises (a gloo group's mesh is a CPU mesh: it never takes a card's
      tensors to the host);
    - a ``meta`` tensor becomes empty local shards on the mesh's device: under
      ``FakeTensorMode`` (the dry-run) they allocate nothing.
    """
    from torch.distributed.tensor import DTensor, distribute_tensor
    dm = sharding.mesh.device_mesh
    pl = sharding.placements
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == tuple(pl) else x.redistribute(dm, pl)
    if x.device.type == "meta":
        loc = torch.empty(local_shape(sharding.mesh, sharding.spec, x.shape),
                          dtype=x.dtype, device=dm.device_type)
        return DTensor.from_local(loc, dm, pl, run_check=False, shape=x.shape,
                                  stride=x.stride())
    if x.device.type not in ("cpu", dm.device_type):
        raise ValueError(f"a tensor on {x.device} cannot be placed on a {dm.device_type} "
                         f"mesh: make the process group with NCCL for tensors on the card")
    return distribute_tensor(x.to(dm.device_type), dm, pl, src_data_rank=None)


def shard_index(device_mesh, dims: Sequence[int]) -> int:
    """This rank's chunk of a tensor dim split evenly over the mesh dims
    ``dims`` (outer to inner, DTensor's order)."""
    coord, idx = device_mesh.get_coordinate(), 0
    for i in sorted(dims):
        idx = idx * device_mesh.size(i) + coord[i]
    return idx


def tree_place(tree, shardings):
    """``place`` over a tree and its matching tree of shardings; non-tensor
    leaves (a cache's host ``cur_len``) pass through."""
    if isinstance(tree, dict):
        return {k: tree_place(v, shardings[k]) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return place(tree, shardings)


def _grad_placements(in_places: Sequence[Optional[List[Any]]], split: Sequence[int]
                     ) -> List[Optional[tuple]]:
    """The placements of the gradients that ``on_shards`` hands back: an
    input replicated over a mesh dim along which the ranks do different work
    (``split``) gets only its rank's part of the gradient there, a partial
    sum (the transpose of ``shard_map``'s unmapped input)."""
    from torch.distributed.tensor import Partial, Replicate
    return [None if pl is None else
            tuple(Partial() if isinstance(p, Replicate) and i in split else p
                  for i, p in enumerate(pl))
            for pl in in_places]


def on_shards(fn, mesh: Mesh, in_specs: Sequence[Optional[Spec]], out_places,
              split: Optional[Sequence[str]] = None):
    """The reference's ``shard_map``: ``fn`` runs on each rank's local
    shards, its inputs placed by ``in_specs`` (None for an argument that is
    not a tensor; a plain tensor is a global value that every rank holds)
    and its outputs wrapped as DTensors with ``out_places``
    (one placement list per output; a ``Partial`` placement is a pending
    ``psum``). Built on ``local_map``. ``split`` names the mesh axes along
    which the ranks do different work, which decides where a replicated
    input's gradient is a partial sum; by default, every axis that splits
    an input."""
    from torch.distributed.tensor.experimental import local_map
    in_places = [None if s is None else placements(mesh, s) for s in in_specs]
    if split is None:
        dims = {i for s in in_specs if s is not None for e in s for a in _parts(e)
                for i in [mesh.axis_names.index(a)]}
    else:
        dims = {mesh.axis_names.index(a) for a in split}
    mapped = local_map(fn, out_placements=out_places, in_placements=in_places,
                       in_grad_placements=_grad_placements(in_places, dims),
                       device_mesh=mesh.device_mesh, redistribute_inputs=True)

    def call(*args):
        # a plain tensor is a global value that every rank holds: cut it
        args = [place(a, NamedSharding(mesh, s)) if s is not None and isinstance(
            a, torch.Tensor) and not is_dtensor(a) else a for a, s in zip(args, in_specs)]
        return mapped(*args)
    return call


def model_mesh():
    """The ambient mesh (``launch.context``) when it has a "model" axis over
    a device mesh, else None: where the models take their distributed
    branches."""
    from repro_torch.launch import context
    mesh = context.current_mesh()
    if (mesh is None or "model" not in mesh.axis_names
            or getattr(mesh, "device_mesh", None) is None):
        return None
    return mesh


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# The reference's rules
# ---------------------------------------------------------------------------

def _rules(cfg, mesh: Mesh) -> Dict[Optional[str], Any]:
    model_ax = "model" if "model" in mesh.axis_names else None
    if cfg.tp_mode == "dp":
        # "model" axis carries batch instead; params replicate across it
        # (FSDP over "data" keeps them memory-feasible)
        model_ax = None
    expert_2d = (
        cfg.n_experts and model_ax and "data" in mesh.axis_names
        and cfg.n_experts % (mesh.shape["model"] * mesh.shape["data"]) == 0
    )
    expert_on_model = (
        cfg.n_experts and model_ax
        and cfg.n_experts % mesh.shape["model"] == 0
    )
    if expert_2d:
        expert_ax = ("data", "model")   # 2D EP: weights fully resident
    elif expert_on_model:
        expert_ax = model_ax
    else:
        expert_ax = None
    return {
        "vocab": model_ax,
        "heads_x_dim": model_ax,
        "kv_x_dim": model_ax,
        "ff": None if expert_on_model else model_ax,
        "experts": expert_ax,
        "d_inner": model_ax,
        "embed": "data" if (cfg.fsdp and "data" in mesh.axis_names) else None,
        "layers": None,
        None: None,
    }


def spec_for(cfg, mesh: Mesh, shape: Tuple[int, ...],
             axes: Tuple[Optional[str], ...]) -> Spec:
    rules = _rules(cfg, mesh)
    used = set()
    out = []
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax)
        parts = _parts(mesh_ax)
        extent = math.prod(mesh.shape[a] for a in parts)
        if not parts or any(a in used for a in parts) or dim % extent != 0:
            out.append(None)
        else:
            used.update(parts)
            out.append(mesh_ax)
    return tuple(out)


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def param_shardings(cfg, mesh: Mesh, abstract_params, specs) -> Any:
    """specs: logical-axis tree parallel to params (tuples at leaves)."""
    return _map2(lambda p, ax: NamedSharding(mesh, spec_for(cfg, mesh, tuple(p.shape), ax)),
                 abstract_params, specs)


def opt_shardings(cfg, mesh: Mesh, opt_abs, specs) -> Any:
    """Optimizer-state shardings derived from param logical axes.

    AdamW moments mirror params exactly; Adafactor's factored moments drop
    the reduced dim from the param spec (v_row: last dim, v_col: 2nd-to-last).
    """
    def mk(shape, axes):
        return NamedSharding(mesh, spec_for(cfg, mesh, tuple(shape), axes))

    out: Dict[str, Any] = {"step": replicated(mesh)}
    if "m" in opt_abs:  # adamw
        full = _map2(lambda p, ax: mk(p.shape, ax), opt_abs["m"], specs)
        out["m"] = full
        out["v"] = full
        return out

    def vr_axes(p, ax):
        return ax[:-1] if len(ax) > p.dim() else ax

    def vc_axes(p, ax):
        if p.dim() == 0:
            return ()
        return ax[:-2] + ax[-1:]

    out["v_row"] = _map2(lambda p, ax: mk(p.shape, vr_axes(p, ax)), opt_abs["v_row"], specs)
    out["v_col"] = _map2(lambda p, ax: mk(p.shape, vc_axes(p, ax)), opt_abs["v_col"], specs)
    return out


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """(B, S, ...) activations: batch over the DP axes."""
    return NamedSharding(mesh, (dp_axes(mesh),))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def cache_shardings(cfg, mesh: Mesh, abstract_cache, batch: int,
                    seq_shard: bool = False) -> Any:
    """Decode-cache shardings.

    Default: batch dim over DP axes, d_inner over model.
    seq_shard (long-context, batch too small to DP-shard): the sequence dim of
    attention caches is sharded over the DP axes instead (sequence
    parallelism); SSM states keep d_inner over model.
    """
    dp = dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp)
    batch_ok = batch % dp_total == 0 and batch >= dp_total

    def leaf(name, x):
        if name == "cur_len" or not isinstance(x, torch.Tensor) or x.dim() == 0:
            return replicated(mesh)
        spec: List[Any] = [None] * x.dim()
        # layouts: k/v (P,B,S,kv,hd) | ckv/krope (P,B,S,r) | ssm (P,B,di,st)
        # | conv (P,B,W-1,di)
        if name in ("k", "v", "ckv", "krope"):
            if batch_ok:
                spec[1] = dp
            elif seq_shard and x.shape[2] % dp_total == 0:
                spec[2] = dp
            if "model" in mesh.axis_names:
                tp = mesh.shape["model"]
                if name in ("k", "v"):
                    # prefer kv-heads; fall back to head_dim, then seq —
                    # a GQA cache must shard over "model" or it won't fit
                    if x.shape[3] % tp == 0:
                        spec[3] = "model"
                    elif x.shape[4] % tp == 0:
                        spec[4] = "model"
                    elif spec[2] is None and x.shape[2] % tp == 0:
                        spec[2] = "model"
                else:  # MLA compressed cache: shard seq over model
                    if spec[2] is None and x.shape[2] % tp == 0:
                        spec[2] = "model"
        elif name == "ssm":
            if batch_ok:
                spec[1] = dp
            if "model" in mesh.axis_names and x.shape[2] % mesh.shape["model"] == 0:
                spec[2] = "model"
        elif name == "conv":
            if batch_ok:
                spec[1] = dp
            if "model" in mesh.axis_names and x.shape[3] % mesh.shape["model"] == 0:
                spec[3] = "model"
        return NamedSharding(mesh, tuple(spec))

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf(name, tree)

    return walk(abstract_cache)
