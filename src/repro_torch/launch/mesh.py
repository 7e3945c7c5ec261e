"""Meshes over ``torch.distributed``, the port of the reference's
``repro/launch/mesh.py``.

A ``Mesh`` carries the reference's axis names and sizes (``mesh.shape`` is
the name -> size dict that ``jax.sharding.Mesh.shape`` gives) and, when a
process group exists, the ``DeviceMesh`` over it that places DTensors
(``repro_torch.launch.sharding``). Functions, never module-level constants,
so importing this module creates no process group.

- ``make_production_mesh``: the reference's 16x16 ("data", "model") or
  2x16x16 ("pod", "data", "model") layout over the current process group,
  which must have 256 or 512 ranks: the fake group of the dry-run, or a real
  cluster.
- ``make_local_mesh``: a ("data", "model") mesh over the live world. With no
  process group it is the one-device record (``device_mesh`` None): what a
  single-card train step or ``ElasticTrainer`` takes, and what places
  nothing; models then run their local code paths.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Optional[Any] = field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def _device_type() -> str:
    """The DeviceMesh's device type: CUDA under NCCL, else the CPU (gloo, and
    the fake backend of the dry-run). A CPU mesh places no tensor of the
    card (``sharding.place`` raises)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _over_world(axis_names: Tuple[str, ...], sizes: Tuple[int, ...]) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(_device_type(), sizes, mesh_dim_names=axis_names)
    return Mesh(axis_names, sizes, dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks) over the
    current process group; raises unless the group has exactly that many."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"the production mesh {dict(zip(axes, sizes))} needs {need} devices "
                           f"(a process group of {need} ranks); {have} rank(s) found")
    return _over_world(axes, sizes)


def make_local_mesh(model: int = 1, data: int = 1) -> Mesh:
    """A ("data", "model") mesh over the live world; ``data`` is cut to the
    ranks that ``model`` leaves, as the reference cuts it to the devices,
    and data x model must then be the world size. With no process group the
    world is this one device: the (1, 1) record, which places nothing, and a
    ``model`` axis above 1 is refused."""
    if not dist.is_initialized():
        if model > 1:
            raise ValueError(f"a local mesh of model={model} needs {model} devices; it has 1")
        return Mesh(("data", "model"), (1, 1))
    n = dist.get_world_size()
    data = min(data, max(n // model, 1))
    if data * model != n:
        raise ValueError(f"a local mesh of data={data} x model={model} does not cover "
                         f"the {n} ranks of the process group")
    return _over_world(("data", "model"), (data, model))


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (includes 'pod' when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
