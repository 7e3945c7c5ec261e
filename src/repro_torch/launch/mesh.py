"""Mesh descriptions, the port of the reference's ``repro/launch/mesh.py``.

A ``Mesh`` here is a plain record of axis names and sizes: it creates no
process group and places nothing. The one-device mesh is what training on
one card needs; the production meshes describe the reference's 16x16 and
2x16x16 layouts and are refused on a machine with fewer devices. Sharding
over a ``torch.distributed`` DeviceMesh belongs to the distributed port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 multi-pod (512 devices);
    raises unless that many CUDA devices exist."""
    mesh = (Mesh(("pod", "data", "model"), (2, 16, 16)) if multi_pod
            else Mesh(("data", "model"), (16, 16)))
    have = torch.cuda.device_count()
    if have < mesh.size:
        raise RuntimeError(f"the production mesh {mesh.shape} needs {mesh.size} devices; "
                           f"{have} CUDA device(s) found")
    return mesh


def make_local_mesh(model: int = 1, data: int = 1) -> Mesh:
    """The one-device mesh (tests / examples / one card), as the reference's
    ``make_local_mesh`` gives on one device: ``data`` is cut to the one
    device, a ``model`` axis above 1 is refused."""
    if model > 1:
        raise ValueError(f"a local mesh of model={model} needs {model} devices; it has 1")
    return Mesh(("data", "model"), (1, 1))


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (includes 'pod' when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
