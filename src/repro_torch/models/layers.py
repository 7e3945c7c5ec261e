"""Parameter construction: the same tree paths and shapes as the reference's
``ParamBuilder`` (``src/repro/models/layers.py``), drawn from a
``torch.Generator``. Params are plain nested dicts of tensors; conv weights
keep the reference's HWIO layout."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.device import resolve_device

Params = Dict[str, Any]


class ParamBuilder:
    """Draws every tensor on the CPU from ``generator`` (a CPU generator), so
    a seed gives the same params on every device, then moves it to
    ``device``."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params: Params = {}

    def make(self, path: str, shape: Sequence[int], init: str = "normal",
             scale: Optional[float] = None) -> None:
        if init == "zeros":
            arr = torch.zeros(tuple(shape))
        elif init == "ones":
            arr = torch.ones(tuple(shape))
        elif init == "normal":
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            arr = torch.randn(tuple(shape), generator=self.generator) * scale
        else:
            raise ValueError(init)
        _tree_set(self.params, path, arr.to(self.device, self.dtype))


def _tree_set(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def tree_to(tree, device: torch.device):
    """Move every tensor of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
