"""Ambient mesh context (a copy of the reference's ``repro/launch/context.py``).

Model code (e.g. the shard_map MoE dispatch) needs the mesh at trace time;
threading it through every forward signature would pollute the model API, so
the launcher sets it here around tracing. When unset, models use their local
(single-device) code paths — tests and examples never touch device state.
"""
from __future__ import annotations

import contextlib

_MESH = None


@contextlib.contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh():
    return _MESH
