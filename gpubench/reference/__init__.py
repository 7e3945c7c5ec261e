"""Plain PyTorch reference of the served diffusion path: each request alone,
as a whole image. Imports nothing of the program under test.

A model kind is a plug-in: ``reference/<kind>.py`` beside ``work/<kind>.py``.
The reference module gives ``specs(cfg)`` (the denoiser's parameter rows),
``conditioning(cfg)`` (the per-request inputs beyond the latent, as ordered
``(name, shape, scale)`` rows), ``sample(cfg, P, latent, cond, steps,
tf32=False)`` (the request's final latent), ``TINY`` (a tiny CPU
configuration whose ``"kind"`` is the kind's name) and ``forward(ar, cfg, P,
x, t, **cond)`` (one denoiser evaluation, whose FLOPs a test counts); the
work module gives ``flops(cfg, H, W)``. A configuration names its kind
under ``"kind"``; nothing else in the harness knows the kinds."""
from __future__ import annotations

import importlib
import importlib.util
import re
from types import ModuleType

KIND = re.compile(r"^[a-z][a-z0-9_]*$")


def kind(cfg: dict) -> ModuleType:
    """The reference module of ``cfg["kind"]``, once both of the kind's files
    are found; otherwise a ``LookupError`` that names both."""
    name = cfg["kind"]
    mods = (f"{__name__}.{name}", f"gpubench.work.{name}")
    if not (KIND.match(str(name)) and all(importlib.util.find_spec(m) for m in mods)):
        raise LookupError(f"model kind {name!r} needs gpubench/reference/{name}.py and "
                          f"gpubench/work/{name}.py")
    return importlib.import_module(mods[0])

