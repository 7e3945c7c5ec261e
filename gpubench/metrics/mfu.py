"""Model FLOPs of the request-steps served in the window's steps (real
requests only, each a whole image) over the steps' time at the tensor
cores' peak, in per cent."""
import importlib

from gpubench.reference import kind
from gpubench.work.peaks import TENSOR_FLOPS


def read(run):
    ticks = run.window_ticks
    secs = sum(t.dt for t in ticks)
    if not secs:
        return None
    kind(run.cfg)                   # raises unless both of the kind's files are there
    work = importlib.import_module(f"gpubench.work.{run.cfg['kind']}")
    per = {}
    total = 0.0
    for t in ticks:
        for s in t.stepped:
            r = s.arrival.res
            if r not in per:
                per[r] = work.flops(run.cfg, *r)
            total += per[r]
    return 100.0 * total / (secs * TENSOR_FLOPS)
