"""Arithmetic that several metric readers share."""
from __future__ import annotations

import importlib

import numpy as np


def attainment(run):
    """Per cent of counted requests that completed by their deadline; dropped
    and unfinished ones are misses."""
    counted = run.counted
    if not counted:
        return None
    return 100.0 * sum(s.met for s in counted) / len(counted)


def ratio_p90(run):
    """90th percentile over the counted requests that completed of latency
    (from the due time) over that request's SLO budget."""
    r = [s.latency / s.arrival.budget for s in run.counted if s.done is not None]
    return float(np.percentile(r, 90)) if r else None


def roofline_share(run, calls_key: str, work_module: str, kernels) -> float | None:
    """Per cent: the calls' summed bound over the kernels' device seconds;
    None where the recorder's count of calls differs from the launches the
    wrapper counted, since the bound would then leave calls out."""
    prof = run.profile
    if not prof or not prof[calls_key]:
        return None
    recorded, launched = prof.get("call_counts", {}).get(calls_key, (0, 0))
    if recorded != launched:
        return None
    secs = sum(prof["kernel_s"].get(k, 0.0) for k in kernels)
    if secs <= 0:
        return None
    work = importlib.import_module(f"gpubench.work.{work_module}")
    return 100.0 * sum(work.bound_s(c) for c in prof[calls_key]) / secs
