"""Whether what the timed path served is correct, decided once the window has
closed, the memory peak has been read and the program's state is freed.

A sample of the requests that the engine completed, drawn from the seed,
``per_resolution`` of each resolution among the window's requests (and one
of the largest resolution from the lead-in or drain if the window completed
none), is served again by the plain reference, each request alone as a whole
image from the same weights and inputs, drawn again from the seed. Numbers
compared, each beside its limit from the traffic file:

- ``latent_err``: the largest, over the sample, of max |program latent -
  reference latent| / max |reference latent| after all the steps: the
  served path (patching, CSP batching with other requests, halos, both
  kernels, the sampler) against the request alone;
- ``decode_err``: the largest max |program image - reference decode of the
  program's own final latent|: the VAE decode stage by itself;
- ``failed``: completed window requests with no image of the right shape
  or with a value that is not finite (limit 0);
- ``bookkeeping``: |completed + dropped + in flight - submitted| (limit 0);
- ``unsampled``: 1 where the engine completed nothing to compare (limit 0).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gpubench import inputs
from gpubench.reference import diffusion as ref


def well_formed(img, res) -> bool:
    return (img is not None and tuple(img.shape) == (8 * res[0], 8 * res[1], 3)
            and bool(np.isfinite(img).all()))


def draw_sample(run, per_resolution: int) -> List:
    """The completed requests to check, drawn from the run's seed."""
    rng = np.random.default_rng(inputs.stream_seed(run.seed, "sample"))
    done = [s for s in run.served if s.done is not None]
    largest = max((s.arrival.res for s in run.served), key=lambda r: r[0] * r[1], default=None)
    out = []
    for res in sorted({s.arrival.res for s in done}):
        pool = [s for s in done if s.arrival.counted and s.arrival.res == res]
        if not pool and res == largest:
            pool = [s for s in done if s.arrival.res == res]
        pick = rng.permutation(len(pool))[:per_resolution]
        out += [pool[int(i)] for i in sorted(pick)]
    return out


def bookkeeping(run) -> int:
    """|completed + dropped + in flight - submitted| by the program's request
    states, plus the requests whose end the harness saw otherwise."""
    states = [s.request.state for s in run.served]
    n = sum(st in ("done", "dropped", "waiting", "active") for st in states)
    odd = sum((s.done is not None) != (s.request.state == "done")
              or (s.dropped is not None) != (s.request.state == "dropped") for s in run.served)
    return abs(n - len(run.served)) + odd


def reference_readings(cfg: dict, traffic: dict, seed: int, arrivals, picks: List[int],
                       served: Dict[int, dict], device, tf32: bool = False) -> Dict[str, float]:
    """latent_err and decode_err of ``served`` ({arrival index: {"latent",
    "image"}}) against the reference; with ``tf32`` the reference's own
    TF32 run stands in the program's place (the control)."""
    weights = inputs.model_weights(cfg, seed, device)
    vae = inputs.vae_weights(cfg, seed, device)
    ins = inputs.request_inputs(cfg, [a.res for a in arrivals], seed, device)
    lat_err = dec_err = 0.0
    for i in picks:
        cond = inputs.conditioning(ins[i])
        z_ref = ref.sample(cfg, weights, ins[i]["latent"], cond, traffic["steps"])
        if tf32:
            z = ref.sample(cfg, weights, ins[i]["latent"], cond, traffic["steps"], tf32=True)
            img = ref.vae_decode(vae, z_ref, tf32=True)
            z_dec = z_ref
        else:
            z = served[i]["latent"].to(device).float()
            img = torch.as_tensor(served[i]["image"], device=device).float()
            z_dec = z
        lat_err = max(lat_err, float((z - z_ref).abs().max() / z_ref.abs().max()))
        dec_err = max(dec_err, float((img - ref.vae_decode(vae, z_dec)).abs().max()))
    del weights, vae, ins
    return {"latent_err": lat_err, "decode_err": dec_err}


def run_checks(run, served: Dict[int, dict], picks: List[int], device) -> Dict[str, dict]:
    """Every number compared with its limit, in the order they print."""
    limits = run.traffic["check"]["limits"]
    failed = sum(not well_formed(s.image, s.arrival.res) for s in run.counted if s.done is not None)
    checks: Dict[str, dict] = {}
    if picks:
        got = reference_readings(run.cfg, run.traffic, run.seed, run.arrivals, picks, served, device)
        for k, v in got.items():
            checks[k] = {"value": v, "limit": limits[k]}
    checks["unsampled"] = {"value": int(not picks), "limit": 0}
    checks["failed"] = {"value": failed, "limit": 0}
    checks["bookkeeping"] = {"value": bookkeeping(run), "limit": 0}
    return checks


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
