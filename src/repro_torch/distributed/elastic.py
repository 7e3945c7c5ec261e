"""Elastic training: checkpoint/restart with mesh resizing + failure
handling, the port of the reference's ``repro/distributed/elastic.py``.

``ElasticTrainer`` wraps a train loop with the fault-tolerance contract:
- periodic async checkpoints (CheckpointManager);
- on a (simulated or real) device failure, rebuild a smaller mesh, restore
  the latest checkpoint onto the trainer's device in the dtypes of the
  params and optimizer state it replaces, and continue;
- straggler policy hook: a step exceeding ``straggler_factor`` x the rolling
  median is logged.

A step is timed on the host clock after a device synchronise, so a step's
time is its work and not its enqueue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device


@dataclass
class ElasticConfig:
    ckpt_every: int = 20
    straggler_factor: float = 4.0
    max_failures: int = 8


def device_count(dev: torch.device) -> int:
    """Devices of ``dev``'s type on this host (the CPU counts as one)."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ElasticTrainer:
    def __init__(self, make_mesh: Callable[[int], Any],
                 build_step: Callable[[Any], Callable],
                 ckpt: CheckpointManager, cfg: ElasticConfig = ElasticConfig(),
                 device=None):
        """make_mesh(n_devices)->mesh; build_step(mesh)->train_step(params,opt,batch).
        ``device``: ``None`` is the CUDA card (raises without one)."""
        self.make_mesh = make_mesh
        self.build_step = build_step
        self.ckpt = ckpt
        self.cfg = cfg
        self.device = resolve_device(device)
        self.failures = 0
        self.step_times: List[float] = []
        self.events: List[Dict] = []

    def run(self, params, opt, batches, start_step: int = 0,
            n_devices: Optional[int] = None,
            fail_at: Optional[Dict[int, int]] = None):
        """fail_at: {step: new_device_count} simulated failure schedule."""
        n = n_devices or device_count(self.device)
        mesh = self.make_mesh(n)
        step_fn = self.build_step(mesh)
        step = start_step
        metrics = None
        for batch in batches:
            if fail_at and step in fail_at:
                # simulated failure: shrink the mesh, restore from latest
                self.failures += 1
                if self.failures > self.cfg.max_failures:
                    raise RuntimeError("too many failures")
                n = fail_at[step]
                self.events.append({"step": step, "event": "remesh", "n": n})
                self.ckpt.wait()
                ck_step, state = self.ckpt.restore(target={"params": params, "opt": opt})
                params, opt = state["params"], state["opt"]
                step = ck_step
                mesh = self.make_mesh(n)
                step_fn = self.build_step(mesh)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            _sync(self.device)
            dt = time.perf_counter() - t0
            if (len(self.step_times) >= 5
                    and dt > self.cfg.straggler_factor
                    * float(np.median(self.step_times[-20:]))):
                self.events.append({"step": step, "event": "straggler",
                                    "dt": dt})
            self.step_times.append(dt)
            step += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt})
        self.ckpt.save(step, {"params": params, "opt": opt})
        self.ckpt.wait()
        return params, opt, step, metrics
