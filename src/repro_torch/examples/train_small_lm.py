"""Train a reduced LM (any of the 10 assigned architectures) for a few steps
with a checkpoint every 4 steps and a restore — the training substrate.

    PYTHONPATH=src python -m repro_torch.examples.train_small_lm --device cpu [--arch mixtral-8x7b]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.layers import tree_to
from repro_torch.optim import opt_init

CKPT_EVERY = 4


def train(cfg, params, steps: int, ckpt_dir: str, device=None) -> dict:
    """``steps`` AdamW (or the config's optimizer) steps on
    ``TokenPipeline(batch=4, seq=64)`` from ``params``, a checkpoint every
    ``CKPT_EVERY`` steps, then the latest checkpoint restored. Returns the
    loss of each step, the params and the restored step."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    opt = opt_init(cfg, params)
    pipe = TokenPipeline(cfg.vocab_size, batch=4, seq=64)
    step_fn = make_train_step(cfg, device=dev)
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    losses = []
    for i in range(steps):
        params, opt, metrics = step_fn(params, opt, next(pipe))
        losses.append(float(metrics["loss"]))
        if (i + 1) % CKPT_EVERY == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt})
    ckpt.wait()
    restored, _ = ckpt.restore()
    return {"losses": losses, "params": params, "restored_step": restored}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu on request)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    # drawn on the host, so the card and the CPU start from the same weights
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    t0 = time.time()
    out = train(cfg, params, args.steps, args.ckpt, dev)
    losses = out["losses"]
    print(f"{cfg.name} on {dev}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({args.steps} steps, {time.time() - t0:.1f}s)")
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"checkpoint at step {out['restored_step']} restored OK")
    return out


if __name__ == "__main__":
    main()
