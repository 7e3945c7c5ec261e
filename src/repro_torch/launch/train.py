"""Training launcher: ``python -m repro_torch.launch.train --arch
internlm2-1.8b --steps 3`` trains a reduced config on the card (``--device
cpu`` for the CPU), the port of the reference's ``repro/launch/train.py``.

As in the reference, ``--smoke`` is a ``store_true`` flag that defaults to
true, so the command line always trains the reduced config.
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
from repro_torch.distributed.elastic import ElasticConfig, ElasticTrainer
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import opt_init


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help='"cpu" or a CUDA device; the default is the card')
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced() if args.smoke else ARCHS[args.arch]
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = opt_init(cfg, params)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq)
    ckpt = CheckpointManager(args.ckpt, keep=2)
    start = 0
    if args.resume:
        step, state = ckpt.restore(target={"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        pipe.restore({"step": step})
        start = step
        print(f"resumed from step {step}")

    trainer = ElasticTrainer(
        make_mesh=lambda n: make_local_mesh(),
        build_step=lambda mesh: make_train_step(cfg, device=dev),
        ckpt=ckpt, cfg=ElasticConfig(ckpt_every=max(args.steps // 2, 1)), device=dev)

    batches = (next(pipe) for _ in range(args.steps))
    t0 = time.time()
    params, opt, step, metrics = trainer.run(params, opt, batches,
                                             start_step=start)
    loss = float(metrics["loss"])
    print(f"arch={cfg.name} steps={step} loss={loss:.4f} "
          f"wall={time.time()-t0:.1f}s events={trainer.events}")
    return {"params": params, "opt": opt, "step": step, "loss": loss,
            "events": trainer.events}


if __name__ == "__main__":
    main()
