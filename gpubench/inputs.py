"""What a run hands both the program and the reference, made from its seed on
the card in a few large calls: the weights, and each request's initial
noise latent and its conditioning (the rows its model kind names)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gpubench.reference import kind
from gpubench.reference.params import Spec, model_specs, vae_specs

# one stream of draws per purpose, from the run's seed
STREAMS = {"model": 1, "vae": 2, "requests": 3, "sample": 5}


def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from a seed of any size."""
    s = int(seed) % 2 ** 128
    ss = np.random.SeedSequence([s & (2 ** 64 - 1), s >> 64, STREAMS[purpose]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, purpose))


def draw_tree(specs: Sequence[Spec], gen: torch.Generator, device, dtype=torch.float32) -> dict:
    """A nested dict of tensors: every normal leaf a scaled slice of one draw."""
    n = sum(int(np.prod(shape)) for _, shape, init, _ in specs if init == "normal")
    buf = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, shape, init, scale in specs:
        if init == "normal":
            size = int(np.prod(shape))
            leaf = buf[off:off + size].view(shape).mul_(scale)
            off += size
        elif init == "ones":
            leaf = torch.ones(shape, device=device)
        else:
            leaf = torch.zeros(shape, device=device)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf.to(dtype)
    return tree


def model_weights(cfg: dict, seed: int, device) -> dict:
    return draw_tree(model_specs(cfg), generator(seed, "model", device), device,
                     getattr(torch, cfg["dtype"]))


def vae_weights(cfg: dict, seed: int, device) -> dict:
    return draw_tree(vae_specs(cfg), generator(seed, "vae", device), device)


def request_inputs(cfg: dict, resolutions: Sequence[Tuple[int, int]], seed: int,
                   device) -> List[Dict[str, torch.Tensor]]:
    """Per request i at latent side ``resolutions[i]``: ``latent`` (H, W, C0)
    standard normal noise, then each of the kind's ``conditioning`` rows
    ``(name, shape, scale)`` under its name, normal x scale. One draw for
    the latents and one a row, in the rows' order."""
    rows = kind(cfg).conditioning(cfg)
    gen = generator(seed, "requests", device)
    c0, n = cfg["latent_channels"], len(resolutions)
    sizes = [h * w * c0 for h, w in resolutions]
    lat = torch.randn(sum(sizes), generator=gen, device=device)
    cond = {name: torch.randn(n, *shape, generator=gen, device=device).mul_(scale)
            for name, shape, scale in rows}
    out, off = [], 0
    for i, ((h, w), size) in enumerate(zip(resolutions, sizes)):
        out.append({"latent": lat[off:off + size].view(h, w, c0),
                    **{name: c[i] for name, c in cond.items()}})
        off += size
    return out


def conditioning(req: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A request's inputs beyond its latent, by name."""
    return {k: v for k, v in req.items() if k != "latent"}
