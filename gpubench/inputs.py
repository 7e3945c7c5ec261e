"""What a run hands both the program and the reference, made from its seed on
the card in a few large calls: the weights, and each request's initial
noise latent and text embedding."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

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
    standard normal noise and ``text`` (n_text, d_text) normal x 0.3, the
    scale of the program's prompt-embedding stand-in. Two draws in all."""
    gen = generator(seed, "requests", device)
    c0, nt, dt = cfg["latent_channels"], cfg["n_text"], cfg["d_text"]
    sizes = [h * w * c0 for h, w in resolutions]
    lat = torch.randn(sum(sizes), generator=gen, device=device)
    txt = torch.randn(len(resolutions), nt, dt, generator=gen, device=device).mul_(0.3)
    out, off = [], 0
    for i, ((h, w), size) in enumerate(zip(resolutions, sizes)):
        out.append({"latent": lat[off:off + size].view(h, w, c0), "text": txt[i]})
        off += size
    return out
