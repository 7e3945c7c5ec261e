"""Tiny VAE decoder + text-encoder stub (Preparation / Postprocessing stages).

Stand-ins for the pretrained pieces that bracket the denoising loop: a
pixel-shuffle conv decoder (x8 upsample, latent 4ch -> RGB) and a
hash-seeded Gaussian prompt embedding (bit-identical to the reference's).
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.patched_ops import conv_nhwc
from repro_torch.device import resolve_device
from repro_torch.models.layers import ParamBuilder


def init_vae(generator: torch.Generator, latent_channels: int = 4, width: int = 32,
             device=None):
    b = ParamBuilder(generator, torch.float32, device)
    b.make("conv1/w", (3, 3, latent_channels, width), scale=0.1)
    b.make("conv1/b", (width,), init="zeros")
    b.make("conv2/w", (3, 3, width, 3 * 64), scale=0.1)
    b.make("conv2/b", (3 * 64,), init="zeros")
    return b.params


def vae_decode(params, latent: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 4) -> (N, 8h, 8w, 3) via pixel shuffle."""
    h = conv_nhwc(latent, params["conv1"]["w"], padding=1) + params["conv1"]["b"]
    h = F.silu(h)
    h = conv_nhwc(h, params["conv2"]["w"], padding=1) + params["conv2"]["b"]
    N, hh, ww, _ = h.shape
    h = h.reshape(N, hh, ww, 8, 8, 3).permute(0, 1, 3, 2, 4, 5)
    return torch.tanh(h.reshape(N, hh * 8, ww * 8, 3))


def encode_prompt(prompt: str, n_text: int, d_text: int, device=None) -> torch.Tensor:
    """Deterministic prompt-embedding stub (frozen text encoder stand-in)."""
    seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(n_text, d_text)) * 0.3, dtype=torch.float32,
                           device=resolve_device(device))
