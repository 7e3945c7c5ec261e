"""Parameters from the JAX reference, passed as numpy, into torch tensors.

Used by the parity tests. The port keeps the reference's layouts (conv
weights HWIO, activations NHWC), so conversion copies every leaf as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tree_from_numpy(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def diffusion_params_from_numpy(tree, device=None):
    """``init_diffusion`` output after ``tree_map(np.asarray, ...)`` -> torch."""
    return _tree_from_numpy(tree, resolve_device(device))


def vae_params_from_numpy(tree, device=None):
    """``init_vae`` output after ``tree_map(np.asarray, ...)`` -> torch."""
    return _tree_from_numpy(tree, resolve_device(device))


def mlp_params_from_numpy(tree, device=None):
    """A predictor MLP's fp32 params (``w1, b1, w2, b2`` and, for the
    latency model, ``w3, b3``) after ``tree_map(np.asarray, ...)`` -> torch."""
    return _tree_from_numpy(tree, resolve_device(device))
