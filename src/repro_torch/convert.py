"""Parameters from the JAX reference, passed as numpy, into torch tensors.

Used by the parity tests. The port keeps the reference's layouts (conv
weights HWIO, activations NHWC, LM blocks stacked over periods), so
conversion copies every leaf as it is. bfloat16 leaves (numpy arrays of
``ml_dtypes.bfloat16``, which torch cannot read) are carried over bit for
bit through a 16-bit integer view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tree_from_numpy(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


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


def lm_params_from_numpy(tree, device=None):
    """The reference's ``lm.init_model(...)[0]`` (or an LM cache's
    ``"blocks"``) after ``tree_map(np.asarray, ...)`` -> torch."""
    return _tree_from_numpy(tree, resolve_device(device))
