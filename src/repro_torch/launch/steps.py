"""LM serving steps, the port of the reference's ``make_prefill_step`` and
``make_decode_step`` (``repro/launch/steps.py``).

Each builder takes ``device``: ``None`` is the CUDA card (and raises without
one), ``device="cpu"`` runs the step on the CPU. A step moves its batch
(numpy arrays or tensors) to that device; the params and the cache must
already be there.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm


def _batch_to(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_prefill_step(cfg, device=None):
    dev = resolve_device(device)

    def prefill_step(params, batch):
        """-> (last-token logits (B, V), decode cache)."""
        b = _batch_to(batch, dev)
        logits, cache, _, _ = lm.forward(
            cfg, params, b["tokens"],
            prefix_embeds=b.get("prefix_embeds"),
            enc_inputs=b.get("enc_inputs"),
            mode="prefill")
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg, device=None):
    dev = resolve_device(device)

    def serve_step(params, cache, batch):
        """-> (logits (B, V), cache advanced by one token, updated in place)."""
        b = _batch_to(batch, dev)
        logits, cache, _, _ = lm.forward(
            cfg, params, b["tokens"], mode="decode", cache=cache)
        return logits[:, 0], cache
    return serve_step
