"""LM steps, the port of the reference's ``make_train_step``,
``make_prefill_step`` and ``make_decode_step`` (``repro/launch/steps.py``).

Each builder takes ``device``: ``None`` is the CUDA card (and raises without
one), ``device="cpu"`` runs the step on the CPU. A step moves its batch
(numpy arrays or tensors) to that device; the params, the optimizer state
and the cache must already be there.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import opt_update


def _batch_to(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def loss_and_grads(cfg, params, batch: dict):
    """(``lm_loss`` detached, the gradient of every leaf of ``params`` as a
    tree like it, each in its leaf's dtype; a leaf the loss does not reach
    gets zeros). Every leaf must be floating; ``batch`` holds tensors."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = lm.lm_loss(cfg, live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(live, list(grads))


def make_train_step(cfg, lr: float = 3e-4, device=None):
    """One optimizer step on ``lm_loss``. As in the reference, ``lr`` is not
    passed on: ``opt_update`` runs with its own default learning rate."""
    dev = resolve_device(device)

    def train_step(params, opt, batch):
        """-> (new params, new opt state, {"loss": fp32 scalar tensor})."""
        loss, grads = loss_and_grads(cfg, params, _batch_to(batch, dev))
        params, opt = opt_update(cfg, params, grads, opt)
        return params, opt, {"loss": loss}
    return train_step


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
