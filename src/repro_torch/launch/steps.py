"""LM steps and the abstract inputs of one (arch x shape x mesh) cell, the
port of the reference's ``repro/launch/steps.py``.

Each ``make_*_step`` takes ``device``: ``None`` is the CUDA card (and raises
without one), ``device="cpu"`` runs the step on the CPU. A step moves its
batch (numpy arrays or tensors) to that device; the params, the optimizer
state and the cache must already be there. A DTensor batch passes as it is.

``abstract_params``, ``abstract_opt``, ``abstract_cache`` and
``input_specs`` are the reference's ``jax.eval_shape`` stand-ins: trees of
``meta`` tensors, which hold shapes and dtypes and allocate nothing.
``build_cell`` runs the same steps on DTensors placed by the reference's
``in_shardings`` and places their outputs by its ``out_shardings``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.launch import context as ctx
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import lm
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import opt_init, opt_update


def _batch_to(batch: dict, dev: torch.device) -> dict:
    from torch.distributed.tensor import DTensor
    return {k: v if isinstance(v, DTensor) else torch.as_tensor(v, device=dev)
            for k, v in batch.items()}


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


# ---------------------------------------------------------------------------
# Abstract trees (no allocation)
# ---------------------------------------------------------------------------

def abstract_params(cfg):
    """(params on ``meta``, logical specs): shapes and dtypes, no values."""
    return lm.build_model(cfg, None, "meta")


def abstract_opt(cfg, params):
    return opt_init(cfg, params)


def abstract_cache(cfg, batch: int, max_len: int):
    return lm.init_cache(cfg, batch, max_len, device="meta")


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """Model inputs for one step of the given ShapeSpec, as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len

    def f(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    i32, dt = torch.int32, torch_dtype(cfg)
    if shape.kind == "decode":   # one new token against a cache of length S
        return {"tokens": f((B, 1), i32)}
    S_tok = S - cfg.vlm_prefix if cfg.vlm_prefix else S
    batch = {"tokens": f((B, S_tok), i32)}
    if shape.kind == "train":
        batch["labels"] = f((B, S_tok), i32)
    if cfg.vlm_prefix:
        # frontend stub: precomputed ViT patch embeddings for the prefix
        batch["prefix_embeds"] = f((B, cfg.vlm_prefix, cfg.d_model), dt)
    if cfg.enc_layers:
        batch["enc_inputs"] = f((B, cfg.enc_seq, cfg.d_model), dt)
    return batch


def batch_shardings(cfg, mesh, batch_tree) -> Any:
    dp = dp_axes(mesh)
    if cfg.tp_mode == "dp" and "model" in mesh.axis_names:
        dp = dp + ("model",)

    def leaf(x):
        spec = [None] * len(x.shape)
        total = math.prod(mesh.shape[a] for a in dp)
        if x.shape[0] % total == 0:
            spec[0] = dp
        elif len(dp) > 1 and x.shape[0] % math.prod(mesh.shape[a] for a in dp[:-1]) == 0:
            spec[0] = dp[:-1]
        return shd.NamedSharding(mesh, tuple(spec))

    return {k: leaf(v) for k, v in batch_tree.items()}


# ---------------------------------------------------------------------------
# One (arch x shape x mesh) cell on DTensors
# ---------------------------------------------------------------------------

def build_cell(cfg, shape, mesh, params=None, opt=None, batch=None, cache=None
               ) -> Tuple[Any, Tuple, Dict[str, Any]]:
    """Returns (fn, args, info): ``fn(*args)`` is one train, prefill or
    decode step on DTensors over ``mesh.device_mesh``.

    ``fn`` places each argument by the reference's ``in_shardings`` (a
    tensor is cut locally, a DTensor redistributed, a ``meta`` tensor becomes
    empty shards), runs the step of ``make_*_step`` under the mesh context
    (the MoE's expert-parallel branch and the sequence-parallel constraints
    read it) and places its outputs by the reference's ``out_shardings``.
    Plain tensors that meet DTensors inside the step (positions, masks,
    constants) count as replicated.

    ``info`` holds ``in_shardings`` and ``out_shardings``, trees of
    ``NamedSharding`` in the order of the arguments and outputs.

    ``args`` holds ``params``, ``opt``, ``batch`` and ``cache`` where given,
    else their abstract (``meta``) trees: under ``FakeTensorMode`` those
    allocate nothing (the dry-run). A decode cell's cache is written in
    place, as the port's decode step writes it. Donation has no counterpart:
    the reference donates params and optimizer state (train) and the cache
    (decode) to its jit; here the step returns new params and moments beside
    the old ones, which live until the caller drops them.
    """
    p_abs, specs = abstract_params(cfg)
    pshard = shd.param_shardings(cfg, mesh, p_abs, specs)
    b_abs = input_specs(cfg, shape)
    bshard = batch_shardings(cfg, mesh, b_abs)
    rep = shd.replicated(mesh)
    dp = dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp)
    dev = torch.device(mesh.device_mesh.device_type)
    params = p_abs if params is None else params
    batch = b_abs if batch is None else {k: torch.as_tensor(v) for k, v in batch.items()}
    logits_shard = shd.NamedSharding(
        mesh, (dp if shape.global_batch % dp_total == 0 else None, "model"))

    def run(step, out_shardings, *placed):
        from torch.distributed.tensor.experimental import implicit_replication
        with ctx.use_mesh(mesh), implicit_replication():
            out = step(*placed)
        return tuple(shd.tree_place(o, s) for o, s in zip(out, out_shardings))

    if shape.kind == "train":
        o_abs = abstract_opt(cfg, p_abs)
        opt = o_abs if opt is None else opt
        oshard = shd.opt_shardings(cfg, mesh, o_abs, specs)
        step = make_train_step(cfg, device=dev)

        def fn(params, opt, batch):
            return run(step, (pshard, oshard, {"loss": rep}),
                       shd.tree_place(params, pshard), shd.tree_place(opt, oshard),
                       shd.tree_place(batch, bshard))
        return fn, (params, opt, batch), {"n_args": 3, "in_shardings": (pshard, oshard, bshard),
                                          "out_shardings": (pshard, oshard, {"loss": rep})}

    if shape.kind == "prefill":
        c_abs = abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cshard = shd.cache_shardings(cfg, mesh, c_abs, shape.global_batch)
        step = make_prefill_step(cfg, device=dev)

        def fn(params, batch):
            return run(step, (logits_shard, cshard),
                       shd.tree_place(params, pshard), shd.tree_place(batch, bshard))
        return fn, (params, batch), {"n_args": 2, "in_shardings": (pshard, bshard),
                                     "out_shardings": (logits_shard, cshard)}

    # decode
    seq_shard = shape.global_batch < dp_total
    c_abs = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cshard = shd.cache_shardings(cfg, mesh, c_abs, shape.global_batch, seq_shard=seq_shard)
    cache = c_abs if cache is None else cache
    step = make_decode_step(cfg, device=dev)

    def fn(params, cache, batch):
        return run(step, (logits_shard, cshard),
                   shd.tree_place(params, pshard), shd.tree_place(cache, cshard),
                   shd.tree_place(batch, bshard))
    return fn, (params, cache, batch), {"n_args": 3,
                                        "in_shardings": (pshard, cshard, bshard),
                                        "out_shardings": (logits_shard, cshard)}
