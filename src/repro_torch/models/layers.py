"""Shared functional layers and parameter construction with logical axes.

Params are plain nested dicts of tensors. ``ParamBuilder`` gives the same tree
paths and shapes as the reference's (``src/repro/models/layers.py``), drawn
from a ``torch.Generator``; conv weights keep the reference's HWIO layout.
Beside ``params`` it records ``specs``, the reference's tree of logical axis
names per dim, which ``repro_torch.launch.sharding`` maps onto a mesh.
The LM layers (norms, MLPs, RoPE) compute as the reference does: norms and
RoPE in fp32, the result cast back to the input's dtype.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

Params = Dict[str, Any]
Specs = Dict[str, Any]


class ParamBuilder:
    """Draws every tensor on the generator's device, then moves it to
    ``device`` in ``dtype``. A CPU generator (the diffusion models' choice)
    gives the same params on every device; a CUDA generator draws on the
    card, which the full-width LMs use so that billions of normals are not
    drawn on the host. On the ``meta`` device nothing is drawn or allocated
    (``generator`` may be ``None``): the tree holds shapes and dtypes only."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype = torch.float32, device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params: Params = {}
        self.specs: Specs = {}

    def make(self, path: str, shape: Sequence[int],
             axes: Optional[Sequence[Optional[str]]] = None, init: str = "normal",
             scale: Optional[float] = None) -> None:
        """``axes``: one logical axis name (or None) per dim; None for all
        dims replicated."""
        axes = (None,) * len(shape) if axes is None else tuple(axes)
        assert len(shape) == len(axes), (path, shape, axes)
        if init not in ("zeros", "ones", "normal"):
            raise ValueError(init)
        if self.device.type == "meta":
            arr = torch.empty(tuple(shape), dtype=self.dtype, device="meta")
        elif init == "zeros":
            arr = torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)
        elif init == "ones":
            arr = torch.ones(tuple(shape), dtype=self.dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            arr = torch.randn(tuple(shape), generator=self.generator,
                              device=self.generator.device)
            arr = arr.mul_(scale).to(self.device, self.dtype)
        _tree_set(self.params, path, arr)
        _tree_set(self.specs, path, axes)

    def submodule(self, prefix: str) -> "ParamBuilder":
        """A ``ParamBuilder`` whose params and specs form the subtrees at
        ``prefix``; it shares this one's generator, dtype and device."""
        sub = ParamBuilder(self.generator, self.dtype, self.device)
        _tree_set(self.params, prefix, sub.params)
        _tree_set(self.specs, prefix, sub.specs)
        return sub


def _tree_set(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in sorted key order (``jax.tree_util``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves: List):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, taken in the
    order of ``tree_leaves(tree)``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        return next(it)
    return rebuild(tree)


def tree_unzip(tree, n: int) -> Tuple:
    """A tree of n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in tree} for i in range(n))
    return tree


def tree_to(tree, device: torch.device):
    """Move every tensor of a nested dict to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def stack_params(trees: Sequence[Params]) -> Params:
    """Stack a list of identical param trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees), dim=0)


def stack_specs(spec: Specs) -> Specs:
    """The specs of a tree stacked by ``stack_params``: "layers" leads."""
    if isinstance(spec, dict):
        return {k: stack_specs(v) for k, v in spec.items()}
    return ("layers",) + tuple(spec)


def tree_index(tree, n: int):
    """Entry ``n`` of a tree stacked along its leading axis (views, no copy)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, n) for k, v in tree.items()}
    return tree[n]


def tree_unbind(tree) -> list:
    """Every entry of a tree stacked along its leading axis, as views. Under
    autograd the gradient of all of them reaches the stacked leaf in one
    stack, where indexing each entry would add a zero-padded full-size
    gradient per entry."""
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """On a DTensor, reduce pending partial sums now (an all-reduce on each
    mesh dim that holds one) rather than let DTensor carry them on: a
    gather of vocab-sharded logits leaves masked partial sums whose mask a
    later op loses, and a row-parallel product's sum carried into the next
    op lets DTensor split that op otherwise than the reference does."""
    places = getattr(x, "placements", ())
    if any(p.is_partial() for p in places):
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in places])
    return x


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding``. On a DTensor table split over its vocab dim, each
    rank looks up the tokens in its own rows (others read as zeros) and the
    partial sums are reduced at once: DTensor's own sharded lookup leaves
    masked partial sums, which the gradient cannot pass back through."""
    places = getattr(table, "placements", ())
    if not any(p.is_shard(0) for p in places):
        return reduce_partial(F.embedding(tokens, table))
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch import context
    from repro_torch.launch import sharding as shd
    mesh = context.current_mesh()
    vocab = [i for i, p in enumerate(places) if p.is_shard(0)]
    t_places = getattr(tokens, "placements", [Replicate()] * len(places))
    tok_spec = shd.spec_of(mesh, t_places, tokens.dim())
    tab_spec = shd.spec_of(mesh, [p if i in vocab else Replicate()
                                  for i, p in enumerate(places)], 2)
    out_places = [Partial() if i in vocab else Shard(p.dim) if p.is_shard() else p
                  for i, p in enumerate(t_places)]
    lo = shd.shard_index(mesh.device_mesh, vocab)

    def local(tok, tab):
        idx = tok.long() - lo * tab.shape[0]
        valid = (idx >= 0) & (idx < tab.shape[0])
        out = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab)
        return out * valid[..., None].to(out.dtype)
    out = shd.on_shards(local, mesh, [tok_spec, tab_spec], (out_places,))(tokens, table)
    return reduce_partial(out)


class _SumGradPartials(torch.autograd.Function):
    """The identity, whose backward sums the partial sums of a DTensor
    gradient at once (Megatron's "f": the all-reduce that a column-parallel
    product's input gradient needs)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last dim, for a weight w (in, out).

    On DTensors it fixes the layout that the reference's shardings give
    GSPMD, where DTensor would choose by collective bytes alone (and, for an
    FSDP weight, gather the activations and repeat the product on every
    rank):
    - w is gathered over each mesh dim on which its input dim is split and
      x's last dim is not, or its output dim is split and x's rows are (the
      FSDP weight gather);
    - a row-parallel product (both split over "model") is summed at once,
      as GSPMD's all-reduce sums it, and so is the partial gradient of x
      (DTensor would carry the partial sums on and split the next op
      otherwise);
    - an x split along a leading dim other than the first (the sequence,
      under ``tp_mode="sp"``) multiplies its local rows by the whole of w
      (the reference's weight gathers): folding the leading dims into one,
      as a matmul does, would turn that split into a strided one, which
      DTensor's matmuls do not take.
    """
    places = getattr(x, "placements", None)
    if places is None or not hasattr(w, "placements"):
        return x @ w
    from torch.distributed.tensor import Replicate
    x = reduce_partial(x)
    places = x.placements
    last = x.dim() - 1
    gathered = [Replicate() if (p.is_shard(0) and not places[i].is_shard(last)) or (
                    p.is_shard(1) and places[i].is_shard() and places[i].dim != last) else p
                for i, p in enumerate(w.placements)]
    if gathered != list(w.placements):
        w = w.redistribute(w.device_mesh, gathered)
    if x.requires_grad:
        x = _SumGradPartials.apply(x)
    if not any(p.is_shard() and 0 < p.dim < x.dim() - 1 for p in places):
        return reduce_partial(x @ w)
    from repro_torch.launch import context
    from repro_torch.launch import sharding as shd
    mesh = context.current_mesh()
    spec = shd.spec_of(mesh, places, x.dim())
    return shd.on_shards(torch.matmul, mesh, [spec, ()], (list(places),))(x, w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dt)


def apply_norm(cfg, x: torch.Tensor, p: Params) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p.get("bias"))


def init_norm(cfg, b: ParamBuilder, path: str, dim: int,
              dim_axis: Optional[str] = None) -> None:
    b.make(f"{path}/scale", (dim,), (dim_axis,), init="ones")
    if cfg.norm == "layernorm":
        b.make(f"{path}/bias", (dim,), (dim_axis,), init="zeros")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, b: ParamBuilder, d_model: int, d_ff: int) -> None:
    if cfg.mlp_type == "swiglu":
        b.make("w_gate", (d_model, d_ff), ("embed", "ff"))
        b.make("w_up", (d_model, d_ff), ("embed", "ff"))
        b.make("w_down", (d_ff, d_model), ("ff", "embed"))
    else:  # gelu
        b.make("w_up", (d_model, d_ff), ("embed", "ff"))
        b.make("w_down", (d_ff, d_model), ("ff", "embed"))
        if cfg.use_bias:
            b.make("b_up", (d_ff,), ("ff",), init="zeros")
            b.make("b_down", (d_model,), ("embed",), init="zeros")


def apply_mlp(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
        return linear(h, p["w_down"])
    h = linear(x, p["w_up"])
    if "b_up" in p:
        h = h + p["b_up"]
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    h = F.gelu(h, approximate="tanh")
    out = linear(h, p["w_down"])
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the two
    halves of head_dim against each other, as the reference does (not
    interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GroupNorm (whole image; the patched variant lives in core/) and the loss
# ---------------------------------------------------------------------------

def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int, eps: float = 1e-5) -> torch.Tensor:
    """x: (B, H, W, C) NHWC. Stats over (H, W, C//G) per group, in fp32."""
    B, H, W, C = x.shape
    xg = x.float().reshape(B, H, W, groups, C // groups)
    var, mu = torch.var_mean(xg, dim=(1, 2, 4), correction=0, keepdim=True)
    out = (xg - mu) * torch.rsqrt(var + eps)
    out = out.reshape(B, H, W, C) * scale + bias
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean xent over valid tokens; logits (..., V), labels int (...,)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = reduce_partial(torch.gather(logits, -1, labels[..., None].long()))[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
