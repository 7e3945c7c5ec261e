"""Latent diffusion backbones with native patched execution.

Two families mirroring the paper's evaluation models:
- ``unet`` (SDXL-analogue): ResBlocks (GroupNorm->SiLU->Conv3x3, timestep
  scale-shift) + transformer blocks (image-level self-attn via CSP groups,
  per-request cross-attn to text, FF), one down/up level with skip.
  Convolutions consume stitched halos; GroupNorm uses exact CSP stats
  (or the paper's per-patch mode).
- ``dit`` (SD3-analogue): pure transformer over 1x1-pixel tokens with
  adaLN timestep modulation — no convolution, so patched execution equals
  unpatched execution.

With ``use_kernels`` every GroupNorm+stitch of a ResBlock and of the output
head runs the fused CUDA kernel, every image self-attention the flash
attention kernel, and every product with a weight the fp32 GEMM kernel's
route rule (``patched_ops.matmul``; on CUDA tensors; CPU tensors take their
plain versions).

Every block is registered with a *kind* so the serving engine knows its
patch semantics: "pixel" blocks are per-patch independent, "context" blocks
need full-image context (cache-filled inputs, paper §5.1).

Requests inside one batch may sit at different denoising steps (paper
Fig. 1): the timestep embedding is per-request and broadcast per patch via
``csp.patch_req``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import patched_ops
from repro_torch.core.csp import CSP
from repro_torch.core.csp_device import csp_device
from repro_torch.core.patching import merge, split
from repro_torch.core.patched_ops import conv_nhwc, matmul, patch_request_index
from repro_torch.core.stitcher import gather_halo
from repro_torch.kernels.ops import fused_groupnorm_stitch, grouped_attention_kernel
from repro_torch.models.layers import ParamBuilder


@dataclass(frozen=True)
class DiffusionConfig:
    """``dtype`` is the params' dtype only. The timestep embedding and the
    engine's latents are fp32, and every product promotes as jnp does
    (``patched_ops.matmul``), so ``dtype="bfloat16"`` is bf16 weights with
    fp32 activations: the DiT's attention runs the fp32 kernel. The UNet at
    bf16 raises at its first convolution, as the reference's does
    (convolutions refuse mixed dtypes)."""
    name: str = "unet-lite"
    kind: str = "unet"            # unet | dit
    latent_channels: int = 4
    width: int = 64               # base channel count
    levels: int = 2               # unet: resolution levels (1 down/up pair per extra)
    blocks_per_level: int = 2
    attn_levels: Tuple[int, ...] = (1,)   # levels with transformer blocks
    dit_depth: int = 8            # dit: number of blocks
    n_heads: int = 4
    groups: int = 8               # GroupNorm groups
    d_text: int = 64              # text-embedding width (stub encoder)
    n_text: int = 8               # text tokens per prompt
    t_dim: int = 128              # timestep embedding
    steps: int = 50               # default denoising steps
    exact_stats: bool = True      # exact CSP GroupNorm vs paper per-patch
    use_kernels: bool = True      # the CUDA GroupNorm+stitch, attention and GEMM kernels
    dtype: str = "float32"


SDXL_LITE = DiffusionConfig(name="sdxl-lite", kind="unet")
SD3_LITE = DiffusionConfig(name="sd3-lite", kind="dit", dit_depth=8, width=64)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(R,) -> (R, dim) sinusoidal."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _conv_init(b: ParamBuilder, path: str, kh, kw, cin, cout):
    b.make(f"{path}/w", (kh, kw, cin, cout), scale=1.0 / math.sqrt(kh * kw * cin))
    b.make(f"{path}/b", (cout,), init="zeros")


def _gn_init(b: ParamBuilder, path: str, c):
    b.make(f"{path}/scale", (c,), init="ones")
    b.make(f"{path}/bias", (c,), init="zeros")


def _res_block_init(b: ParamBuilder, path: str, cin, cout, t_dim):
    _gn_init(b, f"{path}/gn1", cin)
    _conv_init(b, f"{path}/conv1", 3, 3, cin, cout)
    b.make(f"{path}/temb_w", (t_dim, 2 * cout))
    b.make(f"{path}/temb_b", (2 * cout,), init="zeros")
    _gn_init(b, f"{path}/gn2", cout)
    _conv_init(b, f"{path}/conv2", 3, 3, cout, cout)
    if cin != cout:
        _conv_init(b, f"{path}/skip", 1, 1, cin, cout)


def _attn_block_init(b: ParamBuilder, path: str, c, d_text):
    _gn_init(b, f"{path}/gn", c)
    for n in ("wq", "wk", "wv", "wo"):
        b.make(f"{path}/{n}", (c, c))
    b.make(f"{path}/xq", (c, c))
    b.make(f"{path}/xk", (d_text, c))
    b.make(f"{path}/xv", (d_text, c))
    b.make(f"{path}/xo", (c, c))
    _gn_init(b, f"{path}/gn_ff", c)
    b.make(f"{path}/ff1", (c, 4 * c))
    b.make(f"{path}/ff2", (4 * c, c))


def init_diffusion(cfg: DiffusionConfig, generator: torch.Generator, device=None):
    """Random params with the reference's tree paths and shapes."""
    b = ParamBuilder(generator, getattr(torch, cfg.dtype), device)
    C0 = cfg.latent_channels
    W = cfg.width
    b.make("temb_w1", (cfg.t_dim, cfg.t_dim))
    b.make("temb_b1", (cfg.t_dim,), init="zeros")
    b.make("temb_w2", (cfg.t_dim, cfg.t_dim))
    b.make("temb_b2", (cfg.t_dim,), init="zeros")

    if cfg.kind == "dit":
        b.make("tok_in", (C0, W))
        b.make("tok_in_b", (W,), init="zeros")
        b.make("adaln_w", (cfg.t_dim, 3 * W), scale=0.02)
        b.make("adaln_b", (3 * W,), init="zeros")
        for i in range(cfg.dit_depth):
            _attn_block_init(b, f"blk{i}", W, cfg.d_text)
        _gn_init(b, "out_norm", W)
        b.make("tok_out", (W, C0), scale=0.02)
        b.make("tok_out_b", (C0,), init="zeros")
        return b.params

    # unet
    _conv_init(b, "stem", 3, 3, C0, W)
    chans = [W * (2 ** lvl) for lvl in range(cfg.levels)]
    for lvl in range(cfg.levels):
        cin = chans[lvl]
        for i in range(cfg.blocks_per_level):
            _res_block_init(b, f"down{lvl}_res{i}", cin, cin, cfg.t_dim)
            if lvl in cfg.attn_levels:
                _attn_block_init(b, f"down{lvl}_attn{i}", cin, cfg.d_text)
        if lvl + 1 < cfg.levels:
            _conv_init(b, f"down{lvl}_ds", 3, 3, cin, chans[lvl + 1])
    cm = chans[-1]
    _res_block_init(b, "mid_res1", cm, cm, cfg.t_dim)
    _attn_block_init(b, "mid_attn", cm, cfg.d_text)
    _res_block_init(b, "mid_res2", cm, cm, cfg.t_dim)
    for lvl in reversed(range(cfg.levels)):
        cin = chans[lvl]
        if lvl + 1 < cfg.levels:
            _conv_init(b, f"up{lvl}_us", 3, 3, chans[lvl + 1], cin)
        for i in range(cfg.blocks_per_level):
            # concat skip -> 2*cin input
            _res_block_init(b, f"up{lvl}_res{i}", 2 * cin if i == 0 else cin,
                            cin, cfg.t_dim)
            if lvl in cfg.attn_levels:
                _attn_block_init(b, f"up{lvl}_attn{i}", cin, cfg.d_text)
    _gn_init(b, "out_norm", W)
    _conv_init(b, "out_conv", 3, 3, W, C0)
    return b.params


# ---------------------------------------------------------------------------
# Patched block implementations
# ---------------------------------------------------------------------------

def _gn_stitch(cfg: DiffusionConfig, csp: CSP, x: torch.Tensor, gp) -> torch.Tensor:
    """GroupNorm + halo, fused kernel when enabled; returns (P,p+2,p+2,C)."""
    if cfg.use_kernels:
        return fused_groupnorm_stitch(csp, x, gp["scale"], gp["bias"],
                                      cfg.groups, exact=cfg.exact_stats)
    n = patched_ops.patched_groupnorm(csp, x, gp["scale"], gp["bias"],
                                      cfg.groups, exact=cfg.exact_stats)
    return gather_halo(n, csp_device(csp, n.device).neighbors)


def _res_block(cfg, csp: CSP, p, x: torch.Tensor, temb_p: torch.Tensor) -> torch.Tensor:
    """x: (P, s, s, Cin); temb_p: (P, t_dim)."""
    h = _gn_stitch(cfg, csp, x, p["gn1"])
    h = F.silu(h)
    h = patched_ops.patched_conv(csp, None, p["conv1"]["w"], p["conv1"]["b"], haloed=h)
    ss = matmul(F.silu(temb_p), p["temb_w"], cfg.use_kernels) + p["temb_b"]   # (P, 2C)
    scale, shift = torch.chunk(ss, 2, dim=-1)
    h = h * (1 + scale[:, None, None, :]) + shift[:, None, None, :]
    h = _gn_stitch(cfg, csp, h, p["gn2"])
    h = F.silu(h)
    h = patched_ops.patched_conv(csp, None, p["conv2"]["w"], p["conv2"]["b"], haloed=h)
    if "skip" in p:   # a 1x1 conv: a product with the (Cin, Cout) weight
        x = matmul(x, p["skip"]["w"][0, 0], cfg.use_kernels) + p["skip"]["b"]
    return x + h


def _cross_attn(cfg, csp: CSP, p, x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """Pixel-wise cross-attention to the request's text tokens.
    x: (P, s, s, C); text: (R, T, d_text)."""
    P, s, _, C = x.shape
    n_heads, kern = cfg.n_heads, cfg.use_kernels
    hd = C // n_heads
    tx = text[patch_request_index(csp, x.device)]               # (P, T, dt)
    q = matmul(x.reshape(P, s * s, C), p["xq"], kern).reshape(P, s * s, n_heads, hd)
    k = matmul(tx, p["xk"], kern).reshape(P, -1, n_heads, hd)
    v = matmul(tx, p["xv"], kern).reshape(P, -1, n_heads, hd)
    sgn = torch.einsum("pqhd,pkhd->phqk", q.float(), k.float()) * hd ** -0.5
    o = torch.einsum("phqk,pkhd->pqhd", torch.softmax(sgn, -1), v.float())
    o = matmul(o.reshape(P, s * s, C).to(x.dtype), p["xo"], kern)
    return x + o.reshape(P, s, s, C)


def _self_attn(cfg, csp: CSP, p, x: torch.Tensor) -> torch.Tensor:
    """Image-level self-attention via CSP resolution groups."""
    C = x.shape[-1]
    if cfg.use_kernels:
        hd = C // cfg.n_heads

        def attn(imgs, _):
            n, H, Wd, _ = imgs.shape
            t = imgs.reshape(n, H * Wd, C)
            q = matmul(t, p["wq"], cfg.use_kernels).reshape(n, H * Wd, cfg.n_heads, hd)
            k = matmul(t, p["wk"], cfg.use_kernels).reshape(n, H * Wd, cfg.n_heads, hd)
            v = matmul(t, p["wv"], cfg.use_kernels).reshape(n, H * Wd, cfg.n_heads, hd)
            o = grouped_attention_kernel(q, k, v)
            o = matmul(o.reshape(n, H * Wd, C), p["wo"], cfg.use_kernels)
            return o.reshape(n, H, Wd, C)

        return x + patched_ops.per_image_apply(csp, x, attn)
    return x + patched_ops.grouped_self_attention(
        csp, x, p["wq"], p["wk"], p["wv"], p["wo"], cfg.n_heads)


def _attn_block(cfg, csp: CSP, p, x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    P, s, _, C = x.shape
    h = patched_ops.patched_groupnorm(csp, x, p["gn"]["scale"], p["gn"]["bias"],
                                      cfg.groups, exact=cfg.exact_stats)
    h = _self_attn(cfg, csp, p, h)
    h = _cross_attn(cfg, csp, p, h, text)
    hn = patched_ops.patched_groupnorm(csp, h, p["gn_ff"]["scale"], p["gn_ff"]["bias"],
                                       cfg.groups, exact=cfg.exact_stats)
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    ff = matmul(F.gelu(matmul(hn.reshape(P, s * s, C), p["ff1"], cfg.use_kernels),
                       approximate="tanh"), p["ff2"], cfg.use_kernels)
    return h + ff.reshape(P, s, s, C)


def _downsample(csp: CSP, p, x: torch.Tensor) -> torch.Tensor:
    """Stride-2 3x3 conv with halo: (P, s, s, C) -> (P, s/2, s/2, C').

    Matches image-level SAME stride-2 conv (padding right/bottom only for
    even sizes): windows start on even global rows, so only the right/bottom
    halo participates — drop the left/top halo row+col.
    """
    h = gather_halo(x, csp_device(csp, x.device).neighbors)[:, 1:, 1:, :]
    return conv_nhwc(h, p["w"], stride=2) + p["b"]


def _upsample(csp: CSP, p, x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 then 3x3 conv (halo at the upsampled scale)."""
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return patched_ops.patched_conv(csp, up, p["w"], p["b"])


def csp_at_level(csp: CSP, level: int) -> CSP:
    """Same grid/neighbors, halved spatial dims per level."""
    if level == 0:
        return csp
    f = 2 ** level
    return dataclasses.replace(csp, patch=csp.patch // f, res=csp.res // f,
                               group_res=csp.group_res // f)


# ---------------------------------------------------------------------------
# Block plan + forward
# ---------------------------------------------------------------------------

def block_plan(cfg: DiffusionConfig) -> List[Tuple[str, str, int]]:
    """[(name, kind, level)]; kind: 'pixel' | 'context'. The engine's cache
    manager keys caches by block name and treats kinds differently (§5.1)."""
    if cfg.kind == "dit":
        plan = [("tok_in", "pixel", 0)]
        plan += [(f"blk{i}", "context", 0) for i in range(cfg.dit_depth)]
        plan += [("tok_out", "pixel", 0)]
        return plan
    plan = [("stem", "context", 0)]
    for lvl in range(cfg.levels):
        for i in range(cfg.blocks_per_level):
            plan.append((f"down{lvl}_res{i}", "context", lvl))
            if lvl in cfg.attn_levels:
                plan.append((f"down{lvl}_attn{i}", "context", lvl))
        if lvl + 1 < cfg.levels:
            plan.append((f"down{lvl}_ds", "context", lvl))
    plan += [("mid_res1", "context", cfg.levels - 1),
             ("mid_attn", "context", cfg.levels - 1),
             ("mid_res2", "context", cfg.levels - 1)]
    for lvl in reversed(range(cfg.levels)):
        if lvl + 1 < cfg.levels:
            plan.append((f"up{lvl}_us", "context", lvl))
        for i in range(cfg.blocks_per_level):
            plan.append((f"up{lvl}_res{i}", "context", lvl))
            if lvl in cfg.attn_levels:
                plan.append((f"up{lvl}_attn{i}", "context", lvl))
    plan += [("out", "context", 0)]
    return plan


def denoise_patched(cfg: DiffusionConfig, params, csp: CSP, patches: torch.Tensor,
                    t_req: torch.Tensor, text: torch.Tensor,
                    block_hook: Optional[Callable] = None) -> torch.Tensor:
    """One model evaluation on a CSP patch batch.

    t_req: (R,) timestep per request (mixed steps in one batch, Fig. 1);
    text: (R, n_text, d_text). block_hook(name, kind, fn, x) -> x lets the
    cache manager interpose per block (None = plain execution).
    """
    seg = patch_request_index(csp, patches.device)
    temb = timestep_embedding(t_req, cfg.t_dim)
    kern = cfg.use_kernels
    temb = F.silu(matmul(temb, params["temb_w1"], kern) + params["temb_b1"])
    temb = matmul(temb, params["temb_w2"], kern) + params["temb_b2"]    # (R, t_dim)
    temb_p = temb[seg]                                            # (P, t_dim)

    run = block_hook or (lambda name, kind, fn, x: fn(x))

    if cfg.kind == "dit":
        x = run("tok_in", "pixel",
                lambda xx: matmul(xx, params["tok_in"], kern) + params["tok_in_b"], patches)
        mod = matmul(F.silu(temb), params["adaln_w"], kern) + params["adaln_b"]
        sc, sh, gate = torch.chunk(mod[seg], 3, dim=-1)
        for i in range(cfg.dit_depth):
            name = f"blk{i}"
            p = params[name]

            def blk(xx, p=p):
                h = xx * (1 + sc[:, None, None, :]) + sh[:, None, None, :]
                h = _attn_block(cfg, csp, p, h, text)
                return xx + gate[:, None, None, :] * (h - xx)

            x = run(name, "context", blk, x)
        x = patched_ops.patched_groupnorm(
            csp, x, params["out_norm"]["scale"], params["out_norm"]["bias"],
            cfg.groups, exact=cfg.exact_stats)
        return run("tok_out", "pixel",
                   lambda xx: matmul(xx, params["tok_out"], kern) + params["tok_out_b"], x)

    # unet
    x = run("stem", "context",
            lambda xx: patched_ops.patched_conv(csp, xx, params["stem"]["w"],
                                                params["stem"]["b"]), patches)
    skips = []
    level_csp = [csp_at_level(csp, lvl) for lvl in range(cfg.levels)]
    for lvl in range(cfg.levels):
        for i in range(cfg.blocks_per_level):
            x = run(f"down{lvl}_res{i}", "context",
                    lambda xx, lvl=lvl, i=i: _res_block(
                        cfg, level_csp[lvl], params[f"down{lvl}_res{i}"], xx, temb_p), x)
            if lvl in cfg.attn_levels:
                x = run(f"down{lvl}_attn{i}", "context",
                        lambda xx, lvl=lvl, i=i: _attn_block(
                            cfg, level_csp[lvl], params[f"down{lvl}_attn{i}"], xx,
                            text), x)
        skips.append(x)
        if lvl + 1 < cfg.levels:
            x = run(f"down{lvl}_ds", "context",
                    lambda xx, lvl=lvl: _downsample(level_csp[lvl],
                                                    params[f"down{lvl}_ds"], xx), x)
    lm = cfg.levels - 1
    x = run("mid_res1", "context",
            lambda xx: _res_block(cfg, level_csp[lm], params["mid_res1"], xx, temb_p), x)
    x = run("mid_attn", "context",
            lambda xx: _attn_block(cfg, level_csp[lm], params["mid_attn"], xx, text), x)
    x = run("mid_res2", "context",
            lambda xx: _res_block(cfg, level_csp[lm], params["mid_res2"], xx, temb_p), x)
    for lvl in reversed(range(cfg.levels)):
        if lvl + 1 < cfg.levels:
            x = run(f"up{lvl}_us", "context",
                    lambda xx, lvl=lvl: _upsample(level_csp[lvl],
                                                  params[f"up{lvl}_us"], xx), x)
        for i in range(cfg.blocks_per_level):
            if i == 0:
                x = torch.cat([x, skips[lvl]], dim=-1)
            x = run(f"up{lvl}_res{i}", "context",
                    lambda xx, lvl=lvl, i=i: _res_block(
                        cfg, level_csp[lvl], params[f"up{lvl}_res{i}"], xx, temb_p), x)
            if lvl in cfg.attn_levels:
                x = run(f"up{lvl}_attn{i}", "context",
                        lambda xx, lvl=lvl, i=i: _attn_block(
                            cfg, level_csp[lvl], params[f"up{lvl}_attn{i}"], xx,
                            text), x)

    def out_fn(xx):
        h = _gn_stitch(cfg, csp, xx, params["out_norm"])
        h = F.silu(h)
        return conv_nhwc(h, params["out_conv"]["w"]) + params["out_conv"]["b"]

    return run("out", "context", out_fn, x)


def denoise_image(cfg: DiffusionConfig, params, imgs: torch.Tensor,
                  t: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """Unpatched oracle: same-resolution batch (N, H, W, C) through a
    single-request-per-image CSP (each image = its own request)."""
    csp, patches = _batch_csp(imgs)
    out = denoise_patched(cfg, params, csp, patches, t, text)
    return torch.stack(merge(csp, out), dim=0)


def _batch_csp(imgs: torch.Tensor):
    """Whole images as single-patch requests => unpatched semantics."""
    return split([imgs[i] for i in range(imgs.shape[0])], patch=int(imgs.shape[1]))
