#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
1. device: the card's name and power limit, the versions, the kernel build;
2. every CUDA kernel against its plain PyTorch version at the main path's
   shapes, with its time, the plain version's time, the library call's time
   (attention: scaled_dot_product_attention) and the least time the card could
   take: the largest of bytes over 3.35 TB/s and each kind of operation over
   its peak (GN-stitch: flops on CUDA cores; attention: the tensor-core MMAs
   of its route and the exponentials), each row's ``bound_by`` naming the
   term (the kernels line keeps "bytes" or "operations"); attention at the
   UNet's D = 32, at SD3-lite's own D = 16 and at public models' head dims
   (D = 40, 72, 80, 128, 160 at B = 1, S = 1024 and 4096, H = 16 for D = 72
   and 8 for the others, each row naming its kernel instance's width); the
   benchmark cells' fp32 shapes (``CELL_ATTENTION``), every call required on
   the wgmma route (``patch_attention.launches_by_route``, also printed for
   the main path's run and each model of phase 11); every
   D from 1 to 512 and D = 1024 in fp32, bf16 and fp16 at two small shapes,
   and D = 0 raising on the card. GN-stitch is the
   whole ``fused_groupnorm_stitch`` call (partial sums, then the stitch),
   timed inside a CUDA graph, which also shows it makes no host round trip;
   its two kernels are timed alone as well. Then the rest of what the TPU
   kernels take, off the main path, timed the same way: attention with keys
   of another length than the queries (4096 queries over PixArt-α's 120 and
   SD 1.5's 77 text tokens, and 77 over 4096), at D = 320 and 512 (column
   slices of the widest instance) at S = 1024 and 4096, and in fp16;
   GN-stitch at SD 1.5's widest level with per-channel statistics (G = C =
   1280, past the stitch's 512 shared-memory groups) and in fp16; and a
   sweep of G = 513, 640, 1024 and C in the three dtypes;
3. one SDXL-lite and one SD3-lite sampler step with the kernels against the
   same step through the plain path, and the UNet step's device time by
   kernel, the attention's kernel and combine summed, the GroupNorm+stitch
   path's two kernels summed, with device ops, memsets, host-to-device
   copies and stream synchronises per step;
4. the serving engine on SDXL-lite at full width and depth: calibrate, then a
   Poisson workload with the patch cache off (the main path, whose kernel
   launches are counted) and on, every output image checked;
5. the fleet: ``repro_torch.cluster.Cluster`` over three replicas whose
   engines run the real SDXL-lite step under the fleet's sim clock, once with
   ``resolution_affinity`` (each replica owns one resolution, so its patch is
   the latent: 64, 96 or 128) and once with ``round_robin`` (every replica
   has the whole ladder, patch 32), each run's kernel launches counted and
   every image checked; the GroupNorm+stitch call at the affinity replicas'
   patch sides (64/96/128 at level 0, 32/48/64 at level 1) against its plain
   version and timed in a CUDA graph beside its bound; one sampler step per
   affinity CSP against the plain step; and the paper's two predictors on
   the card: the latency MLP fitted to measured step latencies of every
   composition of 0-2 requests per resolution, and the cache-hit model
   refitted to phase 4's cache samples (both printed, neither a gate);
6. the LM serving forward (no kernel of its own: the JAX package's LM path
   reaches no Pallas kernel): (a) each of the ten architectures' reduced
   fp32 configs through one prefill step and one decode step on the card
   against the CPU, logits and every cache leaf at 1e-4; (b) internlm2-1.8b
   at full width and depth in bf16 with random weights drawn on the card:
   eight ragged prompts through ``seqpack.pack`` + ``packed_prefill`` against
   each request's own causal forward, a B=4 S=512 prefill step, 64 greedy
   decode steps, the first against the causal forward over S+1 tokens,
   prefill and decode ms beside their bounds, tokens/s, the device's busy
   share of a decode step and the peak memory; (c) one full-width period of
   mixtral-8x7b (S=4608: flash attention and a wrapped sliding-window ring)
   and two layers of falcon-mamba-7b (S=1024), each prefilled then decoded
   against the causal forward; and the SSM scan at falcon-mamba's width,
   the port's sequential loop against a log-step scan;
7. the LM training path (no kernel of its own either): (a) each of the ten
   architectures' reduced fp32 configs, ``lm_loss`` and every gradient leaf
   on the card against the CPU at 1e-4; one AdamW and one Adafactor update,
   card against CPU; the flash backward at ``tests/test_flash.py``'s four
   gradient cases against the dense autograd version on the card; the SSM
   scan's backward at falcon-mamba's width against autograd through a plain
   out-of-place loop, both timed; (b) internlm2-1.8b at full width and depth
   in bf16 with remat and AdamW (fp32 moments): ``make_train_step`` steps at
   B=2 S=2048 (flash attention forward and backward) on one repeated
   ``TokenPipeline`` batch, step ms beside its bound, tokens/s, the loss per
   step (finite, and below the first step's after it), peak memory, and one
   step under the profiler;
   (c) the launcher as the reference runs it (``--smoke``, reduced config):
   ``main()`` for 4 steps, then ``--resume``; an ``ElasticTrainer`` whose
   simulated failure remeshes and restores; and 4 straight steps equal to 2
   steps, a checkpoint, a restore and 2 more, bit for bit;
8. the distributed path (no kernel of its own: it reaches no Pallas
   kernel): (a) a one-rank NCCL group's ("data", "model") (1, 1)
   DeviceMesh; internlm2-1.8b at full width and depth in bf16 through
   ``build_cell``'s DTensor steps, each against the plain step on the same
   params and batch and timed beside it: a train step at B=2 S=2048 (loss
   and every updated param leaf), a B=4 S=512 prefill (logits and every
   cache leaf) and 8 decode steps (logits, every cache leaf); (b) one
   full-width period of mixtral-8x7b through the MoE's expert-parallel
   branch against the local path: loss and every gradient leaf at 49,152
   tokens (the weight-gather layout) and a B=4 decode step (token gather);
   (a) and (b) exact, since on one rank every local op is the plain op
   (the layouts' collectives are held only by the CPU tests on gloo);
   (c) four gloo ranks spawned on the host with their tensors on the card:
   ``quantized_psum`` against the same quantization on the host and the
   exact sum (the MoE layouts and the pipeline need gloo collectives that
   CUDA tensors do not get, so they run on the CPU only, in the tests);
   (d) the dry-run and roofline of internlm2-1.8b x train_4k and
   mixtral-8x7b x decode_32k on a fake 16x16 group, in a host-only
   subprocess: per-device flops, eager op bytes, argument bytes,
   collective bytes by kind, the H100 roofline terms and each cell's
   seconds;
9. the entry points (``repro_torch.examples`` and ``launch.serve``), each
   path's kernel launches counted from 0 and each kernel of it required to
   launch: (a) ``quickstart --full`` for SDXL-lite (latents 64²/96²/128²,
   patch 32, 29 patches) and SD3-lite (32²/48²/64², patch 16): three
   requests at steps 0, 10 and 30 batched against each alone through both
   kernels, every request at PSNR > 80 and those at steps 10 and 30 at max
   |batched - solo| < 1e-4, whether each is bitwise equal, and the
   ``split_kv`` each attention call took batched and alone; then the same
   for two requests at the smallest side beside one at the middle side, so
   that a batched attention group has B = 2 against B = 1 alone, and at
   least one batched group must take another ``split_kv`` than alone; (b) ``python
   -m repro_torch.launch.serve --cache`` (real clock): completed + dropped
   = submitted; (c) ``serve_hybrid_resolution --full`` on 2 s of Poisson
   arrivals: every image finite and of its size; (d) ``train_small_lm``
   (reduced internlm2-1.8b, fp32, 8 steps) each loss against the CPU's at
   1e-4, the loss falling, the restore at step 8; (e) the sim-clock demos
   (``slo_scheduler_demo.rows`` at qps 8 and 24 for 10 s, ``serve_cluster``'s
   policies on 5 s) equal on the card and the CPU; (f)
   ``calibrate_cache_hit_model --full``: its fit beside the checked-in one;
10. dtype: SD3-lite at full width and depth with ``dtype="bfloat16"`` (bf16
   weights; the latents and the timestep embedding are fp32, and every
   product promotes to fp32 as jnp does, so the attention kernel runs its
   fp32 instance at D = 16), beside the same weights in fp32: three
   ``PatchedServeEngine._denoise_step`` calls from step 40 of 50 on latents
   32²/48²/64² at patch 16 (29 patches) and on 48² + 2 × 32² (a B = 2
   attention group), the patch cache off and then on, the kernel route
   against the plain route at 1e-4 and PSNR > 80, the attention kernel's
   launches above 0, every latent finite and fp32; step ms and peak device
   memory of both dtypes beside phase 3's fp32 SD3-lite step;
11. heads: two public models' widths on the repo's own block structure,
   seed-0 weights drawn on the card: a PixArt-α-shaped DiT (28 blocks,
   width 1152, 16 heads: D = 72; nothing cut) and an SD 1.5-shaped UNet
   (320 x [1, 2, 4] channels, 2 res blocks a level, attention at every
   level, 8 heads: D = 40 / 80 / 160; GroupNorm 32; SD 1.5's fourth level,
   1280 channels without attention, left out): three
   ``_denoise_step`` calls from step 40 of 50 on latents 32²/48²/64² at
   patch 16 (and, for the DiT, 48² + 2 × 32²), cache off, kernel route
   against plain route within 1e-4 of the largest latent and at PSNR > 80,
   the attention (and for the UNet GN-stitch) launches above 0, the head
   dims and instance widths that ran, each route's peak device memory, and
   the engine step of both routes, the median of 5 in turns.

Every comparison phase runs with TF32 off for cuDNN convs and cuBLAS matmuls.
The last line is ``{"ok": true, "device": {...}}``; without CUDA, or if any
phase fails, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.cluster import Cluster, ClusterConfig, sim_engine_factory  # noqa: E402
from repro_torch.cluster.simtools import cluster_workload  # noqa: E402
from repro_torch.configs import ARCHS, torch_dtype  # noqa: E402
from repro_torch.core.csp_device import csp_device  # noqa: E402
from repro_torch.core.latency_model import (  # noqa: E402
    CacheHitModel, fit_cache_hit_model, fit_latency_model, make_features)
from repro_torch.core.patched_ops import patched_groupnorm  # noqa: E402
from repro_torch.core.patching import split  # noqa: E402
from repro_torch.core.requests import Request, poisson_workload  # noqa: E402
from repro_torch.core.seqpack import pack, packed_prefill, unpack_by_request  # noqa: E402
from repro_torch.core.serving import EngineConfig, PatchedServeEngine  # noqa: E402
from repro_torch.core.stitcher import gather_halo  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed.elastic import ElasticConfig, ElasticTrainer  # noqa: E402
from repro_torch.examples import calibrate_cache_hit_model as calibrate  # noqa: E402
from repro_torch.examples.common import psnr  # noqa: E402
from repro_torch.examples import quickstart as qs  # noqa: E402
from repro_torch.examples import serve_cluster as cluster_example  # noqa: E402
from repro_torch.examples import serve_hybrid_resolution as hybrid  # noqa: E402
from repro_torch.examples import slo_scheduler_demo as slo_demo  # noqa: E402
from repro_torch.examples import train_small_lm as train_example  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fp32_gemm as gemm  # noqa: E402
from repro_torch.kernels.fp32_gemm import fp32_gemm  # noqa: E402
from repro_torch.kernels.groupnorm_stitch import (  # noqa: E402
    gn_partials, gn_stitch, groupnorm_stitch)
from repro_torch.kernels.ops import fused_groupnorm_stitch  # noqa: E402
from repro_torch.kernels.patch_attention import (  # noqa: E402
    SLICE_WIDTH, block_q, column_slices, instance_width, patch_attention, split_kv)
from repro_torch.kernels.ref import (  # noqa: E402
    ref_attention, ref_gn_finalize, ref_gn_partials, ref_groupnorm_stitch)
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import context as ctx  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.steps import (batch_shardings, build_cell, loss_and_grads,  # noqa: E402
                                      make_decode_step, make_prefill_step, make_train_step)
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models.flash import flash_attention  # noqa: E402
from repro_torch.models.diffusion import (  # noqa: E402
    SD3_LITE, SDXL_LITE, DiffusionConfig, init_diffusion)
from repro_torch.models.layers import tree_leaves, tree_map, tree_to  # noqa: E402
from repro_torch.models.lm import build_model, forward, init_cache, init_model  # noqa: E402
from repro_torch.models.moe import ep_layout  # noqa: E402
from repro_torch.models.sampler import sampler_step  # noqa: E402
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,  # noqa: E402
                               adamw_update, opt_init)

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,            # GN-stitch: fp32 outside the tensor cores
              torch.bfloat16: 989e12, torch.float16: 989e12}
BF16_MMA_FLOPS = 989e12                        # dense tensor cores (bf16 and fp16), data sheet
TF32_MMA_FLOPS = 495e12                        # dense tensor cores (TF32), data sheet
EXP2_PER_S = 3.9e12                            # 16 ex2/clock/SM x 132 SMs x ~1.83 GHz
TOL = {torch.float32: {"gn": 1e-4, "attn": 1e-4},
       torch.bfloat16: {"gn": 2e-2, "attn": 3e-2},
       torch.float16: {"gn": 2e-2, "attn": 3e-2}}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
CHIP_RES = [(64, 64), (96, 96), (128, 128)]    # 512/768/1024-pixel SD requests
# (level, C) of SDXL-lite's GroupNorm+stitch calls: each level's ResBlocks, and
# the decoder's, whose input is the skip concatenation
GN_LEVELS = ((0, 64), (0, 128), (1, 128), (1, 256))
PUBLIC_HEAD_DIMS = (40, 72, 80, 128, 160)
# (B, S, Sk, H, D): keys of another length than the queries (PixArt-α's 120
# and SD 1.5's 77 text tokens under 4096 image queries, and the reverse), and
# head dims past the widest instance (column slices), each in fp32 and bf16
DOMAIN_ATTENTION = ((1, 4096, 120, 16, 72), (1, 4096, 77, 8, 40), (1, 77, 4096, 8, 40),
                    (1, 1024, 1024, 8, 320), (1, 4096, 4096, 8, 320),
                    (1, 1024, 1024, 8, 512), (1, 4096, 4096, 8, 512))
# (B, S, H, D) in fp16: the UNet's D = 32 row, PixArt-α's and SD 1.5's level 0
FP16_ATTENTION = ((2, 4096, 4, 32), (1, 4096, 16, 72), (1, 4096, 8, 40))
# (B, S, Sk, H, D) of the benchmark cells' fp32 attention (gpubench): SD 1.5's
# D = 40 / 80 / 160 at its levels' sequences, PixArt-α's D = 72, and the text
# keys (77, 120) under image queries; Sk None for S keys
CELL_ATTENTION = ([(1, S, None, 8, 40) for S in (4096, 9216, 16384)]
                  + [(1, S, None, 8, 80) for S in (1024, 2304, 4096)]
                  + [(1, S, None, 8, 160) for S in (256, 576, 1024)]
                  + [(1, S, None, 16, 72) for S in (1024, 2304, 4096)]
                  + [(1, 4096, 77, 8, 40), (1, 16384, 77, 8, 40), (1, 4096, 120, 16, 72),
                     (1, 1024, 77, 8, 160)])
# (M, N, K) of the benchmark cells' fp32 products: PixArt-α's projections
# and feed-forward at 4096 tokens (one 1024-px image) and its projections at
# 1024 (one 512-px image), its text K and V (16 patches x 120 tokens of
# 4096), SD 1.5's level-0 projections at 4096 pixels; and a ragged M, N, K
CELL_GEMMS = ((4096, 1152, 1152), (4096, 4608, 1152), (4096, 1152, 4608), (1024, 1152, 1152),
              (1920, 1152, 4096), (4096, 320, 320), (7400, 1150, 1148))
# (level, C, G) of GN-stitch past the stitch's shared statistics: SD 1.5's
# widest level with per-channel statistics, and with its own 32 groups
GN_DOMAIN = ((2, 1280, 1280), (2, 1280, 32))
# (C, G) of the groups sweep: past 512 groups, per-channel at SD 1.5's
# widths, two partials chunks, groups of two channels
GN_GROUPS = ((1026, 513), (640, 640), (2048, 1024), (1280, 1280))
KERNELS = {  # name -> (wrapper, source, TPU kernel it replaces)
    "groupnorm_stitch": (groupnorm_stitch, "src/repro_torch/kernels/csrc/groupnorm_stitch.cu",
                         "src/repro/kernels/groupnorm_stitch.py:128"),
    "patch_attention": (patch_attention, "src/repro_torch/kernels/csrc/patch_attention.cu",
                        "src/repro/kernels/patch_attention.py:72"),
}
# the fp32 GEMM replaces no TPU kernel (the reference leaves its products to
# XLA); it is counted beside KERNELS, whose per-step launch checks it leaves
GEMM_SOURCE = "src/repro_torch/kernels/csrc/fp32_gemm.cu"
# the two kernels inside one groupnorm_stitch call, each counted by its wrapper
GN_KERNELS = (gn_partials, gn_stitch)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Mean device milliseconds per call, by CUDA events around replays of a
    CUDA graph that holds ``calls`` calls, so that the host's launch overhead
    is not timed. The inputs stay in L2 between calls, as they do on the main
    path, where the producer ran just before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def attention_bound(B: int, S: int, H: int, D: int, dtype, Sk: int | None = None) -> tuple:
    """(least ms the card could take, the term that sets it) for S queries
    and Sk keys (S when None): the largest of q, k, v read and o written once
    over the HBM rate; the MMA flops over the 16-bit tensor-core peak, three
    passes for fp32 (3xbf16) and one for bf16 and fp16; and the B*H*S*Sk
    exponentials over the SFU rate."""
    Sk = S if Sk is None else Sk
    flops = 4 * B * H * S * Sk * D
    terms = {"bytes": 2 * B * (S + Sk) * H * D * (torch.finfo(dtype).bits // 8)
             / HBM_BYTES_PER_S,
             "exp": B * H * S * Sk / EXP2_PER_S}
    if dtype == torch.float32:
        terms["mma_3xbf16"] = 3 * flops / BF16_MMA_FLOPS
    else:
        terms[f"mma_{'bf16' if dtype == torch.bfloat16 else 'f16'}"] = flops / BF16_MMA_FLOPS
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    """(least ms the card could take, 'bytes' or 'operations')."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float, what: str,
            atol: float | None = None) -> float:
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol if atol is None else atol,
                               msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"[build] {lib} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary((lib.parent / "build.log").read_text()):
        log(f"[build] {line}")
    return smi


def ptxas_summary(text: str) -> list:
    """One line per entry function (every kernel instance of every source,
    by its mangled name) in nvcc's -Xptxas -v report: registers, shared
    memory and spills."""
    entries, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"name": m.group(1), "spills": "", "used": ""}
            entries.append(cur)
        elif cur and "spill" in line:
            cur["spills"] = line.strip()
        elif cur and "Used" in line:
            cur["used"] = line.split(":", 1)[1].strip()
            cur = None
    return [f"{e['name']}: {e['used']}; {e['spills']}" for e in entries]


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def gn_rows(dev, gen, level: int, C: int, res: list, patch: int, dtype, modes,
            G: int = 8) -> list:
    """The whole GroupNorm+stitch call with ``G`` groups on the CSP of
    ``res`` cut into ``patch``-sided patches, for each statistics mode in
    ``modes``: held against the plain composite and the plain version, and
    timed in a CUDA graph beside its bound, the plain version and each kernel
    alone."""
    imgs = [torch.randn(h, w, C, generator=gen).to(dev, dtype) for h, w in res]
    csp, patches = split(imgs, patch=patch)
    scale = torch.randn(C, generator=gen).to(dev)
    bias = torch.randn(C, generator=gen).to(dev)
    P, p = patches.shape[0], patches.shape[1]
    meta = csp_device(csp, dev)
    part = gn_partials(patches, G)
    # sums of p*p*C/G terms in another order, fp32 in both
    part_err = max_err(part, ref_gn_partials(patches, G), 1e-4,
                       f"gn_partials level {level} p={p} C={C} G={G} {dtype}", atol=1e-3)
    partials_ms = cuda_ms(lambda: gn_partials(patches, G))
    rows = []
    for exact in modes:
        def whole(exact=exact):
            return fused_groupnorm_stitch(csp, patches, scale, bias, G, exact=exact)

        def plain(exact=exact):   # the CPU path: partials, finalise, stitch
            mean, rstd = ref_gn_finalize(ref_gn_partials(patches, G),
                                         meta.patch_req_i32, meta.request_offset_i32,
                                         p, C, 1e-5, exact)
            return ref_groupnorm_stitch(patches, meta.neighbors_i32,
                                        mean.repeat_interleave(C // G, dim=-1),
                                        rstd.repeat_interleave(C // G, dim=-1),
                                        scale, bias)

        got = whole()
        want = gather_halo(patched_groupnorm(csp, patches, scale, bias, G,
                                             exact=exact), meta.neighbors)
        torch.cuda.synchronize()
        what = f"groupnorm_stitch level {level} p={p} C={C} G={G} {dtype} exact={exact}"
        err = max(max_err(got, want, TOL[dtype]["gn"], what),
                  max_err(got, plain(), TOL[dtype]["gn"], what + " (plain)"))
        ms = cuda_ms(whole)
        plain_ms = cuda_ms(plain)
        stitch_ms = cuda_ms(lambda exact=exact: gn_stitch(
            patches, part, meta.neighbors_i32, meta.patch_req_i32,
            meta.request_offset_i32, scale, bias, exact=exact))
        es = patches.element_size()
        # each input read once (patches, scale, bias, CSP metadata), the tiles written once
        n_bytes = (P * p * p * C * es + P * (p + 2) ** 2 * C * es + 2 * C * 4
                   + meta.neighbors_i32.nbytes + meta.patch_req_i32.nbytes
                   + meta.request_offset_i32.nbytes)
        # statistics: add, multiply, add per input element; normalise + affine: 4 per output
        bms, by = bound_ms(n_bytes, 3 * P * p * p * C + 4 * P * (p + 2) ** 2 * C, dtype)
        rows.append(dict(level=level, P=P, p=p, C=C, G=G, dtype=str(dtype).split(".")[1],
                         exact=exact, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         partials_ms=partials_ms, stitch_ms=stitch_ms,
                         partials_max_abs_err=part_err))
    return rows


def phase_kernels(dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    results = {"groupnorm_stitch": [], "patch_attention": [], "public_heads": [],
               "cell_heads": [], "domain_groupnorm_stitch": [], "domain_patch_attention": [],
               "fp32_gemm": []}
    # GN-stitch on the chip's three-request CSP: level 0 (p=32) and level 1 (p=16)
    for level, C in GN_LEVELS:
        f = 2 ** level
        res = [(h // f, w // f) for h, w in CHIP_RES]
        for dtype in (torch.float32, torch.bfloat16):
            for row in gn_rows(dev, gen, level, C, res, 32 // f, dtype, (True, False)):
                results["groupnorm_stitch"].append(row)
                log(f"[gn_stitch] {json.dumps(row)}")
    # attention at the UNet's level-1 sequences (D=32) and SD3-lite's (D=16,
    # B=1 at each of phase 10's sides);
    # q, k, v are strided views of one (B, S, 3, H, D) projection. B=1 is what
    # the main path runs (one request per resolution group), each of its three
    # S taking the split-KV path.
    for B, S, D in ((1, 1024, 32), (1, 2304, 32), (1, 4096, 32), (2, 1024, 32),
                    (2, 2304, 32), (2, 4096, 32), (1, 1024, 16), (1, 2304, 16),
                    (1, 4096, 16), (2, 1024, 16), (2, 4096, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            results["patch_attention"].append(attention_row(dev, gen, B, S, 4, D, dtype))
    # public models' head dims (phase 11's shapes): SD 1.5's UNet D = 40 / 80 /
    # 160 (H = 8), PixArt-α's and DiT-XL's D = 72 (H = 16), Flux's D = 128
    for D, S in itertools.product(PUBLIC_HEAD_DIMS, (1024, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            results["public_heads"].append(
                attention_row(dev, gen, 1, S, 16 if D == 72 else 8, D, dtype))
    # the benchmark cells' fp32 shapes, every call on the wgmma route
    before = dict(patch_attention.launches_by_route)
    for B, S, Sk, H, D in CELL_ATTENTION:
        results["cell_heads"].append(attention_row(dev, gen, B, S, H, D, torch.float32, Sk))
    routes = {r: n - before[r] for r, n in patch_attention.launches_by_route.items()}
    log(f"[attention cells] launches_by_route {routes}")
    if routes["mma_sync"]:
        raise RuntimeError(f"an fp32 call at the cells' shapes left the wgmma route: {routes}")
    # the fp32 GEMM at the cells' product shapes, each on the kernel's route
    for M, N, K in CELL_GEMMS:
        if gemm.route(torch.float32, dev, M, N, K) != "wgmma_3xtf32":
            raise RuntimeError(f"the cells' product {M}x{N}x{K} is off the GEMM kernel's route")
        results["fp32_gemm"].append(gemm_row(dev, gen, M, N, K))
    attention_dims_sweep(dev, gen)
    # the rest of what the TPU kernels take, off the main path: attention at
    # other key lengths, wider heads and in fp16; GN-stitch past 512 groups and
    # in fp16
    for (B, S, Sk, H, D), dtype in itertools.product(DOMAIN_ATTENTION, DTYPES[:2]):
        results["domain_patch_attention"].append(attention_row(dev, gen, B, S, H, D, dtype, Sk))
    for B, S, H, D in FP16_ATTENTION:
        results["domain_patch_attention"].append(
            attention_row(dev, gen, B, S, H, D, torch.float16))
    gn_cases = [(lvl, C, G, dtype) for (lvl, C, G), dtype in itertools.product(GN_DOMAIN,
                                                                              DTYPES[:2])]
    gn_cases += [(lvl, C, 8, torch.float16) for lvl, C in GN_LEVELS]
    for level, C, G, dtype in gn_cases:
        f = 2 ** level
        for row in gn_rows(dev, gen, level, C, [(h // f, w // f) for h, w in CHIP_RES],
                           32 // f, dtype, (True, False), G):
            results["domain_groupnorm_stitch"].append(row)
            log(f"[gn_stitch] {json.dumps(row)}")
    gn_groups_sweep(dev, gen)
    return results


def gn_groups_sweep(dev, gen) -> None:
    """GN-stitch past the stitch's 512 shared-memory groups (``GN_GROUPS``)
    in the three dtypes and both statistics modes, on a two-request CSP of
    8-sided patches, against the plain composite; the worst error per G."""
    t0 = time.perf_counter()
    for dtype in DTYPES:
        worst = {}
        for (C, G), exact in itertools.product(GN_GROUPS, (True, False)):
            imgs = [torch.randn(h, h, C, generator=gen).to(dev, dtype) for h in (16, 24)]
            csp, patches = split(imgs, patch=8)
            scale, bias = torch.randn(2, C, generator=gen).to(dev).unbind(dim=0)
            got = fused_groupnorm_stitch(csp, patches, scale, bias, G, exact=exact)
            want = gather_halo(patched_groupnorm(csp, patches, scale, bias, G, exact=exact),
                               csp_device(csp, dev).neighbors)
            err = max_err(got, want, TOL[dtype]["gn"],
                          f"groupnorm_stitch C={C} G={G} {dtype} exact={exact}")
            worst[G] = max(worst.get(G, 0.0), err)
        log(f"[gn_stitch groups] {str(dtype).split('.')[1]} (tol {TOL[dtype]['gn']:g}), "
            f"C/G {[f'{C}/{G}' for C, G in GN_GROUPS]}, exact and per-patch: max abs err by G "
            f"{ {g: float(f'{e:.3e}') for g, e in worst.items()} }")
    log(f"[gn_stitch groups] {time.perf_counter() - t0:.1f} s")


def attention_row(dev, gen, B: int, S: int, H: int, D: int, dtype,
                  Sk: int | None = None) -> dict:
    """The attention kernel at one shape (S queries; Sk keys, S when None)
    against ``ref_attention``, timed beside the plain version, SDPA and its
    bound."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if Sk is None:
        qkv = torch.randn(B, S, 3, H, D, generator=gen).to(dev, dtype)
        q, k, v = qkv.unbind(dim=2)
    else:
        q = torch.randn(B, S, H, D, generator=gen).to(dev, dtype)
        k, v = torch.randn(B, Sk, 2, H, D, generator=gen).to(dev, dtype).unbind(dim=2)
    Sk = k.shape[1]
    got = patch_attention(q, k, v)
    want = ref_attention(q, k, v)
    torch.cuda.synchronize()
    err = max_err(got, want, TOL[dtype]["attn"],
                  f"patch_attention S={S} Sk={Sk} D={D} {dtype}")
    ms = cuda_ms(lambda: patch_attention(q, k, v))
    plain = cuda_ms(lambda: ref_attention(q, k, v), calls=2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))
    bms, term = attention_bound(B, S, H, D, dtype, Sk)
    row = dict(B=B, S=S, Sk=Sk, H=H, D=D, width=instance_width(min(D, SLICE_WIDTH)),
               slices=column_slices(D), dtype=str(dtype).split(".")[1],
               n_split=split_kv(B, S, H, n_sm, block_q(dtype, D), Sk, column_slices(D)),
               max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
               bound_by=term, library_ms=lib_ms)
    log(f"[attention] {json.dumps(row)}")
    return row


def gemm_errors(got: torch.Tensor, exact: torch.Tensor) -> tuple:
    """(RMS error over the RMS of ``exact``, max abs error) against fp64."""
    d = got.double() - exact
    return float(d.pow(2).mean().sqrt() / exact.pow(2).mean().sqrt()), float(d.abs().max())


def gemm_row(dev, gen, M: int, N: int, K: int) -> dict:
    """The fp32 GEMM kernel at one (M, N, K) against an fp64 product, beside
    ``torch.matmul`` in fp32 (TF32 off: cuBLAS's FFMA kernels), with two
    bounds: three TF32 passes at 495 TFLOP/s (or the bytes, a read once, the
    weight's two halves once, c written once, if larger) and the work once
    at 989 TFLOP/s, the peak ``mfu`` uses. Its errors must be at most 2x
    torch's, RMS and max."""
    a = torch.randn(M, K, generator=gen).to(dev)
    w = (torch.randn(K, N, generator=gen) * K ** -0.5).to(dev)
    exact = a.double() @ w.double()
    before = fp32_gemm.launches
    got = fp32_gemm(a, w)
    torch.cuda.synchronize()
    if fp32_gemm.launches != before + 1:
        raise RuntimeError(f"fp32_gemm {M}x{N}x{K}: launches {before} -> {fp32_gemm.launches}")
    rms, mx = gemm_errors(got, exact)
    t_rms, t_mx = gemm_errors(a @ w, exact)
    if rms > 2 * t_rms or mx > 2 * t_mx:
        raise RuntimeError(f"fp32_gemm {M}x{N}x{K}: error RMS {rms:.3e} max {mx:.3e} against "
                           f"torch.matmul's {t_rms:.3e} {t_mx:.3e}")
    flops = 2 * M * N * K
    n_bytes = 4 * (M * K + 2 * N * K + M * N)
    bound3 = max(3 * flops / TF32_MMA_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
    ms = cuda_ms(lambda: fp32_gemm(a, w))
    row = dict(M=M, N=N, K=K, tile_n=gemm.tile_n(M, N, torch.cuda.get_device_properties(
        dev).multi_processor_count), ms=ms, torch_ms=cuda_ms(lambda: a @ w),
        bound_ms=bound3, bound_by="mma_3xtf32" if 3 * flops / TF32_MMA_FLOPS * 1e3 >= bound3
        else "bytes", bound_1x_ms=flops / BF16_MMA_FLOPS * 1e3,
        tflops=flops / ms / 1e9, rms_err=rms, max_abs_err=mx, torch_rms_err=t_rms,
        torch_max_abs_err=t_mx)
    row["share_of_bound"] = row["bound_ms"] / ms
    log(f"[fp32_gemm] {json.dumps(row)}")
    return row


def attention_dims_sweep(dev, gen) -> None:
    """Every head dim from 1 to 512 in the three dtypes against
    ``ref_attention`` at two small shapes (one split-KV), and D = 1024 once;
    the worst error per instance width (past the widest: per count of
    column slices); and D = 0 raising on the card."""
    t0 = time.perf_counter()
    for dtype in DTYPES:
        worst = {}
        cases = itertools.chain(
            itertools.product(range(1, 2 * SLICE_WIDTH + 1), ((1, 100, 2), (2, 65, 1))),
            [(4 * SLICE_WIDTH, (1, 100, 2))])
        for D, (B, S, H) in cases:
            q, k, v = torch.randn(B, S, 3, H, D, generator=gen).to(dev, dtype).unbind(dim=2)
            got = patch_attention(q, k, v)
            err = max_err(got, ref_attention(q, k, v), TOL[dtype]["attn"],
                          f"patch_attention B={B} S={S} H={H} D={D} {dtype}")
            w = instance_width(D) if D <= SLICE_WIDTH else f"{column_slices(D)}x{SLICE_WIDTH}"
            worst[w] = max(worst.get(w, 0.0), err)
        log(f"[attention dims] D = 1..{2 * SLICE_WIDTH} and {4 * SLICE_WIDTH} "
            f"{str(dtype).split('.')[1]} (tol {TOL[dtype]['attn']:g}): max abs err by instance "
            f"width (past {SLICE_WIDTH}: column slices x width) "
            f"{ {w: float(f'{e:.3e}') for w, e in worst.items()} }")
    x = torch.zeros(1, 16, 2, 0, device=dev)
    try:
        patch_attention(x, x, x)
    except ValueError as e:
        log(f"[attention dims] D = 0 raises on the card: {e}")
    else:
        raise RuntimeError("patch_attention took head dim 0")
    log(f"[attention dims] {time.perf_counter() - t0:.1f} s")


def reset_launches() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    for fn in GN_KERNELS:
        fn.launches = 0
    patch_attention.launches_by_route = dict.fromkeys(patch_attention.launches_by_route, 0)
    fp32_gemm.launches = 0
    fp32_gemm.launches_by_route = dict.fromkeys(gemm.ROUTES, 0)


def check_gn_kernels() -> None:
    """Each counted GroupNorm+stitch call launched both of its kernels."""
    n = [fn.launches for fn in GN_KERNELS]
    if n != [groupnorm_stitch.launches] * 2:
        raise RuntimeError(f"gn_partials/gn_stitch launches {n} for "
                           f"{groupnorm_stitch.launches} groupnorm_stitch calls")


def launches() -> dict:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def timed_step(fn) -> tuple:
    """(result, host ms) of one call that ends in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_step(fn, n: int = 3) -> None:
    """Device time by kernel over ``n`` warm calls, the device busy share, and
    per step: device ops, the GroupNorm+stitch path's device time, memsets,
    host-to-device copies and stream synchronises."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time for e in kernels)
    log(f"[profile] {n} steps: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {len(kernels)} device ops")
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {us / 1e3 / n:9.4f} ms/step  {100 * us / busy_us:5.1f}%  {name[:110]}")
    for kernel in ("gn_partials_kernel", "gn_stitch_kernel", "patch_attention_kernel",
                   "patch_attention_combine"):
        us = sum(t for name, t in by_name.items() if kernel in name)
        log(f"[profile] {kernel}: {us / 1e3 / n:.4f} ms/step, {100 * us / busy_us:.2f}%")
    us = sum(t for name, t in by_name.items() if "patch_attention_" in name)
    log(f"[profile] attention (kernel + combine): {us / 1e3 / n:.4f} ms/step, "
        f"{100 * us / busy_us:.2f}% of device time")
    us = sum(t for name, t in by_name.items()
             if "gn_partials_kernel" in name or "gn_stitch_kernel" in name)
    memset = [e for e in kernels if e.name.startswith("Memset")]
    log(f"[profile] GroupNorm+stitch path (gn_partials_kernel + gn_stitch_kernel): "
        f"{us / 1e3 / n:.4f} ms/step, {100 * us / busy_us:.2f}% of device time; memsets "
        f"{len(memset) / n:.1f}/step, {sum(e.device_time for e in memset) / 1e3 / n:.4f} ms/step")
    names = [e.name for e in prof.events()]
    h2d = sum(1 for e in kernels if e.name.startswith("Memcpy HtoD"))
    log(f"[profile] per step: {len(kernels) / n:.1f} device ops, {h2d / n:.1f} host-to-device "
        f"copies, {names.count('cudaMemcpyAsync') / n:.1f} cudaMemcpyAsync, "
        f"{names.count('cudaStreamSynchronize') / n:.1f} cudaStreamSynchronize")


def phase_step(dev) -> dict:
    """Returns each model's kernel-route step ms."""
    rng = np.random.default_rng(1)
    step_ms = {}
    cases = ((SDXL_LITE, CHIP_RES, 36), (SD3_LITE, [(32, 32), (64, 64)], 16))
    for cfg, res, per_step in cases:
        params = init_diffusion(cfg, torch.Generator().manual_seed(0), device=dev)
        imgs = [torch.as_tensor(rng.normal(size=(h, w, cfg.latent_channels)),
                                dtype=torch.float32, device=dev) for h, w in res]
        text = torch.as_tensor(rng.normal(size=(len(res), cfg.n_text, cfg.d_text)),
                               dtype=torch.float32, device=dev)
        steps = torch.as_tensor([3, 17, 42][:len(res)])
        csp, patches = split(imgs)
        outs, ms = {}, {}
        for use in (True, False):
            c = dataclasses.replace(cfg, use_kernels=use)
            step = lambda c=c: sampler_step(c, params, csp, patches, steps, 50, text)  # noqa: E731
            reset_launches()
            outs[use], _ = timed_step(step)
            n = sum(launches().values())
            if use and n != per_step:
                raise RuntimeError(f"{cfg.name}: {n} kernel launches per step, "
                                   f"expected {per_step}")
            check_gn_kernels()
            ms[use] = min(timed_step(step)[1] for _ in range(3))
        err = max_err(outs[True], outs[False], 1e-3, f"{cfg.name} sampler_step")
        log(f"[step] {cfg.name} res={res} P={csp.total} p={csp.patch} kernel launches/step="
            f"{per_step} max_abs_err={err:.3e} (tol 1e-3) step ms: kernels {ms[True]:.3f} "
            f"plain {ms[False]:.3f}")
        step_ms[cfg.name] = ms[True]
        if cfg.kind == "unet":
            profile_step(lambda: sampler_step(cfg, params, csp, patches, steps, 50, text))
    return step_ms


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def serve(dev, params, use_cache: bool) -> tuple:
    """Calibrate an SDXL-lite engine, then serve a Poisson workload; returns
    (metrics, launches during the run, engine, workload)."""
    ecfg = EngineConfig(clock="real", use_cache=use_cache, cache_capacity=512, cache_tau=0.05)
    eng = PatchedServeEngine(SDXL_LITE, params, ecfg, dict.fromkeys(CHIP_RES, 1.0), CHIP_RES,
                             device=dev)
    fit = eng.calibrate(total_steps_hint=20)
    log(f"[serve] cache={use_cache} calibration probe ms: "
        f"{[round(x * 1e3, 3) for x in fit['probe_latencies']]}")
    wl = poisson_workload(3.0, 2.0, CHIP_RES, 10.0, eng.sa, steps=20, seed=2)
    reset_launches()
    m = eng.run(wl, max_wall=300)
    torch.cuda.synchronize()
    counts = launches()
    return m, counts, eng, wl


def phase_serve(dev) -> tuple:
    """(the main path's launches, the cache-on run's ``Metrics.cache_samples``)."""
    params = init_diffusion(SDXL_LITE, torch.Generator().manual_seed(0), device=dev)
    main_launches = cache_samples = None
    for use_cache in (False, True):
        m, counts, eng, wl = serve(dev, params, use_cache)
        steps = len(m.step_latencies)
        log(f"[serve] cache={use_cache} requests={len(wl)} completed={m.completed} "
            f"dropped={m.dropped} SLO satisfaction={m.slo_satisfaction:.3f} steps={steps} "
            f"mean step ms={1e3 * float(np.mean(m.step_latencies)):.3f} "
            f"p50 step ms={1e3 * float(np.median(m.step_latencies)):.3f} "
            f"span s={m.span:.3f} cache savings="
            f"{float(np.mean(m.compute_savings)) if m.compute_savings else 0.0:.3f} "
            f"launches={counts} attention launches_by_route="
            f"{patch_attention.launches_by_route}")
        if m.completed < 1 or m.completed + m.dropped != len(wl):
            raise RuntimeError(f"serve cache={use_cache}: {m.completed} completed, "
                               f"{m.dropped} dropped of {len(wl)}")
        by_rid = {r.rid: r for r in wl}
        for rid, img in eng.outputs.items():
            h, w = by_rid[rid].resolution
            if img.shape != (8 * h, 8 * w, 3) or not np.all(np.isfinite(img)):
                raise RuntimeError(f"request {rid}: image {img.shape} finite="
                                   f"{bool(np.all(np.isfinite(img)))}")
        if len(eng.outputs) != m.completed:
            raise RuntimeError(f"{len(eng.outputs)} images for {m.completed} completions")
        if not use_cache:
            if min(counts.values()) <= 0:
                raise RuntimeError(f"a kernel was not launched on the main path: {counts}")
            check_gn_kernels()
            main_launches = counts
        else:
            cache_samples = list(m.cache_samples)
        del eng
        torch.cuda.empty_cache()
    return main_launches, cache_samples


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

# policy -> the replicas' patch sides it must give
FLEET_PATCHES = {"resolution_affinity": [64, 96, 128], "round_robin": [32, 32, 32]}


def fleet_gn_rows(dev) -> list:
    """GroupNorm+stitch at the affinity replicas' patch sides: a batch of two
    requests of one resolution, each request one patch (exact statistics, as
    SDXL-lite runs it)."""
    gen = torch.Generator().manual_seed(4)
    rows = []
    for level, C in GN_LEVELS:
        f = 2 ** level
        for side in (64, 96, 128):
            q = side // f
            for dtype in (torch.float32, torch.bfloat16):
                for row in gn_rows(dev, gen, level, C, [(q, q)] * 2, q, dtype, (True,)):
                    rows.append(row)
                    log(f"[fleet gn_stitch] {json.dumps(row)}")
    return rows


def fleet_steps(dev, params) -> None:
    """One sampler step on each affinity replica's CSP (one request whose
    patch is its whole latent) with the kernels, against the plain step."""
    rng = np.random.default_rng(5)
    cfg = SDXL_LITE
    for h, w in CHIP_RES:
        img = torch.as_tensor(rng.normal(size=(h, w, cfg.latent_channels)),
                              dtype=torch.float32, device=dev)
        text = torch.as_tensor(rng.normal(size=(1, cfg.n_text, cfg.d_text)),
                               dtype=torch.float32, device=dev)
        csp, patches = split([img])
        steps = torch.as_tensor([11])
        outs, ms = {}, {}
        for use in (True, False):
            c = dataclasses.replace(cfg, use_kernels=use)
            reset_launches()
            outs[use], ms[use] = timed_step(
                lambda c=c: sampler_step(c, params, csp, patches, steps, 50, text))
            n = launches()
            # 21 GroupNorm+stitch calls and 5 attention blocks x 1 resolution group
            if use and n != {"groupnorm_stitch": 21, "patch_attention": 5}:
                raise RuntimeError(f"{h}x{w} step: kernel launches {n}, expected 21 and 5")
            check_gn_kernels()
        err = max_err(outs[True], outs[False], 1e-3, f"sdxl-lite {h}x{w} sampler_step")
        log(f"[fleet step] res={h}x{w} P={csp.total} p={csp.patch} max_abs_err={err:.3e} "
            f"(tol 1e-3) step ms (cold): kernels {ms[True]:.3f} plain {ms[False]:.3f}")


def fleet_run(dev, params, policy: str) -> dict:
    """Three replicas whose engines run the real SDXL-lite step under the
    fleet's sim clock serve a Poisson workload; kernel launches are counted
    from 0 for this run alone."""
    factory = sim_engine_factory(resolutions=CHIP_RES, steps=20, synthetic=False,
                                 model_builder=lambda: (SDXL_LITE, params), device=dev)
    cl = Cluster(factory, CHIP_RES, ClusterConfig(n_replicas=3, policy=policy))
    wl = cluster_workload(3.0, 2.0, resolutions=CHIP_RES, slo_scale=10.0, steps=20, seed=2)
    reset_launches()
    t0 = time.perf_counter()
    m = cl.run(wl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    check_gn_kernels()
    s = m.summary()
    reps = [(r.engine.patch, len(r.engine.metrics.step_latencies)) for r in cl.replicas]
    log(f"[fleet] policy={policy} submitted={len(wl)} completed={m.completed} "
        f"dropped={m.dropped} SLO satisfaction={s['slo_satisfaction']} goodput={s['goodput']} "
        f"replicas (patch, steps)={reps} launches={counts} wall s={wall:.3f}")
    if m.completed < 1 or m.completed + m.dropped != len(wl):
        raise RuntimeError(f"fleet {policy}: {m.completed} completed, {m.dropped} dropped "
                           f"of {len(wl)}")
    if sorted(p for p, _ in reps) != FLEET_PATCHES[policy]:
        raise RuntimeError(f"fleet {policy}: replica patches {reps}")
    by_rid = {r.rid: r for r in wl}
    images = {rid: img for r in cl.replicas for rid, img in r.engine.outputs.items()}
    if len(images) != m.completed:
        raise RuntimeError(f"fleet {policy}: {len(images)} images for {m.completed} completions")
    for rid, img in images.items():
        h, w = by_rid[rid].resolution
        if img.shape != (8 * h, 8 * w, 3) or not np.all(np.isfinite(img)):
            raise RuntimeError(f"fleet {policy} request {rid}: image {img.shape} finite="
                               f"{bool(np.all(np.isfinite(img)))}")
    if min(counts.values()) <= 0:
        raise RuntimeError(f"fleet {policy}: a kernel was not launched: {counts}")
    del cl, factory, images
    torch.cuda.empty_cache()
    return counts


def fleet_latency_predictor(dev, params) -> None:
    """The paper's online latency predictor on the card: the warm host-clock
    SDXL-lite step latency (median of 3 after a device synchronise) of every
    composition of 0-2 requests per resolution, and the MLP fitted to them
    (80/20 split). A measurement, not a gate."""
    eng = PatchedServeEngine(SDXL_LITE, params, EngineConfig(clock="real"),
                             dict.fromkeys(CHIP_RES, 1.0), CHIP_RES, device=dev)
    feats, lats = [], []
    for counts in itertools.product(range(3), repeat=len(CHIP_RES)):
        if not sum(counts):
            continue
        batch = [res for res, n in zip(CHIP_RES, counts) for _ in range(n)]
        reqs = [Request(rid=i, resolution=res, arrival=0.0, slo=1e9, total_steps=50)
                for i, res in enumerate(batch)]
        for r in reqs:
            eng._prepare(r)
        for _ in range(2):
            eng._denoise_step(reqs)
        ms = [timed_step(lambda: eng._denoise_step(reqs))[1] for _ in range(5)]
        feats.append(make_features(counts, eng.patches_per_res))
        lats.append(float(np.median(ms)) / 1e3)
    feats, lats = np.stack(feats), np.asarray(lats)
    t0 = time.perf_counter()
    model = fit_latency_model(feats, lats, device=dev)
    fit_s = time.perf_counter() - t0
    # the same split as the fit's: what predicting the training mean scores
    order = np.random.default_rng(0).permutation(len(lats))
    ntr = int(len(lats) * 0.8)
    mean_err = float(np.mean(np.abs(lats[order[:ntr]].mean() - lats[order[ntr:]])
                             / lats[order[ntr:]]))
    log(f"[predictor] latency MLP: {len(lats)} measured compositions, step ms "
        f"{1e3 * lats.min():.3f}..{1e3 * lats.max():.3f}; fitted on {dev} in {fit_s:.2f} s; "
        f"eval_err={model.eval_err:.4f} on the 20% split (the paper's bar: 0.037; "
        f"predicting the training mean: {mean_err:.4f})")
    del eng
    torch.cuda.empty_cache()


def fleet_cache_hit_model(samples: list) -> None:
    """``fit_cache_hit_model`` on phase 4's cache-on samples, beside the
    checked-in coefficients. A measurement; nothing is written."""
    fit, default = fit_cache_hit_model(samples), CacheHitModel()
    log(f"[predictor] cache-hit model refitted to {len(samples)} phase-4 cache samples: "
        f"b0={fit.b0:.4f} b_conc={fit.b_conc:.4f} b_step={fit.b_step:.4f} (checked-in: "
        f"b0={default.b0} b_conc={default.b_conc} b_step={default.b_step})")


def phase_fleet(dev, cache_samples: list) -> dict:
    t0 = time.perf_counter()
    params = init_diffusion(SDXL_LITE, torch.Generator().manual_seed(0), device=dev)
    gn = fleet_gn_rows(dev)
    fleet_steps(dev, params)
    fleet_launches = {policy: fleet_run(dev, params, policy) for policy in FLEET_PATCHES}
    fleet_latency_predictor(dev, params)
    fleet_cache_hit_model(cache_samples)
    log(f"[fleet] phase 5 in {time.perf_counter() - t0:.1f} s")
    return {"groupnorm_stitch": gn, "launches": fleet_launches}


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

# relative to the largest |value| of the reference side: fp32 card against
# CPU; bf16 between two routes on the card (packed against per-request,
# decode against the causal forward), whose matmuls round to bf16 at other
# places. The JAX package's own fp32 bar for these comparisons is 2e-3.
LM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
PEAK_FP32_FLOPS = 67e12                        # CUDA cores, data sheet


def rel_err(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> float:
    """max |got - want| / max |want|, after checking both are finite; raises
    over ``tol``."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape or not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{what}: shapes {tuple(got.shape)} {tuple(want.shape)}, "
                           f"finite {bool(torch.isfinite(got).all())}")
    err = float((got - want).abs().max() / (want.abs().max() + 1e-9))
    if not err <= tol:
        raise RuntimeError(f"{what}: relative error {err:.3e} over {tol:g}")
    return err


def named_leaves(tree, prefix: str = "") -> dict:
    """Path -> leaf of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def pad_cache(cache: dict, big: dict) -> dict:
    """A prefill cache copied into the leading slices of a larger zero cache
    (``big``, from ``init_cache``), as the reference's
    ``test_prefill_decode_consistency`` pads it."""
    def pad(b, s):
        if isinstance(b, dict):
            return {k: pad(b[k], s[k]) for k in b}
        b[tuple(slice(0, n) for n in s.shape)] = s
        return b
    return {"blocks": pad(big["blocks"], cache["blocks"]), "cur_len": cache["cur_len"]}


def lm_batch(cfg, rng, B: int, S: int) -> dict:
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if cfg.vlm_prefix:
        batch["prefix_embeds"] = (rng.normal(size=(B, cfg.vlm_prefix, cfg.d_model))
                                  * 0.1).astype(np.float32)
    if cfg.enc_layers:
        batch["enc_inputs"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                               * 0.1).astype(np.float32)
    return batch


def lm_archs(dev) -> None:
    """(a) Each architecture's reduced config in fp32: one prefill step and
    one decode step (from the prefill cache padded by 4) on the card and on
    the CPU from the same params, logits and every cache leaf compared."""
    B, S = 2, 12
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced()
        params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(0)
        batch = lm_batch(cfg, rng, B, S)
        nxt = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)}
        out = []
        for d in (torch.device("cpu"), dev):
            p = tree_to(params, d)
            logits, cache = make_prefill_step(cfg, d)(p, batch)
            pre = {k: v.clone() for k, v in named_leaves(cache["blocks"]).items()}
            cache = pad_cache(cache, init_cache(cfg, B, S + cfg.vlm_prefix + 4, device=d))
            dlogits, cache = make_decode_step(cfg, d)(p, cache, nxt)
            out.append((logits, pre, dlogits, named_leaves(cache["blocks"]), cache["cur_len"]))
        (cl, cp, cd, cc, cn), (gl, gp, gd, gc, gn) = out
        tol = LM_TOL[torch.float32]
        errs = [rel_err(gl, cl, tol, f"{arch} prefill logits"),
                rel_err(gd, cd, tol, f"{arch} decode logits")]
        errs += [rel_err(gp[k], cp[k], tol, f"{arch} prefill cache {k}") for k in cp]
        errs += [rel_err(gc[k], cc[k], tol, f"{arch} decode cache {k}") for k in cc]
        if gn != cn or gn != S + cfg.vlm_prefix + 1:
            raise RuntimeError(f"{arch}: cur_len {gn} (card) {cn} (cpu)")
        log(f"[lm arch] {arch}: prefill + decode, card against CPU, {len(cp)} cache leaves: "
            f"max rel err logits {max(errs[:2]):.2e}, cache {max(errs[2:]):.2e} (tol {tol:g})")


def matmul_params(cfg, params) -> int:
    """Weights that multiply every token: each matrix of the blocks (stacked
    3-D; the depthwise conv and A_log are not matrix products, the routed
    experts are counted apart) and the LM head."""
    n = sum(v.numel() for k, v in named_leaves(params["blocks"]).items()
            if v.dim() == 3 and not k.endswith(("/conv_w", "/A_log")))
    return n + cfg.d_model * cfg.padded_vocab


def expert_params(params) -> int:
    """Weights of one routed expert, summed over layers."""
    return sum(v.numel() // v.shape[1] for v in named_leaves(params["blocks"]).values()
               if v.dim() == 4)


def lm_bound(cfg, params, n_tokens: int, attn_pairs: int, kv_bytes: int,
             state_bytes: int = 0) -> tuple:
    """(least ms, "bytes" or "operations") of a forward over ``n_tokens``
    tokens. Operations: the matmul flops those tokens need (each through
    every dense weight and its top-k experts) at the bf16 tensor-core peak,
    plus the fp32 attention logits and context over ``attn_pairs`` (query,
    key) pairs per head at the fp32 peak of the CUDA cores (the SSM's
    elementwise work is not counted). Bytes: the dense weights and every
    expert some token needs, read once, plus the KV cache and SSM state
    bytes, over the HBM rate."""
    dense, per_expert = matmul_params(cfg, params), expert_params(params)
    k = cfg.moe_top_k
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    n_attn = sum(1 for m, _ in cfg.layer_plan() if m == "attn") * cfg.n_periods
    t_ops = (2 * n_tokens * (dense + k * per_expert) / BF16_MMA_FLOPS
             + 4 * attn_pairs * cfg.n_heads * hd * n_attn / PEAK_FP32_FLOPS)
    itemsize = torch.finfo(torch_dtype(cfg)).bits // 8
    w_bytes = itemsize * (dense + min(cfg.n_experts, n_tokens * k) * per_expert)
    t_bytes = (w_bytes + kv_bytes + state_bytes) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs a causal (optionally windowed) mask keeps over S."""
    q = np.arange(S)
    return int(np.minimum(q + 1, window if window else S).sum())


def decode_loop(cfg, params, cache, tok, n: int) -> tuple:
    """``n`` greedy decode steps; (logits of each step, cache, host ms per
    step after a device synchronise)."""
    decode = make_decode_step(cfg, tok.device)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        logits, cache = decode(params, cache, {"tokens": tok})
        outs.append(logits)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    return outs, cache, (time.perf_counter() - t0) * 1e3 / n


def lm_profile(fn, n: int, what: str) -> float:
    """Logs ``n`` calls under ``torch.profiler``: the device's busy share of
    the wall, device ops per call and the five device ops that take most of
    its time; returns the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time for e in kernels)
    log(f"[lm profile] {what}, {n} calls: wall {wall_us / 1e3 / n:.3f} ms/call, device busy "
        f"{busy_us / 1e3 / n:.3f} ms/call ({100 * busy_us / wall_us:.1f}%), "
        f"{len(kernels) / n:.0f} device ops/call")
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        log(f"[lm profile]   {us / 1e3 / n:9.4f} ms/call  {100 * us / busy_us:5.1f}%  {name[:100]}")
    return busy_us / wall_us


def lm_main(dev, smi: str) -> None:
    """(b) internlm2-1.8b at full width and depth, bf16, random weights drawn
    on the card: packed prefill of eight ragged prompts against each one's
    own causal forward; a B=4 S=512 prefill, then 64 greedy decode steps
    from the cache padded to 576, the first against the causal forward over
    S+1 tokens; times beside their bounds, tokens/s, the device's busy share
    of a decode step and the peak memory."""
    cfg = ARCHS["internlm2-1.8b"]
    tol = LM_TOL[torch.bfloat16]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in tree_leaves(params))
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"(kv {cfg.n_kv_heads}), vocab {cfg.vocab_size} -> {cfg.padded_vocab}, {cfg.dtype}: "
        f"{n_params / 1e9:.3f} B params drawn on the card in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(3)
    lens = rng.integers(64, 513, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    pb = pack(prompts)
    packed_prefill(cfg, params, pb)
    packed, ms = timed_step(lambda: packed_prefill(cfg, params, pb))
    by_rid = unpack_by_request(pb, packed)
    errs = []
    for rid, p in enumerate(prompts):
        full, _, _, _ = forward(cfg, params, torch.as_tensor(p[None], device=dev), mode="train")
        errs.append(rel_err(by_rid[rid], full[0, -1], tol, f"packed prefill request {rid}"))
    pk_bound, pk_by = lm_bound(cfg, params, int(lens.sum()),
                               sum(causal_pairs(int(n)) for n in lens), 0)
    log(f"[lm] packed prefill: {len(prompts)} prompts of {sorted(int(n) for n in lens)} tokens "
        f"in {pb.total} packed slots, {ms:.3f} ms (bound {pk_bound:.3f} ms, {pk_by}); "
        f"last-token logits against each request's own causal forward: max rel err "
        f"{max(errs):.3e} (tol {tol:g})")

    B, S, n_dec = 4, 512, 64
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    prefill = make_prefill_step(cfg, dev)
    prefill(params, batch)
    pre_ms = min(timed_step(lambda: prefill(params, batch))[1] for _ in range(3))
    logits, cache = prefill(params, batch)
    hd, L = cfg.resolved_head_dim, cfg.n_layers
    kv_bytes = 2 * L * B * S * cfg.n_kv_heads * hd * 2
    pre_bound, pre_by = lm_bound(cfg, params, B * S, B * causal_pairs(S), kv_bytes)
    cache = pad_cache(cache, init_cache(cfg, B, S + n_dec, device=dev))
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    outs, cache, dec_ms = decode_loop(cfg, params, cache, tok, n_dec)
    dec_bound, dec_by = lm_bound(cfg, params, B, B * (S + n_dec), 2 * L * B * (S + n_dec)
                                 * cfg.n_kv_heads * hd * 2)
    toks = torch.cat([torch.as_tensor(batch["tokens"], device=dev), tok], dim=1)
    full, _, _, _ = forward(cfg, params, toks, mode="train")
    err = rel_err(outs[0], full[:, -1], tol, "first decode against the causal forward")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError("non-finite decode logits")
    # the profiled steps rewrite the cache's last 8 positions
    decode = make_decode_step(cfg, dev)
    prof_cache = {"blocks": cache["blocks"], "cur_len": S + n_dec - 8}
    last = tok

    def step():
        nonlocal prof_cache
        _, prof_cache = decode(params, prof_cache, {"tokens": last})
    busy = lm_profile(step, 8, f"decode step B={B}")
    lm_profile(lambda: prefill(params, batch), 2, f"prefill B={B} S={S}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lm] {smi}")
    log(f"[lm] prefill B={B} S={S}: {pre_ms:.3f} ms (bound {pre_bound:.3f} ms, {pre_by})")
    log(f"[lm] decode B={B} from S={S}, cache {S + n_dec}: {dec_ms:.3f} ms/step over {n_dec} "
        f"greedy steps (bound {dec_bound:.3f} ms, {dec_by}), {B * 1e3 / dec_ms:.1f} tokens/s; "
        f"first decode against the causal forward over S+1: rel err {err:.3e} (tol {tol:g})")
    log(f"[lm] decode step under torch.profiler: device busy {100 * busy:.1f}%; "
        f"peak max_memory_allocated {peak:.2f} GB")
    del params, cache, prof_cache, outs, full
    torch.cuda.empty_cache()


def lm_period(dev, smi: str, arch: str, over: dict, B: int, S: int, n_dec: int) -> None:
    """(c) One arch cut to ``over`` (full width), bf16: a B x S prefill step,
    then ``n_dec`` greedy decode steps, each against the causal forward over
    the prompt and the decoded tokens."""
    cfg = dataclasses.replace(ARCHS[arch], **over)
    tol = LM_TOL[torch.bfloat16]
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    prefill = make_prefill_step(cfg, dev)
    prefill(params, batch)
    pre_ms = min(timed_step(lambda: prefill(params, batch))[1] for _ in range(2))
    logits, cache = prefill(params, batch)
    sizes = {k: tuple(v.shape) for k, v in named_leaves(cache["blocks"]).items()}
    W = cfg.sliding_window
    if W and S > W:
        big = init_cache(cfg, B, W, device=dev)       # the ring is full; no room to add
    else:
        big = init_cache(cfg, B, S + n_dec, device=dev)
    cache = pad_cache(cache, big)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    outs, cache, dec_ms = decode_loop(cfg, params, cache, tok, n_dec)
    toks = [torch.as_tensor(batch["tokens"], device=dev), tok]
    toks += [o.argmax(-1, keepdim=True).to(torch.int32) for o in outs[:-1]]
    full, _, _, _ = forward(cfg, params, torch.cat(toks, dim=1), mode="train")
    errs = [rel_err(o, full[:, S + i], tol, f"{arch} decode {i} against the causal forward")
            for i, o in enumerate(outs)]
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    n_attn = sum(1 for m, _ in cfg.layer_plan() if m == "attn") * cfg.n_periods

    def kv(n: int) -> int:
        """bf16 K and V bytes of ``n`` positions (the ring keeps W)."""
        return 2 * n_attn * B * min(n, W or n) * cfg.n_kv_heads * hd * 2
    state = 0
    if cfg.d_inner:
        n_ssm = sum(1 for m, _ in cfg.layer_plan() if m == "mamba") * cfg.n_periods
        state = n_ssm * B * cfg.d_inner * (cfg.ssm_state * 4 + (cfg.conv_width - 1) * 2) * 2
    pre_bound, pre_by = lm_bound(cfg, params, B * S, B * causal_pairs(S, W), kv(S))
    dec_bound, dec_by = lm_bound(cfg, params, B, B * min(S + n_dec, W or S + n_dec),
                                 kv(S + n_dec), state)
    route = ("flash" if S >= cfg.flash_min_seq else "dense") if n_attn else "none"
    log(f"[lm] {smi}")
    log(f"[lm] {cfg.name} ({cfg.n_layers} layer(s), {over}): prefill B={B} S={S} "
        f"(attention route {route}, cache {sorted(set(sizes.values()))}): {pre_ms:.3f} ms "
        f"(bound {pre_bound:.3f} ms, {pre_by}); decode {dec_ms:.3f} ms/step over {n_dec} "
        f"steps (bound {dec_bound:.3f} ms, {dec_by}); decodes against the causal forward: "
        f"max rel err {max(errs):.3e} (tol {tol:g}); peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params, cache, outs, full
    torch.cuda.empty_cache()


def scan_logstep(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's parallel structure for the SSM scan, kept to time
    against the port's loop: log-step (Hillis-Steele) rounds of
    ``_scan_combine``, each element combined with the one 2^r before it.
    Overwrites a and b; returns h."""
    S, d = a.shape[1], 1
    while d < S:
        na, nb = mamba_mod._scan_combine((a[:, :-d], b[:, :-d]), (a[:, d:], b[:, d:]))
        b[:, d:] = nb
        if 2 * d < S:
            a[:, d:] = na
        d *= 2
    return b


def lm_scan(dev, shape=(2, 1024, 8192, 16)) -> None:
    """The SSM scan at falcon-mamba-7b's full width (B=2, S=1024, d_inner
    8192, d_state 16, fp32): the port's ``_scan`` (one multiply-add per
    position) against a log-step scan, each against the loop's output."""
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.exp(-torch.rand(shape, generator=gen, device=dev) * 0.1)
    b = torch.randn(shape, generator=gen, device=dev) * 0.1
    want = mamba_mod._scan(a.clone(), b.clone())
    rows = {}
    for name, fn in (("sequential (the port's _scan)", mamba_mod._scan),
                     ("log-step", scan_logstep)):
        fn(a.clone(), b.clone())
        ms = []
        for _ in range(3):
            ac, bc = a.clone(), b.clone()
            out, t = timed_step(lambda: fn(ac, bc))
            ms.append(t)
        rows[name] = (min(ms), float((out - want).abs().max()))
    bound = 3 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"[lm scan] {shape} fp32: " + ", ".join(
        f"{n} {ms:.3f} ms (max abs diff {e:.2e})" for n, (ms, e) in rows.items())
        + f"; bound {bound:.3f} ms (bytes: a and b read, h written)")
    del a, b, want
    torch.cuda.empty_cache()


def phase_lm(dev, smi: str) -> None:
    t0 = time.perf_counter()
    reset_launches()
    lm_archs(dev)
    lm_main(dev, smi)
    lm_period(dev, smi, "mixtral-8x7b", {"n_layers": 1, "capacity_factor": 4.0},
              B=1, S=4608, n_dec=8)
    lm_period(dev, smi, "falcon-mamba-7b", {"n_layers": 2}, B=2, S=1024, n_dec=16)
    lm_scan(dev)
    log(f"[lm] kernel launches in phase 6 (the LM path reaches no TPU kernel): {launches()}")
    log(f"[lm] phase 6 in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

# a key bias's gradient is zero in exact arithmetic (softmax is invariant to a
# shift shared by every key of a query): both sides hold rounding noise, held
# to the tolerance relative to the tree's largest gradient
ZERO_GRAD = ("/attn/bk", "/cross/bk")
# tests/test_flash.py's gradient cases: (B, Sq, Sk, H, KV, D, Dv, causal, window, bq, bk)
FLASH_GRAD_CASES = [
    (2, 64, 64, 4, 2, 16, 16, True, 0, 16, 16),
    (1, 100, 100, 2, 2, 8, 8, True, 0, 32, 32),
    (2, 64, 64, 4, 1, 16, 32, True, 0, 16, 32),
    (1, 96, 96, 2, 2, 16, 16, True, 32, 32, 32),
]


def grad_errs(got: dict, want: dict, tol: float, what: str) -> float:
    """Largest of each leaf's max |got - want| over its largest |want| (the
    tree's largest for the key biases, whose gradient is 0 in exact
    arithmetic), computed on ``want``'s device; raises over ``tol``."""
    if got.keys() != want.keys():
        raise RuntimeError(f"{what}: gradient leaves differ")
    gmax = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        w = w.detach().float()
        g = got[k].detach().float().to(w.device)
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{what} {k}: shape {tuple(g.shape)} or not finite")
        den = gmax if k.endswith(ZERO_GRAD) else float(w.abs().max())
        err = float((g - w).abs().max()) / (den + 1e-30)
        if not err <= tol:
            raise RuntimeError(f"{what} {k}: relative error {err:.3e} over {tol:g}")
        worst = max(worst, err)
    return worst


def train_archs(dev) -> None:
    """(a) Each architecture's reduced fp32 config: ``lm_loss`` and every
    gradient leaf on the card against the CPU from the same params."""
    tol = LM_TOL[torch.float32]
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced()
        params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = lm_batch(cfg, np.random.default_rng(0), 2, 16)
        batch["labels"] = batch["tokens"]
        out = []
        for d in (torch.device("cpu"), dev):
            b = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            loss, grads = loss_and_grads(cfg, tree_to(params, d), b)
            out.append((loss, named_leaves(grads)))
        (cl, cg), (gl, gg) = out
        lerr = rel_err(gl, cl, tol, f"{arch} loss")
        gerr = grad_errs(gg, cg, tol, arch)
        log(f"[train arch] {arch}: loss {float(gl):.5f} (card) {float(cl):.5f} (cpu), rel err "
            f"{lerr:.2e}; {len(cg)} gradient leaves, max rel err {gerr:.2e} (tol {tol:g})")


def train_optim(dev) -> None:
    """One AdamW and one Adafactor update of jamba's reduced params (2-D,
    3-D and 4-D leaves) on the card against the CPU, from the same grads."""
    tol = LM_TOL[torch.float32]
    cfg = ARCHS["jamba-v0.1-52b"].reduced()
    params = init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    gen = torch.Generator().manual_seed(2)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 0.3, params)
    for name, init, update in (("adamw", adamw_init, adamw_update),
                               ("adafactor", adafactor_init, adafactor_update)):
        out = []
        for d in (torch.device("cpu"), dev):
            p, g = tree_to(params, d), tree_to(grads, d)
            out.append(update(p, g, init(p)))
        (cp, co), (gp, go) = out
        errs = [rel_err(a, b, tol, f"{name} param") for a, b in
                zip(tree_leaves(gp), tree_leaves(cp))]
        errs += [rel_err(a, b, tol, f"{name} state") for a, b in
                 zip(tree_leaves(go), tree_leaves(co))]
        log(f"[train optim] {name}, one update of {len(tree_leaves(cp))} leaves, card against "
            f"CPU: max rel err {max(errs):.2e} (tol {tol:g})")


def dense_attention(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """tests/test_flash.py's dense oracle, in torch."""
    B, Sq, H, D = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, KV, H // KV, D), k) * D ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = kpos <= qpos
        if window:
            m &= kpos > qpos - window
    p = torch.softmax(torch.where(m, s, -1e30), dim=-1)
    return torch.einsum("bkgqs,bskv->bqkgv", p, v).reshape(B, Sq, H, v.shape[-1])


def train_flash(dev) -> None:
    """The flash backward at tests/test_flash.py's four gradient cases
    against autograd through the dense oracle, on the card."""
    tol = LM_TOL[torch.float32]
    for B, Sq, Sk, H, KV, D, Dv, causal, window, bq, bk in FLASH_GRAD_CASES:
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv)))
        w = torch.randn((B, Sq, H, Dv), generator=gen, device=dev)
        grads = []
        for fn in (lambda a, b, c: flash_attention(a, b, c, causal, window, 0, bq, bk),
                   lambda a, b, c: dense_attention(a, b, c, causal, window)):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (fn(*ins) * w).sum().backward()
            grads.append([t.grad for t in ins])
        errs = [rel_err(a, b, tol, f"flash d{n} {(B, Sq, H, KV, D, Dv, window)}")
                for a, b, n in zip(grads[0], grads[1], "qkv")]
        log(f"[train flash] B={B} Sq={Sq} H={H} KV={KV} D={D} Dv={Dv} window={window} "
            f"blocks {bq}x{bk}: dq/dk/dv against dense autograd, max rel err "
            f"{max(errs):.2e} (tol {tol:g})")


def scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t out of place, one position at a time:
    plain autograd differentiates it."""
    hs, h = [], torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def train_scan(dev, smi: str, shape=(2, 1024, 8192, 16)) -> None:
    """The SSM scan's backward at falcon-mamba-7b's width (fp32) against
    autograd through ``scan_plain``; forward + backward ms of each."""
    tol = LM_TOL[torch.float32]
    gen = torch.Generator(device=dev).manual_seed(6)
    a = torch.exp(-torch.rand(shape, generator=gen, device=dev) * 0.1)
    b = torch.randn(shape, generator=gen, device=dev) * 0.1
    w = torch.randn(shape, generator=gen, device=dev)
    rows = {}
    for name, fn in (("_scan (custom backward)", mamba_mod._scan), ("plain loop", scan_plain)):
        best = None
        for _ in range(2):
            ai, bi = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = fn(ai, bi)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (h * w).sum().backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if best is None or t2 - t0 < best[0] + best[1]:
                best = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
            grads = (ai.grad, bi.grad)
            del h, ai, bi
        rows[name] = (best, grads)
    (_, (ga, gb)), (_, (pa, pb)) = rows.values()
    errs = [rel_err(ga, pa, tol, "scan dAbar"), rel_err(gb, pb, tol, "scan dBx")]
    bwd_bound = 5 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"[train scan] {smi}")
    log(f"[train scan] {shape} fp32, forward / backward ms: " + ", ".join(
        f"{n} {f:.3f} / {bw:.3f}" for n, ((f, bw), _) in rows.items())
        + f"; backward bound {bwd_bound:.3f} ms (bytes: dh, Abar, h read, dAbar, dBx "
        f"written); dAbar, dBx against the plain loop: max rel err {max(errs):.2e} "
        f"(tol {tol:g})")
    del a, b, w, rows, ga, gb, pa, pb
    torch.cuda.empty_cache()


def train_bound(cfg, params, B: int, S: int) -> tuple:
    """(least ms, "bytes" or "operations") of one train step with remat.
    Operations: matmul flops at the bf16 tensor-core peak, 6 per weight and
    token for the forward and backward plus 2 for the blocks' recomputed
    forward (the head is not recomputed), and the fp32 attention flops of
    the causal pairs at the CUDA cores' peak, 4 per pair, head and dim in
    each forward (2) and 8 in the backward. Bytes: AdamW reads the bf16
    params and grads and the fp32 moments and writes params and moments,
    22 bytes a param, over the HBM rate."""
    n_head = cfg.d_model * cfg.padded_vocab
    dense = matmul_params(cfg, params)
    T = B * S
    n_attn = sum(1 for m, _ in cfg.layer_plan() if m == "attn") * cfg.n_periods
    pairs = B * causal_pairs(S, cfg.sliding_window)
    t_ops = ((6 * dense + 2 * (dense - n_head)) * T / BF16_MMA_FLOPS
             + 16 * pairs * cfg.n_heads * cfg.resolved_head_dim * n_attn / PEAK_FP32_FLOPS)
    n_params = sum(v.numel() for v in tree_leaves(params))
    t_bytes = 22 * n_params / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


TRAIN_LOSS_TOL = 1e-2   # bf16 loss of one route against another, relative


def train_witness(cfg, params, batch, S: int) -> tuple:
    """The loss and gradients at ``params`` on the recipe's route (flash
    attention, remat), held against two witnesses on the same params and
    batch: the dense attention route (``flash_min_seq`` above S) and no
    remat. Returns (flash-route loss, {witness: (loss rel err, largest
    gradient-leaf rel err)}); raises over TRAIN_LOSS_TOL or LM_TOL[bf16]."""
    loss, grads = loss_and_grads(cfg, params, batch)
    grads = named_leaves(grads)
    out = {}
    for name, wcfg in (("dense route", dataclasses.replace(cfg, flash_min_seq=S + 1)),
                       ("no remat", dataclasses.replace(cfg, remat=False))):
        wl, wg = loss_and_grads(wcfg, params, batch)
        out[name] = (rel_err(loss, wl, TRAIN_LOSS_TOL, f"train loss against the {name}"),
                     grad_errs(grads, named_leaves(wg), LM_TOL[torch.bfloat16],
                               f"train gradient against the {name}"))
        del wg
    return loss, out


def train_main(dev, smi: str, B: int = 2, S: int = 2048, steps: int = 6) -> None:
    """(b) internlm2-1.8b at full width and depth, bf16, remat, AdamW with
    fp32 moments: ``steps`` train steps on one TokenPipeline batch, each
    step's loss and gradients first held against the dense route and against
    no remat at the same params (``train_witness``), then one more step under
    the profiler. The losses must be finite and the first update must lower
    the batch's loss."""
    cfg = ARCHS["internlm2-1.8b"]
    if not (cfg.remat and cfg.dtype == "bfloat16" and cfg.opt == "adamw"
            and cfg.opt_state_dtype == "float32" and S >= cfg.flash_min_seq):
        raise RuntimeError(f"{cfg.name}: not the configuration phase 7 (b) measures")
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = opt_init(cfg, params)
    batch = next(TokenPipeline(cfg.vocab_size, B, S, seed=0))
    dbatch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    step = make_train_step(cfg, device=dev)
    losses, ms, gaps, peak = [], [], [], 0.0
    for _ in range(steps):
        wloss, gap = train_witness(cfg, params, dbatch, S)
        gaps.append(gap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
        losses.append(float(metrics["loss"]))
        rel_err(metrics["loss"], wloss, TRAIN_LOSS_TOL, "train step loss against its witness")
    if not all(np.isfinite(losses)) or not losses[1] < losses[0]:
        raise RuntimeError(f"train losses {losses}: not finite, or the first update did not "
                           f"lower the batch's loss")
    bound, by = train_bound(cfg, params, B, S)
    n_params = sum(v.numel() for v in tree_leaves(params))
    state = {"params": params, "opt": opt}

    def one():
        state["params"], state["opt"], _ = step(state["params"], state["opt"], batch)
    busy = lm_profile(one, 1, f"train step B={B} S={S}")
    steady = min(ms[1:])
    log(f"[train] {smi}")
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.padded_vocab}, {n_params / 1e9:.3f} B params, bf16, remat, AdamW "
        f"(fp32 moments); B={B} S={S} (attention route flash, flash_min_seq "
        f"{cfg.flash_min_seq}), one TokenPipeline batch repeated")
    log(f"[train] losses per step: {', '.join(f'{x:.5f}' for x in losses)}")
    for name in gaps[0]:
        log(f"[train] witness {name}, at each step's params: loss rel err "
            + ", ".join(f"{g[name][0]:.2e}" for g in gaps) + f" (tol {TRAIN_LOSS_TOL:g}); "
            + "largest gradient-leaf rel err " + ", ".join(f"{g[name][1]:.2e}" for g in gaps)
            + f" (tol {LM_TOL[torch.bfloat16]:g})")
    log(f"[train] step ms: {', '.join(f'{x:.1f}' for x in ms)}; steady {steady:.3f} ms "
        f"(bound {bound:.3f} ms, {by}; {100 * bound / steady:.1f}% of it), "
        f"{B * S * 1e3 / steady:.0f} tokens/s; peak max_memory_allocated in a step "
        f"{peak:.2f} GB; device busy under the profiler {100 * busy:.1f}%")
    del params, opt, state
    torch.cuda.empty_cache()


def tree_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def train_launcher(dev) -> None:
    """(c) The launcher on the card as the reference runs it (``--smoke``,
    so the reduced config): 4 steps, then 2 more with ``--resume``; an
    ``ElasticTrainer`` with a simulated failure; and resume equal to
    straight training, bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "launch")
        first = train_cli.main(["--steps", "4", "--ckpt", ck])
        second = train_cli.main(["--steps", "2", "--ckpt", ck, "--resume"])
        if first["step"] != 4 or second["step"] != 6 or not np.isfinite(second["loss"]):
            raise RuntimeError(f"launcher: steps {first['step']}, {second['step']}")
        dev_of = {t.device.type for t in tree_leaves({"p": second["params"], "o": second["opt"]})}
        if dev_of != {dev.type}:
            raise RuntimeError(f"launcher state on {dev_of}")

        cfg = ARCHS["internlm2-1.8b"].reduced()
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        opt = opt_init(cfg, params)
        pipe = TokenPipeline(cfg.vocab_size, 2, 16)
        batches = [next(pipe) for _ in range(8)]
        trainer = ElasticTrainer(make_mesh=lambda n: make_local_mesh(),
                                 build_step=lambda mesh: make_train_step(cfg, device=dev),
                                 ckpt=CheckpointManager(Path(tmp) / "elastic", keep=2),
                                 cfg=ElasticConfig(ckpt_every=2), device=dev)
        _, eopt, estep, metrics = trainer.run(params, opt, batches[:6], fail_at={5: 1})
        remesh = [e for e in trainer.events if e["event"] == "remesh"]
        if (not remesh or not np.isfinite(float(metrics["loss"]))
                or eopt["step"].device.type != dev.type):
            raise RuntimeError(f"elastic: events {trainer.events}")
        log(f"[train launcher] ElasticTrainer on {torch.cuda.device_count()} device(s), "
            f"fail_at {{5: 1}}: events {trainer.events}, ended at step {estep}, loss "
            f"{float(metrics['loss']):.5f}")

        step = make_train_step(cfg, device=dev)
        p1, o1 = params, opt
        for b in batches[:4]:
            p1, o1, m1 = step(p1, o1, b)
        p2, o2 = params, opt
        for b in batches[:2]:
            p2, o2, _ = step(p2, o2, b)
        save_checkpoint(Path(tmp) / "resume", 2, {"params": p2, "opt": o2})
        _, st = load_checkpoint(Path(tmp) / "resume", target={"params": params, "opt": opt})
        p2, o2 = st["params"], st["opt"]
        for b in batches[2:4]:
            p2, o2, m2 = step(p2, o2, b)
        same = (tree_equal(p1, p2) and tree_equal(o1, o2)
                and bool(torch.equal(m1["loss"], m2["loss"])))
        log(f"[train launcher] main() 4 steps (loss {first['loss']:.5f}) then --resume to step "
            f"{second['step']} (loss {second['loss']:.5f}); 4 straight steps against 2 + "
            f"checkpoint + restore + 2: {'bit for bit equal' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError("resumed training differs from straight training")


def phase_train(dev, smi: str) -> None:
    t0 = time.perf_counter()
    reset_launches()
    train_archs(dev)
    train_optim(dev)
    train_flash(dev)
    train_scan(dev, smi)
    train_main(dev, smi)
    train_launcher(dev)
    log(f"[train] kernel launches in phase 7 (the training path reaches no TPU kernel): "
        f"{launches()}")
    log(f"[train] phase 7 in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

#: phase 8's gate on the (1, 1) mesh: the DTensor and EP paths run the plain
#: ops on the same data there, so they must agree bit for bit
DIST_TOL = 0.0


def dfull(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value (a tensor passes as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def tree_rel_err(got, want, tol: float, what: str) -> float:
    """The largest relative error over the leaves of two trees (DTensors
    gathered)."""
    g, w = named_leaves(got), named_leaves(want)
    if set(g) != set(w):
        raise RuntimeError(f"{what}: leaves {sorted(set(g) ^ set(w))} differ")
    return max(rel_err(dfull(g[k]), w[k], tol, f"{what} {k}") for k in w)


def dist_lm(dev, smi: str, mesh) -> None:
    """(a) internlm2-1.8b at full width and depth, bf16, random weights drawn
    on the card, through ``build_cell``'s DTensor steps on the (1, 1) mesh,
    each against the plain step of phases 6-7 on the same params and batch:
    a train step at B=2 S=2048 (loss and every updated param leaf), a
    prefill at B=4 S=512 (logits and every cache leaf) and 8 decode steps
    at B=4 (logits of each, every cache leaf after them). Each timed beside
    the plain step, host clock to a device synchronise, best of the runs.
    On the (1, 1) mesh every local op is the plain op on the same data, so
    each comparison must be exact (tolerance 0); no layout's collective runs
    here, and the layouts themselves are held only by the CPU tests on gloo
    ranks (``tests/test_torch_distributed.py``)."""
    cfg = ARCHS["internlm2-1.8b"]
    tol = DIST_TOL
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    B, S = 2, 2048
    batch = next(TokenPipeline(cfg.vocab_size, B, S, seed=0))
    opt = opt_init(cfg, params)
    plain = make_train_step(cfg, device=dev)
    t_plain = []
    for _ in range(2):
        (p1, o1, m1), ms = timed_step(lambda: plain(params, opt, batch))
        t_plain.append(ms)
        del o1
    fn, args, info = build_cell(cfg, ShapeSpec("train", S, B, "train"), mesh,
                                params=params, opt=opt, batch=batch)
    dparams, dopt = (shd.tree_place(t, sh) for t, sh in zip((params, opt), info["in_shardings"]))
    del opt, args
    t_dt = []
    for _ in range(2):
        (p2, o2, m2), ms = timed_step(lambda: fn(dparams, dopt, batch))
        t_dt.append(ms)
        del o2
    del dopt
    loss_err = rel_err(dfull(m2["loss"]), m1["loss"], tol, "DTensor train loss")
    param_err = tree_rel_err(p2, p1, tol, "DTensor train step param")
    log(f"[dist] {smi}")
    log(f"[dist] {cfg.name} train step B={B} S={S} (bf16, remat, AdamW): DTensor {min(t_dt):.1f} ms "
        f"against plain {min(t_plain):.1f} ms (runs {', '.join(f'{x:.1f}' for x in t_dt)} / "
        f"{', '.join(f'{x:.1f}' for x in t_plain)}); loss {float(m1['loss']):.5f}, rel err "
        f"{loss_err:.2e}; every updated param leaf: max rel err {param_err:.2e} (tol {tol:g})")
    del p1, p2
    torch.cuda.empty_cache()

    B, S, n_dec = 4, 512, 8
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    prefill = make_prefill_step(cfg, dev)
    fnp, _, _ = build_cell(cfg, ShapeSpec("prefill", S, B, "prefill"), mesh, batch=batch)
    t_plain, t_dt = [], []
    for _ in range(3):
        (logits, cache), ms = timed_step(lambda: prefill(params, batch))
        t_plain.append(ms)
        (dlogits, dcache), ms = timed_step(lambda: fnp(dparams, batch))
        t_dt.append(ms)
    pre_err = rel_err(dfull(dlogits), logits, tol, "DTensor prefill logits")
    pre_cache = tree_rel_err(dcache["blocks"], cache["blocks"], tol, "DTensor prefill cache")
    log(f"[dist] {cfg.name} prefill B={B} S={S}: DTensor {min(t_dt):.2f} ms against plain "
        f"{min(t_plain):.2f} ms; logits rel err {pre_err:.2e}, every cache leaf {pre_cache:.2e}")

    cache = pad_cache(cache, init_cache(cfg, B, S + n_dec, device=dev))
    dcache = pad_cache({"blocks": tree_map(dfull, dcache["blocks"]), "cur_len": S},
                       init_cache(cfg, B, S + n_dec, device=dev))
    fnd, _, info = build_cell(cfg, ShapeSpec("decode", S + n_dec, B, "decode"), mesh,
                              cache=dcache, batch={"tokens": batch["tokens"][:, :1]})
    dcache = {"blocks": shd.tree_place(dcache["blocks"], info["in_shardings"][1]["blocks"]),
              "cur_len": S}
    decode = make_decode_step(cfg, dev)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    errs, t_plain, t_dt = [], [], []
    for _ in range(n_dec):
        (lg, cache), ms = timed_step(lambda: decode(params, cache, {"tokens": tok}))
        t_plain.append(ms)
        (dlg, dcache), ms = timed_step(lambda: fnd(dparams, dcache, {"tokens": tok}))
        t_dt.append(ms)
        errs.append(rel_err(dfull(dlg), lg, tol, "DTensor decode logits"))
        tok = lg.argmax(-1, keepdim=True).to(torch.int32)
    dec_cache = tree_rel_err(dcache["blocks"], cache["blocks"], tol, "DTensor decode cache")
    log(f"[dist] {cfg.name} decode B={B} from S={S}, {n_dec} greedy steps: DTensor "
        f"{float(np.median(t_dt)):.2f} ms/step against plain {float(np.median(t_plain)):.2f} "
        f"ms/step (medians); logits max rel err {max(errs):.2e}, every cache leaf after them "
        f"{dec_cache:.2e} (tol {tol:g})")
    del params, dparams, cache, dcache
    torch.cuda.empty_cache()


def dist_moe(dev, smi: str, mesh) -> None:
    """(b) One full-width period of mixtral-8x7b (phase 6c's cut) through the
    expert-parallel branch of ``apply_moe`` on the (1, 1) mesh against the
    local path: loss and every gradient leaf at a train shape of 49,152
    tokens (enough that the weight gather, not the token gather, is the
    layout), and one decode step at B=4 (token gather) from a B=4 S=64
    prefill. Exact, as (a): on one rank the gathers and sums are the
    identity."""
    cfg = dataclasses.replace(ARCHS["mixtral-8x7b"], n_layers=1)
    tol = DIST_TOL
    params, specs = build_model(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    dparams = shd.tree_place(params, shd.param_shardings(cfg, mesh, params, specs))
    B, S = 12, 4096
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in next(TokenPipeline(cfg.vocab_size, B, S, seed=1)).items()}
    (l1, g1), ms_plain = timed_step(lambda: loss_and_grads(cfg, params, batch))
    bshard = batch_shardings(cfg, mesh, batch)

    def ep():
        with ctx.use_mesh(mesh), implicit_replication():
            return loss_and_grads(cfg, dparams, shd.tree_place(batch, bshard))
    (l2, g2), ms_ep = timed_step(ep)
    loss_err = rel_err(dfull(l2), l1, tol, "mixtral EP loss")
    grad_err = tree_rel_err(g2, g1, tol, "mixtral EP gradient")
    del g1, g2
    log(f"[dist] {cfg.name} one period, B={B} S={S} ({ep_layout(cfg, mesh, B, S)}): "
        f"loss and gradients EP {ms_ep:.1f} ms against local {ms_plain:.1f} ms (first calls); "
        f"loss rel err {loss_err:.2e}, every gradient leaf max rel err {grad_err:.2e} "
        f"(tol {tol:g})")

    B, S = 4, 64
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    logits, cache = make_prefill_step(cfg, dev)(params, {"tokens": tokens})
    cache = pad_cache(cache, init_cache(cfg, B, S + 8, device=dev))
    dcache = {"blocks": tree_map(torch.clone, cache["blocks"]), "cur_len": S}
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    lg, _ = make_decode_step(cfg, dev)(params, cache, {"tokens": tok})
    fnd, _, _ = build_cell(cfg, ShapeSpec("decode", S + 8, B, "decode"), mesh, cache=dcache,
                           batch={"tokens": tok})
    dlg, _ = fnd(dparams, dcache, {"tokens": tok})
    err = rel_err(dfull(dlg), lg, tol, "mixtral EP decode logits")
    log(f"[dist] {cfg.name} one period, decode B={B} from S={S} "
        f"({ep_layout(cfg, mesh, B, 1)}): logits rel err {err:.2e} (tol {tol:g})")
    del params, dparams, cache, dcache
    torch.cuda.empty_cache()


DIST_WORKER = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
rank, n, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, sys.argv[4])
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.optim.compression import quantized_psum
x = np.random.default_rng(0).normal(size=(n, 4096)).astype(np.float32)
q = quantized_psum(torch.as_tensor(x[rank], device="cuda"))
# the same arithmetic on the host: shared scale, round-half-even codes
xs = torch.as_tensor(x)
scale = xs.abs().max() / 127.0 + 1e-12
want = torch.clamp(torch.round(xs / scale), -127, 127).to(torch.int32).sum(0).float() * scale
out = {"device": str(q.device), "err_codes": float((q.cpu() - want).abs().max()),
       "err_exact": float((q.cpu() - xs.sum(0)).abs().max())}
if rank == 0:
    print("DIST-RESULT " + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def dist_gloo(dev) -> None:
    """(c) Four gloo ranks spawned on the host, each with its tensor on the
    card: ``quantized_psum`` (an all-reduce MAX, then an int32 all-reduce
    SUM, both of CUDA tensors) against the same quantization done on the
    host (1e-6) and against the exact sum (the reference test's bound 0.2).
    The MoE's expert-parallel layouts and ``pipelined_apply`` run on the
    CPU only (``tests/test_torch_distributed.py``): under gloo, torch's
    functional all-gather of a CUDA tensor (which DTensor's redistribution
    and the MoE's weight and token gathers use) ends the process with a
    segfault, and point-to-point sends of CUDA tensors time out."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, "-c", DIST_WORKER, str(r), "4",
                                   str(Path(tmp) / "store"), str(ROOT / "src")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(4)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"gloo rank failed ({p.returncode}):\n{o[-3000:]}")
    res = json.loads(next(line for line in outs[0].splitlines()
                          if line.startswith("DIST-RESULT "))[len("DIST-RESULT "):])
    if not (res["device"].startswith("cuda") and res["err_codes"] < 1e-6
            and res["err_exact"] < 0.2):
        raise RuntimeError(f"quantized_psum on gloo ranks: {res}")
    log(f"[dist gloo] quantized_psum of (4096,) fp32 on 4 gloo ranks, CUDA tensors "
        f"({res['device']}): max abs err {res['err_codes']:.3e} against the host's "
        f"quantization (tol 1e-6), {res['err_exact']:.3e} against the exact sum (bound 0.2); "
        f"{time.perf_counter() - t0:.1f} s")


DRYRUN_CELLS = (("internlm2-1.8b", "train_4k"), ("mixtral-8x7b", "decode_32k"))
DRYRUN = r"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun, roofline
for arch, shape in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, False, Path(sys.argv[3]))
    rf = roofline.analyze_cell(arch, shape, Path(sys.argv[3]))
    print("DRYRUN " + json.dumps({"rec": rec, "roofline": rf,
                                  "seconds": time.perf_counter() - t0}), flush=True)
"""


def start_dryrun(tmp: str) -> subprocess.Popen:
    """(d) The dry-run of two cells on a fake 16x16 group, host only (no
    CUDA device visible), in a subprocess: its process group is its own."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", DRYRUN, str(ROOT / "src"),
                             json.dumps(DRYRUN_CELLS), tmp],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def finish_dryrun(proc: subprocess.Popen) -> None:
    try:
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode != 0:
        raise RuntimeError(f"dry-run failed ({proc.returncode}):\n{err[-3000:]}")
    for line in out.splitlines():
        if not line.startswith("DRYRUN "):
            continue
        d = json.loads(line[len("DRYRUN "):])
        rec, rf = d["rec"], d["roofline"]
        coll = ", ".join(f"{k} {v:.3e}" for k, v in sorted(rec["collectives"]["bytes_by_kind"].items()))
        t = rf["terms_s"]
        log(f"[dist dryrun] {rec['cell']} on a fake group of {rec['devices']} ranks, "
            f"{d['seconds']:.1f} s: per device {rec['cost']['flops']:.4e} flops, "
            f"{rec['cost']['bytes_eager']:.4e} bytes of eager op traffic, arguments "
            f"{rec['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, collective bytes {coll}; "
            f"H100 roofline compute {t['compute_s']:.4f} s, memory {t['memory_s']:.4f} s, "
            f"collective {t['collective_s']:.4f} s ({rf['dominant']}), useful flops "
            f"{rf['useful_flops_ratio']:.3f}")
    if out.count("DRYRUN ") != len(DRYRUN_CELLS):
        raise RuntimeError(f"dry-run printed {out.count('DRYRUN ')} cells")


def phase_dist(dev, smi: str) -> None:
    import torch.distributed as dist
    t0 = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh()
            log(f"[dist] one-rank NCCL group: mesh {mesh.shape} over {mesh.device_mesh}")
            dist_lm(dev, smi, mesh)
            dist_moe(dev, smi, mesh)
        finally:
            dist.destroy_process_group()
        proc = start_dryrun(tmp)
        try:
            dist_gloo(dev)
        finally:
            finish_dryrun(proc)
    log(f"[dist] kernel launches in phase 8 (the distributed path reaches no TPU kernel): "
        f"{launches()}")
    log(f"[dist] phase 8 in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

def entry_run(name: str, fn, kernels=tuple(KERNELS)) -> tuple:
    """(result, launches) of one entry point's call, the counts set to 0
    just before it and read just after; each kernel in ``kernels`` must have
    launched."""
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = launches()
    check_gn_kernels()
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        raise RuntimeError(f"{name}: {missing} not launched: {counts}")
    log(f"[entry] {name}: launches {counts}, {time.perf_counter() - t0:.1f} s")
    return out, counts


def attention_splits(run) -> tuple:
    """Runs ``run()`` (one ``quickstart.run``) while recording each
    attention call's ``split_kv``: the set taken in the batched step, and
    per request the set taken alone (each ``sampler_step`` call starts a
    new segment)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.patch_attention import sm_count
    segments: list = []
    attention, step = ops.patch_attention, qs.sampler_step

    def rec_attention(q, k, v):
        B, S, H, D = q.shape
        segments[-1].add((B, S, split_kv(B, S, H, sm_count(q.device.index or 0),
                                         block_q(q.dtype, D))))
        return attention(q, k, v)

    def rec_step(*args, **kw):
        segments.append(set())
        return step(*args, **kw)

    ops.patch_attention, qs.sampler_step = rec_attention, rec_step
    try:
        out = run()
    finally:
        ops.patch_attention, qs.sampler_step = attention, step
    return out, sorted(segments[0]), [sorted(s) for s in segments[1:]]


# two requests at the smallest side beside one at the middle side: the
# smallest side's batched attention group has B = 2 against B = 1 alone
PAIR = {"unet": [(96, 96), (64, 64), (64, 64)], "dit": [(48, 48), (32, 32), (32, 32)]}


def entry_quickstart_run(dev, kind: str, sides=None) -> tuple:
    """One ``quickstart.run`` at full width through both kernels, held to
    quickstart's bars: (output, launches, batched splits, alone splits)."""
    tag = f"quickstart --full --kind {kind}" + (f" on {sides}" if sides else "")
    (out, batched, alone), counts = entry_run(
        tag, lambda: attention_splits(lambda: qs.run(kind, full=True, device=dev, sides=sides)),
        kernels=tuple(KERNELS) if kind == "unet" else ("patch_attention",))
    csp, name = out["csp"], out["cfg"].name
    log(f"[entry quickstart] {name}: P={csp.total} p={csp.patch} groups={csp.n_groups}; "
        f"attention (B, S, split_kv) batched {batched}, alone {alone}")
    for r in out["rows"]:
        log(f"[entry quickstart] {name} request {r['request']} {r['resolution']} step "
            f"{r['step']}: max |batched - solo| = {r['max_abs_err']:.3e} PSNR "
            f"{r['psnr']:.2f} dB bitwise {r['bitwise']}")
    qs.check(out["rows"], full=True)
    log(f"[entry quickstart] {name}: every request bitwise equal: "
        f"{all(r['bitwise'] for r in out['rows'])}")
    return out, counts, batched, alone


def entry_quickstart(dev) -> dict:
    """(a) ``quickstart --full`` for SDXL-lite and SD3-lite: batched against
    each request alone through both kernels, held to quickstart's bars, on
    the default sides and on ``PAIR``."""
    counts = {}
    for kind in ("unet", "dit"):
        out, counts[f"quickstart_{kind}"], _, _ = entry_quickstart_run(dev, kind)
        name = out["cfg"].name
        # the same without the kernels: what batching alone does to exactness
        plain = qs.run(kind, full=True, device=dev, use_kernels=False)
        log(f"[entry quickstart] {name} plain path, batched against alone: "
            + "; ".join(f"step {r['step']} max {r['max_abs_err']:.3e} PSNR {r['psnr']:.2f} "
                        f"bitwise {r['bitwise']}" for r in plain["rows"]))
        kern = [max_err(a, b, 1e-3, f"{name} request {i} kernels against plain")
                for i, (a, b) in enumerate(zip(out["batched"], plain["batched"]))]
        log(f"[entry quickstart] {name} batched, kernels against plain: max abs "
            f"err {[f'{e:.3e}' for e in kern]} (tol 1e-3)")
        del out, plain
        out, counts[f"quickstart_{kind}_pair"], batched, alone = entry_quickstart_run(
            dev, kind, PAIR[kind])
        changed = [(B, S, n, sorted({a[2] for seg in alone for a in seg if a[1] == S}))
                   for B, S, n in batched
                   if any(a[1] == S and a[2] != n for seg in alone for a in seg)]
        log(f"[entry quickstart] {name} on {PAIR[kind]}: batched groups whose split_kv "
            f"differs from alone (B, S, batched, alone): {changed}")
        if not changed:
            raise RuntimeError(f"{name} on {PAIR[kind]}: every batched attention group took "
                               "the split_kv it takes alone")
        del out
        torch.cuda.empty_cache()
    return counts


def entry_serve(dev) -> dict:
    """(b) ``launch.serve --cache`` and (c) ``serve_hybrid_resolution
    --full`` on the card, real clock: every request accounted for and every
    image finite and of its request's size."""
    counts = {}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        m, counts["launch_serve"] = entry_run(
            "launch.serve --cache", lambda: serve_cli.main(["--cache", "--duration", "2"]))
    log(printed.getvalue().rstrip())
    submitted = int(re.search(r"requests=(\d+)", printed.getvalue()).group(1))
    if m.completed < 1 or m.completed + m.dropped != submitted:
        raise RuntimeError(f"launch.serve: {m.completed} completed, {m.dropped} dropped "
                           f"of {submitted}")
    with tempfile.TemporaryDirectory() as tmp:
        out, counts["serve_hybrid_full"] = entry_run(
            "serve_hybrid_resolution --full",
            lambda: hybrid.main(["--full", "--duration", "2", "--out", f"{tmp}/img.npy"]))
    m, wl, eng = out["metrics"], out["workload"], out["engine"]
    if m.completed < 1 or m.completed + m.dropped != len(wl):
        raise RuntimeError(f"serve_hybrid: {m.completed} completed, {m.dropped} dropped "
                           f"of {len(wl)}")
    by_rid = {r.rid: r for r in wl}
    for rid, img in eng.outputs.items():
        h, w = by_rid[rid].resolution
        if img.shape != (8 * h, 8 * w, 3) or not np.all(np.isfinite(img)):
            raise RuntimeError(f"serve_hybrid request {rid}: image {img.shape}")
    log(f"[entry serve] serve_hybrid --full: submitted={len(wl)} completed={m.completed} "
        f"dropped={m.dropped} SLO={m.slo_satisfaction:.3f} steps={len(m.step_latencies)} "
        f"median step ms={1e3 * float(np.median(m.step_latencies)):.3f} images "
        f"{len(eng.outputs)} finite")
    del out, eng
    torch.cuda.empty_cache()
    return counts


def entry_train() -> None:
    """(d) ``train_small_lm`` (reduced internlm2-1.8b, fp32, 8 steps) on the
    card against the same steps on the CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        card = train_example.main(["--ckpt", f"{tmp}/card"])
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = train_example.main(["--device", "cpu", "--ckpt", f"{tmp}/cpu"])
        host_s = time.perf_counter() - t0
    errs = [abs(a - b) / abs(b) for a, b in zip(card["losses"], host["losses"])]
    log(f"[entry train] losses card {[round(x, 6) for x in card['losses']]} ({card_s:.1f} s), "
        f"cpu {[round(x, 6) for x in host['losses']]} ({host_s:.1f} s); max rel err "
        f"{max(errs):.3e} (tol 1e-4); restored step {card['restored_step']}")
    if max(errs) > 1e-4 or card["restored_step"] != 8 or not card["losses"][-1] < card["losses"][0]:
        raise RuntimeError("train_small_lm on the card: losses or restore off")


def same(a, b) -> bool:
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


def entry_sim(dev) -> None:
    """(e) the sim-clock demos with their tiny model on the card and on the
    CPU: deterministic, so equal."""
    t0 = time.perf_counter()
    rows = {d: slo_demo.rows([8.0, 24.0], 10.0, device=d) for d in (dev, "cpu")}
    if rows[dev] != rows["cpu"]:
        raise RuntimeError(f"slo_scheduler_demo rows differ: {rows}")
    log(f"[entry sim] slo_scheduler_demo rows (qps, slo, fcfs, same-res) {rows[dev]}, "
        f"card == cpu")
    pol = {d: cluster_example.policies(cut=5.0, device=d) for d in (dev, "cpu")}
    if not same(pol[dev], pol["cpu"]):
        raise RuntimeError("serve_cluster policies differ between the card and the CPU")
    log(f"[entry sim] serve_cluster policies on 5 s: summaries card == cpu "
        f"({time.perf_counter() - t0:.1f} s)")


def entry_calibrate(dev) -> dict:
    """(f) ``calibrate_cache_hit_model --full``: the fit beside the
    checked-in one (a measurement, not a gate)."""
    with tempfile.TemporaryDirectory() as tmp:
        _, counts = entry_run("calibrate_cache_hit_model --full",
                              lambda: calibrate.main(["--full", "--out", f"{tmp}/cal.json"]))
    return {"calibrate_full": counts}


def phase_entry(dev) -> dict:
    """Phase 9: the entry points. Returns each path's kernel launches."""
    t0 = time.perf_counter()
    counts = entry_quickstart(dev)
    counts.update(entry_serve(dev))
    entry_train()
    entry_sim(dev)
    counts.update(entry_calibrate(dev))
    log(f"[entry] phase 9 in {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

# SD3-lite's sides at patch 16 (4 + 9 + 16 = 29 patches), and 48² + 2 x 32²,
# whose 32² attention group has B = 2
DTYPE_LADDER = [(32, 32), (48, 48), (64, 64)]
DTYPE_SIDES = (DTYPE_LADDER, [(48, 48), (32, 32), (32, 32)])


def engine_requests(dev, cfg, params, sides, use_cache: bool) -> tuple:
    """(engine, requests): an engine of ``cfg`` on the ladder's sides and one
    prepared request per side, at step 40 of 50."""
    ecfg = EngineConfig(clock="real", use_cache=use_cache, cache_capacity=512, seed=3)
    eng = PatchedServeEngine(cfg, params, ecfg, dict.fromkeys(DTYPE_LADDER, 1.0), DTYPE_LADDER,
                             device=dev)
    reqs = [Request(rid=i, resolution=r, arrival=0.0, slo=1e9, total_steps=50, steps_done=40,
                    prompt=f"prompt-{i}") for i, r in enumerate(sides)]
    for r in reqs:
        eng._prepare(r)
    return eng, reqs


def dtype_steps(dev, cfg, params, sides, use_cache: bool, n_steps: int = 3) -> tuple:
    """``n_steps`` engine steps of ``cfg`` on one request per side, from step
    40 of 50, the launch counts set to 0 just before and read just after:
    (latents, step ms, launches, cache savings per step)."""
    eng, reqs = engine_requests(dev, cfg, params, sides, use_cache)
    reset_launches()
    ms, savings = [], []
    for _ in range(n_steps):
        saved, t = timed_step(lambda: eng._denoise_step(reqs))
        ms.append(t)
        savings.append(saved)
    counts = launches()
    check_gn_kernels()
    return [r.latent for r in reqs], ms, counts, savings


def dtype_timing(dev, params: dict, n: int = 5) -> dict:
    """dtype -> (kernel-route step ms, the median of ``n`` steps after one
    warm step; peak device memory in MiB above what was allocated before the
    run), cache off on the 29-patch composition, in turns fp32, bf16, bf16,
    fp32."""
    ms = {dtype: [] for dtype in params}
    peak = dict.fromkeys(params, 0.0)
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _, step_ms, _, _ = dtype_steps(dev, dataclasses.replace(SD3_LITE, dtype=dtype),
                                       params[dtype], DTYPE_LADDER, False, n_steps=n + 1)
        ms[dtype] += step_ms[1:]
        peak[dtype] = max(peak[dtype], (torch.cuda.max_memory_allocated(dev) - before) / 2 ** 20)
    return {dtype: (float(np.median(ms[dtype])), peak[dtype]) for dtype in params}


def phase_dtype(dev, smi: str, sd3_step_ms: float) -> dict:
    """Phase 10: SD3-lite with bf16 weights, and the same draws in fp32
    beside it, through the engine, kernel route against plain route.
    Returns the kernel route's launches per run."""
    t0 = time.perf_counter()
    params = {dtype: init_diffusion(dataclasses.replace(SD3_LITE, dtype=dtype),
                                    torch.Generator().manual_seed(0), device=dev)
              for dtype in ("float32", "bfloat16")}
    counts, lats = {}, {}
    for dtype, sides, use_cache in itertools.product(params, DTYPE_SIDES, (False, True)):
        base = dataclasses.replace(SD3_LITE, dtype=dtype)
        tag = f"sd3-lite dtype={dtype} sides={[h for h, _ in sides]} cache={use_cache}"
        runs = {use: dtype_steps(dev, dataclasses.replace(base, use_kernels=use), params[dtype],
                                 sides, use_cache) for use in (True, False)}
        (got, ms, n, saved), (want, plain_ms, plain_n, plain_saved) = runs[True], runs[False]
        for i, (a, b) in enumerate(zip(got, want)):
            if {a.dtype, b.dtype} != {torch.float32} or not (
                    torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise RuntimeError(f"{tag} request {i}: latents {a.dtype}/{b.dtype}, "
                                   "not finite fp32")
        err = max(max_err(a, b, 1e-4, f"{tag} request {i} kernels against plain")
                  for i, (a, b) in enumerate(zip(got, want)))
        db = min(psnr(a, b) for a, b in zip(got, want))
        if db <= 80:
            raise RuntimeError(f"{tag}: PSNR {db:.2f} dB of kernels against plain <= 80")
        if n["patch_attention"] <= 0 or sum(plain_n.values()) != 0:
            raise RuntimeError(f"{tag}: launches kernel route {n}, plain route {plain_n}")
        n_patches = sum(h * w for h, w in sides) // 16 ** 2
        counts[f"{dtype}_{n_patches}p_cache_{'on' if use_cache else 'off'}"] = n
        lats[(dtype, tuple(sides), use_cache)] = got
        log(f"[dtype] {tag}: max |kernels - plain| {err:.3e} (tol 1e-4) PSNR {db:.2f} dB; "
            f"launches {n}, plain {plain_n}; step ms kernels {[round(x, 3) for x in ms]} "
            f"plain {[round(x, 3) for x in plain_ms]}; share of patches reused per step "
            f"and block, kernels {[sorted(set(x)) for x in saved]} plain "
            f"{[sorted(set(x)) for x in plain_saved]}")
    for (dtype, sides, use_cache), got in lats.items():
        if dtype == "bfloat16":
            d = max(float((a - b).abs().max())
                    for a, b in zip(got, lats[("float32", sides, use_cache)]))
            log(f"[dtype] sides={[h for h, _ in sides]} cache={use_cache}: max |bf16 weights - "
                f"fp32 weights| over the latents {d:.3e} (not a gate)")
    timing = dtype_timing(dev, params)
    log(f"[dtype] {smi}: SD3-lite engine step on 32²/48²/64², cache off, kernel route "
        f"(median of 10 steps in turns): bf16 weights {timing['bfloat16'][0]:.3f} ms, fp32 "
        f"weights {timing['float32'][0]:.3f} ms; phase 3's fp32 sampler_step on 32²+64² "
        f"{sd3_step_ms:.3f} ms; peak device memory of the run, MiB: bf16 "
        f"{timing['bfloat16'][1]:.1f}, fp32 {timing['float32'][1]:.1f}")
    log(f"[dtype] phase 10 in {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

# two public text-to-image models' widths on the repo's own block structure:
# PixArt-α (arXiv:2310.00426; 28 blocks, hidden 1152, 16 heads: D = 72; T5
# text 120 x 4096) and Stable Diffusion 1.5 (CompVis v1-inference.yaml: 320
# channels x [1, 2, 4, 4] with attention at the first three levels, 2 res
# blocks a level, 8 heads: D = 40 / 80 / 160; GroupNorm 32; CLIP text 77 x
# 768), whose three attention levels are built and fourth is not
PIXART_ALPHA = DiffusionConfig(name="pixart-alpha-shaped", kind="dit", width=1152,
                               dit_depth=28, n_heads=16, d_text=4096, n_text=120, t_dim=256)
SD15 = DiffusionConfig(name="sd1.5-shaped", kind="unet", width=320, levels=3,
                       blocks_per_level=2, attn_levels=(0, 1, 2), n_heads=8, groups=32,
                       d_text=768, n_text=77, t_dim=320)
HEADS_SIDES = {PIXART_ALPHA.name: DTYPE_SIDES, SD15.name: (DTYPE_LADDER,)}
# what each shape leaves out of its model (widths and heads are never cut)
HEADS_CUT = {PIXART_ALPHA.name: "nothing cut",
             SD15.name: "SD 1.5's fourth level (1280 channels, no attention) left out"}
# kernel route against plain route, relative to the largest |latent| of the
# plain route; and the repo's PSNR bar (tests/test_system.py)
HEADS_TOL, HEADS_PSNR = 1e-4, 80.0


@contextlib.contextmanager
def attention_shapes():
    """Yields the set of (B, S, H, D, instance width) of every attention call
    made through the kernels' entry point while inside."""
    from repro_torch.kernels import ops
    seen, attention = set(), ops.patch_attention

    def rec(q, k, v):
        B, S, H, D = q.shape
        seen.add((B, S, H, D, instance_width(D)))
        return attention(q, k, v)

    ops.patch_attention = rec
    try:
        yield seen
    finally:
        ops.patch_attention = attention


def heads_timing(dev, cfg, params, n: int = 5) -> tuple:
    """(kernel route, plain route) engine step ms on the 29-patch ladder,
    cache off: each the median of ``n`` steps after one warm step, the two
    routes stepping in turns (kernel, plain, plain, kernel, ...)."""
    runs = {use: engine_requests(dev, dataclasses.replace(cfg, use_kernels=use), params,
                                 DTYPE_LADDER, False) for use in (True, False)}
    ms = {True: [], False: []}
    for i in range(n + 1):
        for use in ((True, False) if i % 2 == 0 else (False, True)):
            eng, reqs = runs[use]
            _, t = timed_step(lambda: eng._denoise_step(reqs))
            if i:
                ms[use].append(t)
    return float(np.median(ms[True])), float(np.median(ms[False]))


def heads_compare(dev, cfg, params, sides) -> dict:
    """Three engine steps through the kernels against the plain route on one
    request per side: the checks, the launches, the attention shapes and
    instance widths that ran, and each route's peak device memory."""
    tag = f"{cfg.name} sides={[h for h, _ in sides]}"
    runs, peak, shapes = {}, {}, {}
    for use in (True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with attention_shapes() as seen:
            runs[use] = dtype_steps(dev, dataclasses.replace(cfg, use_kernels=use), params,
                                    sides, False)
        if use:   # the fp32 models' every attention call on the wgmma route
            routes = dict(patch_attention.launches_by_route)
            gemm_routes = dict(fp32_gemm.launches_by_route)
        peak[use] = (torch.cuda.max_memory_allocated(dev) - before) / 2 ** 20
        shapes[use] = sorted(seen)
    (got, ms, n, _), (want, plain_ms, plain_n, _) = runs[True], runs[False]
    for i, (a, b) in enumerate(zip(got, want)):
        if {a.dtype, b.dtype} != {torch.float32} or not (
                torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise RuntimeError(f"{tag} request {i}: latents {a.dtype}/{b.dtype}, not finite fp32")
    scale = max(float(b.abs().max()) for b in want)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    db = min(psnr(a, b) for a, b in zip(got, want))
    if not err <= HEADS_TOL * scale or db <= HEADS_PSNR:
        raise RuntimeError(f"{tag}: kernels against plain max abs {err:.3e} (bar "
                           f"{HEADS_TOL:g} x {scale:.3e}), PSNR {db:.2f} dB (bar {HEADS_PSNR})")
    need = ("patch_attention",) + (("groupnorm_stitch",) if cfg.kind == "unet" else ())
    if any(n[k] <= 0 for k in need) or sum(plain_n.values()) != 0 or shapes[False]:
        raise RuntimeError(f"{tag}: launches kernel route {n}, plain route {plain_n}, "
                           f"plain-route attention calls {shapes[False]}")
    if routes["wgmma_3xbf16"] != n["patch_attention"]:
        raise RuntimeError(f"{tag}: attention launches_by_route {routes}")
    if gemm_routes["wgmma_3xtf32"] <= 0:
        raise RuntimeError(f"{tag}: no product on the GEMM kernel: {gemm_routes}")
    widths = sorted({(D, w) for *_, D, w in shapes[True]})
    log(f"[heads] {tag}: max |kernels - plain| {err:.3e} = {err / scale:.3e} of max |latent| "
        f"{scale:.3e} (bar {HEADS_TOL:g}) PSNR {db:.2f} dB; launches {n}, plain {plain_n}; "
        f"attention launches_by_route {routes}; fp32_gemm launches_by_route {gemm_routes}; "
        f"(head dim, instance width) {widths}; attention (B, S, H) "
        f"{sorted({(B, S, H) for B, S, H, *_ in shapes[True]})}; step ms kernels "
        f"{[round(x, 3) for x in ms]} plain {[round(x, 3) for x in plain_ms]}; peak device "
        f"memory MiB kernels {peak[True]:.1f} plain {peak[False]:.1f}")
    return dict(launches=n, gemm_routes=gemm_routes, max_abs_err=err, rel_err=err / scale,
                psnr=db, widths=[w for _, w in widths], peak_mib=peak[True],
                plain_peak_mib=peak[False])


def phase_heads(dev, smi: str) -> dict:
    """Phase 11: PixArt-α- and SD 1.5-shaped models at full width (depth as
    ``HEADS_CUT`` says), seed-0 weights drawn on the card, through the
    engine, kernel route against plain route. Returns the kernel route's
    launches per run."""
    t0 = time.perf_counter()
    counts = {}
    for cfg in (PIXART_ALPHA, SD15):
        t_cfg = time.perf_counter()
        params = init_diffusion(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        n_params = sum(p.numel() for p in tree_leaves(params))
        for sides in HEADS_SIDES[cfg.name]:
            out = heads_compare(dev, cfg, params, sides)
            counts[f"{cfg.name}_{sum(h * w for h, w in sides) // 16 ** 2}p"] = dict(
                out["launches"], fp32_gemm=out["gemm_routes"])
        kernel_ms, plain_ms = heads_timing(dev, cfg, params)
        depth = (f"{cfg.dit_depth} blocks" if cfg.kind == "dit" else
                 f"{cfg.levels} levels x {cfg.blocks_per_level} res blocks")
        log(f"[heads] {smi}: {cfg.name} (width {cfg.width}, {depth}, {cfg.n_heads} heads, "
            f"{HEADS_CUT[cfg.name]}; {n_params / 1e6:.1f} M params, fp32) engine step on "
            f"32²/48²/64², cache off, median of 5 in turns: kernels {kernel_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms; {time.perf_counter() - t_cfg:.1f} s")
        del params
        torch.cuda.empty_cache()
    log(f"[heads] phase 11 in {time.perf_counter() - t0:.1f} s")
    return counts


SHAPE_KEYS = ("level", "P", "p", "C", "G", "B", "S", "Sk", "H", "D", "dtype", "exact",
              "n_split")


def kernels_line(results: dict, main_launches: dict, fleet: dict, entry: dict,
                 dtype: dict, heads: dict) -> dict:
    """One entry per kernel: the fp32 case at the largest main-path shape,
    with the largest fp32 error over all its cases; ``launches`` from the
    main path's run (phase 4), ``fleet_launches`` from each fleet run,
    ``entry_launches`` from each entry point's run (phase 9),
    ``dtype_launches`` from each kernel-route run of phase 10,
    ``heads_launches`` from each kernel-route run of phase 11, for
    GroupNorm+stitch the fleet's new patch sides (``fleet_shapes``) and for
    attention phase 2's rows at public head dims (``public_heads``); for each,
    phase 2's rows off the main path (``domain``: other key lengths, head
    dims past 256, fp16, groups past 512) and the C entry points of its
    library (``entry_points``)."""
    keep = SHAPE_KEYS + ("width", "slices", "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")
    prefixes = {"groupnorm_stitch": "ps_gn_", "patch_attention": "ps_patch_attention_"}
    out = []
    for name, (_, source, replaces) in KERNELS.items():
        rows = [r for r in results[name] if r["dtype"] == "float32"]
        pick = max(rows, key=lambda r: r["bound_ms"])
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": main_launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": pick["ms"], "plain_ms": pick["plain_ms"], "bound_ms": pick["bound_ms"],
                    "bound_by": "bytes" if pick["bound_by"] == "bytes" else "operations",
                    "library_ms": pick["library_ms"],
                    "shape": {k: v for k, v in pick.items() if k in SHAPE_KEYS},
                    "fleet_launches": {policy: counts[name]
                                       for policy, counts in fleet["launches"].items()},
                    "entry_launches": {path: counts[name] for path, counts in entry.items()},
                    "dtype_launches": {run: counts[name] for run, counts in dtype.items()},
                    "heads_launches": {run: counts[name] for run, counts in heads.items()},
                    "entry_points": [f for f in build.SIGNATURES
                                     if f.startswith(prefixes[name])],
                    "domain": [{k: v for k, v in r.items() if k in keep}
                               for r in results[f"domain_{name}"]]})
        if name == "groupnorm_stitch":
            out[-1]["fleet_shapes"] = [
                {k: v for k, v in r.items()
                 if k in SHAPE_KEYS + ("max_abs_err", "ms", "bound_ms", "bound_by")}
                for r in fleet["groupnorm_stitch"]]
        else:
            out[-1]["public_heads"] = [{k: v for k, v in r.items() if k in keep}
                                       for r in results["public_heads"]]
            out[-1]["cell_heads"] = [{k: v for k, v in r.items() if k in keep}
                                     for r in results["cell_heads"]]
    rows = results["fp32_gemm"]
    out.append({"name": "fp32_gemm", "route": "cuda", "source": GEMM_SOURCE,
                "replaces": "none (the reference's products are jnp matmuls compiled by XLA)",
                "max_rms_err": max(r["rms_err"] for r in rows),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "cell_gemms": rows, "entry_points": ["ps_fp32_gemm"],
                "heads_routes": {run: counts["fp32_gemm"] for run, counts in heads.items()}})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 is off for cuDNN convs and cuBLAS matmuls in every phase")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    results = phase_kernels(dev)
    step_ms = phase_step(dev)
    main_launches, cache_samples = phase_serve(dev)
    fleet = phase_fleet(dev, cache_samples)
    phase_lm(dev, smi)
    phase_train(dev, smi)
    phase_dist(dev, smi)
    entry = phase_entry(dev)
    dtype = phase_dtype(dev, smi, step_ms[SD3_LITE.name])
    heads = phase_heads(dev, smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels_line(results, main_launches, fleet, entry, dtype, heads)))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
