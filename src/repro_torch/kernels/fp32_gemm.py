"""Wrapper of the fp32 GEMM CUDA kernel (``csrc/fp32_gemm.cu``): ``a @ w``
of an fp32 activation and a weight on the tensor cores, in three TF32
passes. It replaces no TPU kernel: the JAX package leaves its products to
XLA, and this port leaves to ``torch.matmul`` the shapes the kernel does not
take (``route``).

``weight_matmul`` is what the models call (through ``patched_ops.matmul``
under ``use_kernels``): it picks the route from the input alone and counts
each call on it in ``fp32_gemm.launches_by_route``; ``fp32_gemm.launches``
counts the kernel's launches. A weight is split into its TF32 halves once,
at its first use, and the halves are kept outside the parameter tree, keyed
by the weight's tensor and its version counter (``weight_halves``).
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.kernels import build
from repro_torch.kernels.patch_attention import sm_count
from repro_torch.kernels.ref import emulated_tf32x3_matmul, round_mantissa

# the routes of a product under use_kernels on the card
ROUTES = ("wgmma_3xtf32", "torch")
# the least M (rows of a), N and K the kernel takes. Below M = 1024 its tiles
# fill too few SMs and each walks all of K alone, and cuBLAS's FFMA kernels
# are as fast at some (N, K) of the models (PERF.md); below N, K = 256 a
# product is too small to matter, and below K = 256 a stage's truncated sum
# is a large share of the result (the kernel's error passes 2x an FFMA
# product's at K = 36)
MIN_M, MIN_N, MIN_K = 1024, 256, 256
TILE_M = 128                       # kBM in csrc/fp32_gemm.cu
# the kernel's tile widths, and each one's throughput a tile relative to the
# widest at the cells' shapes (PERF.md): narrow tiles fill the card at small M
# but read shared memory more per flop
TILE_N_RATE = {128: 1.0, 64: 0.7}

_halves = WeakTensorKeyDictionary()   # weight base -> {view geometry: (version, big, small)}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fp32_gemm: {msg}")


def route(dtype: torch.dtype, device: torch.device, M: int, N: int, K: int) -> str:
    """The route of an (M, K) @ (K, N) product in ``dtype`` on ``device``:
    the kernel for fp32 on CUDA at M, N, K at or above their thresholds with
    K a multiple of 4 and N even; ``torch.matmul`` otherwise."""
    takes = (dtype == torch.float32 and device.type == "cuda" and M >= MIN_M and N >= MIN_N
             and K >= MIN_K and K % 4 == 0 and N % 2 == 0)
    return ROUTES[0] if takes else ROUTES[1]


def tile_n(M: int, N: int, n_sm: int) -> int:
    """The tile width for an (M, N) output on ``n_sm`` SMs: the one whose
    whole waves of TILE_M x width tiles take the least time, each width at
    its relative rate (ties to the wider)."""
    def cost(bn: int) -> float:
        tiles = -(-M // TILE_M) * -(-N // bn)
        return -(-tiles // n_sm) * bn / TILE_N_RATE[bn]
    return min(TILE_N_RATE, key=cost)


def weight_halves(w: torch.Tensor) -> tuple:
    """(K, N) ``w`` -> its TF32 halves (big, small), K-major (N, K) fp32 and
    contiguous: big = rna(w), small = rna(w - big), so w = big + small to
    about 2^-22 of w. Computed once per weight and version: kept while the
    tensor that holds ``w`` lives, computed again after an in-place change."""
    base = w if w._base is None else w._base
    views = _halves.get(base)
    if views is None:
        views = _halves[base] = {}
    version = 0 if w.is_inference() else w._version
    key = (w.storage_offset(), tuple(w.shape), w.stride(), w.dtype)
    hit = views.get(key)
    if hit is None or hit[0] != version:
        wt = w.float().t().contiguous()
        big = round_mantissa(wt, 10)
        hit = views[key] = (version, big, round_mantissa(wt - big, 10))
    return hit[1], hit[2]


def fp32_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) fp32 @ w (K, N) -> (M, N) fp32 contiguous, in three TF32
    passes (a 16-bit ``w`` is taken as its fp32 values). A CPU ``a`` takes
    the plain version (``ref.emulated_tf32x3_matmul``); on CUDA it launches
    the kernel or raises: ``a`` with unit stride along K, a row stride and K
    multiples of 4, a 16-byte aligned base, N even."""
    if a.device.type == "cpu":
        return emulated_tf32x3_matmul(a, w)
    _check(a.device.type == "cuda" and w.device == a.device,
           f"a and w on one CUDA device, got {a.device} and {w.device}")
    _check(a.dtype == torch.float32 and w.dtype in (torch.float32, torch.bfloat16, torch.float16),
           f"an fp32 a and a float w, got {a.dtype} and {w.dtype}")
    _check(a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[0],
           f"a (M, K) and w (K, N), got {tuple(a.shape)} and {tuple(w.shape)}")
    M, K = a.shape
    N = w.shape[1]
    _check(M > 0 and N > 0 and K > 0, f"an empty product {M} x {K} x {N}")
    _check(K % 4 == 0 and N % 2 == 0, f"K a multiple of 4 and N even, got K={K}, N={N}")
    _check(a.stride(1) == 1 and a.stride(0) % 4 == 0 and a.stride(0) >= K
           and a.data_ptr() % 16 == 0,
           f"a with unit stride along K, a row stride a multiple of 4 and a 16-byte aligned "
           f"base, got strides {a.stride()}")
    big, small = weight_halves(w)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    n_sm = sm_count(a.device.index)
    bn = tile_n(M, N, n_sm)
    grid = min(-(-M // TILE_M) * -(-N // bn), n_sm)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    build.check(build.library().ps_fp32_gemm(a.data_ptr(), big.data_ptr(), small.data_ptr(),
                                             out.data_ptr(), M, N, K, a.stride(0), bn, grid,
                                             stream), "fp32_gemm")
    fp32_gemm.launches += 1
    fp32_gemm.launches_by_route[ROUTES[0]] += 1
    return out


fp32_gemm.launches = 0
fp32_gemm.launches_by_route = dict.fromkeys(ROUTES, 0)


def weight_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ w (K, N), ``w`` a weight, with jnp's type promotion, on
    the card: the kernel where ``route`` takes the promoted dtype and shape,
    else ``torch.matmul``; each call counted once on its route."""
    dt = torch.promote_types(a.dtype, w.dtype)
    K, N = w.shape
    M = a.numel() // K if K else 0
    if route(dt, a.device, M, N, K) == ROUTES[1]:
        fp32_gemm.launches_by_route[ROUTES[1]] += 1
        return a.to(dt) @ w.to(dt)
    a2 = a.to(dt).reshape(M, K)
    if a2.stride(1) != 1 or a2.stride(0) % 4 != 0 or a2.data_ptr() % 16 != 0:
        a2 = a2.contiguous()
    return fp32_gemm(a2, w).reshape(*a.shape[:-1], N)
