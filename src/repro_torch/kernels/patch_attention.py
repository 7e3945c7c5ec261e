"""Wrapper of the flash-attention CUDA kernel (``csrc/patch_attention.cu``),
the port of the TPU kernel ``src/repro/kernels/patch_attention.py``.

A CPU tensor takes the plain version (``ref.ref_attention``); a CUDA tensor
launches the kernel or raises. ``patch_attention.launches`` counts wrapper
calls that launched, one per call, whether or not the split-KV combine ran;
``patch_attention.launches_by_route`` counts the same calls by the kernel's
route (``route``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import BLOCK_K, ref_attention

NEG_INF = -1e30     # the TPU kernel's score of a padded key

_LAUNCHERS = {torch.float32: "ps_patch_attention_f32",
              torch.bfloat16: "ps_patch_attention_bf16",
              torch.float16: "ps_patch_attention_f16"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the padded head dims with a kernel instance (kWidths in csrc/patch_attention.cu,
# which a test holds equal); head dim D runs in the smallest width >= D, and a
# wider D in column slices of the widest (column_slices)
INSTANCE_WIDTHS = (16, 32, 48, 64, 80, 96, 128, 160, 192, 256)
SLICE_WIDTH = INSTANCE_WIDTHS[-1]
# the kernel's routes (launch_d in csrc/patch_attention.cu): fp32 below the
# widest instance on wgmma in three bf16 passes; bf16, fp16 and every D past
# the widest instance on mma.sync
ROUTES = ("wgmma_3xbf16", "mma_sync")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"patch_attention: {msg}")


def instance_width(D: int) -> int:
    """The padded head dim of the kernel instance that runs head dim ``D``
    whole; raises ``ValueError`` outside 1..SLICE_WIDTH (a wider D runs in
    ``column_slices(D)`` slices of the widest instance)."""
    _check(1 <= D <= SLICE_WIDTH,
           f"head dim {D} not in 1..{SLICE_WIDTH} (the kernel's widest instance)")
    return next(w for w in INSTANCE_WIDTHS if w >= D)


def column_slices(D: int) -> int:
    """How many SLICE_WIDTH-wide column slices of v and o the kernel's grid
    takes for head dim ``D``: 1 up to the widest instance, and past it each
    slice's block computes the scores over the whole D and writes its own
    columns of o. Raises ``ValueError`` for D < 1."""
    _check(D >= 1, f"head dim {D} < 1")
    return -(-D // SLICE_WIDTH)


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel route that runs head dim ``D`` in ``dtype``: chosen by the
    two alone."""
    return ROUTES[0] if dtype == torch.float32 and D <= SLICE_WIDTH else ROUTES[1]


def row_width(D: int, element_size: int) -> int:
    """The head dim the kernel is handed for ``D``: ``D`` itself when a row
    is whole 16-byte chunks, else the next width that is (the wrapper
    zero-pads q, k and v to it in a copy and drops the extra columns of o)."""
    chunk = 16 // element_size
    return -(-D // chunk) * chunk


def split_kv(B: int, S: int, H: int, n_sm: int, block_q: int, Sk: int | None = None,
             slices: int = 1) -> int:
    """How many key ranges each (query tile, head, batch) is cut into, for
    ``S`` queries and ``Sk`` keys (``S`` when None).

    1 when the B * H * ceil(S / block_q) * ``slices`` query tiles already
    fill the ``n_sm`` SMs; otherwise enough ranges to reach ``n_sm`` blocks,
    at most one per key tile so that every range holds a key
    (``ref.key_ranges``). ``block_q`` is the query rows per block of the
    kernel instance that runs (``block_q(dtype, D)``), ``slices`` its
    ``column_slices(D)``."""
    q_tiles = B * H * -(-S // block_q) * slices
    if q_tiles >= n_sm:
        return 1
    return min(-(-n_sm // q_tiles), -(-(S if Sk is None else Sk) // BLOCK_K))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def block_q(dtype: torch.dtype, D: int) -> int:
    """Query rows per block of the kernel instance that runs (dtype, D), as
    the library reports it (it builds the library)."""
    rows = ctypes.c_int()
    build.check(build.library().ps_patch_attention_block_q(
        _DTYPE_CODE[dtype], D, ctypes.byref(rows)), "patch_attention block_q")
    return rows.value


def patch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, H, D), any strides with unit stride
    over D -> (B, Sq, H, D) contiguous full bidirectional attention, scale
    D**-0.5. On CUDA: fp32, bf16 or fp16, Sk >= 1, any D >= 1 (past 256 in
    ``column_slices(D)`` slices), and every base pointer and stride must be
    16-byte aligned; a D whose rows are not whole 16-byte chunks (16-bit
    D % 8, fp32 D % 4) runs on zero-padded copies (``row_width``)."""
    if q.device.type == "cpu":
        return ref_attention(q, k, v)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dim() == 4, f"expected q (B, Sq, H, D), got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    _check(q.dtype in _LAUNCHERS, f"unsupported dtype {q.dtype}")
    slices = column_slices(D)     # raises for D < 1
    _check(k.dim() == 4 and k.shape[0] == B and k.shape[2:] == q.shape[2:] and k.shape[1] >= 1,
           f"expected k (B, Sk, H, D) = ({B}, Sk >= 1, {H}, {D}), got {tuple(k.shape)}")
    Sk = k.shape[1]
    for t in (k, v):
        _check(t.shape == k.shape and t.dtype == q.dtype and t.device == q.device,
               "k and v must share shape, and q, k and v dtype and device")
    es = q.element_size()
    Dk = row_width(D, es)
    if Dk != D:   # a layout copy: the zero columns add nothing to q k^T
        q, k, v = (F.pad(t, (0, Dk - D)) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(3) == 1, "the head dimension must have unit stride")
        _check(t.data_ptr() % 16 == 0
               and all(st * es % 16 == 0 for st, n in zip(t.stride()[:3], t.shape) if n > 1),
               f"{name} needs a 16-byte aligned base pointer and batch, row and head "
               f"strides (the kernel copies 16-byte chunks), got strides {t.stride()}")
    if q.numel() == 0:
        return torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    out = torch.empty((B, Sq, H, Dk), dtype=q.dtype, device=q.device)
    n_split = split_kv(B, Sq, H, sm_count(q.device.index), block_q(q.dtype, D), Sk, slices)
    part_o = part_ml = None
    if n_split > 1:
        part_o = torch.empty((n_split, B * Sq * H, Dk), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((n_split, B * Sq * H, 2), dtype=torch.float32, device=q.device)
    fn = getattr(build.library(), _LAUNCHERS[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if part_o is None else part_o.data_ptr(),
                   None if part_ml is None else part_ml.data_ptr(),
                   B, Sq, Sk, H, Dk, n_split, *q.stride()[:3], *k.stride()[:3],
                   *v.stride()[:3], D ** -0.5, stream),
                "patch_attention")
    patch_attention.launches += 1
    patch_attention.launches_by_route[route(q.dtype, D)] += 1
    return out if Dk == D else out[..., :D].contiguous()


patch_attention.launches = 0
patch_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
