"""Plain PyTorch versions of the CUDA kernels: the CPU path and the oracle
the kernels are held against; and plain models of the attention kernel's
split-KV cut and of the kernels' tensor-core arithmetic."""
from __future__ import annotations

import math

import torch

from repro_torch.core.stitcher import gather_halo

# Keys per tile of the attention kernel's split-KV cut: kBlockK in
# csrc/patch_attention.cu, which a test holds equal (an instance may walk a
# tile as smaller shared-memory tiles). The wrapper's split rule and
# key_ranges count in it.
BLOCK_K = 64


def ref_gn_partials(patches, groups: int):
    """(P, p, p, C) -> (P, G, 2) fp32 (sum x, sum x^2) per patch and channel
    group: the partials kernel."""
    P, p, _, C = patches.shape
    x = patches.float().reshape(P, p * p, groups, C // groups)
    return torch.stack([x.sum(dim=(1, 3)), (x * x).sum(dim=(1, 3))], dim=-1)


def ref_gn_finalize(partials, patch_req, request_offset, p: int, C: int,
                    eps: float = 1e-5, exact: bool = True):
    """(P, G, 2) partials -> per-patch (P, G) mean and rstd, as the stitch
    kernel's prologue makes them: from the sums of the patch's request
    (exact) or of the patch itself, with the reference's variance
    max(s2/cnt - mean^2, 0) (``core.patched_ops.csp_group_stats``)."""
    G = partials.shape[1]
    n_pix = p * p * (C // G)                       # elements of a patch and group
    if exact:
        seg = patch_req.long()
        n = (request_offset[1:] - request_offset[:-1]).long()
        sums = torch.zeros((len(n), G, 2), device=partials.device).index_add(
            0, seg, partials)[seg]
        cnt = (n[seg] * n_pix).float()[:, None]
    else:
        sums, cnt = partials, float(n_pix)
    mean = sums[..., 0] / cnt
    var = torch.clamp(sums[..., 1] / cnt - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def ref_groupnorm_stitch(patches, neighbors, mean_c, rstd_c, scale, bias,
                         halo: int = 1):
    """Normalize (per-patch per-channel stats) then halo-gather."""
    x = patches.float()
    normed = ((x - mean_c[:, None, None, :]) * rstd_c[:, None, None, :]
              * scale.float() + bias.float()).to(patches.dtype)
    return gather_halo(normed, neighbors, halo)


def ref_attention(q, k, v, scale=None):
    """q (B, Sq, H, D), k and v (B, Sk, H, D): full bidirectional attention,
    fp32 softmax."""
    D = q.shape[-1]
    sc = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def key_ranges(Sk: int, n_split: int) -> list:
    """The key range [start, stop) of each split of ``Sk`` keys as the
    attention kernel cuts them: the T = ceil(Sk / BLOCK_K) key tiles shared
    out as evenly as whole tiles allow, range i holding tiles
    [i*T // n, (i+1)*T // n)."""
    tiles = -(-Sk // BLOCK_K)
    return [(i * tiles // n_split * BLOCK_K, min(Sk, (i + 1) * tiles // n_split * BLOCK_K))
            for i in range(n_split)]


def ref_attention_split(q, k, v, n_split: int):
    """``ref_attention`` computed as the split-KV kernel does: an unnormalised
    fp32 partial (acc, m, l) per key range, merged by log-sum-exp."""
    sc = q.shape[-1] ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    parts = []
    for start, stop in key_ranges(k.shape[1], n_split):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, start:stop]) * sc
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((torch.einsum("bhqk,bkhd->bhqd", p, vf[:, start:stop]), m,
                      p.sum(dim=-1, keepdim=True)))
    mx = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    num = sum(acc * torch.exp(m - mx) for acc, m, _ in parts)
    den = sum(l * torch.exp(m - mx) for _, m, l in parts)
    return (num / den).permute(0, 2, 1, 3).to(q.dtype)


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """fp32 ``x`` rounded to ``bits`` explicit mantissa bits, to nearest with
    ties away from zero (``cvt.rna``): TF32 keeps 10, bf16 7."""
    drop = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, bits: int, passes: int) -> torch.Tensor:
    """a @ b as tensor-core passes with fp32 accumulators compute it: one pass
    of both operands rounded to ``bits``, or three, hi*hi + hi*lo + lo*hi with
    x = hi + lo. Each product of two such values is exact in fp32."""
    ah, bh = round_mantissa(a, bits), round_mantissa(b, bits)
    if passes == 1:
        return ah @ bh
    al, bl = round_mantissa(a - ah, bits), round_mantissa(b - bh, bits)
    return al @ bh + ah @ bl + ah @ bh


def emulated_attention(q, k, v, bits: int = 7, passes: int = 3):
    """(B, Sq, H, D) attention with both products rounded as tensor-core
    passes round them (the fp32 kernel: bf16, three passes; the bf16 kernel:
    one) and the softmax in fp32, as in the kernel: the scale times log2(e)
    applied to the scores, exp2, the row sum of the unrounded P."""
    c = q.shape[-1] ** -0.5 * math.log2(math.e)
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))     # (B, H, S, D)
    s = split_matmul(qf, kf.transpose(-1, -2), bits, passes)
    p = torch.exp2(s * c - s.amax(dim=-1, keepdim=True) * c)
    o = split_matmul(p, vf, bits, passes) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def emulated_tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the fp32 GEMM kernel computes it: both operands
    split into TF32 halves by round-to-nearest (``cvt.rna``), three passes
    small*big + big*small + big*big, fp32 accumulation. The kernel's CPU path."""
    return split_matmul(a.float(), b.float(), 10, 3)
