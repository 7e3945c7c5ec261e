"""Chunked (flash-style) attention in plain torch, with a custom backward.

The port of the reference's ``repro/models/flash.py``: the same blockwise
online softmax (fp32 running max, sum and accumulator per query block), with
Python loops over query and key blocks in place of its two ``lax.scan``s. The
reference reaches no Pallas kernel here, so neither does the port. Supports
GQA (H = KV * G), a value width other than the key width (MLA), causal and
sliding-window masks, ragged Sk (padding masked out) and a query offset.

Key blocks that the mask removes entirely for every query of a block are
skipped. That changes no value: in the reference such a block either adds
exactly zero (a valid key came earlier) or is washed out exactly by the
correction factor exp(NEG_INF - m) = 0 once a valid key arrives, and every
query row that is kept has a valid key (itself, under the causal mask).

The backward (the reference's custom VJP, ``_flash_vjp_bwd``) is a
``torch.autograd.Function``: it saves (q, k, v, o, lse), recomputes each
block's probabilities exp(s - lse), accumulates dq, dk and dv in fp32 and
skips the same fully masked blocks (each of their probabilities is exactly 0
for a kept query, and a padded query's output gradient is 0).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _pad_to(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _block_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int,
                sq: int, sk: int) -> torch.Tensor:
    """(bq, bk) bool validity for one (q-block, kv-block) pair."""
    m = (qpos[:, None] < sq) & (kpos[None, :] < sk)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
        if window:
            m &= kpos[None, :] > qpos[:, None] - window
    return m


def _block_needed(q0: int, q1: int, k0: int, k1: int, causal: bool, window: int) -> bool:
    """Whether any query position in [q0, q1) may see a key in [k0, k1)."""
    if not causal:
        return True
    if k0 > q1 - 1:                       # every key after every query
        return False
    if window and k1 - 1 <= q0 - window:  # every key left of every window
        return False
    return True


def _flash_fwd(q, k, v, causal, window, q_offset, block_q, block_k, scale):
    """-> (o (B,Sq,H,Dv) in q's dtype, lse (B,Sq,H) fp32)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    sc = scale if scale is not None else D ** -0.5

    qp = _pad_to(q, 1, block_q)
    kp = _pad_to(k, 1, block_k)
    vp = _pad_to(v, 1, block_k)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k

    qb = qp.reshape(B, nq, block_q, KV, G, D).float() * sc
    kb = kp.reshape(B, nk, block_k, KV, D).float()
    vb = vp.reshape(B, nk, block_k, KV, Dv).float()
    arange_q = torch.arange(block_q, device=q.device)
    arange_k = torch.arange(block_k, device=q.device)

    out, lses = [], []
    for iq in range(nq):
        q0 = iq * block_q + q_offset
        qblk = qb[:, iq]                                   # (B,bq,KV,G,D)
        qpos = arange_q + q0
        m = torch.full((B, KV, G, block_q), NEG_INF, dtype=torch.float32, device=q.device)
        ell = torch.zeros((B, KV, G, block_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, block_q, Dv), dtype=torch.float32, device=q.device)
        for jk in range(nk):
            k0 = jk * block_k
            if not _block_needed(q0, q0 + block_q, k0, k0 + block_k, causal, window):
                continue
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kb[:, jk])
            mask = _block_mask(qpos, arange_k + k0, causal, window, Sq + q_offset, Sk)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            ell = corr * ell + p.sum(dim=-1)
            acc = corr[..., None] * acc + torch.einsum("bkgqs,bskv->bkgqv", p, vb[:, jk])
            m = m_new
        ell = torch.clamp(ell, min=1e-30)
        out.append(acc / ell[..., None])                   # (B,KV,G,bq,Dv)
        lses.append(m + torch.log(ell))                    # (B,KV,G,bq)
    o = torch.stack(out, dim=1)                            # (B,nq,KV,G,bq,Dv)
    o = o.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * block_q, H, Dv)[:, :Sq]
    lse = torch.stack(lses, dim=1)                         # (B,nq,KV,G,bq)
    lse = lse.permute(0, 1, 4, 2, 3).reshape(B, nq * block_q, H)[:, :Sq]
    return o.to(q.dtype), lse


def _flash_bwd(q, k, v, o, lse, do, causal, window, q_offset, block_q, block_k, scale):
    """-> (dq, dk, dv) in the dtypes of q, k, v; every sum in fp32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    sc = scale if scale is not None else D ** -0.5

    qp = _pad_to(q, 1, block_q).float()
    kp = _pad_to(k, 1, block_k).float()
    vp = _pad_to(v, 1, block_k).float()
    op = _pad_to(o, 1, block_q).float()
    dop = _pad_to(do, 1, block_q).float()
    lsep = _pad_to(lse, 1, block_q).float()
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k

    delta = torch.sum(op * dop, dim=-1)                    # (B,Sqp,H)
    qb = qp.reshape(B, nq, block_q, KV, G, D) * sc
    dob = dop.reshape(B, nq, block_q, KV, G, Dv)
    lb = lsep.reshape(B, nq, block_q, KV, G).permute(0, 1, 3, 4, 2)   # (B,nq,KV,G,bq)
    db = delta.reshape(B, nq, block_q, KV, G).permute(0, 1, 3, 4, 2)
    kb = kp.reshape(B, nk, block_k, KV, D)
    vb = vp.reshape(B, nk, block_k, KV, Dv)
    arange_q = torch.arange(block_q, device=q.device)
    arange_k = torch.arange(block_k, device=q.device)

    dk = torch.zeros((B, nk, block_k, KV, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, nk, block_k, KV, Dv), dtype=torch.float32, device=q.device)
    dqs = []
    for iq in range(nq):
        q0 = iq * block_q + q_offset
        qblk, doblk = qb[:, iq], dob[:, iq]
        lseblk, dblk = lb[:, iq, ..., None], db[:, iq, ..., None]
        qpos = arange_q + q0
        dq_blk = torch.zeros((B, block_q, KV, G, D), dtype=torch.float32, device=q.device)
        for jk in range(nk):
            k0 = jk * block_k
            if not _block_needed(q0, q0 + block_q, k0, k0 + block_k, causal, window):
                continue
            kblk, vblk = kb[:, jk], vb[:, jk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk)
            mask = _block_mask(qpos, arange_k + k0, causal, window, Sq + q_offset, Sk)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lseblk)                      # (B,KV,G,bq,bk)
            dv[:, jk] += torch.einsum("bkgqs,bqkgv->bskv", p, doblk)
            dp = torch.einsum("bqkgv,bskv->bkgqs", doblk, vblk)
            ds = p * (dp - dblk)
            dq_blk += torch.einsum("bkgqs,bskd->bqkgd", ds, kblk)
            dk[:, jk] += torch.einsum("bkgqs,bqkgd->bskd", ds, qblk)
        dqs.append(dq_blk)
    dq = torch.stack(dqs, dim=1).reshape(B, nq * block_q, H, D)[:, :Sq] * sc
    dk = dk.reshape(B, nk * block_k, KV, D)[:, :Sk]
    dv = dv.reshape(B, nk * block_k, KV, Dv)[:, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_k, scale):
        o, lse = _flash_fwd(q, k, v, causal, window, q_offset, block_q, block_k, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, q_offset, block_q, block_k, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    block_q: int = 512, block_k: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,D), k (B,Sk,KV,D), v (B,Sk,KV,Dv) -> (B,Sq,H,Dv)."""
    return _FlashFn.apply(q, k, v, causal, window, q_offset, block_q, block_k, scale)
