"""CSP-level entry points of the kernels, as ``src/repro/kernels/ops.py``."""
from __future__ import annotations

import torch

from repro_torch.core.csp_device import csp_device
from repro_torch.kernels.groupnorm_stitch import groupnorm_stitch
from repro_torch.kernels.patch_attention import patch_attention


def fused_groupnorm_stitch(csp, patches: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, groups: int, eps: float = 1e-5,
                           exact: bool = True, halo: int = 1) -> torch.Tensor:
    """CSP-aware fused GroupNorm + edge stitch.

    Exact per-request statistics, or per-patch ones with exact=False (the
    paper's approximation), then normalize + halo. On the card: two kernel
    launches (partial sums, then the stitch, whose prologue finalizes the
    statistics) on the CSP's cached device metadata, no host round trip."""
    meta = csp_device(csp, patches.device)
    return groupnorm_stitch(patches.contiguous(), meta.neighbors_i32, meta.patch_req_i32,
                            meta.request_offset_i32, scale.float().contiguous(),
                            bias.float().contiguous(), groups, eps=eps, exact=exact,
                            halo=halo)


def grouped_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """One resolution group's (B, S, H, D) attention through the kernel."""
    return patch_attention(q, k, v)
