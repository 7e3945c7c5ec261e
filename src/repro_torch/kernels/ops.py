"""CSP-level entry points of the kernels, as ``src/repro/kernels/ops.py``."""
from __future__ import annotations

import torch

from repro_torch.core.patched_ops import csp_group_stats, patch_request_index
from repro_torch.kernels.groupnorm_stitch import groupnorm_stitch
from repro_torch.kernels.patch_attention import patch_attention


def fused_groupnorm_stitch(csp, patches: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, groups: int, eps: float = 1e-5,
                           exact: bool = True, halo: int = 1) -> torch.Tensor:
    """CSP-aware fused GroupNorm + edge stitch.

    Phase 1 (plain torch): exact per-request stats by segment sum, or per-patch
    stats with exact=False (the paper's approximation). Phase 2 (the kernel):
    normalize + halo in one pass."""
    P, p, _, C = patches.shape
    G = groups
    patches = patches.contiguous()
    if exact:
        mean, var = csp_group_stats(csp, patches, groups)          # (R, G)
        seg = patch_request_index(csp, patches.device)
        mean_p, var_p = mean[seg], var[seg]                        # (P, G)
    else:
        x = patches.float().reshape(P, p * p, G, C // G)
        mean_p = x.mean(dim=(1, 3))
        var_p = torch.square(x - mean_p[:, None, :, None]).mean(dim=(1, 3))
    rstd_p = torch.rsqrt(var_p + eps)
    mean_c = mean_p.repeat_interleave(C // G, dim=-1)              # (P, C)
    rstd_c = rstd_p.repeat_interleave(C // G, dim=-1)
    neighbors = torch.as_tensor(csp.neighbors, dtype=torch.int32, device=patches.device)
    return groupnorm_stitch(patches, neighbors, mean_c, rstd_c,
                            scale.float().contiguous(), bias.float().contiguous(),
                            halo=halo)


def grouped_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """One resolution group's (B, S, H, D) attention through the kernel."""
    return patch_attention(q, k, v)
