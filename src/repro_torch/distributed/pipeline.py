"""Pipeline parallelism: the GPipe microbatch schedule over a ring of
point-to-point sends, the port of the reference's
``repro/distributed/pipeline.py``.

``pipelined_apply`` runs ``n_stages`` sequential stage functions (stacked
stage params, one slice per rank of the "stage" mesh axis) over ``n_micro``
microbatches. Each tick every stage processes one microbatch and the
activations move one hop along the ring with ``batch_isend_irecv`` (the
reference's ``ppermute``). Total ticks = n_micro + n_stages - 1 (fill +
drain bubble). The last stage's outputs reach every rank through the
reference's masked sum (an all-reduce of the outputs, zero except on the
last stage).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_map


def _stage_slice(a: torch.Tensor, sid: int) -> torch.Tensor:
    """This rank's stage slice of a stacked leaf: a DTensor split over the
    stage axis holds it locally, a whole stack is indexed."""
    if hasattr(a, "to_local"):
        return a.to_local()[0]
    return a[sid]


def pipelined_apply(stage_fn: Callable, mesh, stage_params, x_micro: torch.Tensor
                    ) -> torch.Tensor:
    """stage_fn(params_slice, x) -> x, applied n_stages times in sequence.

    mesh: a ``repro_torch.launch.mesh.Mesh`` with a "stage" axis over a
    process group. stage_params: tree with a leading stage axis (whole on
    every rank, or DTensors split over "stage"). x_micro: (n_micro, mb, ...)
    microbatched input, the same on every rank. Returns (n_micro, mb, ...)
    outputs of the LAST stage, on every rank.
    """
    dm = mesh.device_mesh
    n_stages = mesh.shape["stage"]
    group = dm.get_group("stage")
    sid = dm.get_local_rank("stage")
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1

    pl = tree_map(lambda a: _stage_slice(a, sid), stage_params)
    buf = torch.zeros_like(x_micro[0])                 # current activation
    outs = torch.zeros_like(x_micro)
    for t in range(ticks):
        # stage 0 ingests microbatch t (when in range)
        if sid == 0 and t < n_micro:
            buf = x_micro[t]
        y = stage_fn(pl, buf)
        # last stage emits microbatch t - (n_stages - 1)
        if sid == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        # rotate activations forward one stage
        y = y.contiguous()
        buf = torch.empty_like(y)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                           dist.P2POp(dist.irecv, buf, prv, group)]):
            req.wait()
    # only the last stage holds real outputs; every rank gets them
    if sid != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs
