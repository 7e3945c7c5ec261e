"""Patch-level cache manager (paper §5).

One ``PatchCache`` per diffusion block. The control plane (uid<->slot map,
Common/New/Expired set partition, paper Fig. 11) is host-side; the data plane
(reuse-mask computation, batched store update/query) is one gather/scatter
per block step on the device that holds the activations.

Semantics (paper Fig. 10):
  (1) the Cache Reuse Predictor compares the incoming input against the
      cached input from the previous *compute* and emits a per-patch mask;
  (2) masked (reusable) patches take the cached output;
  (3) unmasked patches are recomputed and their (input, output) re-cached;
  (4) uids seen in the cache but not in the batch have exited -> Expired,
      their slots are freed (no preemption, so exit is final).
``update_input_on_reuse=False`` keeps the cached input anchored at the last
actual compute so the drift test bounds the *cumulative* error.

Unlike the reference's functional stores, ``update`` writes the stores in
place (``index_copy_``), which saves a full copy of each store per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch



def _rel_delta(x: torch.Tensor, cached: torch.Tensor) -> torch.Tensor:
    """Per-patch relative MSE between input and cached input. (P,...)->(P,)"""
    ax = tuple(range(1, x.dim()))
    num = torch.mean(torch.square(x.float() - cached.float()), dim=ax)
    den = torch.mean(torch.square(cached.float()), dim=ax) + 1e-8
    return num / den


def _scatter_where(store: torch.Tensor, slots: torch.Tensor, values: torch.Tensor,
                   mask: torch.Tensor) -> None:
    """store[slots] = values where mask, in place; one batched scatter."""
    rows = mask.reshape((-1,) + (1,) * (values.dim() - 1))
    sel = torch.where(rows, values.to(store.dtype), store[slots])
    store.index_copy_(0, slots, sel)


@dataclass
class SyncResult:
    slots: np.ndarray          # (P,) int32 slot per uid
    is_new: np.ndarray         # (P,) bool — no cached entry (must compute)
    n_common: int
    n_new: int
    n_expired: int


class PatchCache:
    """Fixed-capacity device cache for one block: cached inputs + outputs.

    Stores are allocated lazily on first update, on the device of the
    activations — a block's output shape may differ from its input shape."""

    def __init__(self, capacity: int, update_input_on_reuse: bool = False):
        self.capacity = capacity
        self.store_in: Optional[torch.Tensor] = None
        self.store_out: Optional[torch.Tensor] = None
        self.uid_to_slot: Dict[int, int] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self.update_input_on_reuse = update_input_on_reuse
        self.stats = {"hits": 0, "computed": 0, "expired": 0}

    # ---------------- control plane (host) ----------------

    def sync(self, uids: Sequence[int]) -> SyncResult:
        """Partition into Common/New/Expired and resolve slots (Fig. 11)."""
        uids = list(int(u) for u in uids)
        current = set(uids)
        expired = [u for u in self.uid_to_slot if u not in current]
        for u in expired:                       # (4) delete
            self._free.append(self.uid_to_slot.pop(u))
        slots = np.empty(len(uids), np.int32)
        is_new = np.zeros(len(uids), bool)
        n_new = 0
        for j, u in enumerate(uids):
            s = self.uid_to_slot.get(u)
            if s is None:                       # (3) insert
                if not self._free:
                    raise RuntimeError("patch cache capacity exceeded")
                s = self._free.pop()
                self.uid_to_slot[u] = s
                is_new[j] = True
                n_new += 1
            slots[j] = s
        self.stats["expired"] += len(expired)
        return SyncResult(slots=slots, is_new=is_new,
                          n_common=len(uids) - n_new, n_new=n_new,
                          n_expired=len(expired))

    # ---------------- data plane (device) ----------------

    def _slots(self, sync: SyncResult, device: torch.device) -> torch.Tensor:
        return torch.as_tensor(sync.slots, device=device).long()

    def reuse_mask(self, x: torch.Tensor, sync: SyncResult, predictor) -> torch.Tensor:
        """(1) per-patch reuse decision; new entries always compute."""
        if self.store_in is None or self.store_out is None:
            return torch.zeros(len(sync.slots), dtype=torch.bool, device=x.device)
        delta = _rel_delta(x, self.store_in[self._slots(sync, x.device)])
        mask = predictor(delta)
        return mask & ~torch.as_tensor(sync.is_new, device=x.device)

    def cached_outputs(self, sync: SyncResult) -> torch.Tensor:
        return self.store_out[self._slots(sync, self.store_out.device)]

    def cached_inputs(self, sync: SyncResult) -> torch.Tensor:
        return self.store_in[self._slots(sync, self.store_in.device)]

    def update(self, sync: SyncResult, x: torch.Tensor, y: torch.Tensor,
               computed: torch.Tensor) -> None:
        """(5) re-cache computed entries (one scatter per store)."""
        if self.store_in is None:
            self.store_in = x.new_zeros((self.capacity,) + tuple(x.shape[1:]))
        if self.store_out is None:
            self.store_out = y.new_zeros((self.capacity,) + tuple(y.shape[1:]))
        slots = self._slots(sync, x.device)
        computed = torch.as_tensor(computed, device=x.device)
        in_mask = computed | bool(self.update_input_on_reuse)
        _scatter_where(self.store_in, slots, x, in_mask)
        _scatter_where(self.store_out, slots, y, computed)
        n = int(computed.sum())
        self.stats["computed"] += n
        self.stats["hits"] += len(sync.slots) - n


def bucket_size(n: int, ladder: Sequence[int] = (0, 8, 16, 32, 64, 128, 256,
                                                 512, 1024, 2048, 4096)) -> int:
    """Pad dynamic unmasked-counts to a small static ladder."""
    for b in ladder:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


def masked_block_apply(block_fn, patches: torch.Tensor, reuse: np.ndarray,
                       cached_out: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Run block_fn only on non-reused patches, bucket-padded.

    block_fn must be pixel-wise (shape-preserving, per-patch independent).
    Context-dependent blocks instead run dense with cache-filled inputs
    (paper §5.1) — handled by the engine, not here.
    Returns (outputs (P,...), bucket) where reused rows take cached_out.
    """
    reuse = np.asarray(reuse)
    idx = np.nonzero(~reuse)[0]
    n = len(idx)
    if n == 0:
        return cached_out, 0
    b = bucket_size(n)
    pad_idx = np.concatenate([idx, np.zeros(b - n, np.int64)])
    sub = patches[torch.as_tensor(pad_idx, device=patches.device)]
    out_sub = block_fn(sub)[:n]
    out = cached_out.clone()
    out[torch.as_tensor(idx, device=cached_out.device)] = out_sub
    return out, b
