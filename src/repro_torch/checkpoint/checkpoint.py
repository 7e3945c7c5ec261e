"""Fault-tolerant checkpointing: atomic writes, latest-pointer, async mode,
the port of the reference's ``repro/checkpoint/checkpoint.py``.

Format (the reference's, so either package reads the other's files): one
.npz per checkpoint holding the flattened tree (keys are "/"-joined paths) +
a JSON sidecar with step/metadata. A bfloat16 leaf is stored as raw 2-byte
void (``'<V2'``), the bytes ``np.savez`` writes for the reference's
``ml_dtypes.bfloat16`` arrays; on load a 2-byte void leaf becomes a
``torch.bfloat16`` tensor. Writes go to a temp name and are renamed
atomically; a crashed writer never corrupts the latest checkpoint.
``CheckpointManager`` keeps N most recent and can run saves on a background
thread, after copying the tree to host memory.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

BF16_VOID = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf: a tensor (bf16 as 2-byte void) or an array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_VOID)
        return t.numpy()
    return np.array(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """One stored array as a CPU tensor (2-byte void as bfloat16)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        t = tree
        for p in parts[:-1]:
            t = t.setdefault(p, {})
        t[parts[-1]] = v
    return tree


def _conform(target, tree):
    """``tree``'s leaves in the dtype, shape and device of ``target``'s."""
    if isinstance(target, dict):
        return {k: _conform(t, tree[k]) for k, t in target.items()}
    return tree.to(device=target.device, dtype=target.dtype).reshape(target.shape)


def save_checkpoint(path: Path, step: int, tree, extra: Optional[Dict] = None
                    ) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = _flatten({"state": tree})
    tmp = path / f".tmp-{step}-{os.getpid()}"
    final = path / f"ckpt-{step:09d}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)             # atomic
    meta = {"step": step, "time": time.time(), **(extra or {})}
    mtmp = path / f".tmpmeta-{step}-{os.getpid()}"
    mtmp.write_text(json.dumps(meta))
    os.replace(mtmp, path / f"ckpt-{step:09d}.json")
    return final


def latest_step(path: Path) -> Optional[int]:
    path = Path(path)
    if not path.exists():
        return None
    steps = sorted(int(p.stem.split("-")[1]) for p in path.glob("ckpt-*.npz"))
    return steps[-1] if steps else None


def load_checkpoint(path: Path, step: Optional[int] = None,
                    target=None) -> Tuple[int, Any]:
    """-> (step, tree of CPU tensors). With ``target`` (a tree of tensors),
    each leaf takes the dtype, shape and device of the target's leaf."""
    path = Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with np.load(path / f"ckpt-{step:09d}.npz") as z:
        flat = {k: _to_tensor(z[k]) for k in z.files}
    tree = _unflatten(flat)["state"]
    if target is not None:
        tree = _conform(target, tree)
    return step, tree


class CheckpointManager:
    def __init__(self, path: Path, keep: int = 3, async_mode: bool = True):
        self.path = Path(path)
        self.keep = keep
        self.async_mode = async_mode
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        host_tree = _unflatten(_flatten(tree))   # snapshot to host memory now

        def work():
            save_checkpoint(self.path, step, host_tree, extra)
            self._gc()

        self.wait()
        if self.async_mode:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, target=None):
        self.wait()
        return load_checkpoint(self.path, target=target)

    def _gc(self) -> None:
        steps = sorted(int(p.stem.split("-")[1])
                       for p in self.path.glob("ckpt-*.npz"))
        for s in steps[:-self.keep]:
            for suffix in (".npz", ".json"):
                try:
                    (self.path / f"ckpt-{s:09d}{suffix}").unlink()
                except FileNotFoundError:
                    pass
