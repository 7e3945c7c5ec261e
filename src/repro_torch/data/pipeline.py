"""Token data pipeline: synthetic + file-backed (memmap) sources, packed
(tokens, labels) batches, deterministic resume (step-indexed, checkpointable).

A copy of the reference's ``repro/data/pipeline.py`` (numpy only), so the
port draws bit-identical batches; a train step moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_stream(vocab: int, seed: int = 0):
    """Deterministic infinite token source (stateless per index — resumable)."""
    def block(index: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((seed << 32) ^ index)
        # zipf-ish marginal so losses are non-trivial
        z = rng.zipf(1.3, size=n)
        return (z % vocab).astype(np.int32)
    return block


class TokenPipeline:
    """Yields {tokens, labels} of (batch, seq). Supports:
    - source="synthetic" (default) or a path to a flat int32 .bin file
      (memmap; wraps around);
    - exact resume: state is just the step counter.
    """

    def __init__(self, vocab: int, batch: int, seq: int,
                 source: str = "synthetic", seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.step = 0
        if source == "synthetic":
            self._block = synthetic_stream(vocab, seed)
            self._mm = None
        else:
            self._mm = np.memmap(source, dtype=np.int32, mode="r")
            self._block = None

    def state(self) -> Dict:
        return {"step": self.step}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = self.batch * self.seq
        if self._mm is not None:
            start = (self.step * n) % max(len(self._mm) - n, 1)
            flat = np.asarray(self._mm[start:start + n]) % self.vocab
        else:
            flat = self._block(self.step, n)
        self.step += 1
        arr = flat.reshape(self.batch, self.seq).astype(np.int32)
        # lm_loss shifts internally: labels == tokens (next-token objective)
        return {"tokens": arr, "labels": arr}
