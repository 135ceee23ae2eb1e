"""Data pipeline: deterministic synthetic tokens and memmapped token files.

Counterpart of :mod:`repro.data.pipeline`, the same numpy code, so a batch
is bit-identical to the JAX package's.  Batch ``i`` is a pure function of
``(seed, i, shard)``: resuming from a checkpointed step counter replays
the exact stream, with no iterator state to persist.  Batches are numpy
(``(local_batch, seq_len + 1)`` int32, inputs and labels in one array);
the train step takes them as tensors on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    """Markov-ish synthetic LM data (learnable structure, not uniform
    noise)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.local_batch = self.global_batch // self.n_shards

    def batch_at(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32: inputs and labels in one
        array."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        B, T, V = self.local_batch, self.seq_len + 1, self.vocab_size
        # order-1 structure: next token = (prev * a + noise) % V
        a = 31 if V > 31 else 3
        x = np.empty((B, T), dtype=np.int64)
        x[:, 0] = rng.integers(0, V, B)
        noise = rng.integers(0, max(V // 16, 2), (B, T))
        for t in range(1, T):
            x[:, t] = (x[:, t - 1] * a + noise[:, t]) % V
        return x.astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class TokenFileDataset:
    """Memmapped pre-tokenized corpus (the real-cluster path)."""

    path: str
    seq_len: int
    global_batch: int
    shard: int = 0
    n_shards: int = 1
    dtype: str = "int32"

    def __post_init__(self):
        self.tokens = np.memmap(self.path, dtype=self.dtype, mode="r")
        self.local_batch = self.global_batch // self.n_shards
        self.per_step = self.global_batch * (self.seq_len + 1)
        self.n_steps = len(self.tokens) // self.per_step

    def batch_at(self, step: int) -> np.ndarray:
        step = step % max(self.n_steps, 1)
        base = (step * self.per_step
                + self.shard * self.local_batch * (self.seq_len + 1))
        flat = self.tokens[base: base + self.local_batch * (self.seq_len + 1)]
        return np.asarray(flat, dtype=np.int32).reshape(self.local_batch,
                                                        self.seq_len + 1)
