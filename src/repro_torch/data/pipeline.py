"""Deterministic, shard-aware token pipeline (counterpart of
``repro.data.pipeline``; numpy only, so the port keeps its own copy).

Two sources:
  * ``SyntheticLM``: Zipfian unigrams with a bigram Markov structure, so
    a small LM has something to learn; a pure function of (seed, step,
    shard), so a resumed run replays the same batches;
  * ``MemmapTokens``: ``np.memmap`` over a flat token file.

``batch_at(step)`` is stateless: resuming needs only the step counter
from the checkpoint, and a different ``data_shards`` (another mesh)
re-partitions deterministically.  numpy's ``default_rng`` is the same
generator on both sides, so every batch is bit-identical to the
reference's.  Batches are numpy int32 ``{"tokens": [local_batch,
seq_len]}``; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Zipf + bigram-Markov synthetic corpus, deterministic per (seed,
    step, data_shard)."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    data_shard: int = 0
    data_shards: int = 1
    zipf_a: float = 1.3

    def __post_init__(self):
        if self.global_batch % self.data_shards:
            raise ValueError("global_batch must divide data_shards")
        self.local_batch = self.global_batch // self.data_shards
        rng = np.random.default_rng(self.seed)
        # each token prefers 4 successors: learnable low-entropy structure
        self._succ = rng.integers(0, self.vocab_size,
                                  size=(self.vocab_size, 4), dtype=np.int32)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        self._unigram = p / p.sum()

    def batch_at(self, step: int) -> dict:
        """{'tokens': int32 [local_batch, seq_len]} of this shard."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.data_shard)
        b, s = self.local_batch, self.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.choice(self.vocab_size, size=b, p=self._unigram)
        follow = rng.random((b, s)) < 0.8          # 80% bigram-structured
        nxt_choice = rng.integers(0, 4, size=(b, s))
        fresh = rng.choice(self.vocab_size, size=(b, s), p=self._unigram)
        for t in range(1, s):
            structured = self._succ[toks[:, t - 1], nxt_choice[:, t]]
            toks[:, t] = np.where(follow[:, t], structured, fresh[:, t])
        return {"tokens": toks}


@dataclasses.dataclass
class MemmapTokens:
    """A flat token file (``np.memmap``), shard-aware and
    step-addressable."""
    path: str
    seq_len: int
    global_batch: int
    data_shard: int = 0
    data_shards: int = 1
    dtype: str = "int32"

    def __post_init__(self):
        self.local_batch = self.global_batch // self.data_shards
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self.n_tokens = self._data.shape[0]
        self.seqs_total = self.n_tokens // self.seq_len

    def batch_at(self, step: int) -> dict:
        b, s = self.local_batch, self.seq_len
        base = (step * self.global_batch + self.data_shard * b) % max(
            self.seqs_total - b, 1)
        idx = (base + np.arange(b)) % self.seqs_total
        toks = np.stack([self._data[i * s:(i + 1) * s] for i in idx])
        return {"tokens": toks.astype(np.int32)}


def make_pipeline(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticLM(**kw)
    if kind == "memmap":
        return MemmapTokens(**kw)
    raise ValueError(f"unknown pipeline {kind!r}")


__all__ = ["MemmapTokens", "SyntheticLM", "make_pipeline"]
