"""Deterministic synthetic LM data pipeline (numpy only).

The port's own copy of the reference's ``src/repro/data/pipeline.py``,
line for line, so both packages train on identical tokens.

Design goals (cluster posture):
  * *Stateless addressing*: batch(step, shard, num_shards) is a pure
    function of (seed, step, shard) via counter-based RNG (Philox) - any
    worker can regenerate any batch, which is what makes checkpoint-resume
    and elastic re-sharding trivial (no iterator state to save).
  * *Shardable*: each data-parallel rank materializes only its slice.
  * *Structured tokens*: a small Markov-chain "language" (not iid uniform)
    so perplexity actually decreases during the example training runs.

For the stub modality frontends, ``frames``/``patches`` embeddings are
generated the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"
    d_model: int = 0
    enc_seq: int = 0
    n_patches: int = 0

    def __post_init__(self):
        # A fixed random Markov chain over a small state space projected
        # into the vocab: learnable structure with long-range repetition.
        rng = np.random.default_rng(self.seed)
        self._states = 64
        raw = rng.random((self._states, self._states)) ** 4
        self._trans = raw / raw.sum(1, keepdims=True)
        self._proj = rng.integers(0, self.vocab_size,
                                  size=(self._states,), dtype=np.int64)

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.Philox(key=self.seed, counter=(step << 20) + shard))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """Batch slice for one data shard at one step (pure function)."""
        assert self.global_batch % num_shards == 0
        b = self.global_batch // num_shards
        rng = self._rng(step, shard)
        states = rng.integers(0, self._states, size=(b,))
        seq = np.empty((b, self.seq_len), dtype=np.int64)
        # Vectorized Markov rollout.
        cum = np.cumsum(self._trans, axis=1)
        for t in range(self.seq_len):
            seq[:, t] = self._proj[states]
            u = rng.random((b, 1))
            states = (u < cum[states]).argmax(axis=1)
        out = {"tokens": seq.astype(np.int32)}
        if self.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, self.enc_seq, self.d_model)).astype(np.float32)
        if self.family == "vlm":
            out["patches"] = rng.standard_normal(
                (b, self.n_patches, self.d_model)).astype(np.float32)
        return out

    @classmethod
    def for_config(cls, cfg, seq_len: int, global_batch: int, seed: int = 0):
        return cls(vocab_size=cfg.vocab_size, seq_len=seq_len,
                   global_batch=global_batch, seed=seed, family=cfg.family,
                   d_model=cfg.d_model, enc_seq=cfg.enc_seq,
                   n_patches=cfg.n_patches)
