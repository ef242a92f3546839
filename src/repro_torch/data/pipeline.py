"""Deterministic, restartable token stream (plain numpy).

``SyntheticLM`` is the JAX package's seeded Zipf-ish stream, copied: a
batch is a pure function of (seed, step, shard), so both packages see the
same batches and a restart reproduces the stream with no cursor beyond the
step count.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "make_batch_iterator"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_per_shard: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    zipf_a: float = 1.2

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_id]))
        # Zipf-like marginal over the vocab; sequences get local structure by
        # mixing a shifted copy (so models have something learnable).
        z = rng.zipf(self.zipf_a, size=(self.batch_per_shard, self.seq_len + 1))
        toks = (z - 1) % self.vocab_size
        flip = rng.random((self.batch_per_shard, self.seq_len + 1)) < 0.35
        shifted = np.roll(toks, 1, axis=1)
        toks = np.where(flip, shifted, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_batch_iterator(source, start_step: int = 0):
    """Iterator of (step, batch); resumes exactly from ``start_step``."""
    step = start_step
    while True:
        yield step, source.batch_at(step)
        step += 1
