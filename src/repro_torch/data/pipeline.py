"""Deterministic synthetic data pipeline (shard-aware, restart-safe).

A copy of the reference's ``repro/data/pipeline.py`` (numpy only; the port
imports nothing of ``repro``): every ``(step, shard, n_shards)`` gives the
reference's batch bit for bit, so a run resumed in either package replays
the same token stream.

Generates next-token-predictable sequences from a ground-truth bigram chain
so training loss measurably decreases — `examples/train_e2e.py` trains on this. The
pipeline is indexed by (step, shard): any host can regenerate any batch,
which is what makes checkpoint-restart and elastic rescale trivially
deterministic.
"""

from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Bigram-chain language data: token t+1 = perm[token t] with noise."""

    def __init__(self, vocab_size: int, seed: int = 0, noise: float = 0.1):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab_size)
        self.noise = noise
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, n_shards: int = 1):
        """Deterministic batch for (step, shard). Returns tokens + labels."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        b = batch_size // n_shards
        toks = np.empty((b, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        for t in range(seq_len):
            nxt = self.perm[toks[:, t]]
            flip = rng.random(b) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, b), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batches(dataset: SyntheticLM, start_step: int, n_steps: int,
                 batch_size: int, seq_len: int):
    for step in range(start_step, start_step + n_steps):
        yield step, dataset.batch(step, batch_size, seq_len)
