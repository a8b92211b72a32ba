"""Deterministic, preemption-safe synthetic data pipeline (numpy only).

The batch for global step s is a pure function of (seed, s): there is no
iterator state to checkpoint or lose, so after a restart at step s the
pipeline replays exactly the same stream. Its batches are the JAX
package's word for word (the same numpy generators and draws).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLMStream:
    """Zipfian token stream with a planted bigram structure so the loss has
    learnable signal (used by launch/train.py)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.freq = (1.0 / ranks) / (1.0 / ranks).sum()
        self.next_of = rng.permutation(v)      # deterministic bigram map

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, t = cfg.global_batch, cfg.seq_len
        first = rng.choice(cfg.vocab_size, size=(b, 1), p=self.freq)
        noise = rng.random((b, t - 1)) < 0.3
        toks = np.empty((b, t), np.int32)
        toks[:, 0:1] = first
        for i in range(1, t):
            follow = self.next_of[toks[:, i - 1]]
            rand = rng.integers(0, cfg.vocab_size, b)
            toks[:, i] = np.where(noise[:, i - 1], rand, follow)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        return {"tokens": toks, "labels": labels.astype(np.int32)}
