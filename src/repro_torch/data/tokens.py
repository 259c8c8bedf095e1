"""Synthetic LM token pipeline: deterministic, shardable, restart-safe.

Streams Zipf-distributed token sequences with local n-gram structure (so a
real LM can actually reduce loss on it).  Every batch is a pure function of
(seed, step, shard) - the fault-tolerant trainer replays any step after
restore and elastic restarts re-partition the stream by shard count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_order: int = 3
    ngram_strength: float = 0.7   # prob of following the n-gram chain


class TokenStream:
    """Deterministic synthetic token batches."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # fixed random n-gram successor table: v -> successor (cheap chain)
        self.successor = base.integers(0, cfg.vocab, size=cfg.vocab)
        # precomputed Zipf normalization
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.probs = p / p.sum()

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        rows = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + shard
        )
        iid = rng.choice(cfg.vocab, size=(rows, cfg.seq_len), p=self.probs)
        follow = rng.random((rows, cfg.seq_len)) < cfg.ngram_strength
        toks = iid.copy()
        for t in range(1, cfg.seq_len):
            chained = self.successor[toks[:, t - 1]]
            toks[:, t] = np.where(follow[:, t], chained, iid[:, t])
        toks = toks.astype(np.int32)
        return {"tokens": toks, "targets": toks}

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
