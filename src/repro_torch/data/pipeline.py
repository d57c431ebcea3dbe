"""Deterministic synthetic token pipeline with exact-resume semantics.

Every batch is a pure function of (seed, step), so resuming from a
checkpoint at step N reproduces the identical data stream on any number of
hosts — no iterator state to snapshot, no skew after elastic rescale. Each
host materializes only its shard of the global batch.

A numpy-only copy of the JAX package's ``data/pipeline.py``: for the same
(seed, step, host) ``batch_at`` gives arrays equal bit for bit to it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # synthetic structure: orderly enough that loss visibly decreases
    ngram_order: int = 2


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # a fixed random bigram table gives learnable structure
        rng = np.random.default_rng(cfg.seed)
        self._trans = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size,), dtype=np.int64
        )

    def batch_at(self, step: int, *, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """The (host-sharded) batch for ``step`` — pure function of inputs."""
        cfg = self.cfg
        per_host = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id])
        )
        first = rng.integers(0, cfg.vocab_size, size=(per_host, 1), dtype=np.int64)
        toks = np.empty((per_host, cfg.seq_len), dtype=np.int64)
        toks[:, 0] = first[:, 0]
        noise = rng.random((per_host, cfg.seq_len)) < 0.15
        rand = rng.integers(0, cfg.vocab_size, size=(per_host, cfg.seq_len))
        for t in range(1, cfg.seq_len):
            nxt = self._trans[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {
            "tokens": toks.astype(np.int32),
            "loss_mask": np.ones((per_host, cfg.seq_len), np.float32),
        }

    def iterate(self, start_step: int = 0, *, host_id: int = 0,
                num_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step, host_id=host_id, num_hosts=num_hosts)
            step += 1
