"""LinkBench-style workload generator (Armstrong et al., SIGMOD'13 — the
benchmark the paper uses in §8.2).

Generates a request mix over a growing social-graph-like store: node get /
insert / update, edge insert-or-update / delete / update, out-neighbor and
time-range queries — with the paper-noted quirk that LinkBench assigns
neighbor IDs near the source (locality), which we optionally randomize.
Request frequencies follow the published LinkBench mix.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

__all__ = ["LinkBenchConfig", "LinkBenchWorkload", "REQUEST_MIX"]

# Published LinkBench operation mix (fractions of total requests).
REQUEST_MIX = {
    "node_get": 0.129,
    "node_insert": 0.026,
    "node_update": 0.074,
    "edge_insert_or_update": 0.12,
    "edge_delete": 0.03,
    "edge_update": 0.08,
    "edge_getrange": 0.006,
    "edge_outnbrs": 0.535,
}


@dataclasses.dataclass(frozen=True)
class LinkBenchConfig:
    n_vertices: int = 100_000
    edges_per_vertex: float = 5.0
    zipf_alpha: float = 1.6
    payload_bytes: int = 16
    realistic_ids: bool = True   # scatter neighbor ids (paper's critique)
    seed: int = 0


class LinkBenchWorkload:
    def __init__(self, cfg: LinkBenchConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        ops, probs = zip(*REQUEST_MIX.items())
        self._ops = list(ops)
        self._probs = np.asarray(probs) / sum(probs)

    def initial_graph(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, timestamps) of the pre-benchmark bulk load."""
        n = self.cfg.n_vertices
        e = int(n * self.cfg.edges_per_vertex)
        src = (self.rng.zipf(self.cfg.zipf_alpha, e) - 1) % n
        if self.cfg.realistic_ids:
            dst = self.rng.integers(0, n, e)
        else:
            dst = (src + self.rng.integers(1, 100, e)) % n  # LinkBench locality
        ts = np.sort(self.rng.integers(0, 2**31, e))
        return src, dst, ts

    def _vertex(self) -> int:
        return int((self.rng.zipf(self.cfg.zipf_alpha) - 1) % self.cfg.n_vertices)

    def requests(self, n_requests: int) -> Iterator[dict]:
        choices = self.rng.choice(len(self._ops), n_requests, p=self._probs)
        for c in choices:
            op = self._ops[c]
            req = {"op": op, "u": self._vertex()}
            if op.startswith("edge"):
                req["v"] = self._vertex()
                req["ts"] = int(self.rng.integers(0, 2**31))
            if op in ("node_update", "edge_update", "edge_insert_or_update",
                      "node_insert"):
                req["payload"] = float(self.rng.random())
            yield req
