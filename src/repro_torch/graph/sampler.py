"""Fanout neighbor sampler over PAL-CSR (host numpy copy of the reference
`repro/graph/sampler.py`, over the port's `core.lsm` and `core.pal`).

Samples k-hop in-neighborhoods ("who influences me") with per-hop fanouts
(e.g. 15-10 = GraphSAGE-style), reading PAL's dst-perm CSC — exactly the
structure the paper builds for in-edge queries. Produces padded,
device-ready subgraph arrays with local re-indexing.

For the same store and seed every array it returns is bitwise the
reference's: the same `default_rng` stream, the same `rng.choice` calls in
the same order, the same seed-first node order. The reference maps each
sampled edge's endpoints to local ids through a dict, one Python lookup an
edge; here one `searchsorted` over the node list gives the same ids (the
dict keeps a repeated seed's last slot, and so does this)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from ..core.lsm import LSMTree
from ..core.pal import GraphPAL

GraphLike = Union[GraphPAL, LSMTree]

__all__ = ["SampledSubgraph", "NeighborSampler"]


@dataclasses.dataclass
class SampledSubgraph:
    """Padded minibatch subgraph with local indices.

    nodes: (N_pad,) original vertex IDs (first n_seeds = the seed batch)
    node_mask: (N_pad,) valid-node mask
    src, dst: (E_pad,) local indices into `nodes`
    edge_mask: (E_pad,) valid-edge mask
    n_seeds: number of seed (output) nodes
    """

    nodes: np.ndarray
    node_mask: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    edge_mask: np.ndarray
    n_seeds: int


def _local_ids(nodes: np.ndarray, v: np.ndarray) -> np.ndarray:
    """For each id in `v`, the last index i with nodes[i] == v (every id
    of `v` is in `nodes`): what `{int(u): i for i, u in
    enumerate(nodes)}[v]` gives."""
    order = np.argsort(nodes, kind="stable")
    last = np.searchsorted(nodes[order], v, side="right") - 1
    return order[last].astype(np.int64)


class NeighborSampler:
    """Uniform fanout sampler over a PAL graph's in-edges (CSC direction).

    The sampler consolidates the graph into flat CSC arrays once (a PSW-style
    full pass), then serves minibatches with O(batch · prod(fanouts)) work.
    """

    def __init__(self, g: GraphLike, seed: int = 0):
        self.iv = g.intervals
        if isinstance(g, LSMTree):
            g.flush_all()
            parts = g.all_partitions()
        else:
            parts = g.partitions
        # consolidate: in-neighbor CSC over internal ids
        srcs, dsts = [], []
        for p in parts:
            if p.n_edges == 0:
                continue
            live = np.ones(p.n_edges, bool) if p.dead is None else ~p.dead
            srcs.append(p.src[live])
            dsts.append(p.dst[live])
        src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
        order = np.argsort(dst, kind="stable")
        self._src_sorted = src[order]
        n = self.iv.max_vertices
        counts = np.bincount(dst, minlength=n)
        self._ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self._rng = np.random.default_rng(seed)

    def sample(self, seeds: Sequence[int], fanouts: Sequence[int],
               pad_nodes: Optional[int] = None,
               pad_edges: Optional[int] = None) -> SampledSubgraph:
        seeds_orig = np.asarray(list(seeds), dtype=np.int64)
        seeds_int = np.asarray(self.iv.to_internal(seeds_orig))
        frontier = seeds_int
        all_nodes: List[np.ndarray] = [seeds_int]
        e_src: List[np.ndarray] = []
        e_dst: List[np.ndarray] = []
        for f in fanouts:
            deg = self._ptr[frontier + 1] - self._ptr[frontier]
            take = np.minimum(deg, f)
            tot = int(take.sum())
            s_hop = np.empty(tot, np.int64)
            d_hop = np.empty(tot, np.int64)
            o = 0
            for v, k, dg_ in zip(frontier, take, deg):
                if k == 0:
                    continue
                lo = self._ptr[v]
                if dg_ <= f:
                    picks = np.arange(lo, lo + dg_)
                else:
                    picks = lo + self._rng.choice(int(dg_), size=int(k),
                                                  replace=False)
                s_hop[o:o + int(k)] = self._src_sorted[picks]
                d_hop[o:o + int(k)] = v
                o += int(k)
            e_src.append(s_hop)
            e_dst.append(d_hop)
            frontier = np.unique(s_hop)
            all_nodes.append(frontier)
        nodes_int = np.unique(np.concatenate(all_nodes))
        # ensure seeds occupy the first n_seeds slots
        seed_pos = np.searchsorted(nodes_int, seeds_int)
        perm = np.concatenate([seed_pos, np.setdiff1d(
            np.arange(nodes_int.shape[0]), seed_pos)])
        nodes_int = nodes_int[perm]

        ends = _local_ids(nodes_int, np.concatenate(
            e_src + e_dst + [np.empty(0, np.int64)]))
        e = ends.shape[0] // 2
        src_l, dst_l = ends[:e], ends[e:]

        n = nodes_int.shape[0]
        n_pad = pad_nodes or (-(-max(n, 1) // 128) * 128)
        e_pad = pad_edges or (-(-max(e, 1) // 128) * 128)
        if n > n_pad or e > e_pad:
            raise ValueError(f"padding too small: nodes {n}>{n_pad} or "
                             f"edges {e}>{e_pad}")
        nodes = np.zeros(n_pad, np.int64)
        nodes[:n] = np.asarray(self.iv.to_original(nodes_int))
        node_mask = np.zeros(n_pad, bool)
        node_mask[:n] = True
        srcp = np.zeros(e_pad, np.int64)
        dstp = np.zeros(e_pad, np.int64)
        srcp[:e], dstp[:e] = src_l, dst_l
        edge_mask = np.zeros(e_pad, bool)
        edge_mask[:e] = True
        return SampledSubgraph(nodes, node_mask, srcp, dstp, edge_mask,
                               n_seeds=int(seeds_orig.shape[0]))
