"""The logical work of the benchmark's queries and sweeps, counted from the
raw edge list and never from the program's layout, so that any
implementation is held to the same count.

One hop of a frontier expansion over B columns (frontier sets F_j):
  * the out-edges of every vertex in the union of the F_j, read once:
    4 bytes each (the head's id), repeated edges counted once;
  * the frontier's entries, sum_j |F_j|: 4 bytes each;
  * the outputs, the distinct (column, head) pairs: 8 bytes each (an index
    and a count), written once;
  * one add per path (column, vertex of F_j, head).
Friends-of-friends is two hops: from the seeds (one vertex a column), then
from each seed's distinct friends.

One PageRank iteration over E edges (repeated edges and self-loops
counted, as the iteration sends along each) and n vertices: both endpoints
of every edge, 4 bytes each; the ranks read and the sums written, 4 bytes
each a vertex; one add per edge.

`peaks.bound_s` turns bytes and adds into the least time on the chip.
"""
from __future__ import annotations

import torch

from . import peaks
from .reference.fof import EdgeIndex


def hop_work(index: EdgeIndex, col: torch.Tensor, frontier: torch.Tensor):
    """(bytes, adds, col, head) of one hop: `frontier[i]` is in column
    `col[i]`; the returned pairs are the hop's distinct outputs."""
    union = torch.unique(frontier)
    edges_read = int(index.degree(union).sum())
    row, head = index.expand(frontier)
    paths = int(head.shape[0])
    keys = torch.unique(col[row] * index.n + head)
    outputs = int(keys.shape[0])
    nbytes = 4 * edges_read + 4 * int(frontier.shape[0]) + 8 * outputs
    return nbytes, paths, keys // index.n, keys % index.n


def fof_bound_s(index: EdgeIndex, seeds: torch.Tensor) -> float:
    """The least time on the chip for the two hops of one request."""
    col = torch.arange(seeds.shape[0], device=seeds.device)
    b1, a1, c1, f1 = hop_work(index, col, seeds)
    b2, a2, _, _ = hop_work(index, c1, f1)
    return peaks.bound_s(b1, a1) + peaks.bound_s(b2, a2)


def pagerank_iteration_bound_s(n_edges: int, n_vertices: int) -> float:
    return peaks.bound_s(8 * n_edges + 8 * n_vertices, n_edges)
