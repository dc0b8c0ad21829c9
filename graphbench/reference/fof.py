"""Plain friends-of-friends with counts, from the raw edge list, in original ids.

The semantics, worked out here from the edge list alone:
  * a seed's friends are the distinct heads of its out-edges (a repeated
    edge is one friendship; a self-loop makes the seed its own friend);
  * a target is a head of a friend's out-edge; its count is the number of
    distinct friends with an edge to it;
  * the seed's friends and the seed itself are left out of its targets;
  * each seed's targets come in ascending id order.

`distinct=False` counts every copy of a repeated edge instead: the control,
which breaks the exactness that the configuration states.

Imports torch alone: nothing of the program under test.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EdgeIndex:
    """CSR of an edge list over vertices 0 .. n - 1: the heads of v's
    out-edges are heads[ptr[v]:ptr[v + 1]], ascending."""

    n: int
    ptr: torch.Tensor     # (n + 1,) int64
    heads: torch.Tensor   # (E,) int64

    @classmethod
    def build(cls, src: torch.Tensor, dst: torch.Tensor, n: int,
              distinct: bool = True) -> "EdgeIndex":
        keys = src.to(torch.int64) * n + dst.to(torch.int64)
        keys = torch.unique(keys) if distinct else torch.sort(keys).values
        tails = keys // n
        ptr = torch.searchsorted(
            tails, torch.arange(n + 1, device=keys.device, dtype=torch.int64))
        return cls(n, ptr, keys % n)

    def degree(self, v: torch.Tensor) -> torch.Tensor:
        return self.ptr[v + 1] - self.ptr[v]

    def expand(self, v: torch.Tensor):
        """(row, head): for each i, the heads of v[i]'s out-edges."""
        lo, deg = self.ptr[v], self.degree(v)
        row = torch.repeat_interleave(
            torch.arange(v.shape[0], device=v.device), deg)
        start = torch.cumsum(deg, 0) - deg
        pos = lo[row] + torch.arange(row.shape[0], device=v.device) \
            - start[row]
        return row, self.heads[pos]


@dataclasses.dataclass
class FofAnswer:
    """CSR per seed, as numpy arrays: ids[offsets[i]:offsets[i + 1]] are
    seed i's targets (ascending), counts their distinct middles."""

    offsets: object
    ids: object
    counts: object


def two_hop(index: EdgeIndex, seeds: torch.Tensor) -> FofAnswer:
    """Friends-of-friends with counts of `seeds` (int64, any order, on the
    index's device)."""
    n = index.n
    S = seeds.shape[0]
    s_row, friend = index.expand(seeds)
    f_keys = s_row * n + friend                 # (seed row, friend)
    p_row, target = index.expand(friend)
    t_keys = s_row[p_row] * n + target          # one per path
    keys, counts = torch.unique(t_keys, return_counts=True)
    drop = torch.isin(keys, f_keys) | torch.isin(
        keys, torch.arange(S, device=seeds.device) * n + seeds)
    keys, counts = keys[~drop], counts[~drop]
    offsets = torch.searchsorted(
        keys, torch.arange(S + 1, device=seeds.device) * n)
    return FofAnswer(offsets.cpu().numpy(), (keys % n).cpu().numpy(),
                     counts.cpu().numpy())


def seeds_differing(answer, want: FofAnswer) -> int:
    """How many seeds' answers (targets and counts) differ between
    `answer` (offsets, ids, counts as numpy arrays) and `want`."""
    import numpy as np
    S = want.offsets.shape[0] - 1
    got_off = np.asarray(answer.offsets)
    if got_off.shape != want.offsets.shape:
        return S
    wrong = 0
    for i in range(S):
        a, b = int(got_off[i]), int(got_off[i + 1])
        c, d = int(want.offsets[i]), int(want.offsets[i + 1])
        if not (np.array_equal(np.asarray(answer.ids)[a:b], want.ids[c:d])
                and np.array_equal(np.asarray(answer.counts)[a:b],
                                   want.counts[c:d])):
            wrong += 1
    return wrong
