"""Segment-reduction message-passing primitives (port of the reference
`repro/graph/segment_ops.py`).

Message passing is an edge-index gather followed by a scatter into
destination segments: `index_add_` for sums, `scatter_reduce_` for max and
min. All ops take `edge_index`-style (src, dst) integer tensors with ids in
[0, n_nodes), as the reference's callers pass them. The reference's
`jax.ops.segment_max` / `segment_min` leave an empty segment at the
reduction's identity (-inf / +inf for floats); here the output starts at
that identity and the reduction includes it, which gives the same values.
`sorted_` is the reference's `indices_are_sorted` hint: accepted, no
effect."""
from __future__ import annotations

import torch

__all__ = [
    "gather_src",
    "scatter_sum",
    "scatter_mean",
    "scatter_max",
    "scatter_min",
    "scatter_std",
    "degree",
    "edge_softmax",
    "aggregate_multi",
]


def gather_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Messages from source features: x[src]."""
    return x.index_select(0, src.long())


def scatter_sum(msgs, dst, n_nodes: int, sorted_: bool = False):
    # out of place, on a buffer of the input's type (new_zeros / new_full /
    # new_ones): a DTensor on a mesh, which cannot reshard the buffer an
    # in-place scatter writes into
    return msgs.new_zeros((n_nodes, *msgs.shape[1:])).index_add(
        0, dst.long(), msgs)


def scatter_mean(msgs, dst, n_nodes: int, sorted_: bool = False):
    s = scatter_sum(msgs, dst, n_nodes, sorted_)
    d = torch.clamp(degree(dst, n_nodes).to(s.dtype), min=1.0)
    return s / d[:, None] if s.dim() == 2 else s / d


def _identity(dtype: torch.dtype, reduce: str):
    """The reduction's identity: what an empty segment holds."""
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _scatter_extreme(msgs, dst, n_nodes: int, reduce: str):
    out = msgs.new_full((n_nodes, *msgs.shape[1:]),
                        _identity(msgs.dtype, reduce))
    idx = dst.long().reshape(-1, *([1] * (msgs.dim() - 1))).expand_as(msgs)
    return out.scatter_reduce(0, idx, msgs, reduce, include_self=True)


def scatter_max(msgs, dst, n_nodes: int, sorted_: bool = False):
    return _scatter_extreme(msgs, dst, n_nodes, "amax")


def scatter_min(msgs, dst, n_nodes: int, sorted_: bool = False):
    return _scatter_extreme(msgs, dst, n_nodes, "amin")


def scatter_std(msgs, dst, n_nodes: int, eps: float = 1e-5,
                sorted_: bool = False):
    """Per-destination standard deviation (PNA aggregator)."""
    mean = scatter_mean(msgs, dst, n_nodes, sorted_)
    sq_mean = scatter_mean(msgs * msgs, dst, n_nodes, sorted_)
    var = torch.clamp(sq_mean - mean * mean, min=0.0)
    return torch.sqrt(var + eps)


def degree(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    ones = dst.new_ones(dst.shape, dtype=torch.float32)
    return scatter_sum(ones, dst, n_nodes)


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor, n_nodes: int):
    """Numerically-stable softmax of edge scores grouped by destination."""
    d = dst.long()
    m = scatter_max(scores, d, n_nodes)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(scores - m[d])
    z = scatter_sum(ex, d, n_nodes)
    return ex / torch.clamp(z[d], min=1e-16)


def aggregate_multi(msgs, dst, n_nodes: int,
                    aggregators=("mean", "max", "min", "std")):
    """Stacked multi-aggregator reduce (PNA). Returns (n_nodes, A*d). An
    empty segment's max and min are 0, as the reference maps every value
    at or beyond the dtype's finite range (the -inf / +inf identities
    included) to 0."""
    outs = []
    info = torch.finfo(msgs.dtype)
    for a in aggregators:
        if a == "mean":
            outs.append(scatter_mean(msgs, dst, n_nodes))
        elif a == "sum":
            outs.append(scatter_sum(msgs, dst, n_nodes))
        elif a == "max":
            o = scatter_max(msgs, dst, n_nodes)
            outs.append(torch.where(o <= info.min, 0.0, o))
        elif a == "min":
            o = scatter_min(msgs, dst, n_nodes)
            outs.append(torch.where(o >= info.max, 0.0, o))
        elif a == "std":
            outs.append(scatter_std(msgs, dst, n_nodes))
        else:
            raise ValueError(a)
    return torch.cat(outs, dim=-1)
