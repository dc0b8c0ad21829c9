"""Edge-chunked message passing (port of the reference
`repro/graph/chunked.py`; the PSW discipline for GNNs on big partitions).

Edges are processed in chunks, holding only (E/chunks)-sized per-edge
transients. Aggregators fold across chunks: sum/mean/std via (sum, sumsq,
count) moments; max/min via an elementwise fold with ±1e30 identities
(masked edges contribute the identity, so a masked message never wins a
max the way a naive `segment_max(msgs * mask)` lets it).

The reference's `lax.scan` over chunks is a Python loop over the chunks of
each array's leading axis. Its sharding hints (`constrain`) sit where it
has them, no-ops on one device (`repro_torch.sharding`). Its per-chunk
`jax.checkpoint` has no counterpart: eager autograd keeps each chunk's
(E/chunks)-sized transients, not the whole edge set's."""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from ..sharding import constrain, unflatten
from .segment_ops import scatter_max, scatter_min, scatter_sum

__all__ = ["multi_aggregate_chunked", "fold_aggregate"]

NEG = -1e30
POS = 1e30


def multi_aggregate_chunked(
    msg_fn: Callable[..., torch.Tensor],
    edge_arrays: Dict[str, torch.Tensor],  # split along edges, incl. 'dst',
                                           # 'mask'
    n_nodes: int,
    d_msg: int,
    aggregators: Sequence[str] = ("mean", "max", "min", "std"),
    chunks: int = 1,
) -> Dict[str, torch.Tensor]:
    """Fold segment aggregations over edge chunks.

    msg_fn(**chunk_arrays) -> (Ec, d) messages. The edge count must be a
    multiple of `chunks`. Returns the dict of raw float32 moments {sum,
    sumsq, max, min, count} on the edges' device; finalize with
    `fold_aggregate`.
    """
    need_sq = "std" in aggregators
    need_max = "max" in aggregators
    need_min = "min" in aggregators
    dst_all = edge_arrays["dst"]
    E, dev = dst_all.shape[0], dst_all.device
    if chunks < 1 or E % chunks:
        raise ValueError(f"{E} edges do not split into {chunks} chunks")

    def one_chunk(acc, chunk):
        dst = chunk["dst"]
        mask = chunk["mask"]
        msgs = msg_fn(**{k: v for k, v in chunk.items()
                         if k not in ("dst", "mask")})
        m = mask.to(msgs.dtype)[:, None]
        acc["sum"] = acc["sum"] + scatter_sum(msgs * m, dst, n_nodes)
        acc["count"] = acc["count"] + scatter_sum(m[:, 0], dst, n_nodes)
        if need_sq:
            acc["sumsq"] = acc["sumsq"] + scatter_sum(msgs * msgs * m, dst,
                                                      n_nodes)
        if need_max:
            mx = scatter_max(torch.where(m > 0, msgs, NEG), dst, n_nodes)
            acc["max"] = torch.maximum(acc["max"], mx)
        if need_min:
            mn = scatter_min(torch.where(m > 0, msgs, POS), dst, n_nodes)
            acc["min"] = torch.minimum(acc["min"], mn)
        return _on_nodes(acc)

    f32 = dict(dtype=torch.float32, device=dev)
    acc = {"sum": torch.zeros((n_nodes, d_msg), **f32),
           "count": torch.zeros((n_nodes,), **f32)}
    if need_sq:
        acc["sumsq"] = torch.zeros((n_nodes, d_msg), **f32)
    if need_max:
        acc["max"] = torch.full((n_nodes, d_msg), NEG, **f32)
    if need_min:
        acc["min"] = torch.full((n_nodes, d_msg), POS, **f32)

    acc = _on_nodes(acc)
    if chunks == 1:
        return one_chunk(acc, edge_arrays)
    # keep chunks edge-sharded (a reshape alone could replicate them)
    chunked = {k: constrain(unflatten(v, 0, (chunks, E // chunks)),
                            None, "edges", *([None] * (v.ndim - 1)))
               for k, v in edge_arrays.items()}
    for i in range(chunks):
        acc = one_chunk(acc, {k: v[i] for k, v in chunked.items()})
    return acc


def _on_nodes(acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: constrain(v, "nodes", *([None] * (v.ndim - 1)))
            for k, v in acc.items()}


def fold_aggregate(acc: Dict[str, torch.Tensor],
                   aggregators: Sequence[str], eps: float = 1e-5):
    """Finalize moments into the stacked (N, A*d) aggregate."""
    cnt = torch.clamp(acc["count"], min=1.0)[:, None]
    has = (acc["count"] > 0)[:, None]
    outs = []
    for a in aggregators:
        if a == "sum":
            outs.append(acc["sum"])
        elif a == "mean":
            outs.append(acc["sum"] / cnt)
        elif a == "std":
            mean = acc["sum"] / cnt
            var = torch.clamp(acc["sumsq"] / cnt - mean * mean, min=0.0)
            outs.append(torch.sqrt(var + eps))
        elif a == "max":
            outs.append(torch.where(has, acc["max"], 0.0))
        elif a == "min":
            outs.append(torch.where(has, acc["min"], 0.0))
        else:
            raise ValueError(a)
    return torch.cat(outs, dim=-1)
