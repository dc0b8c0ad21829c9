"""Distributed PSW operators over a `torch.distributed` ring: the paper's
sliding windows across GPUs. Port of the reference `repro/graph/psw_ops.py`.

GraphChi streams each partition's windows sequentially through RAM; here
the node-state shards stream around the rank ring by point-to-point sends
(`batch_isend_irecv`). One full revolution delivers every remote source row
exactly once: an all-gather's bytes with an x-shard-sized memory footprint
(DESIGN.md §2).

There is no global sharded array in torch, so each rank holds its shard
and calls every op with it (all ranks together, as a collective): x_loc
(n_loc, ...), rows [rank * n_loc, (rank + 1) * n_loc) of the global x, and
its own edges' global row ids.

Ops (all differentiable; ring_gather's backward is a REVERSE grad-ring, so
nothing is kept per step):

  ring_gather(x_loc, idx, ring)         idx arbitrary global rows
  ring_scatter_sum(v, idx, n, ring)     its transpose
  local_gather(x_loc, idx, ring)        idx owned by this rank (PAL dst!)
  local_scatter_sum(v, idx, n, ring)    scatter into this rank's rows
  local_edge_softmax(s, idx, n, ring)   softmax grouped by local destination

`ring_mesh(n_loc)` is the reference's `ring_mesh(mesh)`: the ring of the
default process group, or a ring of one rank when no group is initialised.
At one rank no op sends anything. The local ops clip ids to
the rank's rows, as the reference clips.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .segment_ops import edge_softmax

__all__ = ["Ring", "ring_mesh", "ring_gather", "ring_scatter_sum",
           "local_gather", "local_scatter_sum", "local_edge_softmax"]


@dataclasses.dataclass(frozen=True)
class Ring:
    """A rank's view of the default group's ring: its rank, the world
    size, the rows each rank holds, and the ranks it sends to and receives
    from."""
    rank: int
    size: int
    n_loc: int
    next: int
    prev: int

    @property
    def n(self) -> int:
        return self.n_loc * self.size


def ring_mesh(n_loc: int) -> Ring:
    """The default process group's ring with n_loc rows a rank; a ring of
    one rank when no process group is initialised."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        return Ring(rank, size, n_loc, (rank + 1) % size, (rank - 1) % size)
    return Ring(0, 1, n_loc, 0, 0)


def _expand(sel, ndim):
    return sel.reshape(sel.shape + (1,) * (ndim - 1))


def _shift(t: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """Send `t` to rank `to` while receiving its like from `frm`."""
    buf = torch.empty_like(t)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.contiguous(), to),
            dist.P2POp(dist.irecv, buf, frm)]):
        req.wait()
    return buf


def _check_rows(x_loc: torch.Tensor, ring: Ring) -> None:
    if x_loc.shape[0] != ring.n_loc:
        raise ValueError(f"x_loc has {x_loc.shape[0]} rows; the ring holds "
                         f"{ring.n_loc} a rank")


def _check_n(n: int, ring: Ring) -> None:
    if n != ring.n:
        raise ValueError(f"n = {n}, but the ring holds {ring.n_loc} rows on "
                         f"each of {ring.size} ranks")


# ---------------------------------------------------------------------------
# ring gather with reverse-ring backward
# ---------------------------------------------------------------------------
def _ring_fwd_local(x_loc, idx, ring: Ring):
    """x[idx] from the shards: at step s the shard of rank - s is resident;
    the rows it owns are taken, then it moves on to rank + 1. At one rank
    every row is resident."""
    P, n_loc = ring.size, ring.n_loc
    i = idx.long()
    if P == 1:
        return x_loc[i]
    out = torch.zeros((i.shape[0],) + x_loc.shape[1:], dtype=x_loc.dtype,
                      device=x_loc.device)
    x_rot = x_loc
    for s in range(P):
        owner = (ring.rank - s) % P
        sel = (i // n_loc) == owner
        rows = x_rot[torch.clamp(i - owner * n_loc, 0, n_loc - 1)]
        out = torch.where(_expand(sel, rows.dim()), rows, out)
        if s < P - 1:                  # the last shard goes nowhere
            x_rot = _shift(x_rot, ring.next, ring.prev)
    return out


def _ring_bwd_local(idx, g, ring: Ring, dtype):
    """Reverse grad-ring: a per-shard float32 gradient buffer circulates
    backward; each rank scatter-adds its contribution when the owner's
    buffer is resident; after P steps every buffer is home, fully
    accumulated, and cast to `dtype`."""
    P, n_loc = ring.size, ring.n_loc
    i = idx.long()
    g32 = g.to(torch.float32)
    gbuf = torch.zeros((n_loc,) + g.shape[1:], dtype=torch.float32,
                       device=g.device)
    for s in range(P):
        owner = (ring.rank + s) % P
        sel = (i // n_loc) == owner
        local_row = torch.clamp(i - owner * n_loc, 0, n_loc - 1)
        contrib = torch.zeros_like(gbuf).index_add_(
            0, local_row, torch.where(_expand(sel, g32.dim()), g32, 0.0))
        gbuf = gbuf + contrib
        if P > 1:
            gbuf = _shift(gbuf, ring.prev, ring.next)
    return gbuf.to(dtype)


class _RingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_loc, idx, ring):
        ctx.save_for_backward(idx)
        ctx.ring, ctx.dtype = ring, x_loc.dtype
        return _ring_fwd_local(x_loc, idx, ring)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return _ring_bwd_local(idx, g, ctx.ring, ctx.dtype), None, None


class _RingScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, idx, ring):
        ctx.save_for_backward(idx)
        ctx.ring, ctx.dtype = ring, vals.dtype
        return _ring_bwd_local(idx, vals, ring, vals.dtype)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gv = _ring_fwd_local(g, idx, ctx.ring)
        return gv.to(ctx.dtype), None, None


def ring_gather(x_loc: torch.Tensor, idx: torch.Tensor,
                ring: Ring) -> torch.Tensor:
    """x[idx] for this rank's edges: x_loc (n_loc, ...) this rank's rows of
    x, idx (E_loc,) global row ids. Returns (E_loc, ...)."""
    _check_rows(x_loc, ring)
    return _RingGather.apply(x_loc, idx, ring)


def ring_scatter_sum(vals: torch.Tensor, idx: torch.Tensor, n: int,
                     ring: Ring) -> torch.Tensor:
    """Transpose of ring_gather: scatter-add this rank's rows `vals`
    (E_loc, ...) into global rows idx of an (n, ...) output, of which the
    rank returns its (n_loc, ...) rows, via the reverse grad-ring: never
    materialising a replicated (n, ...) array. Its backward is a
    ring_gather of the cotangent."""
    _check_n(n, ring)
    return _RingScatterSum.apply(vals, idx, ring)


# ---------------------------------------------------------------------------
# shard-local ops (PAL guarantees destination locality)
# ---------------------------------------------------------------------------
def _local(idx, ring: Ring):
    return torch.clamp(idx.long() - ring.rank * ring.n_loc, 0,
                       ring.n_loc - 1)


def local_gather(x_loc: torch.Tensor, idx: torch.Tensor,
                 ring: Ring) -> torch.Tensor:
    """x[idx] where every idx is owned by this rank, exactly the PAL
    property for destination rows. Zero communication."""
    _check_rows(x_loc, ring)
    return x_loc[_local(idx, ring)]


def local_scatter_sum(vals: torch.Tensor, idx: torch.Tensor, n: int,
                      ring: Ring) -> torch.Tensor:
    """segment-sum into this rank's destination rows. Zero communication."""
    _check_n(n, ring)
    out = torch.zeros((ring.n_loc,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, _local(idx, ring), vals)


def local_edge_softmax(scores: torch.Tensor, idx: torch.Tensor, n: int,
                       ring: Ring) -> torch.Tensor:
    """edge_softmax grouped by this rank's destinations (each column of a
    2-D `scores` on its own)."""
    _check_n(n, ring)
    return edge_softmax(scores, _local(idx, ring), ring.n_loc)
