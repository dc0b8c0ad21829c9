"""Plan builder + wrapper for the frontier-expansion kernel.

Port of the reference `repro/kernels/frontier_expand/ops.py`. The plan
builder is its host numpy copy, plus `dst_ptr`: the CSR over the
destination-sorted rows that lets the CUDA kernel give each destination a
contiguous row range instead of segment-summing per-row results. A
destination with more than `split_rows` rows (a power-law hub) is "heavy":
`chunks` cuts its rows into pieces of at most `split_rows` rows, which the
kernel sums in parallel and then reduces per destination (`heavy_dst`,
`heavy_ptr`: the CSR from heavy destinations to their chunks).

Virtual-row ELL: the deduplicated edge set, grouped by destination, is
split into rows of at most `k_slots` sources — a destination of degree d
occupies ceil(d/k) rows, so the plan is linear in |E| and exact.

`row_dst` maps each virtual row to its destination, destination-sorted;
padding rows map to `n_dst`.

`frontier_expand_counts` runs the CUDA kernel on CUDA tensors and the plain
torch version on CPU tensors; there is no fallback from one to the other, so
a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import round_up
from . import kernel as _kernel
from .ref import frontier_expand_torch

__all__ = ["FrontierPlan", "build_frontier_plan", "frontier_expand_counts",
           "plan_to_device"]

# rows one kernel work item walks at most; longer destinations are split
# (a power-law hub would otherwise hold the whole launch behind one warp)
SPLIT_ROWS = 8

# kernel launches made by frontier_expand_counts: read and reset it as
# `ops.launches` (a run zeroes it, drives its path, and reads it back to
# show that the path went through the kernel)
launches = 0


@dataclasses.dataclass(frozen=True)
class FrontierPlan:
    """Layout of one store's deduplicated edge set (one direction): numpy
    arrays from `build_frontier_plan`, torch tensors after
    `plan_to_device`."""

    idx: np.ndarray       # (R, K) int32 source id per slot
    mask: np.ndarray      # (R, K) bool, True where a slot holds an edge
    row_dst: np.ndarray   # (R,) int32 destination per row; padding -> n_dst
    n_src: int
    n_dst: int
    n_edges: int          # deduplicated edge count packed into the plan
    k_slots: int
    # kernel layout (port only), see `_kernel_layout`
    dst_ptr: np.ndarray = None    # (n_dst + 1,) int64: rows of d are
    #                               dst_ptr[d]:dst_ptr[d + 1]
    heavy_dst: np.ndarray = None  # (H,) int64 destinations > split_rows rows
    heavy_ptr: np.ndarray = None  # (H + 1,) int64 CSR into chunks
    chunks: np.ndarray = None     # (C, 2) int64 [row begin, row end)
    split_rows: int = SPLIT_ROWS


def _kernel_layout(row_dst: np.ndarray, n_dst: int) -> dict:
    """dst_ptr over the destination-sorted rows, and the heavy
    destinations' row ranges cut into chunks of at most SPLIT_ROWS."""
    split_rows = SPLIT_ROWS
    dst_ptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(row_dst, minlength=n_dst + 1)[:n_dst],
              out=dst_ptr[1:])
    rows = np.diff(dst_ptr)
    heavy = np.flatnonzero(rows > split_rows)
    n_chunks = -(-rows[heavy] // split_rows)
    heavy_ptr = np.zeros(heavy.shape[0] + 1, np.int64)
    np.cumsum(n_chunks, out=heavy_ptr[1:])
    owner = np.repeat(np.arange(heavy.shape[0]), n_chunks)
    begin = (dst_ptr[heavy][owner]
             + (np.arange(heavy_ptr[-1]) - heavy_ptr[owner]) * split_rows)
    end = np.minimum(begin + split_rows, dst_ptr[heavy + 1][owner])
    return {"dst_ptr": dst_ptr, "heavy_dst": heavy.astype(np.int64),
            "heavy_ptr": heavy_ptr,
            "chunks": np.stack([begin, end], 1).astype(np.int64)}


def build_frontier_plan(src, dst, n_src: int, n_dst: int,
                        k_slots: int = 32) -> FrontierPlan:
    """Host-side, fully vectorized: dedup + destination-major sort via one
    packed-key unique, ranks within destination groups via run-length
    arithmetic, then one scatter into the (R, K) slot grid."""
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    keys = np.unique(dst * np.int64(n_src) + src)
    E = keys.shape[0]
    if E == 0:
        return FrontierPlan(np.zeros((128, k_slots), np.int32),
                            np.zeros((128, k_slots), bool),
                            np.full(128, n_dst, np.int32),
                            int(n_src), int(n_dst), 0, k_slots,
                            **_kernel_layout(np.full(128, n_dst, np.int32),
                                             int(n_dst)))
    d = keys // n_src
    s = keys % n_src
    newgrp = np.empty(E, bool)
    newgrp[0] = True
    newgrp[1:] = d[1:] != d[:-1]
    gstart = np.flatnonzero(newgrp)
    gid = np.cumsum(newgrp) - 1
    rank = np.arange(E) - gstart[gid]
    gcount = np.diff(np.append(gstart, E))
    vrows = -(-gcount // k_slots)                  # ceil: rows per group
    vbase = np.cumsum(vrows) - vrows
    row = vbase[gid] + rank // k_slots
    col = rank % k_slots
    R = int(vrows.sum())
    Rp = round_up(R, 128)
    idx = np.zeros((Rp, k_slots), np.int32)
    mask = np.zeros((Rp, k_slots), bool)
    idx[row, col] = s
    mask[row, col] = True
    row_dst = np.full(Rp, n_dst, np.int32)
    row_dst[:R] = np.repeat(d[gstart], vrows)
    return FrontierPlan(idx, mask, row_dst, int(n_src), int(n_dst), int(E),
                        k_slots, **_kernel_layout(row_dst, int(n_dst)))


def plan_to_device(plan: FrontierPlan, device) -> FrontierPlan:
    """The plan with its arrays as tensors on `device`."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    return dataclasses.replace(
        plan, idx=put(plan.idx, np.int32), mask=put(plan.mask, bool),
        row_dst=put(plan.row_dst, np.int32),
        dst_ptr=put(plan.dst_ptr, np.int64),
        heavy_dst=put(plan.heavy_dst, np.int64),
        heavy_ptr=put(plan.heavy_ptr, np.int64),
        chunks=put(plan.chunks, np.int64))


def frontier_expand_counts(plan: FrontierPlan, x: torch.Tensor) -> torch.Tensor:
    """out (n_dst, B): out[d, j] = Σ_{(s,d) in plan} x[s, j], on the plan's
    device. With 0/1 indicator columns this is each destination's count of
    DISTINCT frontier in-neighbors — expand + distinct + aggregate in one
    launch. float32 accumulation is integer-exact below 2**24, far above any
    degree here. CUDA tensors launch the kernel; CPU tensors take the plain
    torch version."""
    global launches
    if not isinstance(plan.idx, torch.Tensor):
        raise TypeError("plan arrays are numpy: move the plan with "
                        "plan_to_device first")
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, not {type(x).__name__}")
    if x.device != plan.idx.device:
        raise ValueError(f"x is on {x.device}, the plan on {plan.idx.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != plan.n_src:
        raise ValueError(f"x must be float32 ({plan.n_src}, B), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cuda":
        B = x.shape[1]
        out = torch.empty((plan.n_dst, B), dtype=torch.float32,
                          device=x.device)
        if out.numel():
            scratch = torch.empty((plan.chunks.shape[0], B),
                                  dtype=torch.float32, device=x.device)
            _kernel.launch(plan, x, out, scratch)
            launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no frontier-expansion path for {x.device}")
    return frontier_expand_torch(plan.idx, plan.mask, x, plan.row_dst,
                                 plan.n_dst)
