"""Plan builder + wrapper for the frontier-expansion kernel.

Port of the reference `repro/kernels/frontier_expand/ops.py`. The plan
builder is its host numpy copy: the virtual-row ELL that the plain torch
version reads. `plan_to_device` moves it to a device and builds there, with
torch ops, the compact layout the CUDA kernel reads instead
(`kernel_layout`): `col`, the live slots' sources in row-major order, so
each destination's edges are contiguous and in slot order, and `edge_ptr`,
the CSR over them. A destination with more than `light_edges` edges (a
power-law hub) is "heavy": `chunks` cuts its edges into pieces of at most
`chunk_edges`, which the kernel sums in parallel and then reduces per
destination (`heavy_dst`, `heavy_ptr`: the CSR from heavy destinations to
their chunks).

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

from ...core import telemetry
from ..common import cdiv, count_launch, round_up
from . import kernel as _kernel
from .ref import frontier_expand_torch

__all__ = ["FrontierPlan", "build_frontier_plan", "frontier_expand_counts",
           "hub_chunks", "kernel_layout", "plan_to_device", "unique_sorted"]

# A kernel warp walks 32 consecutive destinations or one hub chunk: a
# destination with more than LIGHT_EDGES edges is cut into chunks of at most
# CHUNK_EDGES, so no warp walks more than 32 * LIGHT_EDGES = CHUNK_EDGES
# edges and a power-law hub cannot hold the launch behind one warp. Chosen
# on the H100 (scripts/frontier_expand_variants.py).
LIGHT_EDGES = 32
CHUNK_EDGES = 1024

# kernel launches made by frontier_expand_counts: read and reset it as
# `ops.launches` (a run zeroes it, drives its path, and reads it back to
# show that the path went through the kernel)
launches = 0


@dataclasses.dataclass(frozen=True)
class FrontierPlan:
    """Layout of one store's deduplicated edge set (one direction): numpy
    arrays from `build_frontier_plan`, torch tensors after
    `plan_to_device`, which adds the kernel's compact layout."""

    idx: np.ndarray       # (R, K) int32 source id per slot
    mask: np.ndarray      # (R, K) bool, True where a slot holds an edge
    row_dst: np.ndarray   # (R,) int32 destination per row; padding -> n_dst
    n_src: int
    n_dst: int
    n_edges: int          # deduplicated edge count packed into the plan
    k_slots: int
    # kernel layout (port only, on the device), see `kernel_layout`
    col: torch.Tensor = None        # (E,) int32 sources, row-major
    edge_ptr: torch.Tensor = None   # (n_dst + 1,) int64: edges of d are
    #                                 col[edge_ptr[d]:edge_ptr[d + 1]]
    heavy_dst: torch.Tensor = None  # (H,) int64 destinations > light_edges
    heavy_ptr: torch.Tensor = None  # (H + 1,) int64 CSR into chunks
    chunks: torch.Tensor = None     # (C, 2) int64 [edge begin, edge end)
    light_edges: int = LIGHT_EDGES
    chunk_edges: int = CHUNK_EDGES


def kernel_layout(idx: torch.Tensor, mask: torch.Tensor,
                  row_dst: torch.Tensor, n_dst: int,
                  light_edges: int = LIGHT_EDGES,
                  chunk_edges: int = CHUNK_EDGES) -> dict:
    """The kernel's compact destination CSR, built with torch ops on the
    plan tensors' device: `col` and `edge_ptr` from the live slots, then
    `hub_chunks`."""
    dev = idx.device
    col = idx[mask]                       # row-major: slot order per row
    row_end = torch.zeros(idx.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(mask.sum(1), 0, out=row_end[1:])
    first_row = torch.searchsorted(
        row_dst, torch.arange(n_dst + 1, dtype=row_dst.dtype, device=dev))
    edge_ptr = row_end[first_row]
    return {"col": col, "edge_ptr": edge_ptr,
            **hub_chunks(edge_ptr, light_edges, chunk_edges)}


def hub_chunks(edge_ptr: torch.Tensor, light_edges: int = LIGHT_EDGES,
               chunk_edges: int = CHUNK_EDGES) -> dict:
    """The destinations with more than `light_edges` edges, and their edge
    ranges cut into chunks of at most `chunk_edges`, on edge_ptr's
    device."""
    dev = edge_ptr.device
    counts = edge_ptr[1:] - edge_ptr[:-1]
    heavy = torch.nonzero(counts > light_edges).squeeze(1)
    n_chunks = (counts[heavy] + chunk_edges - 1) // chunk_edges
    heavy_ptr = torch.zeros(heavy.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_chunks, 0, out=heavy_ptr[1:])
    owner = torch.repeat_interleave(
        torch.arange(heavy.shape[0], device=dev), n_chunks)
    begin = (edge_ptr[heavy][owner]
             + (torch.arange(owner.shape[0], device=dev) - heavy_ptr[owner])
             * chunk_edges)
    end = torch.minimum(begin + chunk_edges, edge_ptr[heavy + 1][owner])
    return {"heavy_dst": heavy, "heavy_ptr": heavy_ptr,
            "chunks": torch.stack([begin, end], 1),
            "light_edges": light_edges, "chunk_edges": chunk_edges}


def unique_sorted(a) -> np.ndarray:
    """`np.unique` of a 1-D array (its sorted distinct values) by a sort and
    a neighbour compare. numpy 2.3 and later take integers through a hash
    table instead: 93 s for 56M int64 keys on an H100 host's CPU, where the
    sort takes 8 s."""
    a = np.sort(np.asarray(a).ravel())
    if a.size > 1:
        keep = np.empty(a.size, bool)
        keep[0] = True
        np.not_equal(a[1:], a[:-1], out=keep[1:])
        a = a[keep]
    return a


def build_frontier_plan(src, dst, n_src: int, n_dst: int,
                        k_slots: int = 32) -> FrontierPlan:
    """Host-side, fully vectorized: dedup + destination-major sort via one
    packed-key unique, ranks within destination groups via run-length
    arithmetic, then one scatter into the (R, K) slot grid."""
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    keys = unique_sorted(dst * np.int64(n_src) + src)
    E = keys.shape[0]
    if E == 0:
        return FrontierPlan(np.zeros((128, k_slots), np.int32),
                            np.zeros((128, k_slots), bool),
                            np.full(128, n_dst, np.int32),
                            int(n_src), int(n_dst), 0, k_slots)
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
                        k_slots)


def plan_to_device(plan: FrontierPlan, device) -> FrontierPlan:
    """The plan's reference arrays as tensors on `device`, and the kernel's
    compact layout built from them there (`kernel_layout`)."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    idx, mask = put(plan.idx, np.int32), put(plan.mask, bool)
    row_dst = put(plan.row_dst, np.int32)
    return dataclasses.replace(
        plan, idx=idx, mask=mask, row_dst=row_dst,
        **kernel_layout(idx, mask, row_dst, plan.n_dst))


def frontier_expand_counts(plan: FrontierPlan, x: torch.Tensor) -> torch.Tensor:
    """out (n_dst, B): out[d, j] = Σ_{(s,d) in plan} x[s, j], on the plan's
    device. With 0/1 indicator columns this is each destination's count of
    DISTINCT frontier in-neighbors — expand + distinct + aggregate in one
    launch. float32 accumulation is integer-exact below 2**24, far above any
    degree here. CUDA tensors launch the kernel; CPU tensors take the plain
    torch version."""
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
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no frontier-expansion path for {x.device}")
    B = x.shape[1]
    with telemetry.span("x.frontier_expand.counts", B=B):
        if x.device.type == "cpu":
            return frontier_expand_torch(plan.idx, plan.mask, x,
                                         plan.row_dst, plan.n_dst)
        out = torch.empty((plan.n_dst, B), dtype=torch.float32,
                          device=x.device)
        if out.numel():
            scratch = torch.empty((plan.chunks.shape[0], B),
                                  dtype=torch.float32, device=x.device)
            flags = torch.empty(
                (plan.n_src, cdiv(B, _kernel.TILE) if B >= 32 else 0),
                dtype=torch.uint8, device=x.device)
            _kernel.launch(plan, x, out, scratch, flags)
            count_launch(globals())
        return out
