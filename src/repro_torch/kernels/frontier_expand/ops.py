"""Plan builder + wrapper for the frontier-expansion kernel.

Port of the reference `repro/kernels/frontier_expand/ops.py`, whose plan is
a host numpy virtual-row ELL. The port's plan is the destination CSR the
CUDA kernel reads, built with torch ops on the plan's device from the
deduplicated packed keys `dst * n_src + src` sorted there: `col`, each
edge's source, so each destination's edges are contiguous and in ascending
source order (the reference ELL's row-major slot order), and `edge_ptr`,
the CSR over them. A destination with more than `light_edges` edges (a
power-law hub) is "heavy": `chunks` cuts its edges into pieces of at most
`chunk_edges`, which the kernel sums in parallel. `chunk_row` is where each
chunk's sum goes: a hub of one chunk (most of them) writes its row of the
output directly; a hub of several writes a row of scratch per chunk, and
the kernel's second pass sums those per hub (`reduce_dst`, `reduce_ptr`:
the CSR from these hubs to their scratch rows).

`frontier_expand_counts` runs the CUDA kernel on CUDA tensors and the plain
torch version on CPU tensors; there is no fallback from one to the other, so
a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import dataclasses

import torch

from ...core import telemetry
from ..common import cdiv, count_launch
from . import kernel as _kernel
from .ref import frontier_expand_torch

__all__ = ["FrontierPlan", "build_frontier_plan", "frontier_expand_counts",
           "hub_chunks"]

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
    """Layout of one store's deduplicated edge set (one direction), its
    tensors on one device (`build_frontier_plan`)."""

    col: torch.Tensor          # (E,) int32 sources, by destination
    edge_ptr: torch.Tensor     # (n_dst + 1,) int64: edges of d are
    #                            col[edge_ptr[d]:edge_ptr[d + 1]]
    chunks: torch.Tensor       # (C, 2) int64 [edge begin, edge end)
    chunk_row: torch.Tensor    # (C,) int64 scratch row (c < S) or
    #                            destination (lone chunk) of chunk c
    reduce_dst: torch.Tensor   # (H,) int64 hubs of several chunks
    reduce_ptr: torch.Tensor   # (H + 1,) int64 CSR into scratch rows
    n_src: int
    n_dst: int
    n_edges: int               # E, the deduplicated edge count
    light_edges: int
    chunk_edges: int
    reduced_hubs: int          # H: the hubs the second pass sums
    scratch_rows: int          # S: their chunks, chunks[:S]

    @property
    def device(self) -> torch.device:
        return self.col.device


def hub_chunks(edge_ptr: torch.Tensor, light_edges: int = LIGHT_EDGES,
               chunk_edges: int = CHUNK_EDGES) -> dict:
    """The destinations with more than `light_edges` edges cut into chunks
    of at most `chunk_edges`, on edge_ptr's device. The chunks of hubs of
    several chunks come first, hub by hub in destination order, and chunk c
    of them writes scratch row c; the lone chunks of the other hubs follow
    and write their destination's row of the output. Synchronizes once, for
    the host counts `reduced_hubs` and `scratch_rows`."""
    dev = edge_ptr.device
    counts = edge_ptr[1:] - edge_ptr[:-1]
    heavy = torch.nonzero(counts > light_edges).squeeze(1)
    n_chunks = (counts[heavy] + chunk_edges - 1) // chunk_edges
    several = n_chunks > 1
    hubs = torch.cat([heavy[several], heavy[~several]])
    n_chunks = torch.cat([n_chunks[several], n_chunks[~several]])
    ptr = torch.zeros(hubs.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_chunks, 0, out=ptr[1:])
    owner = torch.repeat_interleave(
        torch.arange(hubs.shape[0], device=dev), n_chunks)
    begin = (edge_ptr[hubs][owner]
             + (torch.arange(owner.shape[0], device=dev) - ptr[owner])
             * chunk_edges)
    end = torch.minimum(begin + chunk_edges, edge_ptr[hubs + 1][owner])
    n_reduce = int(several.sum())
    n_scratch = int(ptr[n_reduce])
    chunk_row = torch.cat([torch.arange(n_scratch, device=dev),
                           hubs[n_reduce:]])
    return {"chunks": torch.stack([begin, end], 1), "chunk_row": chunk_row,
            "reduce_dst": hubs[:n_reduce], "reduce_ptr": ptr[:n_reduce + 1],
            "light_edges": light_edges, "chunk_edges": chunk_edges,
            "reduced_hubs": n_reduce, "scratch_rows": n_scratch}


def build_frontier_plan(src, dst, n_src: int, n_dst: int,
                        device) -> FrontierPlan:
    """The plan of the edges (src[i], dst[i]) on `device`: the packed keys
    `dst * n_src + src` deduplicated and sorted there, so the repeats of a
    multigraph count once; `col` and `edge_ptr` read straight off them, then
    `hub_chunks`."""
    src = torch.as_tensor(src, dtype=torch.int64).ravel()
    dst = torch.as_tensor(dst, dtype=torch.int64).ravel()
    keys = torch.unique((dst * n_src + src).to(device))
    col = (keys % n_src).to(torch.int32)
    edge_ptr = torch.searchsorted(
        keys, torch.arange(n_dst + 1, device=keys.device) * n_src)
    return FrontierPlan(col, edge_ptr, n_src=int(n_src), n_dst=int(n_dst),
                        n_edges=int(keys.shape[0]), **hub_chunks(edge_ptr))


def frontier_expand_counts(plan: FrontierPlan, x: torch.Tensor) -> torch.Tensor:
    """out (n_dst, B): out[d, j] = Σ_{(s,d) in plan} x[s, j], on the plan's
    device. With 0/1 indicator columns this is each destination's count of
    DISTINCT frontier in-neighbors — expand + distinct + aggregate in one
    launch. float32 accumulation is integer-exact below 2**24, far above any
    degree here. CUDA tensors launch the kernel; CPU tensors take the plain
    torch version."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, not {type(x).__name__}")
    if x.device != plan.device:
        raise ValueError(f"x is on {x.device}, the plan on {plan.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != plan.n_src:
        raise ValueError(f"x must be float32 ({plan.n_src}, B), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no frontier-expansion path for {x.device}")
    B = x.shape[1]
    with telemetry.span("x.frontier_expand.counts", B=B,
                        reduced_hubs=plan.reduced_hubs):
        if x.device.type == "cpu":
            return frontier_expand_torch(plan.col, plan.edge_ptr, x,
                                         plan.n_dst)
        out = torch.empty((plan.n_dst, B), dtype=torch.float32,
                          device=x.device)
        if out.numel():
            scratch = torch.empty((plan.scratch_rows, B),
                                  dtype=torch.float32, device=x.device)
            flags = torch.empty(
                (plan.n_src, cdiv(B, _kernel.TILE) if B >= 32 else 0),
                dtype=torch.uint8, device=x.device)
            _kernel.launch(plan, x, out, scratch, flags)
            count_launch(globals())
        return out
