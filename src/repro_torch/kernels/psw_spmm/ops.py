"""Row layouts + wrappers for the PSW SpMM kernel (port of the reference
`repro/kernels/psw_spmm/ops.py`).

The reference multiplies dense (dst block, src block) adjacency tiles
against x. The port's kernel gathers instead over a destination CSR that
holds only the nonzeros (`RowLayout`):
- `prepare_rows` builds it from an edge list on x's device (a sort of
  `dst * n + src` keys and `unique_consecutive`), with no host numpy;
- `compact_tiles` builds the same layout from the reference's tiles, so
  the tile API `psw_spmm` keeps its signature;
- `prepare_blocks` is the reference's host tile build, equal to it
  bitwise, for the tile API's callers.

`psw_spmm_rows` launches the CUDA kernel for CUDA tensors and takes the
plain torch version (`ref.py::psw_spmm_rows_torch`) for CPU tensors; there
is no fallback from one to the other, so a kernel that fails to build or
launch raises. Only stored entries are multiplied: a non-finite x[s]
reaches only the rows with an edge from s, as in `spmm_dense_ref` (the
reference's dense `tiles @ x` spreads 0 * inf = NaN over every row of an
active tile; ROADMAP queue 3). For finite x the results are the tiles'."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ...core.multihop import _resolve_device
from ...graph.padding import bucket_edges_by_block
from ..common import cdiv, count_launch
from . import kernel as _kernel
from .ref import psw_spmm_rows_torch

__all__ = ["CHUNK", "RowLayout", "compact_tiles", "prepare_blocks",
           "prepare_rows", "psw_spmm", "psw_spmm_edges", "psw_spmm_rows"]

# a row with more entries than this is a hub, cut into chunks
CHUNK = 32

# kernel launches made by psw_spmm_rows: read and reset it as
# `ops.launches`
launches = 0


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """A destination CSR of the adjacency, each row's entries sorted by
    source, plus the chunk plan of its hub rows (rows with more than
    `max_row` entries). A chunk is a run of whole source blocks of one hub
    row: its blocks start within one `max_row`-entry window of the row, so
    it holds at most max_row + block - 1 entries."""
    row_ptr: torch.Tensor    # (n_rows + 1,) int64
    col: torch.Tensor        # (nnz,) int32 source ids
    val: torch.Tensor        # (nnz,) float32 edge multiplicities
    hub_rows: torch.Tensor   # (H,) int64, ascending
    hub_ptr: torch.Tensor    # (H + 1,) int64: hub h's chunks
    chunks: torch.Tensor     # (C, 2) int64: [entry begin, entry end)
    n_src: int
    block: int
    max_row: int

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.col.shape[0]


def _chunk_plan(row_ptr: torch.Tensor, col: torch.Tensor, block: int,
                max_row: int):
    """(hub_rows, hub_ptr, chunks) for the rows of more than `max_row`
    entries: a hub's source blocks are grouped by the `max_row`-entry
    window their first entry falls in."""
    dev = row_ptr.device
    lens = row_ptr[1:] - row_ptr[:-1]
    hub_rows = torch.nonzero(lens > max_row).flatten()
    H = hub_rows.shape[0]
    if not H:
        return (hub_rows, torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros((0, 2), dtype=torch.int64, device=dev))
    hl = lens[hub_rows]
    hub = torch.repeat_interleave(torch.arange(H, device=dev), hl)
    off = torch.arange(hub.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(hl, 0) - hl, hl)          # entry offset in its row
    e = row_ptr[hub_rows][hub] + off
    blk = col[e].long() // block
    starts = off == 0                          # source block starts
    starts[1:] |= blk[1:] != blk[:-1]
    bi = torch.nonzero(starts).flatten()
    win, bh = off[bi] // max_row, hub[bi]
    new = torch.ones_like(bi, dtype=torch.bool)
    new[1:] = (bh[1:] != bh[:-1]) | (win[1:] != win[:-1])
    begin, ch = e[bi[new]], bh[new]
    end = torch.empty_like(begin)
    end[:-1] = begin[1:]
    last = torch.ones(begin.shape[0], dtype=torch.bool, device=dev)
    last[:-1] = ch[1:] != ch[:-1]
    end = torch.where(last, row_ptr[hub_rows + 1][ch], end)
    hub_ptr = torch.zeros(H + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(ch, minlength=H), 0, out=hub_ptr[1:])
    return hub_rows, hub_ptr, torch.stack([begin, end], 1)


def _layout(rows: torch.Tensor, cols: torch.Tensor, val: torch.Tensor,
            n_rows: int, n_src: int, block: int) -> RowLayout:
    """The RowLayout of entries already sorted by (row, source)."""
    bounds = torch.arange(n_rows + 1, dtype=rows.dtype, device=rows.device)
    row_ptr = torch.searchsorted(rows, bounds)
    col = cols.to(torch.int32)
    hub_rows, hub_ptr, chunks = _chunk_plan(row_ptr, col, block, CHUNK)
    return RowLayout(row_ptr, col, val.to(torch.float32), hub_rows, hub_ptr,
                     chunks, n_src, block, CHUNK)


def prepare_rows(src, dst, n_nodes: int, block: int = 128,
                 device=None) -> RowLayout:
    """An edge list (array-likes of ids in [0, n_nodes)) -> its RowLayout
    on `device` (None: the GPU). Multi-edges become one entry whose value
    is their count, as the tiles count them."""
    dev = _resolve_device(device, "prepare_rows")
    if n_nodes >= 2**31:
        raise ValueError(f"{n_nodes} nodes: source ids are int32")
    # torch.tensor copies: a read-only array (a partition file's memmap)
    # is never aliased, so evicting its mapping cannot pull it from under
    # a tensor
    s = torch.tensor(np.asarray(src), dtype=torch.int64, device=dev)
    d = torch.tensor(np.asarray(dst), dtype=torch.int64, device=dev)
    if s.shape != d.shape or s.dim() != 1:
        raise ValueError(f"src {tuple(s.shape)} and dst {tuple(d.shape)} "
                         "must be one-dimensional and of one length")
    if s.numel() and bool((torch.minimum(s.min(), d.min()) < 0)
                          | (torch.maximum(s.max(), d.max()) >= n_nodes)):
        raise ValueError(f"source and destination ids must lie in "
                         f"[0, {n_nodes})")
    keys, counts = torch.unique_consecutive(torch.sort(d * n_nodes + s).values,
                                            return_counts=True)
    rows = keys // n_nodes
    return _layout(rows, keys - rows * n_nodes, counts, n_nodes, n_nodes,
                   block)


def compact_tiles(coords: torch.Tensor, tiles: torch.Tensor,
                  n_dst_blocks: int, block: int,
                  n_src_blocks: int) -> RowLayout:
    """The RowLayout of the tile API's (coords, tiles), on their device:
    the nonzeros of every tile, rows coords[t, 0] * block + i, stably
    sorted by row, so each row keeps the tiles' order. For the tiles of
    `prepare_blocks` it equals `prepare_rows` of the same edges."""
    t, i, j = torch.nonzero(tiles).unbind(1)
    c = coords.long()
    rows = c[t, 0] * block + i
    order = torch.sort(rows, stable=True).indices
    cols = (c[t, 1] * block + j)[order]
    return _layout(rows[order], cols, tiles[t, i, j][order],
                   n_dst_blocks * block, n_src_blocks * block, block)


def prepare_blocks(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   block: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side: bucket an edge list into dense tiles + ensure every dst
    block appears (zero filler tiles), as the reference's Pallas kernel
    needs. Returns (coords sorted by dst block, tiles, n_dst_blocks)."""
    coords, tiles = bucket_edges_by_block(src, dst, n_nodes, block)
    n_blocks = cdiv(n_nodes, block)
    present = np.zeros(n_blocks, bool)
    present[coords[:, 0]] = True
    missing = np.nonzero(~present)[0]
    if not missing.size:
        # np.unique sorted the keys dst-block-major: the reference's stable
        # sort would return the same order, so skip its copy of the tiles
        return coords, tiles, n_blocks
    fill_coords = np.stack([missing, np.zeros_like(missing)], 1).astype(np.int32)
    coords = np.concatenate([coords, fill_coords])
    tiles = np.concatenate([tiles, np.zeros((missing.size, block, block),
                                            tiles.dtype)])
    order = np.argsort(coords[:, 0], kind="stable")
    return coords[order], tiles[order], n_blocks


def psw_spmm_rows(layout: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """A @ x over a RowLayout on x's device: x (n_src, F) float32. Returns
    (n_rows, F); a row without entries is zero."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, not {type(x).__name__}")
    if (x.dtype != torch.float32 or x.dim() != 2
            or x.shape[0] != layout.n_src):
        raise ValueError(f"expected float32 x ({layout.n_src}, F); got "
                         f"{x.dtype} {tuple(x.shape)}")
    if layout.row_ptr.device != x.device:
        raise ValueError(f"layout on {layout.row_ptr.device}, x on "
                         f"{x.device}: expected one device")
    if x.device.type == "cuda":
        out = torch.empty((layout.n_rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        if out.numel():
            scratch = torch.empty((layout.chunks.shape[0], x.shape[1]),
                                  dtype=torch.float32, device=x.device)
            _kernel.launch(layout, x.contiguous(), out, scratch)
            count_launch(globals())
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no psw_spmm path for {x.device}")
    return psw_spmm_rows_torch(layout.row_ptr, layout.col, layout.val, x,
                               layout.block)


def psw_spmm(coords: torch.Tensor, tiles: torch.Tensor, x: torch.Tensor,
             n_dst_blocks: int, block: int) -> torch.Tensor:
    """Block-sparse A @ X over PAL tiles: coords (T, 2) int32 (dst block,
    src block) sorted by dst block, tiles (T, block, block) float32, x
    (n_src_blocks*block, F) float32, all on one device. Returns
    (n_dst_blocks*block, F); a dst block without tiles is zero. The tiles'
    nonzeros are compacted into a RowLayout on their device and go through
    `psw_spmm_rows`."""
    for name, t in (("coords", coords), ("tiles", tiles), ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, not "
                            f"{type(t).__name__}")
    if coords.device != x.device or tiles.device != x.device:
        raise ValueError(f"coords on {coords.device}, tiles on "
                         f"{tiles.device}, x on {x.device}: expected one "
                         "device")
    T = coords.shape[0]
    if (coords.dtype != torch.int32 or tuple(coords.shape) != (T, 2)
            or tiles.dtype != torch.float32
            or tuple(tiles.shape) != (T, block, block)
            or x.dtype != torch.float32 or x.dim() != 2
            or x.shape[0] % block):
        raise ValueError(
            f"expected int32 coords (T, 2), float32 tiles (T, {block}, "
            f"{block}) and x (n_src_blocks*{block}, F); got {coords.dtype} "
            f"{tuple(coords.shape)}, {tiles.dtype} {tuple(tiles.shape)}, "
            f"{x.dtype} {tuple(x.shape)}")
    n_src_blocks = x.shape[0] // block
    if T and not bool(
            (coords[1:, 0] >= coords[:-1, 0]).all()
            & (coords[:, 0] >= 0).all()
            & (coords[:, 0] < n_dst_blocks).all()
            & (coords[:, 1] >= 0).all()
            & (coords[:, 1] < n_src_blocks).all()):
        raise ValueError("coords must be sorted by dst block, with dst "
                         f"blocks below {n_dst_blocks} and src blocks "
                         f"below {n_src_blocks}")
    layout = compact_tiles(coords, tiles, n_dst_blocks, block, n_src_blocks)
    return psw_spmm_rows(layout, x)


def psw_spmm_edges(src, dst, x: torch.Tensor, n_nodes: int,
                   block: int = 128) -> torch.Tensor:
    """Edge list -> RowLayout on x's device -> kernel (no tiles). x is
    (n_nodes, F); returns (n_nodes, F): out[d] = Σ_{(s,d) in E} x[s],
    multi-edges counted."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, not {type(x).__name__}")
    return psw_spmm_rows(prepare_rows(src, dst, n_nodes, block, x.device), x)
