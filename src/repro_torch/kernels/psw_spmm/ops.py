"""Tile builder + wrapper for the PSW block-sparse SpMM kernel (port of the
reference `repro/kernels/psw_spmm/ops.py`).

`prepare_blocks` is the reference's host numpy build, equal to it bitwise.
`psw_spmm` launches the CUDA kernel for CUDA tensors and takes the plain
torch version for CPU tensors; there is no fallback from one to the other,
so a kernel that fails to build or launch raises. The kernel walks each dst
block's tiles through `tile_ptr` and masks ragged feature columns itself,
so x is not padded to 128 columns as the TPU wrapper does."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...graph.padding import bucket_edges_by_block
from ..common import cdiv, round_up
from . import kernel as _kernel
from .ref import psw_spmm_torch

__all__ = ["prepare_blocks", "psw_spmm", "psw_spmm_edges", "tile_ptr"]

# kernel launches made by psw_spmm: read and reset it as `ops.launches`
launches = 0


def prepare_blocks(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   block: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side: bucket an edge list into dense tiles + ensure every dst
    block appears (zero filler tiles) so the kernel initializes all rows.
    Returns (coords sorted by dst block, tiles, n_dst_blocks)."""
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


def tile_ptr(coords: torch.Tensor, n_dst_blocks: int) -> torch.Tensor:
    """(n_dst_blocks + 1,) int64 CSR over dst-sorted coords: the tiles of
    dst block b are tile_ptr[b]:tile_ptr[b + 1]."""
    dst_blk = coords[:, 0].contiguous()
    bounds = torch.arange(n_dst_blocks + 1, dtype=dst_blk.dtype,
                          device=dst_blk.device)
    return torch.searchsorted(dst_blk, bounds)


def psw_spmm(coords: torch.Tensor, tiles: torch.Tensor, x: torch.Tensor,
             n_dst_blocks: int, block: int) -> torch.Tensor:
    """Block-sparse A @ X over PAL tiles: coords (T, 2) int32 (dst block,
    src block) sorted by dst block, tiles (T, block, block) float32, x
    (n_src_blocks*block, F) float32, all on one device. Returns
    (n_dst_blocks*block, F); a dst block without tiles is zero."""
    global launches
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
    if x.device.type == "cuda":
        if block != _kernel.BLOCK:
            raise ValueError(f"the CUDA kernel takes {_kernel.BLOCK}-square "
                             f"tiles, not {block}")
        if T and not bool(
                (coords[1:, 0] >= coords[:-1, 0]).all()
                & (coords[:, 0] >= 0).all()
                & (coords[:, 0] < n_dst_blocks).all()
                & (coords[:, 1] >= 0).all()
                & (coords[:, 1] < x.shape[0] // block).all()):
            raise ValueError("coords must be sorted by dst block, with dst "
                             f"blocks below {n_dst_blocks} and src blocks "
                             f"below {x.shape[0] // block}")
        out = torch.empty((n_dst_blocks * block, x.shape[1]),
                          dtype=torch.float32, device=x.device)
        if out.numel():
            _kernel.launch(tile_ptr(coords, n_dst_blocks),
                           coords.contiguous(), tiles.contiguous(),
                           x.contiguous(), out)
            launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no psw_spmm path for {x.device}")
    return psw_spmm_torch(coords, tiles, x, n_dst_blocks, block)


def psw_spmm_edges(src, dst, x: torch.Tensor, n_nodes: int,
                   block: int = 128) -> torch.Tensor:
    """Convenience: edge list -> tiles (host) -> x's device -> kernel.
    Returns (n_nodes, F): out[d] = Σ_{(s,d) in E} x[s], multi-edges
    counted."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    for name, ids in (("source", src), ("destination", dst)):
        if ids.size and (ids.min() < 0 or ids.max() >= n_nodes):
            raise ValueError(f"{name} ids must lie in [0, {n_nodes})")
    coords, tiles, n_blocks = prepare_blocks(src, dst, n_nodes, block)
    coords = torch.from_numpy(coords).to(x.device)
    tiles = torch.from_numpy(tiles).to(x.device)
    n_src_pad = round_up(n_nodes, block)
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_src_pad - x.shape[0]))
    return psw_spmm(coords, tiles, xp, n_blocks, block)[:n_nodes]
