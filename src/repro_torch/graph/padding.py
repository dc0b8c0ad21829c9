"""Padding / bucketing helpers for device-ready graph layouts (numpy port of
`repro/graph/padding.py`; both functions return arrays equal to the
reference's, dtype and all)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["pad_to_ell", "bucket_edges_by_block"]


def pad_to_ell(src: np.ndarray, dst: np.ndarray, n_nodes: int,
               max_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """ELL layout: (n_nodes, max_degree) source-index matrix + validity mask.
    Edges beyond max_degree per destination are dropped (caller picks the cap;
    PAL's |E|/P constraint from the paper bounds it).

    The reference walks the edges one by one in stable dst order and keeps
    each destination's first `max_degree`; here each edge's rank within its
    destination group comes from run-length arithmetic over the same stable
    order, so the kept edges and their slots are the same."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    order = np.argsort(dst, kind="stable")
    s, d = src[order], dst[order]
    idx = np.zeros((n_nodes, max_degree), np.int32)
    mask = np.zeros((n_nodes, max_degree), bool)
    E = s.shape[0]
    if E == 0:
        return idx, mask
    newgrp = np.empty(E, bool)
    newgrp[0] = True
    np.not_equal(d[1:], d[:-1], out=newgrp[1:])
    gstart = np.flatnonzero(newgrp)
    rank = np.arange(E) - np.repeat(gstart, np.diff(np.append(gstart, E)))
    keep = rank < max_degree
    rows, cols = d[keep], rank[keep]
    idx[rows, cols] = s[keep]
    mask[rows, cols] = True
    return idx, mask


def bucket_edges_by_block(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                          block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Group edges into (dst_block, src_block) tiles; returns the list of
    active tile coordinates and a dense per-tile adjacency stack — the
    block-sparse layout consumed by the psw_spmm kernel."""
    bs = (src // block).astype(np.int64)
    bd = (dst // block).astype(np.int64)
    keys = bd * (-(-n_nodes // block)) + bs
    uniq, inv = np.unique(keys, return_inverse=True)
    n_blocks_side = -(-n_nodes // block)
    coords = np.stack([uniq // n_blocks_side, uniq % n_blocks_side], axis=1)
    tiles = np.zeros((uniq.shape[0], block, block), np.float32)
    np.add.at(tiles, (inv, dst % block, src % block), 1.0)  # multigraph-safe
    return coords.astype(np.int32), tiles
