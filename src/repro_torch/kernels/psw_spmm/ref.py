"""Plain torch versions of the PSW block-sparse SpMM (the reference oracles
are `repro/kernels/psw_spmm/ref.py::psw_spmm_ref` and `spmm_dense_ref`).

All run in full float32: TF32 is switched off around the tile products,
as the reference's tests hold rtol 1e-5. `psw_spmm_rows_torch` is the
kernel's plain version over the destination CSR that `ops.prepare_rows`
builds: it multiplies only the stored entries, so a non-finite x[s] reaches
only the rows with an edge from s (the dense `psw_spmm_torch` gives
0 * inf = NaN in every row of an active tile, as the reference does)."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["psw_spmm_rows_torch", "psw_spmm_torch", "spmm_dense_torch"]


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def psw_spmm_torch(coords: torch.Tensor, tiles: torch.Tensor,
                   x: torch.Tensor, n_dst_blocks: int,
                   block: int) -> torch.Tensor:
    """out[db*B:(db+1)*B] += tiles[t] @ x[sb*B:(sb+1)*B] for each active tile.

    coords: (T, 2) int (dst_block, src_block); tiles: (T, B, B);
    x: (n_src_blocks*B, F). Returns (n_dst_blocks*B, F).
    """
    B = block
    F = x.shape[-1]
    xb = x.reshape(-1, B, F)
    with _no_tf32():
        prods = torch.bmm(tiles, xb[coords[:, 1].long()])
    out = torch.zeros((n_dst_blocks, B, F), dtype=x.dtype, device=x.device)
    out.index_add_(0, coords[:, 0].long(), prods)
    return out.reshape(n_dst_blocks * B, F)


def spmm_dense_torch(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
                     n_dst: int) -> torch.Tensor:
    """Edge-list oracle: out[d] = sum_{(s,d) in E} x[s]."""
    out = torch.zeros((n_dst, x.shape[-1]), dtype=x.dtype, device=x.device)
    out.index_add_(0, dst.long(), x[src.long()])
    return out


def psw_spmm_rows_torch(row_ptr: torch.Tensor, col: torch.Tensor,
                        val: torch.Tensor, x: torch.Tensor,
                        block: int) -> torch.Tensor:
    """out[r] = sum over r's entries e of val[e] * x[col[e]], summed as the
    tiles were: each run of entries from one source block (`col // block`)
    into its own partial, the partials then added in entry order.

    row_ptr: (n_rows + 1,) int64 CSR; col: (nnz,) int, each row's entries
    sorted by source; val: (nnz,) float32; x: (n_src, F). Returns
    (n_rows, F)."""
    n_rows = row_ptr.shape[0] - 1
    dev = x.device
    out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=dev)
    if not col.numel():
        return out
    c = col.long()
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                   row_ptr[1:] - row_ptr[:-1])
    blk = c // block
    new = torch.ones_like(c, dtype=torch.bool)
    new[1:] = (rows[1:] != rows[:-1]) | (blk[1:] != blk[:-1])
    group = torch.cumsum(new, 0) - 1
    partial = torch.zeros((int(new.sum()), x.shape[1]), dtype=x.dtype,
                          device=dev)
    partial.index_add_(0, group, val[:, None].to(x.dtype) * x[c])
    out.index_add_(0, rows[new], partial)
    return out
