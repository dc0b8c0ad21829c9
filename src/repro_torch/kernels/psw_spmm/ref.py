"""Plain torch versions of the PSW block-sparse SpMM (the reference oracles
are `repro/kernels/psw_spmm/ref.py::psw_spmm_ref` and `spmm_dense_ref`).

Both run in full float32: TF32 is switched off around the tile products,
as the reference's tests hold rtol 1e-5."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["psw_spmm_torch", "spmm_dense_torch"]


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
