"""PSW block-sparse SpMM: a hand-written CUDA kernel for Hopper
(csrc/psw_spmm.cu), its plain torch version (ref.py) and the tile builder
and wrapper (ops.py). The launch count is `ops.launches`."""
from . import ops
from .ops import prepare_blocks, psw_spmm, psw_spmm_edges, tile_ptr
from .ref import psw_spmm_torch, spmm_dense_torch

__all__ = ["ops", "prepare_blocks", "psw_spmm", "psw_spmm_edges",
           "psw_spmm_torch", "spmm_dense_torch", "tile_ptr"]
