"""PSW SpMM: a hand-written CUDA row-gather kernel for Hopper
(csrc/psw_spmm.cu), its plain torch versions (ref.py) and the row-layout
builders and wrappers (ops.py). The launch count is `ops.launches`."""
from . import ops
from .ops import (CHUNK, RowLayout, compact_tiles, prepare_blocks,
                  prepare_rows, psw_spmm, psw_spmm_edges, psw_spmm_rows,
                  transpose_rows)
from .ref import psw_spmm_rows_torch, psw_spmm_torch, spmm_dense_torch

__all__ = ["CHUNK", "RowLayout", "compact_tiles", "ops", "prepare_blocks",
           "prepare_rows", "psw_spmm", "psw_spmm_edges", "psw_spmm_rows",
           "psw_spmm_rows_torch", "psw_spmm_torch", "spmm_dense_torch",
           "transpose_rows"]
