"""Bind the Hopper PSW row-gather SpMM kernel (csrc/psw_spmm.cu).

Built at first use by `kernels/common.py` (nvcc, sm_90a, into
`build/kernels/psw_spmm_<hash>.so`) and loaded with ctypes; nothing here
runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import common

__all__ = ["SOURCE", "launch", "library_path", "load_library"]

NAME = "psw_spmm"
SOURCE = Path(__file__).resolve().parent / "csrc" / "psw_spmm.cu"


def library_path() -> Path:
    return common.library_path(NAME, SOURCE)


def _bind(lib) -> None:
    fn = lib.psw_spmm_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load_library():
    """The kernel's shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def launch(layout, x: torch.Tensor, out: torch.Tensor,
           scratch: torch.Tensor) -> None:
    """out (n_rows, F) <- the product of a device-resident RowLayout with x
    (n_src, F), on the current stream of x's device; scratch (n_chunks, F)
    holds the hub rows' chunk totals. Every layout.col must be below
    n_src. Raises if a launch is refused."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    n_rows, F = out.shape
    nnz = layout.col.shape[0]
    C, H = layout.chunks.shape[0], layout.hub_rows.shape[0]
    check = common.check_tensor
    check(layout.row_ptr, "row_ptr", torch.int64, (n_rows + 1,), dev)
    check(layout.col, "col", torch.int32, (nnz,), dev)
    check(layout.val, "val", torch.float32, (nnz,), dev)
    check(layout.hub_rows, "hub_rows", torch.int64, (H,), dev)
    check(layout.hub_ptr, "hub_ptr", torch.int64, (H + 1,), dev)
    check(layout.chunks, "chunks", torch.int64, (C, 2), dev)
    check(x, "x", torch.float32, (layout.n_src, F), dev)
    check(out, "out", torch.float32, (layout.n_rows, F), dev)
    check(scratch, "scratch", torch.float32, (C, F), dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.psw_spmm_launch(
        layout.row_ptr.data_ptr(), layout.col.data_ptr(),
        layout.val.data_ptr(), layout.hub_rows.data_ptr(),
        layout.hub_ptr.data_ptr(), layout.chunks.data_ptr(), x.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), n_rows, C, H, F, layout.block,
        layout.max_row, dev.index, stream)
    common.raise_on_error(lib, NAME, err)
