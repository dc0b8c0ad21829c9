"""Bind the Hopper embedding-bag kernel (csrc/embedding_bag.cu).

Built at first use by `kernels/common.py` (nvcc, sm_90a, into
`build/kernels/embedding_bag_<hash>.so`) and loaded with ctypes; nothing
here runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import common

__all__ = ["SOURCE", "launch", "library_path", "load_library"]

NAME = "embedding_bag"
SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"


def library_path() -> Path:
    return common.library_path(NAME, SOURCE)


def _bind(lib) -> None:
    fn = lib.embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load_library():
    """The kernel's shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def launch(idx: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
           out: torch.Tensor, err: torch.Tensor, lib=None) -> None:
    """out (B, D) <- Σ_k w·table[idx] over idx (B, K) int32 or int64, w
    (B, K) and table (V, D), on the current stream of table's device. The
    kernel reads no row outside [0, V): such a slot adds nothing and sets
    err (one int32, 0 before the launch) to 1, for the caller to read.
    err lies on table's device or in pinned host memory, which the kernel
    writes through the same address (unified addressing): then a stream
    synchronize, and no copy, makes it readable on the host. `lib` is
    another build of the source (scripts/embedding_bag_variants.py).
    Raises if the launch is refused."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    B, K = idx.shape
    V, D = table.shape
    check = common.check_tensor
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx has dtype {idx.dtype}, expected int32 or int64")
    check(idx, "idx", idx.dtype, (B, K), dev)
    check(w, "w", torch.float32, (B, K), dev)
    check(table, "table", torch.float32, (V, D), dev)
    check(out, "out", torch.float32, (B, D), dev)
    if err.device.type == "cpu" and not err.is_pinned():
        raise ValueError("err on the host must be pinned memory")
    check(err, "err", torch.int32, (1,),
          err.device if err.device.type == "cpu" else dev)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.embedding_bag_launch(
        idx.data_ptr(), int(idx.dtype == torch.int64), w.data_ptr(),
        table.data_ptr(), out.data_ptr(), err.data_ptr(), B, K, D, V,
        dev.index, stream)
    common.raise_on_error(lib, NAME, code)
