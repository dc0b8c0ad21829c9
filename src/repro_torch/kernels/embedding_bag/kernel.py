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
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load_library():
    """The kernel's shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def launch(idx: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
           out: torch.Tensor) -> None:
    """out (B, D) <- Σ_k w·table[idx] over idx/w (B, K) and table (V, D),
    on the current stream of table's device. idx must lie in [0, V).
    Raises if the launch is refused."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    B, K = idx.shape
    V, D = table.shape
    check = common.check_tensor
    check(idx, "idx", torch.int32, (B, K), dev)
    check(w, "w", torch.float32, (B, K), dev)
    check(table, "table", torch.float32, (V, D), dev)
    check(out, "out", torch.float32, (B, D), dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.embedding_bag_launch(idx.data_ptr(), w.data_ptr(),
                                   table.data_ptr(), out.data_ptr(), B, K, D,
                                   dev.index, stream)
    common.raise_on_error(lib, NAME, err)
