"""Bind the Hopper ELL gather-reduce kernel (csrc/segment_ell.cu).

Built at first use by `kernels/common.py` (nvcc, sm_90a, into
`build/kernels/segment_ell_<hash>.so`) and loaded with ctypes; nothing here
runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import common

__all__ = ["SOURCE", "launch", "library_path", "load_library"]

NAME = "segment_ell"
SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_ell.cu"


def library_path() -> Path:
    return common.library_path(NAME, SOURCE)


def _bind(lib) -> None:
    fn = lib.segment_ell_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load_library():
    """The kernel's shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def launch(idx: torch.Tensor, mask: torch.Tensor, x: torch.Tensor,
           out: torch.Tensor, lib=None) -> None:
    """out (N, F) <- Σ_k mask·x[idx] over idx/mask (N, K) and x (M, F), on
    the current stream of x's device. The live slots' idx must lie in
    [0, M). `lib` is another build of the source
    (scripts/segment_ell_variants.py). Raises if the launch is refused."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    N, K = idx.shape
    M, F = x.shape
    check = common.check_tensor
    check(idx, "idx", torch.int32, (N, K), dev)
    check(mask, "mask", torch.bool, (N, K), dev)
    check(x, "x", torch.float32, (M, F), dev)
    check(out, "out", torch.float32, (N, F), dev)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.segment_ell_launch(idx.data_ptr(), mask.data_ptr(),
                                 x.data_ptr(), out.data_ptr(), N, K, F,
                                 dev.index, stream)
    common.raise_on_error(lib, NAME, err)
