"""Bind the Hopper PSW block-sparse SpMM kernel (csrc/psw_spmm.cu).

Built at first use by `kernels/common.py` (nvcc, sm_90a, into
`build/kernels/psw_spmm_<hash>.so`) and loaded with ctypes; nothing here
runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import common

__all__ = ["BLOCK", "SOURCE", "launch", "library_path", "load_library",
           "smem_bytes"]

NAME = "psw_spmm"
BLOCK = 128          # the kernel's tile side
SOURCE = Path(__file__).resolve().parent / "csrc" / "psw_spmm.cu"


def library_path() -> Path:
    return common.library_path(NAME, SOURCE)


def _bind(lib) -> None:
    fn = lib.psw_spmm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.psw_spmm_smem_bytes.argtypes = []
    lib.psw_spmm_smem_bytes.restype = ctypes.c_int


def load_library():
    """The kernel's shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def smem_bytes() -> int:
    """Dynamic shared memory a CTA of the kernel asks for."""
    return int(load_library().psw_spmm_smem_bytes())


def launch(tile_ptr: torch.Tensor, coords: torch.Tensor,
           tiles: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> None:
    """out (n_dst_blocks*128, F) <- the block-sparse product of the tiles
    (T, 128, 128) at dst-sorted coords (T, 2) with x (n_src_blocks*128, F),
    on the current stream of x's device. tile_ptr (n_dst_blocks + 1,) is
    the CSR over coords' dst blocks; every coords[:, 1] must be below
    n_src_blocks. Raises if the launch is refused."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    T = coords.shape[0]
    n_dst_blocks = tile_ptr.shape[0] - 1
    X, F = x.shape
    check = common.check_tensor
    check(tile_ptr, "tile_ptr", torch.int64, (n_dst_blocks + 1,), dev)
    check(coords, "coords", torch.int32, (T, 2), dev)
    check(tiles, "tiles", torch.float32, (T, BLOCK, BLOCK), dev)
    check(x, "x", torch.float32, (X, F), dev)
    check(out, "out", torch.float32, (n_dst_blocks * BLOCK, F), dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.psw_spmm_launch(tile_ptr.data_ptr(), coords.data_ptr(),
                              tiles.data_ptr(), x.data_ptr(), out.data_ptr(),
                              n_dst_blocks, X, F, dev.index, stream)
    common.raise_on_error(lib, NAME, err)
