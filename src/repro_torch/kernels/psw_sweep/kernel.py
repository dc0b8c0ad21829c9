"""Bind the Hopper PSW sweep kernels (csrc/psw_sweep.cu): the window
exchange's send buffer and the gather-and-segment-sum.

Built at first use by `kernels/common.py` (nvcc, sm_90a, into
`build/kernels/psw_sweep_<hash>.so`) and loaded with ctypes; nothing here
runs at import time, so the module imports on a machine with no CUDA
toolkit.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import common

__all__ = ["IDENTITY", "INDEX", "SOURCE", "TILE", "WINDOW", "exchange",
           "library_path", "load_library", "n_tiles", "segment_sum"]

NAME = "psw_sweep"
TILE = 2048          # merge items (row ends and edges) a block: kTile in the .cu
SOURCE = Path(__file__).resolve().parent / "csrc" / "psw_sweep.cu"
IDENTITY, INDEX, WINDOW = 0, 1, 2   # how an edge names its table row (Mode)


def library_path() -> Path:
    return common.library_path(NAME, SOURCE)


def _bind(lib) -> None:
    ex = lib.psw_sweep_exchange_launch
    ex.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    ex.restype = ctypes.c_int
    fn = lib.psw_sweep_sum_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load_library():
    """The kernels' shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def n_tiles(L: int, E: int) -> int:
    """Blocks a partition of L destinations and E edge slots takes."""
    return common.cdiv(L + E, TILE)


def _cuda(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {t.device}")
    return t.device


def exchange(x: torch.Tensor, send_idx: torch.Tensor, send: torch.Tensor,
             lib=None) -> None:
    """send (P, Pl, W, d) <- x[o, send_idx[o, c, w]] at [c, o, w] for x
    (Pl, L, d) and send_idx (Pl, P, W), on the current stream of x's
    device. Raises if the launch is refused."""
    dev = _cuda(x)
    Pl, L, d = x.shape
    P, W = send_idx.shape[1], send_idx.shape[2]
    check = common.check_tensor
    check(x, "x", torch.float32, (Pl, L, d), dev)
    check(send_idx, "send_idx", torch.int32, (Pl, P, W), dev)
    check(send, "send", torch.float32, (P, Pl, W, d), dev)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.psw_sweep_exchange_launch(x.data_ptr(), send_idx.data_ptr(),
                                        send.data_ptr(), P, Pl, L, W, d,
                                        dev.index, stream)
    common.raise_on_error(lib, NAME, err)


def segment_sum(mode: int, table: torch.Tensor, seg_ptr: torch.Tensor,
                out: torch.Tensor, coords: torch.Tensor,
                partials: torch.Tensor, idx_a: torch.Tensor = None,
                idx_b: torch.Tensor = None, lib=None) -> None:
    """out (Pl, L, d) <- the float64 sums, rounded once, of each
    destination's edge values over seg_ptr (Pl, L + 1): `table` is the
    messages (Pl, E, d) (IDENTITY), the vertex state (N, d) read at idx_a =
    src (INDEX), or the window buffer (Pl, P, W, d) read at idx_a =
    edge_owner, idx_b = edge_slot (WINDOW); the index arrays are (Pl, E)
    int32. coords (2, Pl, n_tiles + 1) int64 and partials (2, Pl, n_tiles,
    d) float64 are the kernel's scratch. On the current stream of out's
    device; raises if a launch is refused."""
    dev = _cuda(out)
    Pl, L, d = out.shape
    check = common.check_tensor
    if mode == IDENTITY:
        E = table.shape[1]
        check(table, "table", torch.float32, (Pl, E, d), dev)
        stride_p, width = E * d, 0
    else:
        E = idx_a.shape[1]
        check(idx_a, "idx_a", torch.int32, (Pl, E), dev)
        if mode == INDEX:
            check(table, "table", torch.float32, (table.shape[0], d), dev)
            stride_p, width = 0, 0
        elif mode == WINDOW:
            P, W = table.shape[1], table.shape[2]
            check(table, "table", torch.float32, (Pl, P, W, d), dev)
            check(idx_b, "idx_b", torch.int32, (Pl, E), dev)
            stride_p, width = P * W * d, W
        else:
            raise ValueError(f"no sweep mode {mode}")
    nt = n_tiles(L, E)
    check(seg_ptr, "seg_ptr", torch.int64, (Pl, L + 1), dev)
    check(out, "out", torch.float32, (Pl, L, d), dev)
    check(coords, "coords", torch.int64, (2, Pl, nt + 1), dev)
    check(partials, "partials", torch.float64, (2, Pl, nt, d), dev)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [None if t is None else t.data_ptr() for t in (idx_a, idx_b)]
    err = lib.psw_sweep_sum_launch(
        mode, table.data_ptr(), ptr[0], ptr[1], seg_ptr.data_ptr(),
        out.data_ptr(), coords.data_ptr(), partials.data_ptr(), Pl, L, E,
        stride_p, width, d, dev.index, stream)
    common.raise_on_error(lib, NAME, err)
