"""Bind the Hopper frontier-expansion kernel (csrc/frontier_expand.cu).

Built at first use by `kernels/common.py` (nvcc, sm_90a, into
`build/kernels/frontier_expand_<hash>.so`) and loaded with ctypes; nothing
here runs at import time, so the module imports on a machine with no CUDA
toolkit.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import common

__all__ = ["SOURCE", "TILE", "launch", "library_path", "load_library"]

NAME = "frontier_expand"
TILE = 128          # columns per warp and per non-zero flag (kTile in the .cu)
SOURCE = Path(__file__).resolve().parent / "csrc" / "frontier_expand.cu"


def library_path() -> Path:
    return common.library_path(NAME, SOURCE)


def _bind(lib) -> None:
    fn = lib.frontier_expand_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def load_library():
    """The kernel's shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def launch(plan, x: torch.Tensor, out: torch.Tensor, scratch: torch.Tensor,
           flags: torch.Tensor, lib=None) -> None:
    """out (n_dst, B) <- the frontier expansion of x (n_src, B) over a
    device-resident FrontierPlan's compact layout, on the current stream of
    x's device; scratch (plan.scratch_rows, B) holds the chunk sums of the
    hubs of several chunks, flags (n_src, ceil(B / TILE)) uint8 the
    non-zero tiles of x when B >= 32 (else (n_src, 0)). `lib` is another
    build of the source (scripts/frontier_expand_variants.py). Raises if a
    launch is refused."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    n_dst, B = out.shape
    E, C = plan.col.shape[0], plan.chunks.shape[0]
    H, S = plan.reduced_hubs, plan.scratch_rows
    tiles = common.cdiv(B, TILE) if B >= 32 else 0
    check = common.check_tensor
    check(plan.col, "col", torch.int32, (E,), dev)
    check(plan.edge_ptr, "edge_ptr", torch.int64, (plan.n_dst + 1,), dev)
    check(plan.chunks, "chunks", torch.int64, (C, 2), dev)
    check(plan.chunk_row, "chunk_row", torch.int64, (C,), dev)
    check(plan.reduce_dst, "reduce_dst", torch.int64, (H,), dev)
    check(plan.reduce_ptr, "reduce_ptr", torch.int64, (H + 1,), dev)
    check(x, "x", torch.float32, (plan.n_src, B), dev)
    check(out, "out", torch.float32, (plan.n_dst, B), dev)
    check(scratch, "scratch", torch.float32, (S, B), dev)
    check(flags, "flags", torch.uint8, (plan.n_src, tiles), dev)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.frontier_expand_launch(
        plan.col.data_ptr(), plan.edge_ptr.data_ptr(),
        plan.chunks.data_ptr(), plan.chunk_row.data_ptr(),
        plan.reduce_dst.data_ptr(), plan.reduce_ptr.data_ptr(),
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
        plan.n_src, n_dst, C, S, H, plan.light_edges, B, dev.index, stream)
    common.raise_on_error(lib, NAME, err)
