"""Build and bind the Hopper frontier-expansion kernel (csrc/frontier_expand.cu).

The CUDA source has a plain C interface: `nvcc` compiles it for sm_90a into
a shared library at first use, under `build/kernels/` at the repository
root, named by a hash of the source so an edited kernel rebuilds and an
unchanged one is reused. It is loaded with ctypes; nothing here runs at
import time, so the module imports on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["build_dir", "launch", "library_path", "load_library"]

_SRC = Path(__file__).resolve().parent / "csrc" / "frontier_expand.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LOCK = threading.Lock()
_LIB = None


def build_dir() -> Path:
    """`build/kernels/` at the repository root (src/repro_torch/kernels/
    frontier_expand/kernel.py is four levels below it)."""
    return Path(__file__).resolve().parents[4] / "build" / "kernels"


def library_path() -> Path:
    h = hashlib.sha1(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode())
    return build_dir() / f"frontier_expand_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the frontier-expansion kernel")


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)


def load_library():
    """The kernel's shared library, built on first use and cached."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            fn = lib.frontier_expand_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3 + [
                ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.frontier_expand_error_string.argtypes = [ctypes.c_int]
            lib.frontier_expand_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(plan, x: torch.Tensor, out: torch.Tensor,
           scratch: torch.Tensor) -> None:
    """out (n_dst, B) <- the frontier expansion of x (n_src, B) over a
    device-resident FrontierPlan, on the current stream of x's device;
    scratch (n_chunks, B) holds the heavy destinations' chunk partials.
    Raises if a launch is refused."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    R, K = plan.idx.shape
    n_dst, B = out.shape
    C, H = plan.chunks.shape[0], plan.heavy_dst.shape[0]
    _check(plan.idx, "idx", torch.int32, (R, K), dev)
    _check(plan.mask, "mask", torch.bool, (R, K), dev)
    _check(plan.dst_ptr, "dst_ptr", torch.int64, (n_dst + 1,), dev)
    _check(plan.chunks, "chunks", torch.int64, (C, 2), dev)
    _check(plan.heavy_dst, "heavy_dst", torch.int64, (H,), dev)
    _check(plan.heavy_ptr, "heavy_ptr", torch.int64, (H + 1,), dev)
    _check(x, "x", torch.float32, (plan.n_src, B), dev)
    _check(out, "out", torch.float32, (plan.n_dst, B), dev)
    _check(scratch, "scratch", torch.float32, (C, B), dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.frontier_expand_launch(
        plan.idx.data_ptr(), plan.mask.data_ptr(), plan.dst_ptr.data_ptr(),
        plan.chunks.data_ptr(), plan.heavy_dst.data_ptr(),
        plan.heavy_ptr.data_ptr(), x.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n_dst, C, H, K, plan.split_rows, B, dev.index,
        stream)
    if err != 0:
        msg = lib.frontier_expand_error_string(err).decode()
        raise RuntimeError(f"frontier_expand kernel launch failed: {msg}")
