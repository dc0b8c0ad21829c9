"""Shared kernel utilities (port of the reference `repro/kernels/common.py`;
its `default_interpret` is a Pallas-on-TPU switch and has no counterpart),
and the one nvcc build/load helper that every kernel's `kernel.py` uses.

Each CUDA source has a plain C interface: `nvcc` compiles it for sm_90a into
a shared library at first use, under `build/kernels/` at the repository
root, named by the kernel and a hash of its source and flags, so an edited
kernel rebuilds and an unchanged one is reused. The library is loaded with
ctypes; nothing here runs at import time, so the package imports on a
machine with no CUDA toolkit. `build_libraries` builds several kernels at
once, one nvcc process each, all started together."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch

__all__ = ["build_dir", "build_libraries", "cdiv", "check_tensor",
           "library_path", "load_library", "raise_on_error", "round_up"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def build_dir() -> Path:
    """`build/kernels/` at the repository root (this file is
    src/repro_torch/kernels/common.py, three levels below it)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def library_path(name: str, src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def build_libraries(sources: Dict[str, Path]) -> None:
    """Build every missing library of `sources` (kernel name -> CUDA
    source): one nvcc process each, all started together, each into a
    temporary name and then renamed atomically. The command and ptxas's
    register/spill report go to `<library>.log`. Raises if any build
    failed, after every nvcc has ended."""
    nvcc = None
    jobs = []
    for name, src in sources.items():
        out = library_path(name, src)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, out, tmp, cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout
                                           + stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                          f"{stderr}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str, src: Path,
                 bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The kernel's shared library, built on first use and cached per
    name; `bind` sets the argument and return types of its entry points.
    Every library exports `<name>_error_string(int)`."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_libraries({name: src})
            lib = ctypes.CDLL(str(library_path(name, src)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            bind(lib)
            _LIBS[name] = lib
        return lib


def raise_on_error(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """What a kernel takes: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
