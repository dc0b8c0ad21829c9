"""Bind the Hopper flash-attention kernels (csrc/flash_attention.cu: bf16 on
wgmma + TMA, fp32 on SIMT).

Built at first use by `kernels/common.py` (nvcc, sm_90a, into
`build/kernels/flash_attention_<hash>.so`) and loaded with ctypes; nothing
here runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import common

__all__ = ["SOURCE", "launch", "library_path", "load_library"]

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def library_path() -> Path:
    return common.library_path(NAME, SOURCE)


def _bind(lib) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def load_library():
    """The kernel's shared library, built on first use and cached."""
    return common.load_library(NAME, SOURCE, _bind)


def vector_ready(t: torch.Tensor) -> bool:
    """What the kernel reads through strides (the bf16 kernel through TMA
    tensor maps): the last dimension dense, the other strides and the base
    address on 16-byte boundaries, and no stride 0 on a dimension longer
    than 1 (a broadcast view)."""
    step = 16 // t.element_size()
    return (t.stride(-1) == 1
            and all(s % step == 0 and (s > 0 or n == 1)
                    for s, n in zip(t.stride()[:-1], t.shape[:-1]))
            and t.data_ptr() % 16 == 0)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool) -> None:
    """out (B, S, H, D), contiguous, <- attention of q (B, S, H, D) over k
    and v (B, T, Hkv, D), on the current stream of q's device. Raises if
    the launch is refused."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    for name, t, shape in (("k", k, (B, T, Hkv, D)), ("v", v, (B, T, Hkv, D))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {q.dtype} {shape} on {dev}")
        if not vector_ready(t):
            raise ValueError(f"{name} strides {t.stride()} are not 16-byte "
                             "aligned with a dense last dimension")
    if not vector_ready(q):
        raise ValueError(f"q strides {q.stride()} are not 16-byte aligned "
                         "with a dense last dimension")
    common.check_tensor(out, "out", q.dtype, (B, S, H, D), dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, Hkv, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], D ** -0.5, int(causal), DTYPES[q.dtype],
        dev.index, stream)
    common.raise_on_error(lib, NAME, err)
