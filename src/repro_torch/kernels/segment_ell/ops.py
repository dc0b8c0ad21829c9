"""Wrapper for the ELL gather-reduce kernel (port of the reference
`repro/kernels/segment_ell/ops.py`).

`segment_ell` launches the CUDA kernel for CUDA tensors and takes the plain
torch version for CPU tensors; there is no fallback from one to the other,
so a kernel that fails to build or launch raises. The kernel masks ragged
rows and columns itself, so nothing is padded to 128 as the TPU wrapper
does."""
from __future__ import annotations

import numpy as np
import torch

from ...graph.padding import pad_to_ell
from . import kernel as _kernel
from .ref import segment_ell_torch

__all__ = ["segment_ell", "segment_ell_from_edges"]

# kernel launches made by segment_ell: read and reset it as `ops.launches`
launches = 0


def segment_ell(idx: torch.Tensor, mask: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """out (N, F): out[n] = Σ_k mask[n,k]·x[idx[n,k]] for int32 idx and
    bool mask (N, K) and float32 x (M, F), all on one device. The live
    slots' idx must lie in [0, M); a masked slot's idx is never read."""
    global launches
    for name, t in (("idx", idx), ("mask", mask), ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, not "
                            f"{type(t).__name__}")
    if idx.device != x.device or mask.device != x.device:
        raise ValueError(f"idx on {idx.device}, mask on {mask.device}, x on "
                         f"{x.device}: expected one device")
    if (idx.dim() != 2 or mask.shape != idx.shape or x.dim() != 2
            or idx.dtype != torch.int32 or mask.dtype != torch.bool
            or x.dtype != torch.float32):
        raise ValueError(
            f"expected int32 idx and bool mask (N, K), float32 x (M, F); got "
            f"{idx.dtype} {tuple(idx.shape)}, {mask.dtype} "
            f"{tuple(mask.shape)}, {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cuda":
        out = torch.empty((idx.shape[0], x.shape[1]), dtype=torch.float32,
                          device=x.device)
        if out.numel():
            _kernel.launch(idx.contiguous(), mask.contiguous(),
                           x.contiguous(), out)
            launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no segment_ell path for {x.device}")
    return segment_ell_torch(idx, mask, x)


def segment_ell_from_edges(src, dst, x: torch.Tensor, n_nodes: int,
                           max_degree: int) -> torch.Tensor:
    """Sum each destination's first `max_degree` in-neighbours' rows of x
    (stable edge order, as `pad_to_ell` keeps them): the ELL layout is built
    on the host, then moved to x's device."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.size and (src.min() < 0 or src.max() >= x.shape[0]):
        raise ValueError(f"source ids must lie in [0, {x.shape[0]})")
    if dst.size and (dst.min() < 0 or dst.max() >= n_nodes):
        raise ValueError(f"destination ids must lie in [0, {n_nodes})")
    idx, mask = pad_to_ell(src, dst, n_nodes, max_degree)
    return segment_ell(torch.from_numpy(idx).to(x.device),
                       torch.from_numpy(mask).to(x.device), x)
