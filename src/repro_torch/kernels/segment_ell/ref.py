"""Plain torch version of the ELL gather-reduce kernel (the reference oracle
is `repro/kernels/segment_ell/ref.py::segment_ell_ref`).

A loop over the slots in order k = 0..K-1, as the kernel walks them, so the
two agree bitwise on the card; peak memory stays (N, F), not (N, K, F). A
masked slot's index is never used to gather, so it may hold anything."""
from __future__ import annotations

import torch

__all__ = ["segment_ell_torch"]


def segment_ell_torch(idx: torch.Tensor, mask: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """idx (N, K) source rows, mask (N, K) valid, x (M, F).
    out[n] = Σ_k mask[n,k]·x[idx[n,k]]."""
    safe = torch.where(mask, idx, 0).long()
    acc = torch.zeros((idx.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    for k in range(idx.shape[1]):
        acc += torch.where(mask[:, k:k + 1], x[safe[:, k]], 0)
    return acc
