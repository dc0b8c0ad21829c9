"""Plain torch version of the frontier-expansion kernel.

The same K-loop as the reference oracle (`repro/kernels/frontier_expand/
ref.py::frontier_expand_ref`), followed by the per-destination reduction
that the reference wrapper does with a sorted `segment_sum`, here an
`index_add_` over `row_dst`. The CPU path of `frontier_expand_counts` and
the CUDA kernel's check in `chip_smoke.py` both use it."""
from __future__ import annotations

import torch

__all__ = ["frontier_expand_torch"]


def frontier_expand_torch(idx: torch.Tensor, mask: torch.Tensor,
                          x: torch.Tensor, row_dst: torch.Tensor,
                          n_dst: int) -> torch.Tensor:
    """idx/mask (R, K), x (M, B), row_dst (R,) destination per row (padding
    rows -> n_dst). Returns (n_dst, B): out[d] = Σ_{rows r of d} Σ_k
    mask[r,k]·x[idx[r,k]]. Peak memory stays (R, B), not (R, K, B)."""
    idx = idx.long()
    acc = torch.zeros((idx.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    for k in range(idx.shape[1]):
        acc += torch.where(mask[:, k:k + 1], x[idx[:, k]], 0)
    out = torch.zeros((n_dst + 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    out.index_add_(0, row_dst.long(), acc)
    return out[:n_dst]
