"""Plain torch version of the embedding-bag kernel (the reference oracle is
`repro/kernels/embedding_bag/ref.py::embedding_bag_ref`).

A loop over the slots in order k = 0..K-1, as the kernel walks them, each
step `acc + w[:, k] * row` rounded twice in fp32, so the two agree bitwise
on the card; peak memory stays (B, D), not (B, K, D). The table is
float32, as the kernel takes it."""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_torch"]


def embedding_bag_torch(idx: torch.Tensor, weights: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """idx (B, K) rows of table (V, D), weights (B, K). out[b] =
    Σ_k weights[b,k]·table[idx[b,k]]. Every slot is gathered, weight 0
    included."""
    B, K = idx.shape
    rows = idx.long()
    w = weights.float()
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for k in range(K):
        acc += w[:, k, None] * table[rows[:, k]]
    return acc
