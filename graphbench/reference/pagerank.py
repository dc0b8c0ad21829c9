"""Plain PageRank over the raw edge list, in original ids.

The iteration the configuration states: every rank starts at 1; each step
sends rank / out-degree along every edge (a repeated edge sends once per
copy, a self-loop to its own tail) and sets
rank = (1 - damping) + damping * (sum received). A vertex with no
out-edges sends nothing.

`dtype=torch.float64` is the reference. `torch.bfloat16` keeps the ranks
and what they send in bfloat16, the precision below the program's float32,
with float32 sums: the control.

Imports torch alone: nothing of the program under test.
"""
from __future__ import annotations

import torch


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int, iterations: int,
             damping: float, dtype=torch.float64) -> torch.Tensor:
    """(n,) ranks, as float64 on the edges' device."""
    acc_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    outdeg = torch.bincount(src, minlength=n).to(acc_dtype)
    inv = (1.0 / torch.clamp(outdeg, min=1.0)).to(dtype)
    r = torch.ones(n, dtype=dtype, device=src.device)
    for _ in range(iterations):
        share = (r * inv).to(dtype)
        acc = torch.zeros(n, dtype=acc_dtype, device=src.device)
        acc.index_add_(0, dst, share[src].to(acc_dtype))
        r = ((1.0 - damping) + damping * acc).to(dtype)
    return r.to(torch.float64)


def max_relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / |want| over every vertex (ranks are >= 1 - damping,
    never 0); a non-finite rank reads as 1e30."""
    got = got.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return 1e30
    return float(((got - want).abs() / want.abs()).max())
