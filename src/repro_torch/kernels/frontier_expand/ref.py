"""Plain torch version of the frontier-expansion kernel.

It reads the kernel's destination CSR (`col`, `edge_ptr`) and adds each
edge's source row into its destination with `index_add_`, which is what
the reference computes from its ELL (`repro/kernels/frontier_expand/
ref.py::frontier_expand_ref` and the wrapper's sorted `segment_sum`). The
CPU path of `frontier_expand_counts` and the CUDA kernel's check in
`chip_smoke.py` both use it."""
from __future__ import annotations

import torch

__all__ = ["frontier_expand_torch"]

EDGE_CHUNK = 1 << 20   # edges gathered at once: peak memory (chunk, B)


def frontier_expand_torch(col: torch.Tensor, edge_ptr: torch.Tensor,
                          x: torch.Tensor, n_dst: int) -> torch.Tensor:
    """col (E,) sources grouped by destination, edge_ptr (n_dst + 1,) the
    CSR over them, x (M, B). Returns (n_dst, B): out[d] = Σ_{e in
    [edge_ptr[d], edge_ptr[d + 1])} x[col[e]]."""
    out = torch.zeros((n_dst, x.shape[1]), dtype=x.dtype, device=x.device)
    for a in range(0, col.shape[0], EDGE_CHUNK):
        e = torch.arange(a, min(a + EDGE_CHUNK, col.shape[0]),
                         device=x.device)
        dst = torch.searchsorted(edge_ptr, e, right=True) - 1
        out.index_add_(0, dst, x[col[a:a + EDGE_CHUNK].long()])
    return out
