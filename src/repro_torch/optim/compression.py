"""Gradient compression for the data-parallel all-reduce (port of the
reference `repro/optim/compression.py`).

int8 error-feedback quantization (1-bit-Adam-family trick): each DP rank
quantizes its local gradient to int8 with a per-tensor scale before the
all-reduce, keeping the quantization residual locally and adding it to the
next step's gradient (error feedback keeps the bias bounded).

`compressed_psum_tree` runs over a `torch.distributed` process group where
the reference runs a `psum` over a shard_map axis: one `all_reduce` of the
int8 payloads widened to int32 (the sum of many ranks' int8 values
overflows int8) and one fp32 `all_reduce` of the scales a leaf. The
payload all-reduce therefore moves 4 bytes a value, as the reference's
int32 psum does: as many as an fp32 all-reduce, not a quarter of them.
`group=None` is one rank: no communication, the same arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["ef_compress", "ef_decompress", "compressed_psum_tree"]


def ef_compress(g: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (g + residual) to int8 with a per-tensor scale.
    Returns (q_int8, scale, new_residual)."""
    x = g.to(torch.float32) + residual
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_residual = x - q.to(torch.float32) * scale
    return q, scale, new_residual


def ef_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_tree(grads, residuals, group=None):
    """Error-feedback int8 all-reduce of a gradient tree over `group` (a
    process group, or None for one rank). Scales are all-reduced in fp32
    (negligible bytes); the int8 payloads are summed as int32 values, 4
    bytes each on the interconnect. Returns (mean_grads, residuals)."""
    if group is None:
        n = 1
    else:
        import torch.distributed as dist
        n = dist.get_world_size(group)

    def one(g, r):
        q, scale, new_r = ef_compress(g, r)
        # int8 summation can overflow int8 — accumulate in int32
        total = q.to(torch.int32)
        scale_sum = scale.clone()
        if group is not None:
            dist.all_reduce(total, group=group)
            dist.all_reduce(scale_sum, group=group)
        # each rank used its own scale; approximate with the mean scale
        mean = total.to(torch.float32) * (scale_sum / n) / n
        return mean.to(g.dtype), new_r

    flat_g, spec = pytree.tree_flatten(grads)
    flat_r = pytree.tree_leaves(residuals)
    out = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return (pytree.tree_unflatten([o[0] for o in out], spec),
            pytree.tree_unflatten([o[1] for o in out], spec))
