"""Wrapper for the embedding-bag kernel (port of the reference
`repro/kernels/embedding_bag/ops.py`): weighted bag sums, mode sum or mean.

`embedding_bag` launches the CUDA kernel for CUDA tensors and takes the
plain torch version for CPU tensors; there is no fallback from one to the
other, so a kernel that fails to build or launch raises. The kernel masks
the ragged bag and column edges itself, so neither B nor D is padded to
128 as the TPU wrapper does: at a million rows that pad copies the whole
table on every call. The mean divides once, here, as the reference does.

Ids outside [0, V) raise ValueError on both devices: on the CPU before the
plain version runs; on the card the kernel reads no such row and sets an
error word, which the wrapper reads after the launch, so the call
synchronises its stream. The word is one int32 of pinned host memory,
which the kernel writes through its mapped address: the read needs the
synchronize and no copy. It is kept, one a device and stream, and is zero
between calls: only a refused call writes it, and it is zeroed again
before the ValueError. The reference's jnp oracle clamps high ids and
wraps negative ones instead (ROADMAP queue 3 note f)."""
from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import embedding_bag_torch

__all__ = ["embedding_bag"]

# kernel launches made by embedding_bag: read and reset it as `ops.launches`
launches = 0

_error_words: dict = {}   # (device index, stream handle) -> pinned int32, 0


def embedding_bag(idx: torch.Tensor, weights: torch.Tensor,
                  table: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """out (B, D): out[b] = Σ_k weights[b,k]·table[idx[b,k]] over a
    float32 table (V, D), divided by max(Σ_k weights[b,k], 1e-9) for
    mode="mean". idx (B, K) int32 or int64 must lie in [0, V), else
    ValueError; a padded slot holds any valid row and weight 0. All on one
    device."""
    global launches
    for name, t in (("idx", idx), ("weights", weights), ("table", table)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, not "
                            f"{type(t).__name__}")
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")
    if idx.device != table.device or weights.device != table.device:
        raise ValueError(f"idx on {idx.device}, weights on "
                         f"{weights.device}, table on {table.device}: "
                         "expected one device")
    if (idx.dim() != 2 or weights.shape != idx.shape or table.dim() != 2
            or idx.dtype not in (torch.int32, torch.int64)
            or not weights.is_floating_point()):
        raise ValueError(
            f"expected int idx and float weights (B, K), table (V, D); got "
            f"{idx.dtype} {tuple(idx.shape)}, {weights.dtype} "
            f"{tuple(weights.shape)}, {tuple(table.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, not {table.dtype}")
    V = table.shape[0]
    if table.device.type == "cuda":
        out = torch.empty((idx.shape[0], table.shape[1]),
                          dtype=torch.float32, device=table.device)
        if idx.numel() or out.numel():
            stream = torch.cuda.current_stream(table.device)
            key = (table.device.index, stream.cuda_stream)
            err = _error_words.get(key)
            if err is None:
                err = _error_words[key] = torch.zeros(
                    1, dtype=torch.int32, pin_memory=True)
            _kernel.launch(idx.contiguous(),
                           weights.to(torch.float32).contiguous(),
                           table.contiguous(), out, err)
            launches += 1
            stream.synchronize()
            if err.item():
                err.zero_()
                raise ValueError(f"ids must lie in [0, {V})")
    elif table.device.type == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= V):
            raise ValueError(f"ids must lie in [0, {V})")
        out = embedding_bag_torch(idx, weights, table)
    else:
        raise ValueError(f"no embedding_bag path for {table.device}")
    if mode == "mean":
        denom = torch.clamp_min(weights.sum(1, keepdim=True), 1e-9)
        out = out / denom.float()
    return out
