"""Wrappers for the PSW sweep kernels (`core/psw.py::edge_centric_sweep`).

`window_send` builds the window exchange's send buffer and `segment_sum`
sums each destination's edge values, gathered by the kernel from the vertex
state (`src=`) or the window buffer (`edge_owner=`, `edge_slot=`) or given
as messages. CUDA tensors launch the kernels; CPU tensors take the plain
torch versions (ref.py); there is no fallback from one to the other, so a
kernel that fails to build or launch raises. The CUDA path takes float32
values."""
from __future__ import annotations

from typing import Optional

import torch

from ..common import count_launch
from . import kernel as _kernel
from .ref import edge_rows_torch, segment_sum_torch, window_send_torch

__all__ = ["segment_sum", "window_send"]

# kernel launches made by window_send and segment_sum: read and reset it as
# `ops.launches` (a run zeroes it, drives its path, and reads it back to
# show that the path went through the kernels)
launches = 0


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no PSW sweep path for {t.device}")
    if t.device.type == "cuda" and t.dtype != torch.float32:
        raise TypeError(f"the CUDA sweep takes float32 values, not {t.dtype}")
    return t.device.type


def window_send(x: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """(P, Pl, W, d): [c, o, w] = x[o, send_idx[o, c, w]] for owner-local
    state x (Pl, L, d) and int32 send_idx (Pl, P, W), consumer-major. It is
    the window buffer of a sweep on one device (Pl = P) and the send buffer
    of the exchange over a process group."""
    if _device(x) == "cpu":
        return window_send_torch(x, send_idx)
    Pl, L, d = x.shape
    P, W = send_idx.shape[1], send_idx.shape[2]
    send = torch.empty((P, Pl, W, d), dtype=torch.float32, device=x.device)
    if send.numel():
        _kernel.exchange(x.contiguous(), send_idx, send)
        count_launch(globals())
    return send


def segment_sum(table: torch.Tensor, seg_ptr: torch.Tensor,
                src: Optional[torch.Tensor] = None,
                edge_owner: Optional[torch.Tensor] = None,
                edge_slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Pl, L, d): out[p, v] = the sum of destination v's edge values over
    the (Pl, L + 1) destination CSR seg_ptr, in float64, rounded once. The
    values are `table`'s rows: the messages (Pl, E, d) themselves; with
    `src` (Pl, E), rows of the vertex state (N, d); with `edge_owner` and
    `edge_slot` (Pl, E), rows edge_owner * W + edge_slot of the window
    buffer recv[p] (table (Pl, P, W, d)). Edges past seg_ptr[p, L] are
    never read."""
    if _device(table) == "cpu":
        if src is not None or edge_owner is not None:
            table = edge_rows_torch(table, src, edge_owner, edge_slot)
        return segment_sum_torch(table, seg_ptr)
    if src is not None:
        mode, idx_a, idx_b = _kernel.INDEX, src, None
    elif edge_owner is not None:
        mode, idx_a, idx_b = _kernel.WINDOW, edge_owner, edge_slot
    else:
        mode, idx_a, idx_b = _kernel.IDENTITY, None, None
    Pl, L, d = seg_ptr.shape[0], seg_ptr.shape[1] - 1, table.shape[-1]
    out = torch.empty((Pl, L, d), dtype=torch.float32, device=table.device)
    if out.numel():
        E = (table if idx_a is None else idx_a).shape[1]
        nt = _kernel.n_tiles(L, E)
        coords = torch.empty((2, Pl, nt + 1), dtype=torch.int64,
                             device=table.device)
        partials = torch.empty((2, Pl, nt, d), dtype=torch.float64,
                               device=table.device)
        _kernel.segment_sum(mode, table.contiguous(), seg_ptr.contiguous(),
                            out, coords, partials, idx_a, idx_b)
        count_launch(globals())
    return out
