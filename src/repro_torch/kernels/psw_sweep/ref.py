"""Plain torch versions of the PSW sweep kernels.

`window_send_torch` is the window exchange's send buffer by `torch.gather`;
`edge_rows_torch` gathers each edge's row of the vertex state or of the
window buffer; `segment_sum_torch` adds each destination's messages in
float64, in edge order, with `index_add_`, and rounds once. They are the
CPU path of `ops.py`, the message build of a caller's `msg_fn` on either
device, and the kernels' oracle."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["edge_rows_torch", "segment_sum_torch", "window_send_torch"]


def window_send_torch(x: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """(P, Pl, W, d) with [c, o, w] = x[o, send_idx[o, c, w]] for x (Pl, L,
    d) and send_idx (Pl, P, W): a view of the gathered (Pl, P, W, d). The
    reference's `take_along_axis` broadcasts x over the consumer axis;
    torch.gather does not, so x is expanded (a view, no copy)."""
    Pl, L, d = x.shape
    P, W = send_idx.shape[1], send_idx.shape[2]
    idx = send_idx.long()[..., None].expand(Pl, P, W, d)
    return torch.gather(x[:, None].expand(Pl, P, L, d), 2, idx).transpose(0, 1)


def edge_rows_torch(table: torch.Tensor, src: Optional[torch.Tensor] = None,
                    edge_owner: Optional[torch.Tensor] = None,
                    edge_slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Pl, E, d): each edge's row of the vertex state table (N, d) at src,
    or of the window buffer (Pl, P, W, d) at edge_owner * W + edge_slot."""
    if src is not None:
        return table[src]
    Pl, P, W, d = table.shape
    flat = table.reshape(Pl, P * W, d)
    idx = (edge_owner * W + edge_slot).long()    # < P * W: no wrap
    return torch.gather(flat, 1, idx[..., None].expand(*idx.shape, d))


def segment_sum_torch(msgs: torch.Tensor, seg_ptr: torch.Tensor) -> torch.Tensor:
    """out[p, v] = Σ msgs[p, seg_ptr[p, v]:seg_ptr[p, v + 1]] for (Pl, E, d)
    msgs and a (Pl, L + 1) destination CSR: a float64 `index_add_` in edge
    order, rounded once to msgs' dtype. Edges past seg_ptr[p, L] (padding)
    go to a row that is dropped."""
    Pl, E, d = msgs.shape
    L = seg_ptr.shape[1] - 1
    pos = torch.arange(E, device=msgs.device).expand(Pl, E).contiguous()
    dst = torch.searchsorted(seg_ptr.contiguous(), pos, right=True) - 1
    dst += torch.arange(Pl, device=msgs.device)[:, None] * (L + 1)
    out = torch.zeros((Pl * (L + 1), d), dtype=torch.float64,
                      device=msgs.device)
    out.index_add_(0, dst.reshape(-1), msgs.reshape(Pl * E, d).double())
    return out.reshape(Pl, L + 1, d)[:, :L].to(msgs.dtype).contiguous()
