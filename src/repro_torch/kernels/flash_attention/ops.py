"""Wrapper for the flash-attention kernel (port of the reference
`repro/kernels/flash_attention/ops.py`): kernel forward, recompute backward.

`flash_attention` is a `torch.autograd.Function`. Its forward launches the
CUDA kernel for CUDA tensors and takes the plain torch version for CPU
tensors; there is no fallback from one to the other, so a kernel that
fails to build or launch raises. Its backward recomputes the forward's own
plain version, `flash_attention_torch` (causal mask aligned top-left), and
differentiates that, so the gradient is the forward's for every S and T.
The reference's custom VJP recomputes through its `attention_ref` instead,
whose mask is aligned bottom-right: the two gradients agree only for
S == T (ROADMAP queue 3 note b). The kernel masks ragged S and T itself,
so nothing is padded."""
from __future__ import annotations

import torch

from ..common import count_launch
from . import kernel as _kernel
from .ref import flash_attention_torch

__all__ = ["flash_attention"]

# kernel launches made by flash_attention: read and reset it as
# `ops.launches`
launches = 0


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, not "
                            f"{type(t).__name__}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}: expected one device")
    if (q.dtype not in _kernel.DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"q, k and v must share one dtype of "
                        f"{tuple(_kernel.DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]):
        raise ValueError(f"expected q (B, S, H, D) and k, v (B, T, Hkv, D) "
                         f"with H % Hkv == 0; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    D = q.shape[3]
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"head dim {D}: the kernel takes a multiple of 16 "
                         "up to 128")


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    if q.device.type == "cuda":
        # a copy lands on fresh, aligned storage (`contiguous` may not)
        q, k, v = (t if _kernel.vector_ready(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if out.numel():
            _kernel.launch(q, k, v, out, causal)
            count_launch(globals())
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention path for {q.device}")
    return flash_attention_torch(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_torch(*qkv, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, T, Hkv, D), one dtype (float32 or
    bfloat16), D a multiple of 16 up to 128, H % Hkv == 0. Returns
    (B, S, H, D) in q's dtype: softmax(q k^T D^-0.5) v per head, query head
    h reading kv head h // (H / Hkv), fp32 online softmax, the causal mask
    aligned top-left (key t visible to query s iff t <= s)."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal))
