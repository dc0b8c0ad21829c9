"""Wrapper for the flash-attention kernel (port of the reference
`repro/kernels/flash_attention/ops.py`): kernel forward, recompute backward.

`flash_attention` is a `torch.autograd.Function`. Its forward launches the
CUDA kernel for CUDA tensors and takes the plain torch version for CPU
tensors; there is no fallback from one to the other, so a kernel that
fails to build or launch raises. Its backward recomputes the forward's own
plain version, `flash_attention_torch` (causal mask aligned top-left), and
differentiates that, so the gradient is the forward's for every S and T.
It does so one chunk of Q_CHUNK queries at a time (with the keys a causal
chunk can see), adding each chunk's dk and dv in fp32, so autograd holds
one chunk's score blocks at a time, never the whole layer's. The
reference's custom VJP also recomputes (through XLA, no backward kernel),
but through its `attention_ref`, whose mask is aligned bottom-right: the
two gradients agree only for S == T (ROADMAP queue 3 note b). The kernel masks ragged S and T itself,
so nothing is padded."""
from __future__ import annotations

import torch

from ..common import count_launch
from . import kernel as _kernel
from .ref import attention_chunked, flash_attention_torch

# the backward's query chunk: flash_attention_torch's, so each chunk
# recomputes exactly the rows the forward's plain version computes
Q_CHUNK = 512

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


def _backward(q, k, v, g, causal: bool):
    """(dq, dk, dv) of `flash_attention_torch` at (q, k, v) against g,
    differentiated one query chunk at a time in fp32."""
    B, S, H, D = q.shape
    T = k.shape[1]
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s0 in range(0, S, Q_CHUNK):
        s1 = min(s0 + Q_CHUNK, S)
        t1 = min(T, s1) if causal else T    # keys the chunk can see
        with torch.enable_grad():
            qc = q[:, s0:s1].float().requires_grad_()
            kc = kf[:, :t1].detach().requires_grad_()
            vc = vf[:, :t1].detach().requires_grad_()
            out = attention_chunked(qc, kc, vc, causal=causal,
                                    q_chunk=Q_CHUNK, kv_chunk=1024,
                                    q_pos0=s0)
            gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                             g[:, s0:s1].float())
        dq[:, s0:s1] = gq
        dk[:, :t1] += gk
        dv[:, :t1] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_backward(q, k, v, g, ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, T, Hkv, D), one dtype (float32 or
    bfloat16), D a multiple of 16 up to 128, H % Hkv == 0. Returns
    (B, S, H, D) in q's dtype: softmax(q k^T D^-0.5) v per head, query head
    h reading kv head h // (H / Hkv), fp32 online softmax, the causal mask
    aligned top-left (key t visible to query s iff t <= s)."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal))
