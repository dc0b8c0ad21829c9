"""Plain torch versions of the flash-attention kernel (the reference oracle
is `repro/kernels/flash_attention/ref.py::attention_ref`).

`attention_chunked` is the one plain implementation of chunked attention
with an fp32 online softmax: the model's `blockwise_attention` and the
kernel's plain version `flash_attention_torch` both call it. Its causal
mask is aligned top-left (key t is visible to query q_pos0 + s iff
t <= q_pos0 + s), as the Pallas kernel and the reference's
`blockwise_attention` align it. Chunks need not divide S or T.

`attention_ref` ports the reference oracle, whose causal mask is aligned
bottom-right (`tril(k=T-S)`): the two agree only for S == T (ROADMAP
queue 3 note b). The tests hold the port against it; the wrapper's
backward recomputes through `flash_attention_torch`, the forward's own
function."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_chunked", "attention_ref", "flash_attention_torch"]


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_chunk: int, kv_chunk: int,
                      q_pos0: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, T, Hkv, D), H % Hkv == 0 (query head h
    reads kv head h // G). Exact softmax attention, computed in fp32 over
    q_chunk x kv_chunk score blocks; returns (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    for s0 in range(0, S, q_chunk):
        qc = min(q_chunk, S - s0)
        qb = q[:, s0:s0 + qc].float().reshape(B, qc, Hkv, G, D)
        q_idx = q_pos0 + s0 + torch.arange(qc, device=dev)
        m = torch.full((B, Hkv, G, qc), -torch.inf, device=dev)
        num = torch.zeros((B, Hkv, G, qc, D), device=dev)
        den = torch.zeros((B, Hkv, G, qc), device=dev)
        for t0 in range(0, T, kv_chunk):
            kc = min(kv_chunk, T - t0)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb,
                             kf[:, t0:t0 + kc]) * scale
            if causal:
                kv_idx = t0 + torch.arange(kc, device=dev)
                s = torch.where(q_idx[:, None] >= kv_idx[None, :], s,
                                -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            num = num * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, t0:t0 + kc])
            den = den * corr + p.sum(-1)
            m = m_new
        o = num / torch.clamp_min(den[..., None], 1e-30)    # (B,Hkv,G,qc,D)
        out[:, s0:s0 + qc] = o.permute(0, 3, 1, 2, 4).reshape(
            B, qc, H, D).to(q.dtype)
    return out


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain torch: top-left causal or full GQA
    attention, fp32 online softmax, scale D^-0.5, out in q's dtype. Chunks
    of 512 queries x 1,024 keys bound the fp32 scores (256 MiB at B = 4,
    H = 32)."""
    return attention_chunked(q, k, v, causal=causal, q_chunk=512,
                             kv_chunk=1024)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, T, Hkv, D); H % Hkv == 0. Exact softmax
    attention in fp32, the causal mask aligned bottom-right."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool,
                          device=q.device).tril(T - S)
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)
