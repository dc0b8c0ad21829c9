"""BERT4Rec (Sun et al., arXiv:1904.06690) (port of the reference
`repro/models/bert4rec.py`): a bidirectional transformer over item
interaction sequences, trained on a masked-item loss and scored against
the whole item table or a candidate set.

Plain torch throughout, as the reference is plain jnp: its attention is an
einsum with a key-padding mask (no Pallas kernel), and its lookups are
per-slot gathers of the item table (`table[item_seq]`, candidate rows), not
pooled bags, so no hand-written kernel is on this path. The reference's
sharding hints (`constrain`) sit where it has them, no-ops on one device
(`repro_torch.sharding`), and `param_logical_axes` gives the params'
logical axes. Ids index the table directly, so an id outside it raises
(the reference's `jnp.take` fills such rows).

Behaviour kept from the reference: the tanh GELU, a layer norm over the
population variance with eps 1e-6 and no bias, a sequence that is all
padding gives NaN (every key is masked), and `score_all_items` scores the
padding row, the [MASK] row and the padded vocab rows like any other.
`masked_lm_loss` streams its logsumexp over vocab chunks, as the
reference's `lax.scan` over a `jax.checkpoint`ed body does: the streaming
logsumexp is an `autograd.Function` whose backward recomputes each chunk's
scores, forms exp(scores - logz) and adds that chunk's share of d(rows),
d(table rows) and d(bias), so no more than one chunk's (rows, chunk)
scores is live at a time in either pass."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import constrain, unflatten
from .gnn.common import param_device

__all__ = ["Bert4RecConfig", "encode", "init_params", "masked_lm_loss",
           "param_logical_axes", "score_all_items", "score_candidates"]


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: Optional[int] = None          # default 4*d
    dropout: float = 0.0                # kept for config parity (eval mode)
    compute_dtype: object = torch.float32

    @property
    def vocab(self) -> int:
        """Item ids are 1..n_items; 0 is padding, n_items + 1 [MASK]."""
        return self.n_items + 2

    @property
    def padded_vocab(self) -> int:
        """Table rows rounded up to a multiple of 256, as the reference
        pads them."""
        return -(-self.vocab // 256) * 256

    @property
    def ff(self) -> int:
        return self.d_ff or 4 * self.embed_dim


def init_params(gen: Optional[torch.Generator], cfg: Bert4RecConfig,
                device=None):
    """fp32 params drawn on `device` (default: the GPU) from `gen`, with the
    reference's scales: projections normal·d^-0.5, w2 normal·ff^-0.5, the
    item and position tables normal·0.02, norm scales 1, biases 0. A torch
    generator gives other numbers than a jax key: tests carry the
    reference's params across with `convert.bert4rec_params_from_arrays`."""
    gen, dev = param_device(gen, device)
    d, ff = cfg.embed_dim, cfg.ff

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def ones(n):
        return torch.ones((n,), device=dev)

    def zeros(n):
        return torch.zeros((n,), device=dev)

    blocks = [{"wq": normal((d, d), d ** -0.5),
               "wk": normal((d, d), d ** -0.5),
               "wv": normal((d, d), d ** -0.5),
               "wo": normal((d, d), d ** -0.5),
               "w1": normal((d, ff), d ** -0.5),
               "w2": normal((ff, d), ff ** -0.5),
               "ln1": ones(d), "ln2": ones(d), "b1": zeros(ff), "b2": zeros(d)}
              for _ in range(cfg.n_blocks)]
    return {"item_embed": normal((cfg.padded_vocab, d), 0.02),
            "pos_embed": normal((cfg.seq_len, d), 0.02),
            "blocks": blocks,
            "out_bias": zeros(cfg.padded_vocab),
            "final_ln": ones(d)}


def param_logical_axes(cfg: Bert4RecConfig):
    """Tree of logical-axis tuples mirroring init_params' structure (the
    reference's)."""
    blk = {
        "wq": ("fsdp", "model"), "wk": ("fsdp", "model"),
        "wv": ("fsdp", "model"), "wo": ("model", "fsdp"),
        "w1": ("fsdp", "model"), "w2": ("model", "fsdp"),
        "ln1": (None,), "ln2": (None,), "b1": ("model",), "b2": (None,),
    }
    return {
        "item_embed": ("table", None),   # PAL-hashed row sharding
        "pos_embed": (None, None),
        "blocks": [dict(blk) for _ in range(cfg.n_blocks)],
        "out_bias": ("table",),
        "final_ln": (None,),
    }


def _ln(x, scale, eps: float = 1e-6):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps) * scale


def encode(params, item_seq: torch.Tensor, cfg: Bert4RecConfig):
    """item_seq: (B, S) int (0 = pad). Returns (B, S, d) representations:
    bidirectional attention with a key-padding mask (no causal mask, no
    decode step)."""
    B, S = item_seq.shape
    d, H = cfg.embed_dim, cfg.n_heads
    dh = d // H
    cdt = cfg.compute_dtype
    pad = item_seq == 0

    # replicate the (row-sharded) table for the lookup, as the reference does
    table = constrain(params["item_embed"], None, None)
    x = F.embedding(item_seq, table).to(cdt)
    x = x + params["pos_embed"][None, :S].to(cdt)
    x = constrain(x, "batch", None, None)
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"].to(cdt))
        q = unflatten(h @ blk["wq"].to(cdt), 2, (H, dh))
        k = unflatten(h @ blk["wk"].to(cdt), 2, (H, dh))
        v = unflatten(h @ blk["wv"].to(cdt), 2, (H, dh))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        s = s.masked_fill(pad[:, None, None, :], -torch.inf)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, d)
        x = x + o @ blk["wo"].to(cdt)
        h = _ln(x, blk["ln2"].to(cdt))
        f = F.gelu(h @ blk["w1"].to(cdt) + blk["b1"].to(cdt),
                   approximate="tanh")
        f = constrain(f, "batch", None, "model")
        x = x + f @ blk["w2"].to(cdt) + blk["b2"].to(cdt)
        x = constrain(x, "batch", None, None)
    return _ln(x, params["final_ln"].to(cdt))


def masked_lm_loss(params, batch, cfg: Bert4RecConfig,
                   vocab_chunk: int = 16384):
    """Masked-item cross-entropy at the masked positions only, with a
    streaming logsumexp over `vocab_chunk` table rows at a time, so the
    (B, S, vocab) logits are never made. Ids at or above `cfg.vocab` (the
    padded rows) score -inf.

    batch: item_seq (B, S) with [MASK] tokens placed; masked_positions
    (B, M) slot indices (0-padded); labels (B, M) the true items at those
    slots, 0 = unused slot."""
    reps = encode(params, batch["item_seq"], cfg)          # (B, S, d)
    pos = batch["masked_positions"].long()
    rows = torch.take_along_dim(reps, pos[..., None], dim=1)  # (B, M, d)
    flat = rows.reshape(-1, rows.shape[-1]).float()        # (R, d)
    lab = batch["labels"].reshape(-1).long()               # (R,)
    valid = lab > 0

    table = params["item_embed"].float()
    bias = params["out_bias"].float()
    gold = (flat * table[lab]).sum(-1) + bias[lab]
    logz = _StreamingLogsumexp.apply(flat, table, bias, cfg.vocab,
                                     vocab_chunk)
    ce = (logz - gold) * valid
    return ce.sum() / torch.clamp_min(valid.sum(), 1)


def _chunk_scores(flat, table, bias, start: int, chunk: int, vocab: int):
    """flat @ table[start:start + chunk].T + bias, the ids at or above
    `vocab` set to -inf: (R, rows of the chunk), fp32."""
    sc = flat @ table[start:start + chunk].T
    sc += bias[start:start + chunk]
    if start + sc.shape[1] > vocab:
        sc[:, max(vocab - start, 0):] = -torch.inf
    return sc


class _StreamingLogsumexp(torch.autograd.Function):
    """logz (R,) of flat @ table.T + bias over the first `vocab` ids, one
    chunk of table rows at a time. The reference zero-pads the table to a
    multiple of the chunk; those rows score -inf and add nothing, so the
    last chunk is cut short here."""

    @staticmethod
    def forward(ctx, flat, table, bias, vocab: int, chunk: int):
        R, dev = flat.shape[0], flat.device
        m = torch.full((R,), -torch.inf, device=dev)
        s = torch.zeros((R,), device=dev)
        for start in range(0, table.shape[0], chunk):
            sc = _chunk_scores(flat, table, bias, start, chunk, vocab)
            m_new = torch.maximum(m, sc.max(-1).values)
            s = s * torch.exp(m - m_new) + sc.sub_(m_new[:, None]).exp_(
                ).sum(-1)
            m = m_new
            del sc
        logz = m + torch.log(torch.clamp_min(s, 1e-30))
        ctx.save_for_backward(flat, table, bias, logz)
        ctx.vocab, ctx.chunk = vocab, chunk
        return logz

    @staticmethod
    def backward(ctx, g):
        flat, table, bias, logz = ctx.saved_tensors
        d_flat = torch.zeros_like(flat)
        d_table = torch.zeros_like(table)
        d_bias = torch.zeros_like(bias)
        for start in range(0, table.shape[0], ctx.chunk):
            p = _chunk_scores(flat, table, bias, start, ctx.chunk, ctx.vocab)
            # d logz / d score = softmax = exp(score - logz)
            p.sub_(logz[:, None]).exp_().mul_(g[:, None])
            stop = start + p.shape[1]
            d_flat.addmm_(p, table[start:stop])
            torch.mm(p.T, flat, out=d_table[start:stop])
            torch.sum(p, 0, out=d_bias[start:stop])
            del p
        return d_flat, d_table, d_bias, None, None


def score_all_items(params, item_seq: torch.Tensor, cfg: Bert4RecConfig):
    """Next-item scores over the full table from the last position:
    (B, padded_vocab), the bias added in the product's epilogue."""
    last = encode(params, item_seq, cfg)[:, -1]
    table = params["item_embed"].to(last.dtype)
    return constrain(torch.addmm(params["out_bias"].to(last.dtype), last,
                                 table.T), "batch", "table")


def score_candidates(params, item_seq: torch.Tensor,
                     candidate_ids: torch.Tensor, cfg: Bert4RecConfig):
    """retrieval_cand: score the queries against a candidate set, one
    gather of table rows and one product. item_seq: (B, S);
    candidate_ids: (n_cand,). Returns (B, n_cand)."""
    last = encode(params, item_seq, cfg)[:, -1]            # (B, d)
    ids = candidate_ids.long()
    cand = params["item_embed"][ids].to(last.dtype)        # (n_cand, d)
    bias = params["out_bias"][ids].to(last.dtype)
    return torch.addmm(bias, last, cand.T)
