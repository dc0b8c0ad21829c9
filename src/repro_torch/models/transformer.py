"""Decoder-only transformer (port of the reference
`repro/models/transformer.py`): dense and MoE layers, GQA/MQA, qk-norm,
RoPE, KV-cache decode.

The reference's functional API and parameter layout are kept: params are a
dict of tensors whose layer leaves carry a leading `n_layers` axis, so
`repro_torch.convert` maps the reference's pytree key for key. `lax.scan`
over layers is a Python loop. The reference's sharding hints (`constrain`)
sit where it has them: on one device they return their input, on a mesh
they redistribute a DTensor (`repro_torch.sharding`);
`param_logical_axes` gives the params' logical axes, leaf for leaf.

Prefill and training attention (no KV cache) goes through
`kernels.flash_attention.flash_attention`: the hand-written kernel for CUDA
tensors, its plain version for CPU tensors. That kernel computes what the
reference's prefill path computes with `blockwise_attention` (top-left
causal mask, scale D^-0.5, fp32 online softmax, output in the q dtype).
Decode attends over the cache in plain torch, as the reference does
outside any Pallas kernel; the cache is updated in place.

The reference's cast points are kept: the norm variance, the RoPE angles
and the attention scores in fp32, each weight cast to the compute dtype at
its product. `cast_params` casts the whole tree once, which gives the same
values, because each cast is deterministic.

MoE (`moe_mlp`, `_moe_core`) is the reference's sort-based GShard dispatch
by data-parallel group: the B·S tokens split into dp groups, dp the
product of the active mesh's `pod` and `data` sizes (1 with no mesh or
when it does not divide B), each group routed, capped and combined on its
own, on the rank that holds it (`route_groups`). The router runs in
`router_dtype` (fp32, TF32 off as torch's matmul default), top-k over its
softmax, a stable argsort of the chosen experts, each token's position in
its expert's run by a left `searchsorted`; pairs past the capacity go to a
spare slot that is sliced off, and empty slots gather the group's token 0
with gate 0, so the expert FFN runs on it there and its output is
multiplied by 0. The expert products are batched matmuls in the compute
dtype over all groups' slots, outside any hand-written kernel as in the
reference. The combine is a token-major sum within each group: each token
adds its own slots in ascending slot order, starting from 0, and a group's
token 0 adds its empty slots' zero-gated rows too; that is the order of the
reference's `segment_sum` on its CPU, and it is deterministic on the card,
where `index_add_` would add with atomics in an order that varies run to
run. Sequences longer than 2,048 tokens, and a multiple of it, are routed
in chunks of 2,048, each with its own capacity, as the reference does.

Training: `loss_fn` is the reference's mean next-token cross-entropy in
fp32 plus the summed MoE balance loss, the padded vocab rows masked to
-1e30. While grad is enabled each layer runs under `_remat`, the
reference's `jax.checkpoint` policy as `torch.utils.checkpoint`: "full"
recomputes the whole layer in the backward, "dots" saves the outputs of
the matrix products (mm, bmm, addmm: what `checkpoint_dots` saves) and
recomputes the rest, "none" saves everything. Under `no_grad` (serving)
nothing is checkpointed. The layers' views are taken with one `unbind` of
each stacked leaf a forward, so the backward stacks each leaf's layer
gradients once instead of zero-filling an (n_layers, ...) gradient for
every layer's `select`."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.multihop import _resolve_device
from ..kernels.flash_attention import attention_chunked, flash_attention
from ..sharding import constrain, current_rules, unflatten

__all__ = [
    "MoEConfig",
    "TransformerConfig",
    "attention",
    "blockwise_attention",
    "cached_attention",
    "cast_params",
    "decode_step",
    "dense_mlp",
    "expert_ffn",
    "forward",
    "init_cache",
    "init_params",
    "label_logits",
    "layer_fn",
    "loss_fn",
    "moe_capacity",
    "moe_groups",
    "moe_mlp",
    "param_logical_axes",
    "prefill",
    "qkv",
    "rms_norm",
    "rope",
    "route_groups",
    "route_tokens",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    router_dtype: Any = torch.float32
    ep_mode: str = "expert"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None            # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "dots"                     # none | full | dots (training)
    q_chunk: int = 512
    kv_chunk: int = 1024
    norm_eps: float = 1e-6
    # Kept from the reference, where it selects nothing either: prefill
    # attention always takes kernels.flash_attention here.
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as the reference pads it."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_params(self) -> int:
        """Total parameter count (the reference's formula)."""
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (h * dh) * 2 + d * (kv * dh) * 2  # wq,wo + wk,wv
        if self.moe is None:
            mlp = 3 * d * self.d_ff
        else:
            mlp = self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        per_layer = attn + mlp + 2 * d + (2 * dh if self.qk_norm else 0)
        return self.n_layers * per_layer + 2 * self.padded_vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        dense = self.n_params - self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        return dense + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff_expert


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, d_head); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs        # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def blockwise_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
                        q_pos0: int = 0, scale: Optional[float] = None):
    """Flash-style attention in plain torch: O(S·chunk) memory, exact
    softmax, GQA by head grouping. q: (B, S, H, Dh); k, v: (B, T, Hkv, Dh).
    One implementation with the kernel's plain version
    (`kernels.flash_attention.attention_chunked`); chunks need not divide
    S and T."""
    return attention_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, q_pos0=q_pos0, scale=scale)


def qkv(params, x, cfg: TransformerConfig, positions):
    """The attention inputs: q (B, S, H, Dh), k and v (B, S, Hkv, Dh), in
    the compute dtype, qk-normed and rotated as the reference does."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    q = unflatten(x @ params["wq"].to(cdt), 2, (H, Dh))
    k = unflatten(x @ params["wk"].to(cdt), 2, (Hkv, Dh))
    v = unflatten(x @ params["wv"].to(cdt), 2, (Hkv, Dh))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"].to(cdt), cfg.norm_eps)
        k = rms_norm(k, params["k_norm"].to(cdt), cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                     cfg.rope_theta), v


def attention(params, x, cfg: TransformerConfig, positions, kv_cache=None,
              cache_pos: Optional[int] = None):
    """Self-attention. Train/prefill when kv_cache is None; decode otherwise,
    where kv_cache is one layer's (k, v) cache views (B, T, Hkv, Dh), written
    in place at cache_pos.

    Returns (out, new_kv) where new_kv is (k, v) for cache construction."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    q, k, v = qkv(params, x, cfg, positions)
    q = constrain(q, "batch", None, "model", None)
    k = constrain(k, "batch", None, None, None)
    if kv_cache is None:
        out = flash_attention(q, k, v, causal=True)
        new_kv = (k, v)
    else:
        ck, cv = kv_cache
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        out = cached_attention(q, ck, cv, cache_pos).to(cdt)
        new_kv = (ck, cv)
    out = constrain(out, "batch", None, "model", None)
    y = out.reshape(B, S, H * Dh) @ params["wo"].to(cdt)
    return y, new_kv


def cached_attention(q, ck, cv, cache_pos: int) -> torch.Tensor:
    """Decode attention of q (B, S, H, Dh) over a cache (B, T, Hkv, Dh),
    query s at position cache_pos + s seeing cache slots 0 ... that
    position. fp32 scores and output."""
    B, S, H, Dh = q.shape
    T, Hkv = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     ck.float()) * (Dh ** -0.5)
    # causal within the new tokens + all previous cache entries
    kv_idx = torch.arange(T, device=q.device)
    qpos = cache_pos + torch.arange(S, device=q.device)
    mask = kv_idx[None, :] <= qpos[:, None]             # (S, T)
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
    return out.reshape(B, S, H, Dh)


def dense_mlp(params, x, cfg: TransformerConfig):
    cdt = cfg.compute_dtype
    g = constrain(x @ params["w_gate"].to(cdt), "batch", None, "model")
    u = constrain(x @ params["w_up"].to(cdt), "batch", None, "model")
    return (F.silu(g) * u) @ params["w_down"].to(cdt)


MOE_SEQ_CHUNK = 2048


def moe_mlp(params, x, cfg: TransformerConfig):
    """Sort-based capacity MoE dispatch (GShard). x: (B, S, d) in the
    compute dtype. Returns (out (B, S, d), aux: the balance loss, fp32).

    A sequence longer than 2,048 tokens and a multiple of it is routed in
    chunks of 2,048 (all B rows of a chunk together, each chunk with its own
    capacity), and aux is the mean over the chunks, as the reference's
    scan does. Each chunk's tokens are routed by data-parallel group
    (`_moe_core`)."""
    B, S, d = x.shape
    if S > MOE_SEQ_CHUNK and S % MOE_SEQ_CHUNK == 0:
        outs, auxes = [], []
        for c in range(0, S, MOE_SEQ_CHUNK):
            o, a = _moe_core(params, x[:, c:c + MOE_SEQ_CHUNK], cfg)
            outs.append(o)
            auxes.append(a)
        return torch.cat(outs, 1), torch.stack(auxes).mean()
    return _moe_core(params, x, cfg)


def moe_capacity(mo: MoEConfig, tokens: int) -> int:
    """Slots per expert for `tokens` routed together: the reference's
    Python truncation of cf·t·K/E + 0.5, then at least 8 and a multiple
    of 8."""
    cap = int(mo.capacity_factor * tokens * mo.top_k / mo.n_experts + 0.5)
    return max(8, -(-cap // 8) * 8)


def moe_groups(batch: int) -> int:
    """The reference's routing groups: the product of the active mesh's
    `pod` and `data` sizes, or 1 with no mesh or when it does not divide
    the batch."""
    mesh = current_rules().mesh
    dp = 1
    if mesh is not None:
        names = list(mesh.mesh_dim_names)
        for ax in ("pod", "data"):
            if ax in names:
                dp *= mesh.size(names.index(ax))
    return dp if batch % dp == 0 else 1


def route_tokens(router: torch.Tensor, xg: torch.Tensor, mo: MoEConfig):
    """The router: xg (..., d) -> (probs (..., E), gates (..., K)
    renormalised, idx (..., K) the experts, best first), all in
    `mo.router_dtype`."""
    rdt = mo.router_dtype
    probs = torch.softmax(xg.to(rdt) @ router.to(rdt), dim=-1)
    gates, idx = torch.topk(probs, mo.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def route_groups(router: torch.Tensor, xt: torch.Tensor, mo: MoEConfig,
                 cap: int):
    """Route each group of xt (G, tg, d) on its own into (E, cap) slots.
    Returns (idx (G, tg, K) the experts, tfs (G, E·cap) each slot's token
    in its group, slots (G, tg, K) each token's slots ascending, gates
    (G, tg, K) theirs, counts (G, E) each expert's pairs, me (G, E) the
    mean router probabilities, ce (G, E) the chosen share)."""
    G, tg, _ = xt.shape
    E, K = mo.n_experts, mo.top_k
    dev = xt.device
    probs, gates, idx = route_tokens(router, xt, mo)
    expert_of = idx.reshape(G, tg * K)
    order = torch.argsort(expert_of, dim=-1, stable=True)
    sorted_e = expert_of.gather(1, order)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E + 1, device=dev).expand(G, E + 1)
        .contiguous())
    counts = seg_start[:, 1:] - seg_start[:, :-1]
    ce = counts.to(probs.dtype) / (tg * K)

    pos_in_e = torch.arange(tg * K, device=dev) - seg_start.gather(1,
                                                                   sorted_e)
    ok = pos_in_e < cap
    slot = torch.where(ok, sorted_e * cap + pos_in_e, E * cap)
    # invert slot -> token; every dropped pair lands on its group's spare
    # slot E·cap
    tfs = order.new_zeros(G, E * cap + 1).scatter_(1, slot, order // K)
    slots = order.new_empty(G, tg * K).scatter_(1, order, slot)
    slots, by_slot = slots.reshape(G, tg, K).sort(dim=-1)
    return (idx, tfs[:, :E * cap], slots, gates.gather(-1, by_slot), counts,
            probs.mean(1), ce)


def expert_ffn(params, ein: torch.Tensor, cdt) -> torch.Tensor:
    """Every expert's SwiGLU FFN on its slots: ein (E, cap, d) -> (E, cap,
    d), each weight cast to `cdt` at its product."""
    g = torch.bmm(ein, params["w_gate"].to(cdt))
    u = torch.bmm(ein, params["w_up"].to(cdt))
    return torch.bmm(F.silu(g) * u, params["w_down"].to(cdt))


def _by_rank(fn, n_out: int, rows, shared=()):
    """fn(*rows, *shared) on this rank's share of the routing groups.
    Plain tensors: fn itself. DTensors: `local_map`, every `rows` tensor
    and output with the first one's placements (its dim 0 the groups, so
    a rank routes its own, with no collective), each `shared` tensor
    replicated in and its gradient summed over the ranks that split the
    groups."""
    from torch.distributed.tensor import DTensor
    if not isinstance(rows[0], DTensor):
        return fn(*rows, *shared)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(rows[0].placements)
    rep = (Replicate(),) * len(pl)
    summed = tuple(Partial() if p.is_shard(0) else Replicate() for p in pl)
    return local_map(
        fn, out_placements=(pl,) * n_out,
        in_placements=(pl,) * len(rows) + (rep,) * len(shared),
        in_grad_placements=(pl,) * len(rows) + (summed,) * len(shared),
        redistribute_inputs=True)(*rows, *shared)


def _moe_core(params, x, cfg: TransformerConfig,
              groups: Optional[int] = None):
    """The reference's local-capacity dispatch: the B·S tokens in `groups`
    groups of B·S / groups (None: `moe_groups(B)`, the mesh's), each routed,
    capped at moe_capacity(tg) and combined on its own, then the expert
    FFN over all groups at once. On a mesh each rank routes and combines
    its own groups (`_by_rank`); one group is the plain GShard dispatch."""
    mo = cfg.moe
    B, S, d = x.shape
    E, K = mo.n_experts, mo.top_k
    cdt = cfg.compute_dtype
    dp = moe_groups(B) if groups is None else groups
    if B % dp:
        raise ValueError(f"{dp} routing groups do not split a batch of {B}")
    tg = B * S // dp
    cap = moe_capacity(mo, tg)
    x = constrain(x, "batch", None, None)

    def route(x_loc, router):
        xt = x_loc.reshape(-1, tg, d)                 # this rank's groups
        idx, tfs, slots, gates, counts, me, ce = route_groups(router, xt,
                                                              mo, cap)
        base = torch.arange(xt.shape[0], device=xt.device)[:, None] * tg
        ein = xt.to(cdt).reshape(-1, d)[tfs + base]
        return ein.reshape(-1, E, cap, d), slots, gates, counts, me, ce

    ein, slots, gates, counts, me, ce = _by_rank(route, 6, (x,),
                                                 (params["router"],))
    aux = mo.aux_coef * E * torch.sum(me.mean(0) * ce.mean(0))
    exp_ax = "experts" if mo.ep_mode == "expert" else None
    ein = constrain(ein, "batch", exp_ax, None, None)     # (dp, E, cap, d)
    # the groups' slots of an expert side by side: one product an expert
    eout = expert_ffn(params, ein.transpose(0, 1).reshape(E, dp * cap, d),
                      cdt)
    eout = constrain(eout.reshape(E, dp, cap, d).transpose(0, 1), "batch",
                     exp_ax, None, None)

    def combine(slots, gates, counts, eout):
        # each token's slots in ascending slot order, each row times its
        # pair's gate; a dropped pair (slot E·cap, which sorts last) adds 0
        G = eout.shape[0]
        dropped = slots == E * cap
        base = torch.arange(G, device=eout.device)[:, None, None] * (E * cap)
        rows_of = (slots.clamp(max=E * cap - 1) + base).reshape(G * tg, K)
        dropped = dropped.reshape(G * tg, K)
        gates = gates.to(cdt).reshape(G * tg, K)
        flat = eout.reshape(G * E * cap, d)
        out = flat.new_zeros((G * tg, d))
        for j in range(K):
            rows = flat[rows_of[:, j]] * gates[:, j, None]
            out = out + rows.masked_fill_(dropped[:, j, None], 0)
        # a group's empty slots' zero-gated rows belong to its token 0: 0,
        # or NaN when an expert with an empty slot (its last one is then
        # empty) gave a non-finite FFN of that token
        out = out.reshape(G, tg, d)
        last = eout[:, :, -1] * 0                             # (G, E, d)
        out[:, 0] = out[:, 0] + torch.where((counts < cap)[..., None], last,
                                            0).sum(1)
        return out.reshape(-1, S, d)

    out = _by_rank(combine, 1, (slots, gates, counts, eout))
    return constrain(out, "batch", None, None), aux


def layer_fn(params, x, cfg: TransformerConfig, positions, kv_cache=None,
             cache_pos: Optional[int] = None):
    """One layer; returns (x, new_kv, aux) as the reference does (aux, the
    MoE balance loss, is 0.0 for a dense layer)."""
    cdt = cfg.compute_dtype
    h = rms_norm(x, params["ln1"].to(cdt), cfg.norm_eps)
    a, new_kv = attention(params["attn"], h, cfg, positions, kv_cache,
                          cache_pos)
    # a DTensor keeps the output product's partial sums lazily, where XLA
    # reduces them at the product: reduce them here, not in every later op
    x = constrain(x + a, "batch", None, None)
    h = rms_norm(x, params["ln2"].to(cdt), cfg.norm_eps)
    if cfg.moe is None:
        m, aux = dense_mlp(params["mlp"], h, cfg), 0.0
    else:
        m, aux = moe_mlp(params["mlp"], h, cfg)
    return constrain(x + m, "batch", None, None), new_kv, aux


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {
        "wq": (d, H * Dh), "wk": (d, Hkv * Dh), "wv": (d, Hkv * Dh),
        "wo": (H * Dh, d),
    }
    if cfg.qk_norm:
        attn["q_norm"] = (Dh,)
        attn["k_norm"] = (Dh,)
    if cfg.moe is None:
        mlp = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
               "w_down": (cfg.d_ff, d)}
    else:
        E, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        mlp = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
               "w_down": (E, f, d)}
    return {"attn": attn, "mlp": mlp, "ln1": (d,), "ln2": (d,)}


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Stacked-layer params drawn on `device` (default: the GPU) from
    `generator` (default: seeded 0 on that device), with the reference's
    scales: matrices normal·fan_in^-0.5, norm scales 1, embed normal·0.02,
    lm_head normal·d^-0.5. A torch generator gives other numbers than a
    jax key: tests carry the reference's params across with `convert`."""
    dev = _resolve_device(device, "the model")
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    dt = cfg.param_dtype

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=dev).mul_(std)

    def init_tree(tree):
        out = {}
        for name, shp in tree.items():
            if isinstance(shp, dict):
                out[name] = init_tree(shp)
            elif len(shp) == 1:                      # norm scales
                out[name] = torch.ones((cfg.n_layers, *shp), dtype=dt,
                                       device=dev)
            else:
                out[name] = normal((cfg.n_layers, *shp), shp[-2] ** -0.5)
        return out

    d = cfg.d_model
    return {
        "embed": normal((cfg.padded_vocab, d), 0.02),
        "layers": init_tree(_layer_shapes(cfg)),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": normal((cfg.padded_vocab, d), d ** -0.5),
    }


def param_logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Tree of logical-axis tuples mirroring init_params' structure (the
    reference's, leaf for leaf; the stacked layer axis leads, unsharded)."""
    attn = {
        "wq": ("fsdp", "model"), "wk": ("fsdp", "model"),
        "wv": ("fsdp", "model"), "wo": ("model", "fsdp"),
    }
    if cfg.qk_norm:
        attn["q_norm"] = (None,)
        attn["k_norm"] = (None,)
    if cfg.moe is None:
        mlp = {"w_gate": ("fsdp", "model"), "w_up": ("fsdp", "model"),
               "w_down": ("model", "fsdp")}
    elif cfg.moe.ep_mode == "ffn":
        mlp = {"router": ("fsdp", None), "w_gate": (None, "fsdp", "model"),
               "w_up": (None, "fsdp", "model"),
               "w_down": (None, "model", "fsdp")}
    else:
        mlp = {"router": ("fsdp", None), "w_gate": ("experts", "fsdp", None),
               "w_up": ("experts", "fsdp", None),
               "w_down": ("experts", None, "fsdp")}
    layer = {"attn": attn, "mlp": mlp, "ln1": (None,), "ln2": (None,)}
    return {
        "embed": ("model", "fsdp"),
        "layers": _map(layer, lambda ax: (None, *ax)),
        "final_norm": (None,),
        "lm_head": ("model", "fsdp"),
    }


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def cast_params(params, cfg: TransformerConfig):
    """Every leaf in the compute dtype: the values each product's cast
    would give, made once (a serving copy; the fp32 tree stays as it is)."""
    return _map(params, lambda t: t.to(cfg.compute_dtype))


def _layers(layers, n_layers: int) -> List[Dict[str, Any]]:
    """Each layer's params as views of the stacked leaves, one `unbind` a
    leaf, so autograd stacks the layers' gradients once."""
    views = _map(layers, lambda t: t.unbind(0))
    return [_map(views, lambda t: t[i]) for i in range(n_layers)]


# the ops whose outputs "dots" saves: the matrix products
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: TransformerConfig):
    """fn under the config's checkpoint policy while grad is enabled; fn
    itself under `no_grad` or with remat "none"."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: none | full | dots")
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


# ---------------------------------------------------------------------------
# Forward / decode
# ---------------------------------------------------------------------------
def _embed(params, tokens, cfg: TransformerConfig):
    return params["embed"][tokens].to(cfg.compute_dtype)


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens: (B, S) -> (logits (B, S, vocab) in compute dtype, aux): aux
    is the reference's summed MoE loss, a float32 0 for dense layers."""
    B, S = tokens.shape
    cdt = cfg.compute_dtype
    x = constrain(_embed(params, tokens, cfg), "batch", None, None)
    positions = torch.arange(S, device=x.device).expand(B, S)

    def body(x, lp):
        x, _, a = layer_fn(lp, x, cfg, positions)
        return x, a

    body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params["layers"], cfg.n_layers):
        x, a = body(x, lp)
        aux = aux + a
    x = rms_norm(x, params["final_norm"].to(cdt), cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, params["lm_head"].to(cdt))
    return constrain(logits, "batch", None, "model"), aux


def loss_fn(params, batch, cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32 (+ the MoE aux). batch:
    tokens (B, S) and labels (B, S), integer tensors on the params'
    device."""
    logits, aux = forward(params, batch["tokens"], cfg)
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:      # mask padded vocab rows
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = label_logits(logits, batch["labels"])
    return (logz - gold).mean() + aux


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit of its label: (..., V), (...) -> (...)."""
    return logits.gather(-1, labels.long()[..., None])[..., 0]


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = _resolve_device(device, "the model")
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_seq: int, cache_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt, return (logits_last (B, vocab), cache)."""
    B, S = tokens.shape
    cdt = cfg.compute_dtype
    cache = init_cache(cfg, B, max_seq, dtype=cache_dtype,
                       device=tokens.device)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        x, (k, v), _ = layer_fn(lp, x, cfg, positions)
        cache["k"][i, :, :S] = k.to(cache_dtype)
        cache["v"][i, :, :S] = v.to(cache_dtype)
    # the norm is per token: the last token's alone is the same values
    x = rms_norm(x[:, -1], params["final_norm"].to(cdt), cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", x, params["lm_head"].to(cdt))
    return logits, cache


def decode_step(params, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, cfg: TransformerConfig):
    """One decode step. tokens: (B, 1) int; pos: the cache position.
    Returns (logits (B, vocab), cache), the cache updated in place."""
    B, S = tokens.shape
    cdt = cfg.compute_dtype
    x = _embed(params, tokens, cfg)
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        x, _, _ = layer_fn(lp, x, cfg, positions,
                           kv_cache=(cache["k"][i], cache["v"][i]),
                           cache_pos=pos)
    x = rms_norm(x[:, -1], params["final_norm"].to(cdt), cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", x, params["lm_head"].to(cdt))
    return constrain(logits, "batch", "model"), cache
