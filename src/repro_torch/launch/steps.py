"""Per-family step builders (port of the reference `repro/launch/steps.py`):
(arch × shape) cell → a step function + its inputs' shapes, dtypes and
placements.

This is the glue the dry-run, the card's cell runs and the tests share.
Every cell runs a COMPLETE step: train cells include loss, backward, and
the AdamW update; serve cells include the full request path (e.g. chunked
top-k over the item table, not just logits).

`CellPlan.args` are meta tensors of the cell's shapes and dtypes (the
torch counterpart of the reference's `ShapeDtypeStruct`s), meta DTensors
placed by the rules when the rules hold a mesh. `materialize(plan,
device, generator)` makes real inputs on a device: params from the
model's `init_params`, AdamW state from `adamw_init`, and batches of valid
ids, masks and features.

The step logic is the reference's: the LM train step's accumulation count
(`lm_grad_accum`), the bf16 cast of every ≥2-D param before the loss (a
differentiable cast; gradients come back in fp32), the fp32 gradient sum
over microbatches divided by their count, then `adamw_update` (in place,
as the port's AdamW is); bert4rec's train step with 8 microbatches from B
= 16,384 and vocab chunks of 8,192; its serve step in request chunks of
16,384, vocab chunks of 65,536 and a running top-100 whose tie order is
`jax.lax.top_k`'s (the lower id first); the retrieval step; the prefill
and decode cells with the cache layout (layers, B, T, Hkv, Dh). The GNN
cells adapt the config and pad the batch as the reference does.

Microbatches are a Python loop: eager autograd frees each microbatch's
graph once its gradient is taken, so the reference's `jax.checkpoint` of
the microbatch body has no counterpart. Without a mesh microbatch i is
rows i·B/accum ... of the batch, the reference's reshape; on a mesh it is
the i-th part of every data-parallel shard's rows (a local view of the
DTensor, no collective), which keeps every microbatch spread over every
shard as the reference's count rule intends. The batched GNN cell's
`vmap` over graphs is a loop over them. `pos` of the decode cell is a
Python int (the cache slot written), S - 1 in the plan's args.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ArchSpec, ShapeCell
from ..models import bert4rec, transformer
from ..models.gnn import equiformer_v2, gin, meshgraphnet, pna
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..sharding import ShardingRules

__all__ = ["CACHE_AXES", "CellPlan", "build_cell", "lm_grad_accum",
           "materialize", "topk_stable"]


@dataclasses.dataclass
class CellPlan:
    fn: Callable
    args: Tuple[Any, ...]
    out_shardings: Any
    rules: ShardingRules
    meta: Dict[str, Any]
    fill: Callable = None       # (device, generator) -> real args


def materialize(plan: CellPlan, device, generator: Optional[torch.Generator]
                = None) -> Tuple[Any, ...]:
    """Real inputs of the plan's shapes and dtypes on `device`, drawn from
    `generator` (default: a CPU generator seeded 0)."""
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(0)
    return plan.fill(torch.device(device), generator)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _meta(shape, dtype, rules: ShardingRules, axes=None):
    """A meta tensor of `shape`, a meta DTensor placed by `axes` when the
    rules hold a mesh (replicated for axes None)."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    if rules.mesh is None:
        return t
    from torch.distributed.tensor import Replicate, distribute_tensor
    pl = (rules.placements(*axes) if axes is not None
          else (Replicate(),) * rules.mesh.ndim)
    return distribute_tensor(t, rules.mesh, pl, src_data_rank=None)


def _meta_tree(tree, rules: ShardingRules, axes_tree=None):
    """Each leaf of a (meta) tensor tree as `_meta`, with its axes."""
    leaves, spec = pytree.tree_flatten(tree)
    axes = ([None] * len(leaves) if axes_tree is None
            else pytree.tree_flatten(axes_tree, is_leaf=_is_axes)[0])
    if len(axes) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(axes)} axis tuples")
    return pytree.tree_unflatten(
        [_meta(t.shape, t.dtype, rules, a) for t, a in zip(leaves, axes)],
        spec)


def _opt_meta(params_meta, rules: ShardingRules):
    """AdamW state of meta params: m and v placed as the params, step
    replicated."""
    def f32(p):
        if rules.mesh is None:
            return torch.empty(p.shape, dtype=torch.float32, device="meta")
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(
            torch.empty(p.shape, dtype=torch.float32, device="meta"),
            rules.mesh, p.placements, src_data_rank=None)
    return {"m": pytree.tree_map(f32, params_meta),
            "v": pytree.tree_map(f32, params_meta),
            "step": _meta((), torch.int32, rules)}


def _round_to(n: int, k: int) -> int:
    return -(-n // k) * k


def _dp(mesh) -> int:
    dp = 1
    if mesh is not None:
        names = list(mesh.mesh_dim_names)
        for ax in ("pod", "data"):
            if ax in names:
                dp *= mesh.shape[names.index(ax)]
    return dp


def _micro(x: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Microbatch i of `accum` along dim 0 (module docstring)."""
    if accum == 1:
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        loc = x.to_local()
        mb = loc.shape[0] // accum
        return DTensor.from_local(loc[i * mb:(i + 1) * mb], x.device_mesh,
                                  x.placements, run_check=False)
    mb = x.shape[0] // accum
    return x[i * mb:(i + 1) * mb]


def _accumulated_step(params, opt, batch, accum: int, loss_of,
                      opt_cfg: AdamWConfig, cast=None):
    """The reference's microbatch scan: the fp32 sum of each microbatch's
    gradient (of `loss_of(params, microbatch)`, params cast by `cast`
    first), divided by `accum`, then AdamW; the loss is the mean of the
    microbatches' losses."""
    leaves, spec = pytree.tree_flatten(params)
    loss_sum, grads = 0.0, None
    for i in range(accum):
        mb = {k: _micro(v, i, accum) for k, v in batch.items()}
        live = [p.detach().requires_grad_() for p in leaves]
        tree = pytree.tree_unflatten(
            [cast(p) for p in live] if cast is not None else live, spec)
        loss = loss_of(tree, mb)
        g = torch.autograd.grad(loss, live)
        del live, tree
        if grads is None:
            grads = list(g)
        else:
            for a, b in zip(grads, g):
                a.add_(b)
        del g
        loss_sum = loss_sum + loss.detach()
    if accum > 1:
        for g in grads:
            g.div_(accum)
    params, opt, metrics = adamw_update(pytree.tree_unflatten(grads, spec),
                                        opt, params, opt_cfg)
    return params, opt, {"loss": loss_sum / accum, **metrics}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def lm_grad_accum(cfg, batch: int, seq: int, mesh=None) -> int:
    """Microbatch count of an LM train step: per-device live activations
    (L × d_model × 2 bytes of bf16 residual a token, scan + remat) under
    ~5 GB (2.5 GB for MoE, whose dispatch buffers scale with the
    microbatch too), while each microbatch still spans every DP shard.
    `mesh`: anything with `mesh_dim_names` and `shape` (a DeviceMesh), or
    None for one device."""
    dp = _dp(mesh)
    tokens_per_dev = batch * seq // dp
    act_bytes = tokens_per_dev * cfg.n_layers * cfg.d_model * 2
    budget = 2_500_000_000 if cfg.moe is not None else 5_000_000_000
    need = max(1, -(-act_bytes // budget))
    accum = 1
    while accum < need and (batch // (accum * 2)) >= dp:
        accum *= 2
    return accum


# the KV cache (layers, B, T, Hkv, Dh): batch over data, slots over model
CACHE_AXES = (None, "batch", "model", None, None)


def _tokens(gen, shape, vocab: int, device):
    return torch.randint(0, vocab, shape, generator=gen,
                         dtype=torch.int32).to(device)


def _lm_cell(spec: ArchSpec, cell: ShapeCell, rules: ShardingRules) -> CellPlan:
    cfg = spec.config
    B, S = cell.dims["batch"], cell.dims["seq"]
    if cell.kind in ("prefill", "decode"):
        # inference has no optimizer state: replicate params over the data
        # axis (TP-only sharding) so serving never re-gathers them
        rules = ShardingRules(rules={**rules.rules, "fsdp": None},
                              mesh=rules.mesh)
    axes = transformer.param_logical_axes(cfg)
    params_meta = _meta_tree(
        transformer.init_params(cfg, torch.Generator(), device="meta"),
        rules, axes)
    param_sh = pytree.tree_map(lambda ax: rules.sharding(*ax), axes,
                               is_leaf=_is_axes)

    def params_of(dev, gen):
        return transformer.init_params(cfg, _on(gen, dev), dev)

    if cell.kind == "train":
        opt_cfg = AdamWConfig()
        accum = lm_grad_accum(cfg, B, S, rules.mesh)

        def cast(p):
            # cast params to the compute dtype before the loss (while still
            # sharded on a mesh, so the FSDP gathers move half the bytes)
            return p.to(cfg.compute_dtype) if p.ndim >= 2 else p

        def train_step(params, opt, batch):
            return _accumulated_step(
                params, opt, batch, accum,
                lambda p, mb: transformer.loss_fn(p, mb, cfg), opt_cfg, cast)

        args = (params_meta, _opt_meta(params_meta, rules),
                {"tokens": _meta((B, S), torch.int32, rules, ("batch", None)),
                 "labels": _meta((B, S), torch.int32, rules,
                                 ("batch", None))})

        def fill(dev, gen):
            params = params_of(dev, gen)
            return (params, adamw_init(params),
                    {"tokens": _tokens(gen, (B, S), cfg.vocab_size, dev),
                     "labels": _tokens(gen, (B, S), cfg.vocab_size, dev)})

        return CellPlan(train_step, args,
                        (param_sh, {"m": param_sh, "v": param_sh,
                                    "step": None}, None),
                        rules, {"tokens_per_step": B * S,
                                "grad_accum": accum}, fill)

    cache_sh = rules.sharding(*CACHE_AXES)
    if cell.kind == "prefill":
        def prefill_step(params, tokens):
            return transformer.prefill(params, tokens, cfg, max_seq=S)

        args = (params_meta,
                _meta((B, S), torch.int32, rules, ("batch", None)))

        def fill(dev, gen):
            return (params_of(dev, gen),
                    _tokens(gen, (B, S), cfg.vocab_size, dev))

        return CellPlan(prefill_step, args,
                        (None, {"k": cache_sh, "v": cache_sh}), rules,
                        {"tokens_per_step": B * S}, fill)

    if cell.kind == "decode":
        cshape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)

        def decode(params, cache, tokens, pos):
            return transformer.decode_step(params, cache, tokens, pos, cfg)

        args = (params_meta,
                {"k": _meta(cshape, torch.bfloat16, rules, CACHE_AXES),
                 "v": _meta(cshape, torch.bfloat16, rules, CACHE_AXES)},
                _meta((B, 1), torch.int32, rules, ("batch", None)), S - 1)

        def fill(dev, gen):
            params = params_of(dev, gen)
            dgen = _on(gen, dev)
            cache = {k: torch.randn(cshape, generator=dgen, device=dev,
                                    dtype=torch.bfloat16) * 0.5
                     for k in ("k", "v")}
            return (params, cache,
                    _tokens(gen, (B, 1), cfg.vocab_size, dev), S - 1)

        return CellPlan(decode, args, (None, {"k": cache_sh, "v": cache_sh}),
                        rules, {"tokens_per_step": B}, fill)

    raise ValueError(cell.kind)


def _on(gen: torch.Generator, dev: torch.device) -> torch.Generator:
    """A generator on `dev` seeded from `gen` (init_params draws on the
    device)."""
    if gen.device.type == dev.type:
        return gen
    g = torch.Generator(device=dev)
    g.manual_seed(int(torch.randint(0, 2**62, (1,), generator=gen)))
    return g


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
_GNN_MODULES = {
    "pna": pna, "gin-tu": gin, "equiformer-v2": equiformer_v2,
    "meshgraphnet": meshgraphnet,
}


def _adapt_gnn_config(arch: str, base, dims) -> Any:
    d_feat, n_cls = dims["d_feat"], dims["n_classes"]
    graph_level = dims["task"] == "graph_reg"
    E = dims["n_edges"]
    chunks = 16 if E >= 10_000_000 else (4 if E >= 1_000_000 else 1)
    if arch == "pna":
        return dataclasses.replace(base, d_in=d_feat, n_classes=n_cls,
                                   readout="graph" if graph_level else "node",
                                   edge_chunks=chunks)
    if arch == "gin-tu":
        return dataclasses.replace(base, d_in=d_feat, n_classes=n_cls,
                                   readout="graph" if graph_level else "node",
                                   edge_chunks=chunks)
    if arch == "meshgraphnet":
        return dataclasses.replace(base, d_node_in=d_feat, d_edge_in=4,
                                   d_out=n_cls, edge_chunks=chunks,
                                   remat_blocks=chunks > 1)
    if arch == "equiformer-v2":
        # huge partitions: PSW ring gather + per-layer remat (DESIGN.md §2);
        # remat is ALWAYS on — 12 unrematted layers of per-edge irreps
        # state exceed device memory even on small graphs
        echunks, mode = 1, "take"
        if E >= 10_000_000:
            echunks, mode = 16, "psw_ring"
        elif E >= 100_000:
            echunks, mode = 4, "psw_ring"
        return dataclasses.replace(base, d_out=n_cls, n_species=128,
                                   edge_chunks=echunks, gather_mode=mode,
                                   remat_layers=True)
    raise ValueError(arch)


def _gnn_batch(arch: str, dims, rules: ShardingRules, shards: int):
    """({key: (shape, dtype, logical axes)}, N, E) of one (possibly
    padded/sharded) graph batch."""
    batched = "batch" in dims
    N, E = dims["n_nodes"], dims["n_edges"]
    big = (not batched) and N >= max(shards, 4096)
    node2 = ("nodes", None) if big else None
    node1 = ("nodes",) if big else None
    edge1 = ("edges",) if big else None
    edge2 = ("edges", None) if big else None
    if big:
        # node padding: divisible by the shard count; edge padding: by
        # shards × max chunking (so per-chunk slices stay shardable)
        N = _round_to(N, 512)
        E = _round_to(E, 512 * 16)
    lead = ()
    if batched:
        lead = (dims["batch"],)
        node2, node1 = ("batch", None, None), ("batch", None)
        edge1, edge2 = ("batch", None), ("batch", None, None)

    batch = {
        "src": ((*lead, E), torch.int32, edge1),
        "dst": ((*lead, E), torch.int32, edge1),
        "edge_mask": ((*lead, E), torch.bool, edge1),
        "node_mask": ((*lead, N), torch.bool, node1),
    }
    if arch == "equiformer-v2":
        batch["species"] = ((*lead, N), torch.int32, node1)
        batch["pos"] = ((*lead, N, 3), torch.float32, node2)
    else:
        batch["x"] = ((*lead, N, dims["d_feat"]), torch.float32, node2)
    if arch == "meshgraphnet":
        batch["edge_attr"] = ((*lead, E, 4), torch.float32, edge2)
    if dims["task"] == "graph_reg":
        batch["labels"] = ((dims["batch"],), torch.float32,
                           ("batch",) if batched else None)
    else:
        batch["labels"] = ((*lead, N), torch.int32, node1)
    return batch, N, E


def _gnn_fill(batch_spec, dims, cfg, gen, dev):
    """A valid random batch: edges among the first n_nodes nodes (the rest
    is padding), masks on exactly the real nodes and edges, labels in
    range."""
    n_real, e_real = dims["n_nodes"], dims["n_edges"]
    out = {}
    for k, (shape, dtype, _) in batch_spec.items():
        if k in ("src", "dst"):
            t = torch.randint(0, n_real, shape, generator=gen,
                              dtype=torch.int32)
        elif k == "edge_mask":
            t = (torch.arange(shape[-1]) < e_real).expand(shape).clone()
        elif k == "node_mask":
            t = (torch.arange(shape[-1]) < n_real).expand(shape).clone()
        elif k == "species":
            t = torch.randint(0, cfg.n_species, shape, generator=gen,
                              dtype=torch.int32)
        elif k == "labels" and dtype == torch.int32:
            t = torch.randint(0, dims["n_classes"], shape, generator=gen,
                              dtype=torch.int32)
        elif k == "pos":
            t = torch.rand(shape, generator=gen) * 4.0
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype)
        out[k] = t.to(dev)
    return out


def _gnn_loss(module, cfg, dims):
    graph_level = dims["task"] == "graph_reg"
    batched = "batch" in dims

    def loss_fn(params, batch):
        if batched:
            # the reference's vmap over graphs: a loop
            graphs = {k: v for k, v in batch.items() if k != "labels"}
            out = torch.stack([
                module.forward(params, {k: v[b] for k, v in graphs.items()},
                               cfg)
                for b in range(batch["labels"].shape[0])])
            if graph_level:
                pred = out.reshape(out.shape[0], -1)[:, 0]     # (B,)
                return torch.mean((pred - batch["labels"]) ** 2)
            raise ValueError("batched node task unsupported")
        out = module.forward(params, batch, cfg)              # (N, n_cls)
        mask = batch["node_mask"]
        logits = out.float()
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        gold = logits.gather(-1, batch["labels"].long()[:, None])
        ce = (logz - gold)[:, 0] * mask
        return ce.sum() / torch.clamp(mask.sum(), min=1)

    return loss_fn


def _gnn_cell(spec: ArchSpec, cell: ShapeCell, rules: ShardingRules,
              shards: int) -> CellPlan:
    module = _GNN_MODULES[spec.name]
    cfg = _adapt_gnn_config(spec.name, spec.config, cell.dims)
    batched = "batch" in cell.dims
    big = (not batched) and cell.dims["n_nodes"] >= max(shards, 4096)
    if not big:
        # small/batched graphs: replicate graph arrays — null the node/edge
        # logical axes so in-model constraints don't force 512-way sharding
        rules = ShardingRules(rules={**rules.rules, "nodes": None,
                                     "edges": None}, mesh=rules.mesh)
    batch_spec, N, E = _gnn_batch(spec.name, cell.dims, rules, shards)

    # GNN params are small: replicate
    params_meta = _meta_tree(
        module.init_params(torch.Generator(), cfg, device="meta"), rules)
    loss_fn = _gnn_loss(module, cfg, cell.dims)
    opt_cfg = AdamWConfig()

    def train_step(params, opt, batch):
        return _accumulated_step(params, opt, batch, 1, loss_fn, opt_cfg)

    args = (params_meta, _opt_meta(params_meta, rules),
            {k: _meta(s, dt, rules, ax)
             for k, (s, dt, ax) in batch_spec.items()})

    def fill(dev, gen):
        params = module.init_params(_on(gen, dev), cfg, device=dev)
        return (params, adamw_init(params),
                _gnn_fill(batch_spec, cell.dims, cfg, gen, dev))

    return CellPlan(train_step, args, None, rules,
                    {"n_nodes": N, "n_edges": E, "edges_per_step": E},
                    fill)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------
def topk_stable(values: torch.Tensor, ids: torch.Tensor, k: int):
    """(top values, their ids) along dim 1 with `jax.lax.top_k`'s tie
    order: equal values in ascending column order, and among columns that
    tie at the k-th value the leftmost kept. `torch.topk` gives the k-th
    value; the columns above it and the leftmost ties are then picked by a
    running count, and the k picked sorted stably by value."""
    kth = torch.topk(values, k, dim=1).values[:, -1:]
    above = values > kth
    tie = values == kth
    room = k - above.sum(1, keepdim=True, dtype=torch.int32)
    pick = above | (tie & (torch.cumsum(tie, 1, dtype=torch.int32) <= room))
    slot = torch.cumsum(pick, 1, dtype=torch.int32) - 1
    slot = torch.where(pick, slot, k).long()
    cols = torch.arange(values.shape[1], device=values.device).expand_as(
        values)
    picked = slot.new_zeros((values.shape[0], k + 1))
    picked.scatter_(1, slot, cols)
    picked = picked[:, :k]                      # ascending columns
    v = values.gather(1, picked)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return v, ids.gather(1, picked.gather(1, order))


def _recsys_cell(spec: ArchSpec, cell: ShapeCell,
                 rules: ShardingRules) -> CellPlan:
    cfg = spec.config
    axes = bert4rec.param_logical_axes(cfg)
    params_meta = _meta_tree(
        bert4rec.init_params(torch.Generator(), cfg, device="meta"), rules,
        axes)
    param_sh = pytree.tree_map(lambda ax: rules.sharding(*ax), axes,
                               is_leaf=_is_axes)
    B = cell.dims["batch"]
    batch_axes = ("batch", None) if B > 1 else None
    S = cfg.seq_len

    def params_of(dev, gen):
        return bert4rec.init_params(_on(gen, dev), cfg, device=dev)

    def histories(gen, n, dev):
        # item ids 1..n_items, the oldest slots padding (0)
        seq = torch.randint(1, cfg.n_items + 1, (n, S), generator=gen,
                            dtype=torch.int32)
        lens = torch.randint(1, S + 1, (n, 1), generator=gen)
        return torch.where(torch.arange(S) >= S - lens, seq, 0).to(dev)

    if cell.kind == "train":
        opt_cfg = AdamWConfig()
        n_masked = 40                       # ~20% of seq_len=200
        accum = 8 if B >= 16384 else 1

        def train_step(params, opt, batch):
            return _accumulated_step(
                params, opt, batch, accum,
                lambda p, mb: bert4rec.masked_lm_loss(p, mb, cfg,
                                                      vocab_chunk=8192),
                opt_cfg)

        args = (params_meta, _opt_meta(params_meta, rules),
                {"item_seq": _meta((B, S), torch.int32, rules, batch_axes),
                 "masked_positions": _meta((B, n_masked), torch.int32, rules,
                                           batch_axes),
                 "labels": _meta((B, n_masked), torch.int32, rules,
                                 batch_axes)})

        def fill(dev, gen):
            params = params_of(dev, gen)
            seq = torch.randint(1, cfg.n_items + 1, (B, S), generator=gen,
                                dtype=torch.int32)
            if n_masked <= S:           # distinct slots
                pos = torch.argsort(torch.rand((B, S), generator=gen),
                                    dim=1)[:, :n_masked].to(torch.int32)
            else:                       # a short smoke sequence
                pos = torch.randint(0, S, (B, n_masked), generator=gen,
                                    dtype=torch.int32)
            labels = seq.gather(1, pos.long())
            seq = seq.scatter(1, pos.long(), cfg.n_items + 1)    # [MASK]
            return (params, adamw_init(params),
                    {"item_seq": seq.to(dev), "masked_positions": pos.to(dev),
                     "labels": labels.to(dev)})

        return CellPlan(train_step, args,
                        (param_sh, {"m": param_sh, "v": param_sh,
                                    "step": None}, None),
                        rules, {"sequences_per_step": B,
                                "grad_accum": accum}, fill)

    if cell.kind == "serve":
        top_k = 100
        chunk = 65536
        req_chunk = 16384  # bulk requests stream through in chunks

        def _serve_chunk(params, item_seq):
            last = bert4rec.encode(params, item_seq, cfg)[:, -1]   # (B, d)
            table, bias_all = params["item_embed"], params["out_bias"]
            rows = cfg.padded_vocab
            b = last.shape[0]
            best_v = torch.full((b, top_k), -torch.inf, dtype=last.dtype,
                                device=last.device)
            best_i = torch.zeros((b, top_k), dtype=torch.int32,
                                 device=last.device)
            # the reference zero-pads the table to a multiple of the
            # chunk; those rows are ids >= vocab and score -inf, so the
            # last chunk is cut short here
            for start in range(0, _round_to(rows, chunk), chunk):
                stop = min(start + chunk, rows)
                emb = table[start:stop].to(last.dtype)
                bias = bias_all[start:stop].to(last.dtype)
                s = torch.addmm(bias, last, emb.T)
                ids = torch.arange(start, stop, dtype=torch.int32,
                                   device=last.device)
                s = torch.where(ids[None, :] < cfg.vocab, s, -torch.inf)
                best_v, best_i = topk_stable(
                    torch.cat([best_v, s], 1),
                    torch.cat([best_i, ids.expand(b, -1)], 1), top_k)
            return best_v, best_i

        @torch.no_grad()
        def serve_step(params, item_seq):
            """Full-catalog top-k; bulk batches stream through in request
            chunks (offline scoring is embarrassingly parallel over
            users). A batch that is no multiple of the chunk ends in a
            shorter chunk, where the reference's reshape refuses it."""
            Bn = item_seq.shape[0]
            if Bn <= req_chunk:
                return _serve_chunk(params, item_seq)
            outs = [_serve_chunk(params, item_seq[c:c + req_chunk])
                    for c in range(0, Bn, req_chunk)]
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]))

        args = (params_meta,
                _meta((B, S), torch.int32, rules, batch_axes))

        def fill(dev, gen):
            return params_of(dev, gen), histories(gen, B, dev)

        return CellPlan(serve_step, args, None, rules,
                        {"requests_per_step": B}, fill)

    if cell.kind == "retrieval":
        n_cand = cell.dims["n_candidates"]

        @torch.no_grad()
        def retrieval_step(params, item_seq, candidates):
            scores = bert4rec.score_candidates(params, item_seq, candidates,
                                               cfg)
            cols = torch.arange(scores.shape[1], device=scores.device)
            return topk_stable(scores, cols.expand_as(scores), 100)

        args = (params_meta, _meta((B, S), torch.int32, rules),
                _meta((n_cand,), torch.int32, rules, ("table",)))

        def fill(dev, gen):
            cand = torch.randperm(cfg.n_items, generator=gen)[:n_cand] + 1
            return (params_of(dev, gen), histories(gen, B, dev),
                    cand.to(torch.int32).to(dev))

        return CellPlan(retrieval_step, args, None, rules,
                        {"candidates_per_step": n_cand}, fill)

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
def build_cell(spec: ArchSpec, shape_name: str, rules: ShardingRules,
               shards: int) -> CellPlan:
    cell = spec.shapes[shape_name]
    if cell.skip:
        raise ValueError(f"cell {spec.name}×{shape_name} is skipped: {cell.skip}")
    if spec.family == "lm":
        return _lm_cell(spec, cell, rules)
    if spec.family == "gnn":
        return _gnn_cell(spec, cell, rules, shards)
    if spec.family == "recsys":
        return _recsys_cell(spec, cell, rules)
    raise ValueError(spec.family)
