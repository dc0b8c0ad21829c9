#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--vertices N] [--edges N] [--seed S]
                          [--disk-budget-mb MB] [--service-vertices N]
                          [--service-edges N] [--gnn-vertices N]
                          [--gnn-edges N]

Run from the root of a checkout: the port is imported from `src/`, and its
CUDA kernels are built from the checkout's sources into `build/kernels/` at
first use (one nvcc per kernel, all started together). The main path is the
graph store read by multi-hop queries and analysed by PSW. Phase 9, the
disk tier, runs first, right after the build, while the process's peak RSS
is still its baseline; phases 0-8 follow, then phase 10, the service and
shard tiers, phase 11, GNN serving on sampled minibatches, phase 12,
EquiformerV2 serving from phase 11's sampler, phase 13, MoE serving,
phase 14, bert4rec serving, phase 15, training, and phase 16, the cell
steps of launch/steps.py, runs last:

  9. the disk tier at benchmarks/bench_disk.py's scale-1.0 configuration
     (a 96 MB data budget; --disk-budget-mb sets it, and with it the edge
     count, 4.2 x budget / 41 bytes, over edges / 30 vertex ids): a
     `GraphDB` in `build/disk_phase/` (64 intervals, 3 levels, branching 4,
     partitions of at most budget / 1,230 edges, a resident budget of
     budget / 8) built from 100,000-edge chunks of default_rng(7) with a
     checkpoint every 1,000,000 edges; (a) its bytes on disk at least 4x
     the budget; (b) `pagerank_out_of_core` for 5 iterations, evicting
     after every bucket, the peak RSS delta of a and b within the budget
     (bench_disk's 96 MB floor; glibc's M_MMAP_THRESHOLD pinned as there
     for the rest of the run); (c) close and
     `GraphDB.open`, `to_coo()` bitwise and bench_disk's 500 probe edges
     found both ways; (e) over the reopened store, its dense plan built and
     timed apart, `two_hop_counts(dense="kernel")` on 256 seeds and
     `khop(dense="kernel", k=3)` from 64, bitwise equal to the sparse host
     path and to a `GraphPAL` of its `to_coo()`; (f) `GraphDB.snapshot()`
     bitwise equal to the GraphPAL's `DeviceGraph`, `pagerank_device` in
     both modes bitwise equal and within 1e-4 of step b's out-of-core
     ranks; (g) `psw_spmm_edges` over the store's edges at F = 128 within
     rowwise 1e-5 of the float32 edge oracle and 1e-4 of float64; (d) last,
     bench_disk's crash recovery: 20,000 more edges, the directory copied
     while the store is live, the copy opened to every acknowledged edge
     and the live store's `to_coo()`;

  0. a small graph: the dense kernel path against the per-hop baselines
     (`bfs_perhop`, `friends_of_friends_perhop`);
  1. bulk store: a LiveJournal-like power-law graph (SNAP soc-LiveJournal1:
     4,847,571 vertices, 68,993,773 edges; cut to 4M vertices and 56M edges,
     about 14 per vertex as there) in a `GraphPAL`, its dense plan built and
     resident on the GPU (its seconds and bytes logged);
     `two_hop_counts(dense="kernel")` on 256 seeds,
     `khop(dense="kernel", k=3)` from 64 seeds, and `query.bfs` from one
     seed with the `dense="auto"` heuristic, each bitwise against the sparse
     host path;
  2. live store: edges streamed into an `LSMTree` with deletes, then
     `two_hop_counts(dense="kernel")` on the live tree and on a pinned
     `read_view()`, bitwise against sparse;
  3. the frontier_expand kernel against its plain torch version at the main
     path's shapes (B = 1: the largest BFS level; B = 64 and 128: two_hop's
     hop-2 panels of 64 and 128 seeds; B = 128: a dense 30% 0/1 panel with
     no zero row to skip): bitwise equal, with times, the bytes and gather
     bounds, the panel's non-zero rows and a `torch.sparse.mm` yardstick;
  4. PSW analytics on the bulk store: `build_device_graph` (host build and
     upload timed apart); the psw_sweep kernels on the DeviceGraph's own
     arrays at a sweep's shapes (`window_send` bitwise its plain gather,
     `segment_sum` within 1e-6 of a float64 sum of the same values and
     bitwise alike in its window and index modes), with times, the 8E +
     8n bytes bound of an iteration and a `torch.sparse.mm` yardstick;
     `pagerank_device` for 5 iterations in `dense_gather` and
     `psw_windows` (bitwise equal, and bitwise equal again on a second
     run; every sweep through the kernels, by `x.psw.sweep_kernel` and
     the launch count), held against a float64 numpy PageRank at rtol
     1e-3;
  5. live snapshots: `LSMTree.snapshot` of phase 2's tree and
     `ManifestView.snapshot` of a pinned view, bitwise equal in every array
     and in PageRank to `build_device_graph` of a `GraphPAL` holding the
     same live edges;
  6. neighbour aggregation through the segment_ell and psw_spmm kernels:
     `segment_ell_from_edges` over the bulk store's edges (K = 15, the first
     fanout of `minibatch_lg`; F = 100, `ogb_products`' d_feat), and
     `psw_spmm_edges` over a second live `LSMTree` (32,768 vertices,
     458,752 power-law edges, part still buffered; F = 128) and a
     Cora-shaped graph (2,708 vertices, 10,556 edges, F = 1,433), each
     against the edge oracle; then each kernel against its plain version
     (psw_spmm's computed in float64, here and in every later phase: the
     float32 one adds a hub row's terms in atomic order, which varies),
     with times, bound and library yardstick (psw_spmm on its prebuilt row
     layout, with `prepare_rows`, the tile compaction and the tile API
     timed on their own);
  7. LM serving at granite-3-2b's full config (40 layers, d 2,048, 32 heads,
     8 kv heads, vocab 49,155; random fp32 weights made on the device from
     --seed, bf16 compute): `serve_requests` with 8 prompts of 4,096 tokens
     in batches of 4, 32 generated tokens each, every prefill layer through
     the flash_attention kernel; then the kernel against its plain version
     on layer 0's q/k/v at the serve shape (bf16 within 2e-2, fp32 within
     2e-5), with the SDPA yardstick there, at 32,768 tokens and at
     qwen3-14b's heads (40, 8 kv, D 128; 4,096 tokens); a 2-layer
     fp32 cut at full width (prefill through the kernel against the plain
     attention, decode against forward, within 1e-4); the share of greedy
     tokens the plain path agrees with;
  8. pooled lookups at bert4rec's serving shape (a 1,000,192 x 64 fp32 item
     table, 16,384 and 512 histories of 200 slots, left-padded): the
     embedding_bag kernel in sum and mean, bitwise against its plain
     version and within 1e-5 of float64 numpy, with the kernel's and the
     wrapper's times (the wrapper's read of the id-check word included)
     and the F.embedding_bag yardstick; then, at B = 64, ids of V and -1
     must raise ValueError (and the next call be bitwise again), and, at
     B = 64 and 4,096, a padding row holding inf or NaN must give the
     plain version's NaN columns;
 10. the service and shard tiers at benchmarks/bench_shard.py's scale-1.0
     configuration (--service-vertices and --service-edges shrink it):
     200,000 vertex ids, 3,000,000 power-law edges (seed 8) in 16 insert
     batches and 50 deletes, stores of 8 intervals, 2 levels, branching 8,
     in `build/service_phase/` (removed at the end). (a) The op prefix into
     a pipelined `ServiceDB`, checkpointed, its view held to d; (b) as
     bench_service.py's contended section, a writer streams 300,000 more
     edges (seed 9, 10,000 a batch, 60,000 edges/s) while the maintenance
     pipeline merges, and two reader threads each pin a `read_view()`
     (before the writer starts, then after half its edges) and run
     `two_hop_counts(dense="kernel")` on 256 seeds and `khop(dense=
     "kernel", k=3)` on 64, bitwise against the sparse host path on the
     same view, the dense plan's builds counted; (c) a `FrontDesk` in front
     of it serves the edge part of the LinkBench mix (out_neighbors,
     getrange, insert) and fof from 8 client threads under
     bench_chaos.py's budgets (none may complete late without a typed
     error), then, quiesced, fof for 256 seeds through it equals the dense
     kernel's on a view of the same publication; (d) a 4-shard
     `ShardRouter` (spawned workers that load neither jax nor the reference
     and make no CUDA context) fed the op prefix equals the view of (a)
     bitwise (n_edges, out_neighbors of 512 ids, khop levels, FoF counts),
     as do the dense kernel's answers on that view, then 8 client threads
     read it for 5 s; (e) a `begin_snapshot()` session opened with
     `Snapshot.open`: its `snapshot()` on the card bitwise equal to a
     `GraphPAL`'s, PageRank modes bitwise equal, `psw_spmm_edges` at
     F = 128 within rowwise 1e-5 of the float64 edge oracle (the float32
     oracle, `index_add_` over the hub's 877,000 in-edges one at a time,
     misses float64 itself by several times that; its distance is logged);
 11. GNN serving on sampled minibatches, the repo's minibatch_lg cell
     (configs/gnn_common.py: Reddit, 232,965 vertices, 114,615,892 edges,
     602 features, 41 classes; --gnn-vertices and --gnn-edges shrink it):
     a stand-in with Reddit's sizes (power-law edges from --seed) in a
     16-partition `GraphPAL`, a `NeighborSampler` over its in-edge CSC, the
     feature table on the card; 4 batches of 1,024 seeds with fanouts
     15-10, padded to 169,984 nodes and 168,960 edges, uploaded, their
     features gathered on the card, then gin-tu (5 layers, d 64, its
     neighbour sum on psw_spmm: one layout a forward, one launch a layer),
     pna (4, d 75) and meshgraphnet (15, d 128, random 4-wide edge
     features) compute every node's logits, adapted to the cell as
     repro/launch/steps.py::_adapt_gnn_config does (edge_chunks 1); each
     model's forward timed with CUDA events and profiled once with
     torch.profiler (the device's busy share). Gates: the padding invariants;
     the seeds' logits on the card within 1e-4 of the same forward on the
     CPU; GIN's within 1e-4 of GIN with psw_spmm's plain neighbour sum on
     the card; no NaN or inf; psw_spmm on one batch's layout at F = 64
     (GIN's encoder output) within rowwise 1e-5 of its plain version, with
     its time, bound and the torch.sparse.mm yardstick;
 12. EquiformerV2 serving sampled minibatches of phase 11's stand-in (its
     sampler): equiformer-v2's full config (12 layers, 128 channels, l_max
     6, m_max 2, 8 heads) adapted to minibatch_lg as
     repro/launch/steps.py::_adapt_gnn_config does (41 outputs, 128
     species, 4 edge chunks, psw_ring on one rank, remat on), random
     weights from --seed; unit-ball positions and hashed species a vertex
     (`phase_equiformer`); 2 batches of 1,024 seeds at 15-10, padded to
     169,984 nodes and 168,960 edges, each forward timed with CUDA events
     and the first profiled. Its message scatter runs on psw_spmm (one
     layout a chunk a forward, one launch a chunk and layer). Gates:
     logits (169,984, 41), finite; the kernel's forward within 1e-4 of the
     same forward with psw_spmm's plain version; the card's take-mode
     forward at edge_chunks 1 and 4 within 1e-4 of the CPU's on a 64-seed
     batch; n_layers x edge_chunks launches a forward; psw_spmm at the
     scatter shape (F = 6,272) within rowwise 1e-5 of its plain version,
     with its time, bound and the index_add_ yardstick. Logged: the seeds'
     logits under a random global rotation;
 13. MoE serving (`phase_moe`): qwen3-moe-235b-a22b (d 4,096, 64 heads, 4
     kv heads, d_head 128, qk_norm, 128 experts, top-8, d_ff_expert 1,536,
     vocab 151,936 -> 152,064) and phi3.5-moe-42b-a6.6b (32 heads, 8 kv
     heads, 16 experts, top-2, d_ff_expert 6,400, vocab 32,064) at full
     width, each cut to 4 layers (MOE_LAYERS) with bf16 params drawn on
     the card from --seed; `serve_requests` with 4 prompts of 4,096 tokens
     in one batch, 16 generated, every prefill layer's attention on the
     flash_attention kernel and its MoE in 2 sequence chunks of 8,192
     tokens (qwen3-moe: cap 640); the kernel on layer 0's q/k/v at that
     shape within 2e-2 of its plain version (GQA 16 and 4); then one MoE
     layer at the prefill shape timed with CUDA events against its bf16
     expert FLOPs, and the greedy tokens and prefill routings of the plain
     attention path (logged). Gates on a 2-layer fp32 cut of qwen3-moe at
     full width, 4 prompts of 256 tokens, capacity factor E/K (no token
     dropped, so a routing touches only its own sequence): the fp32 kernel
     on layer 0's q/k/v within 2e-5 of its plain version; (a) prefill
     through the kernel against the plain attention, every token-layer
     routing compared first (at most 1% may differ), last-token logits
     within 1e-4 in every prompt whose routings all agree (one at least);
     (b) decode against forward over 8 steps within 1e-4; (c) finite
     logits, tokens below padded_vocab. Then qwen3-moe's layer 0 at the
     prefill shape routed in 2 groups a chunk (the reference's dp = 2 on
     a data mesh; `_moe_core(groups=2)`, one rank having no mesh: 2 x
     4,096 tokens, cap 320) against two dp = 1 calls on the batch's
     halves: each chunk's experts, slot tables, slots and expert counts
     bitwise, the output within 2e-2 (bf16), timed beside the dp = 1
     layer;
 14. bert4rec serving at its full config (`phase_bert4rec`: 1,000,000
     items, a 1,000,192 x 64 fp32 table, 2 blocks, 2 heads, 200 slots;
     params drawn on the card): serve_p99, `score_all_items` of the first
     512 of phase 8's histories, (512, 1,000,192) fp32 scores and their
     top 100; retrieval_cand, `score_candidates` of one history against
     1,000,000 candidate ids and their top 100; encode, scoring, top-k
     and both requests timed with CUDA events, the scoring pass against
     its bound. Gates: 8 rows within 1e-4 of the CPU's, the candidates'
     scores within 1e-5 of the full scores at their columns, no NaN in a
     row with an item. serve_bulk (B = 262,144) is phase 16a.
 15. training (`phase_train`), each model freed before the next: (a)
     granite-3-2b at its full config (fp32 master params and AdamW state,
     bf16 compute, remat "full"), `launch/train.py::train_step` for 4
     steps on one TokenStream batch of 2 x 4,096 tokens (train_4k's
     256 x 4,096 cut to the batch); gates: finite losses falling from step
     0 to step 3, 80 flash_attention launches a step (forward and
     recompute), and on a 2-layer fp32 cut at full width the gradient
     with the kernel forward within 1e-4 of the plain forward's; logged:
     step s, tokens/s, model FLOP/s (6 N tokens / step s) against 989
     TFLOP/s, peak GiB, the attention backward's ms a layer against
     SDPA's backward; (b) phi3.5-moe at full width cut to 2 of 32 layers
     (fp32 params and AdamW state), 2 steps on 1 x 4,096 tokens; gates:
     finite losses, the balance loss above 0, the router's gradient not 0;
     (c) bert4rec at its full config, one of train_batch's 8 microbatches
     (8,192 of 65,536 sequences, 40 masked slots, vocab chunks of 8,192),
     2 steps; gates: finite losses, the item table's gradient not 0; (d)
     gin-tu on phase 11's first batch, 3 AdamW steps of the node
     cross-entropy; gates: the first gradient on the card within 1e-4 of
     the CPU's, 10 psw_spmm launches a step (the forward's and the
     transpose's); (e) EquiformerV2 at phase 12's config cut to 4 of 12
     layers on phase 12's first batch, one step; gates: a finite gradient
     norm, 3 psw_spmm launches a layer and chunk (forward, recompute,
     transpose); (f) psw_spmm's transpose (`transpose_rows`) at the GIN
     shape and at EquiformerV2's scatter shape (F = 6,272): equal to
     `prepare_rows` of the swapped edges, the kernel within rowwise 1e-5
     of its plain version, with times, the bytes bound and the
     `torch.sparse.mm` yardstick.
 16. the cells of launch/steps.py (`phase_cells`), each step through
     `build_cell` and its inputs from `materialize` (random weights from
     --seed): (a) bert4rec serve_bulk at full size, 262,144 histories of
     200 slots over all 1,000,192 rows, top 100 in request chunks of
     16,384 and vocab chunks of 65,536; gate: 512 sampled requests' ids
     and values within 1e-5 of `torch.topk` over `score_all_items` (a tie
     may swap ids); (b) bert4rec train_batch cut to 16,384 sequences, 8
     microbatches by the cell's rule, one step; gates: a finite loss, the
     table's gradient not 0, and on a cut that fits one pass (100,000
     items, 20 slots, 4 masked) the accumulated step against one pass:
     the gradient norms before the clip within 1e-4 relative, the clipped
     gradients within rtol 1e-4, atol 1e-5 x their largest |g|; (c)
     gin-tu x ogb_products at full size (2,449,029 nodes, 61,859,140
     power-law edges from --seed, 100 features, 47 classes, 16 edge
     chunks), 2 train steps; gate: 10 psw_spmm launches a step (5
     forward, 5 transpose); then psw_spmm and its transpose on the step's
     row layout at F = 64 (a 2,445,979-entry hub row), each within
     rowwise 1e-5 of its plain version in float64;
     (d) granite-3-2b x train_4k at full depth cut to B = 8, 2
     microbatches of 4 x 4,096 by the cell's rule, one step; gates: 160
     flash_attention launches, and on a 2-layer fp32 cut (2 microbatches
     of 2 x 2,048) the accumulated step against one pass as in (b); (e) prefill_32k cut to B = 2 (40 launches) and decode_32k
     cut to B = 8 at a 32,768-slot cache, 4 tokens; (f) a one-rank NCCL
     process group: `pagerank_device(group=...)` bitwise the group-less
     one in both modes on bench_shard's 3M power-law edges, and
     `compressed_psum_tree` over (d)'s gradient tree bitwise the local
     int8 round trip; (g) two dry-run cells (gin-tu x full_graph_sm and
     equiformer-v2 x minibatch_lg, psw_ring, on the 16 x 16 mesh of a fake
     world of 256) in one subprocess started first, status "ok" each,
     EquiformerV2's ring hops counted as collective-permute bytes.

Each kernel's launch count is zeroed just before the path that runs it
(phases 1-2 for frontier_expand, phase 4's PageRank runs for psw_sweep,
phase 6's aggregation calls for
segment_ell and psw_spmm, phase 7's `serve_requests` for flash_attention,
phase 8's lookups for embedding_bag) and read just after; the disk path's
own counts (phase 9's dense calls on the store for frontier_expand, its
`psw_spmm_edges` for psw_spmm) are logged on the `disk path:` line and
given as `disk_path_launches` in the kernels line; phase 10's (its dense
hops in b-d for frontier_expand, e's `psw_spmm_edges` for psw_spmm) on the
`service path:` line and as `service_path_launches`; phase 11's (psw_spmm
in every GIN forward of its 4 batches, which must be 5 a forward) on the
`gnn path:` line and as `gnn_path_launches`; phase 12's (psw_spmm in
every EquiformerV2 forward on the card, n_layers x edge_chunks each) on
the `equiformer path:` line and as `equiformer_path_launches`; phase 13's
(flash_attention in both MoE models' `serve_requests`, n_layers a
prefill) on the `moe path:` line and as `moe_path_launches`; phase 15's
(flash_attention in (a) and (b), psw_spmm in (d) and (e), each zeroed
before its own steps) on the `train path:` line and as
`train_path_launches`; phase 16's (flash_attention in 16d's step and 16e's
prefill, psw_spmm in 16c's two steps) on the `cell path:` line and as
`cell_path_launches`. Any failed check exits non-zero. The
second-to-last line is the card's name and power limit from nvidia-smi;
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import resource
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
FP64_OPS_PER_S = 34e12      # H100 SXM, fp64 outside the tensor cores


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def power_law_graph(n_vertices: int, n_edges: int, alpha: float = 1.8,
                    seed: int = 0, hot_frac: float = 0.5):
    """Numpy copy of benchmarks/common.py::power_law_graph: a zipf-hot head
    of celebrity destinations (scattered ids) mixed with uniform long-tail
    follows — power-law in-degrees, uniform out-degrees."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    hot = (rng.zipf(alpha, n_edges) - 1) % n_vertices
    hot = (hot * 2654435761) % n_vertices
    uniform = rng.integers(0, n_vertices, n_edges)
    dst = np.where(rng.random(n_edges) < hot_frac, hot, uniform)
    return src, dst


def same_two_hop(a, b) -> bool:
    return (np.array_equal(a.offsets, b.offsets)
            and np.array_equal(a.ids, b.ids)
            and np.array_equal(a.counts, b.counts))


def same_levels(a, b) -> bool:
    return (len(a.levels) == len(b.levels)
            and all(np.array_equal(x, y) for x, y in zip(a.levels, b.levels)))


class Clock:
    """Host seconds per phase, each ending in a device synchronize."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = {}

    def __call__(self, name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        self.torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t0
        log(f"  {name}: {self.seconds[name]:.3f} s")
        return out


def hop_modes(telemetry) -> dict:
    return dict(telemetry.snapshot()["counters"].get("multihop.hops", {}))


def phase_small(core, dev, seed: int) -> None:
    """A small graph through the kernel path against the per-hop
    baselines (the repo's own oracles)."""
    n, e = 2000, 20000
    src, dst = power_law_graph(n, e, seed=seed + 7)
    g = core.GraphPAL.from_edges(src, dst, n_partitions=16, max_id=n - 1)
    core.dense_plan(g, "out", device=dev)
    seeds = np.random.default_rng(seed).choice(n, 40, replace=False)
    res = core.two_hop_counts(g, seeds, dense="kernel", device=dev)
    for i, v in enumerate(seeds.tolist()):
        ids = res.ids[res.slice_of(i)]
        check(np.array_equal(ids, core.friends_of_friends_perhop(g, v)),
              f"small graph: dense FoF of {v} differs from the per-hop FoF")
    got = core.bfs(g, int(seeds[0]), max_depth=6, device=dev)
    check(got == core.bfs_perhop(g, int(seeds[0]), max_depth=6),
          "small graph: bfs differs from bfs_perhop")
    log(f"phase 0 small graph ({n} vertices, {e} edges): dense FoF of "
        f"{len(seeds)} seeds and bfs match the per-hop baselines")


def phase_bulk(torch, core, fe_ops, dev, args, clock):
    log(f"phase 1 bulk store: {args.vertices} vertices, {args.edges} edges")
    src, dst = clock("generate", power_law_graph, args.vertices, args.edges,
                     seed=args.seed)
    g = clock("GraphPAL.from_edges", core.GraphPAL.from_edges, src, dst,
              n_partitions=16, max_id=args.vertices - 1)
    del src, dst
    plan = clock("dense_plan (edge keys on the host, the plan on the card)",
                 core.dense_plan, g, "out", device=dev)
    counts = plan.edge_ptr[1:] - plan.edge_ptr[:-1]
    heavy = counts > plan.light_edges
    nbytes = sum(t.numel() * t.element_size() for t in vars(plan).values()
                 if torch.is_tensor(t))
    log(f"  plan: {plan.n_edges} distinct edges, {nbytes} bytes on the "
        f"card; {int(heavy.sum())} heavy "
        f"destinations (> {plan.light_edges} edges, "
        f"{int(counts[heavy].sum())} edges) in "
        f"{plan.chunks.shape[0]} chunks of <= {plan.chunk_edges}, "
        f"{plan.reduced_hubs} of them in {plan.scratch_rows} chunks summed "
        f"by pass 2; longest {int(counts.max())} edges")
    rng = np.random.default_rng(args.seed + 1)
    seeds = rng.choice(args.vertices, 256, replace=False)

    n0 = fe_ops.launches
    dense = clock("two_hop_counts dense (256 seeds)", core.two_hop_counts,
                  g, seeds, dense="kernel", device=dev)
    sparse = clock("two_hop_counts sparse (256 seeds)", core.two_hop_counts,
                   g, seeds)
    check(same_two_hop(dense, sparse), "bulk two_hop_counts: dense != sparse")
    check(fe_ops.launches > n0, "bulk two_hop_counts launched no kernel")
    log(f"  two_hop: {dense.ids.shape[0]} (seed, target) pairs, "
        f"counts sum {int(dense.counts.sum())}, bitwise equal")

    s64 = seeds[:64]
    kd = clock("khop dense k=3 (64 seeds)", core.khop, g, s64, 3,
               dense="kernel", device=dev)
    ks = clock("khop sparse k=3 (64 seeds)", core.khop, g, s64, 3,
               dense="never")
    check(same_levels(kd, ks), "bulk khop: dense != sparse")
    log(f"  khop levels {[int(lv.shape[0]) for lv in kd.levels]}, "
        "bitwise equal")

    src0 = int(seeds[0])
    modes0, n0 = hop_modes(core.telemetry), fe_ops.launches
    depth = clock(f"bfs auto depth {args.bfs_depth}", core.bfs, g, src0,
                  max_depth=args.bfs_depth, device=dev)
    bfs_launches = fe_ops.launches - n0
    modes = {k: v - modes0.get(k, 0) for k, v in hop_modes(
        core.telemetry).items()}
    ref = clock(f"khop sparse depth {args.bfs_depth}", core.khop, g, [src0],
                args.bfs_depth, dense="never")
    want = {u: d for d, lv in enumerate(ref.levels) for u in lv.tolist()}
    check(depth == want, "bulk bfs: auto (kernel) != sparse")
    check(bfs_launches > 0, "bfs never took the kernel path")
    log(f"  bfs: {len(depth)} reached, levels "
        f"{[int(lv.shape[0]) for lv in ref.levels]}, hop modes {modes}, "
        f"{bfs_launches} kernel hops, bitwise equal")
    frontier = max(ref.levels, key=lambda lv: lv.shape[0])
    return g, seeds, frontier


def phase_live(core, fe_ops, dev, args, clock):
    n = args.vertices
    log(f"phase 2 live store: stream {args.live_edges} edges into an LSMTree")
    iv = core.IntervalMap.for_capacity(n - 1, 16)
    t = core.LSMTree(iv, n_levels=3, branching=4, buffer_cap=50_000)
    src, dst = power_law_graph(n, args.live_edges, seed=args.seed + 2)
    batch = 10_000

    def stream():
        for i in range(0, src.shape[0], batch):
            t.insert_edges(src[i:i + batch], dst[i:i + batch])

    clock("stream inserts", stream)
    rng = np.random.default_rng(args.seed + 3)
    gone = rng.choice(src.shape[0], 300, replace=False)
    for i in gone.tolist():
        t.delete_edge(int(src[i]), int(dst[i]))
    log(f"  {t.n_edges} live edges after 300 deletes, "
        f"{sum(len(lv) for lv in t.levels)} partitions, "
        f"{args.live_edges / clock.seconds['stream inserts']:.0f} edges/s")
    seeds = rng.choice(np.unique(src), 256, replace=False)
    n0 = fe_ops.launches
    dense = clock("live two_hop dense", core.two_hop_counts, t, seeds,
                  dense="kernel", device=dev)
    sparse = clock("live two_hop sparse", core.two_hop_counts, t, seeds)
    check(same_two_hop(dense, sparse), "live two_hop_counts: dense != sparse")
    with t.read_view() as view:
        vd = clock("read_view two_hop dense", core.two_hop_counts, view,
                   seeds, dense="kernel", device=dev)
        vs = clock("read_view two_hop sparse", core.two_hop_counts, view,
                   seeds)
    check(same_two_hop(vd, vs), "read_view two_hop_counts: dense != sparse")
    check(same_two_hop(vd, dense), "read_view differs from the live tree")
    check(fe_ops.launches > n0, "live two_hop_counts launched no kernel")
    log(f"  live two_hop: {dense.ids.shape[0]} pairs, bitwise equal on the "
        "tree and its pinned view")
    return t


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph and replayed, so the host's launch path is out of the time (it
    outlasts a kernel of a few microseconds). Best of 3 replays."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def kernel_vs_plain(torch, fe, kernel, plan, x, reps: int) -> dict:
    """Kernel against the plain version on one panel: bitwise check (NaN
    nowhere: the panels are 0/1), times, the bytes and gather bounds and
    the torch.sparse.mm yardstick on the plan's own CSR."""
    B = int(x.shape[1])
    out = torch.empty((plan.n_dst, B), dtype=torch.float32, device=x.device)
    scratch = torch.empty((plan.scratch_rows, B), dtype=torch.float32,
                          device=x.device)
    flags = torch.empty((plan.n_src, -(-B // kernel.TILE) if B >= 32 else 0),
                        dtype=torch.uint8, device=x.device)
    kernel.launch(plan, x, out, scratch, flags)
    plain = fe.frontier_expand_torch(plan.col, plan.edge_ptr, x, plan.n_dst)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    check(torch.equal(out, plain),
          f"kernel != plain version at B={B} (max abs err {err})")
    del plain
    ms = cuda_ms(torch, lambda: kernel.launch(plan, x, out, scratch, flags),
                 reps)
    plain_ms = cuda_ms(torch, lambda: fe.frontier_expand_torch(
        plan.col, plan.edge_ptr, x, plan.n_dst), max(1, reps // 4))

    # yardstick: the same product as one cuSPARSE SpMM of the CSR adjacency
    # (the kernel's compact layout: col and edge_ptr)
    col = plan.col.long()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # "sparse CSR is in beta"
        adj = torch.sparse_csr_tensor(
            plan.edge_ptr, col, torch.ones(col.shape[0], device=x.device),
            size=(plan.n_dst, plan.n_src))
    lib = torch.sparse.mm(adj, x)
    torch.cuda.synchronize()
    check(torch.equal(lib, out), f"torch.sparse.mm != kernel at B={B}")
    del lib
    library_ms = cuda_ms(torch, lambda: torch.sparse.mm(adj, x), reps)
    del adj, col

    E, M, N = plan.n_edges, plan.n_src, plan.n_dst
    nz = (x != 0).any(1)
    nz_rows = int(nz.sum())
    gathered = int(nz[plan.col.long()].sum())   # edges whose x row is read
    xo = M * B * 4 + N * B * 4                   # x read once, out written
    # each input read once, each output written once
    bytes_once = E * 4 + (N + 1) * 8 + xo
    ops = E * B                       # one fp32 add per gathered element
    # what gathering every edge's x row moves (a 32-byte sector at least)
    gather_bytes = E * 4 + (N + 1) * 8 + E * max(B * 4, 32) + N * B * 4
    res = {"B": B, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "nonzero_rows": nz_rows,
           "gathered_rows": gathered,
           **bound(bytes_once, ops, FP32_OPS_PER_S),
           "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
           "gather_bytes": gather_bytes, "edges": E}
    return res


def phase_kernel(torch, core, fe, kernel, g, seeds, frontier, dev, reps,
                 seed):
    """The kernel against its plain version at the main path's shapes: the
    largest BFS level (B = 1), two_hop's hop-2 panels of 64 and 128 seeds,
    and a dense 30% 0/1 panel at B = 128 (nothing to skip)."""
    log("phase 3 kernel against plain version at the main path's shapes")
    plan = core.dense_plan(g, "out", device=dev)
    iv = g.intervals
    M = plan.n_src
    res = {}
    x1 = torch.zeros((M, 1), dtype=torch.float32, device=dev)
    fi = torch.from_numpy(np.asarray(iv.to_internal(frontier), np.int64))
    x1[fi.to(dev), 0] = 1.0                    # the largest BFS level
    res["bfs"] = kernel_vs_plain(torch, fe, kernel, plan, x1, reps)
    del x1
    log(f"  B=1 ({frontier.shape[0]} frontier vertices): "
        + json.dumps(res["bfs"]))
    for B in (64, 128):
        si = torch.from_numpy(np.asarray(iv.to_internal(seeds[:B]),
                                         np.int64)).to(dev)
        x = torch.zeros((M, B), dtype=torch.float32, device=dev)
        x[si, torch.arange(B, device=dev)] = 1.0
        hop1 = fe.frontier_expand_counts(plan, x)
        panel = (hop1 > 0).to(torch.float32)   # two_hop's hop-2 input
        del x, hop1
        res[f"hop2_{B}"] = kernel_vs_plain(torch, fe, kernel, plan, panel,
                                           reps)
        del panel
        log(f"  B={B} hop-2 panel: " + json.dumps(res[f"hop2_{B}"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dense = (torch.rand((M, 128), generator=gen, device=dev) < 0.3).to(
        torch.float32)
    res["dense"] = kernel_vs_plain(torch, fe, kernel, plan, dense,
                                   max(2, reps // 4))
    del dense
    log("  B=128 dense 30% panel: " + json.dumps(res["dense"]))
    return res


DG_FIELDS = ("src", "dst_local", "mask", "outdeg", "send_idx", "edge_owner",
             "edge_slot", "seg_ptr")
PR_MODES = ("dense_gather", "psw_windows")


def dg_bytes(dg) -> int:
    return sum(getattr(dg, f).numel() * getattr(dg, f).element_size()
               for f in DG_FIELDS if getattr(dg, f) is not None)


def pagerank_fp64(src, dst, n: int, n_iters: int = 5,
                  damping: float = 0.85) -> np.ndarray:
    """Independent float64 PageRank over an edge list (original ids): the
    same synchronous iteration as `pagerank_device`."""
    outdeg = np.bincount(src, minlength=n)
    inv = 1.0 / np.maximum(outdeg, 1)
    r = np.ones(n)
    for _ in range(n_iters):
        acc = np.bincount(dst, weights=(r * inv)[src], minlength=n)
        r = (1.0 - damping) + damping * acc
    return r


def psw_sweep_vs_plain(torch, pw, dg, n_vertices: int, reps: int,
                       seed: int) -> dict:
    """The psw_sweep kernels against their plain versions on the
    DeviceGraph's own arrays, at one PageRank sweep's shapes: window_send
    bitwise its plain gather; segment_sum in window mode within 1e-6 of a
    float64 sum of the same values (an empty destination exactly 0) and
    bitwise its index mode; times, the 8E + 8n bytes bound of an iteration
    and a torch.sparse.mm yardstick on the same edges."""
    P, L, E = dg.n_partitions, dg.interval_len, dg.src.shape[1]
    gen = torch.Generator(device=dg.src.device)
    gen.manual_seed(seed)
    x = torch.rand((P, L, 1), generator=gen, device=dg.src.device) / 4
    win = {"edge_owner": dg.edge_owner, "edge_slot": dg.edge_slot}
    recv = pw.window_send(x, dg.send_idx)
    check(torch.equal(recv, pw.window_send_torch(x, dg.send_idx)),
          "psw_sweep window_send != plain version")
    out = pw.segment_sum(recv, dg.seg_ptr, **win)
    check(torch.equal(out, pw.segment_sum(x.reshape(-1, 1), dg.seg_ptr,
                                          src=dg.src)),
          "psw_sweep segment_sum: index mode != window mode")
    want = pw.segment_sum_torch(pw.edge_rows_torch(recv, **win).double(),
                                dg.seg_ptr)            # float64 sums
    diff = (out.double() - want).abs()
    err = float(diff.max())
    rel = float((diff / want.abs().clamp_min(1e-300)).max())
    del diff
    check(rel <= 1e-6, f"psw_sweep segment_sum vs float64: max rel err {rel}")

    def sweep():
        return pw.segment_sum(pw.window_send(x, dg.send_idx), dg.seg_ptr,
                              **win)

    def plain():
        return pw.segment_sum_torch(pw.edge_rows_torch(
            pw.window_send_torch(x, dg.send_idx), **win), dg.seg_ptr)

    ms = cuda_ms(torch, sweep, reps)
    exchange_ms = cuda_ms(torch, lambda: pw.window_send(x, dg.send_idx),
                          reps)
    sum_ms = cuda_ms(torch, lambda: pw.segment_sum(recv, dg.seg_ptr, **win),
                     reps)
    index_sum_ms = cuda_ms(torch, lambda: pw.segment_sum(
        x.reshape(-1, 1), dg.seg_ptr, src=dg.src), reps)
    plain_ms = cuda_ms(torch, plain, max(1, reps // 4))

    # yardstick: the same sums as one cuSPARSE SpMV of the CSR adjacency
    # over the edges before each partition's padding
    live = torch.arange(E, device=x.device)[None, :] < dg.seg_ptr[:, L:]
    col = dg.src[live].long()
    del live
    counts = (dg.seg_ptr[:, 1:] - dg.seg_ptr[:, :-1]).reshape(-1)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # "sparse CSR is in beta"
        adj = torch.sparse_csr_tensor(
            crow, col, torch.ones(col.shape[0], device=x.device),
            size=(P * L, P * L))
    xf = x.reshape(-1, 1)
    lib = torch.sparse.mm(adj, xf)
    lib_err = float((lib.double().reshape(P, L, 1) - want).abs().max())
    del lib, want
    library_ms = cuda_ms(torch, lambda: torch.sparse.mm(adj, xf), reps)
    del adj, col, crow

    n_edges = dg.n_edges
    # an iteration's floor: each edge's two int32 window coordinates and
    # each vertex's rank read and written once
    bytes_once = 8 * n_edges + 8 * n_vertices
    return {"P": P, "L": L, "E_max": E, "window_width": dg.window_width,
            "edges": n_edges, "max_abs_err": err, "max_rel_err": rel,
            "ms": ms, "exchange_ms": exchange_ms, "sum_ms": sum_ms,
            "index_sum_ms": index_sum_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            **bound(bytes_once, n_edges, FP64_OPS_PER_S)}


def phase_psw(torch, core, pw, g, dev, args, clock):
    log("phase 4 PSW analytics on the bulk store")
    host = clock("build_device_graph host build", core.build_device_graph, g,
                 device="cpu")
    dg = clock("build_device_graph upload", host.to, dev)
    del host                                   # free the host copy
    P, E = dg.src.shape
    log(f"  DeviceGraph: {dg.n_edges} edges in {P} partitions, E_max {E}, "
        f"window width {dg.window_width}, {dg_bytes(dg) / 2**30:.2f} GiB on "
        "the device")
    res = psw_sweep_vs_plain(torch, pw, dg, args.vertices, args.reps,
                             args.seed + 6)
    log("  psw_sweep window sweep: " + json.dumps(res))

    def swept() -> int:
        return int(core.telemetry.snapshot()["counters"].get(
            "x.psw.sweep_kernel", 0))

    runs = {}
    sweeps0 = swept()
    pw.ops.launches = 0                        # the PageRank runs...
    for rep in (1, 2):
        for mode in PR_MODES:
            runs[mode, rep] = clock(f"pagerank_device {mode} (5 iters) run "
                                    f"{rep}", core.pagerank_device, dg, 5,
                                    mode=mode)
    launches, sweeps = pw.ops.launches, swept() - sweeps0   # ...end here
    # 5 sweeps a run; psw_windows launches the exchange and the sum a
    # sweep, dense_gather the sum alone
    check(sweeps == 20, f"{sweeps} kernel sweeps in 4 PageRank runs, not 20")
    check(launches == 30, f"{launches} psw_sweep launches in 4 PageRank "
          "runs, not 30")
    first = runs["dense_gather", 1]
    check(torch.equal(first, runs["psw_windows", 1]),
          "pagerank_device: dense_gather != psw_windows")
    for mode in PR_MODES:
        check(torch.equal(runs[mode, 1], runs[mode, 2]),
              f"pagerank_device {mode}: a second run differs from the first")
    n = args.vertices
    src, dst = g.to_coo()
    want = clock("float64 numpy PageRank", pagerank_fp64, src, dst, n)
    del src, dst
    got = first.reshape(-1).cpu().numpy()[
        g.intervals.to_internal(np.arange(n))].astype(np.float64)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(bool(np.all(np.isfinite(got))), "pagerank_device: non-finite ranks")
    check(rel <= 1e-3, f"pagerank_device vs float64: max rel err {rel}")
    log(f"  pagerank: both modes and both runs bitwise equal; max relative "
        f"error vs float64 numpy {rel:.3e} (limit 1e-3); rank sum "
        f"{float(want.sum()):.1f}, max {float(want.max()):.1f}; {sweeps} "
        f"kernel sweeps, {launches} psw_sweep launches")
    del dg, runs, first
    return launches, res


def same_device_graph(torch, a, b) -> bool:
    return ((a.n_partitions, a.interval_len, a.n_edges)
            == (b.n_partitions, b.interval_len, b.n_edges)
            and all(torch.equal(getattr(a, f), getattr(b, f))
                    for f in DG_FIELDS))


def phase_snapshots(torch, core, t, dev, args, clock):
    log("phase 5 live snapshots of phase 2's LSMTree")
    dg_t = clock("LSMTree.snapshot", t.snapshot, device=dev)
    with t.read_view() as view:
        dg_v = clock("ManifestView.snapshot", view.snapshot, device=dev)
    src, dst = t.to_coo()
    g = core.GraphPAL.from_edges(src, dst, n_partitions=16,
                                 max_id=args.vertices - 1)
    del src, dst
    dg_g = clock("build_device_graph(GraphPAL of the live edges)",
                 core.build_device_graph, g, device=dev)
    check(same_device_graph(torch, dg_t, dg_g),
          "LSMTree.snapshot != the GraphPAL DeviceGraph")
    check(same_device_graph(torch, dg_v, dg_g),
          "ManifestView.snapshot != the GraphPAL DeviceGraph")
    for mode in PR_MODES:
        r = core.pagerank_device(dg_g, 5, mode=mode)
        check(torch.equal(core.pagerank_device(dg_t, 5, mode=mode), r)
              and torch.equal(core.pagerank_device(dg_v, 5, mode=mode), r),
              f"snapshot pagerank {mode} differs from the GraphPAL's")
    log(f"  {dg_g.n_edges} live edges ({t.total_buffered()} still "
        "buffered): both snapshots bitwise equal to the GraphPAL "
        "DeviceGraph in every array and in PageRank (both modes)")


def live_tree(core, n: int, e: int, seed: int):
    """A second live store: power-law edges streamed in 10,000-edge
    batches, the tail still in the buffers."""
    t = core.LSMTree(core.IntervalMap.for_capacity(n - 1, 16), n_levels=2,
                     branching=4, buffer_cap=50_000)
    src, dst = power_law_graph(n, e, seed=seed)
    for i in range(0, e, 10_000):
        t.insert_edges(src[i:i + 10_000], dst[i:i + 10_000])
    check(t.total_buffered() > 0, "the second live tree buffered no edges")
    return t


def randn(torch, shape, dev, seed: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def phase_aggregate(torch, core, se, ps, g, dev, args, clock):
    """The aggregation path through both kernels' entry points, each
    result against the edge oracle. Returns what the kernel checks need."""
    from repro_torch.graph import pad_to_ell
    log("phase 6 neighbour aggregation")
    n, K, F = args.vertices, 15, 100
    src, dst = g.to_coo()
    x = randn(torch, (n, F), dev, args.seed + 10)
    se.ops.launches = ps.ops.launches = 0      # the aggregation path...
    h = clock("segment_ell_from_edges bulk store (K=15, F=100)",
              se.segment_ell_from_edges, src, dst, x, n, K)
    n2, e2 = 32_768, 458_752
    t2 = live_tree(core, n2, e2, args.seed + 11)
    s2, d2 = t2.to_coo()
    x2 = randn(torch, (n2, 128), dev, args.seed + 12)
    y2 = clock("psw_spmm_edges live tree (F=128)", ps.psw_spmm_edges,
               s2, d2, x2, n2)
    n3, e3 = 2_708, 10_556
    s3, d3 = power_law_graph(n3, e3, seed=args.seed + 13)
    x3 = randn(torch, (n3, 1_433), dev, args.seed + 14)
    y3 = clock("psw_spmm_edges Cora-shaped (F=1433)", ps.psw_spmm_edges,
               s3, d3, x3, n3)
    launches = {"segment_ell": se.ops.launches,
                "psw_spmm": ps.ops.launches}   # ...ends here
    for name, count in launches.items():
        check(count > 0, f"the aggregation path launched no {name} kernel")

    # edge oracles: segment_ell over the edges pad_to_ell keeps
    idx, mask = (torch.from_numpy(a) for a in pad_to_ell(src, dst, n, K))
    del src, dst
    rows = torch.arange(n).repeat_interleave(mask.sum(1))
    kept = idx[mask]
    want = ps.spmm_dense_torch(kept.to(dev), rows.to(dev), x, n)
    err = float((h - want).abs().max())
    check(torch.allclose(h, want, rtol=1e-5, atol=1e-5),
          f"segment_ell vs the edge oracle: max abs err {err}")
    log(f"  segment_ell: {int(kept.shape[0])} kept of {g.n_edges} edges, "
        f"max abs err vs edge oracle {err:.3e} (rtol/atol 1e-5)")
    del rows, want
    # psw_spmm against the edge oracle in float64 (the hottest destination
    # of the live tree has ~126k in-edges)
    for name, s_, d_, x_, y_ in (("live tree", s2, d2, x2, y2),
                                 ("Cora-shaped", s3, d3, x3, y3)):
        si = torch.from_numpy(s_).to(dev)
        di = torch.from_numpy(d_).to(dev)
        want = ps.spmm_dense_torch(si, di, x_.double(), x_.shape[0])
        ok, err, ratio = row_tolerance(y_, want, 1e-4, 1e-4)
        check(ok, f"psw_spmm {name} vs the edge oracle: max abs err {err}, "
                  f"{ratio:.2f}x the tolerance")
        log(f"  psw_spmm {name}: max abs err vs float64 edge oracle "
            f"{err:.3e}, {ratio:.3f}x the rowwise tolerance 1e-4; largest "
            f"|out| {float(want.abs().max()):.1f}")
        del si, di, want
    del h, y2, y3
    return launches, (idx.to(dev), mask.to(dev), x, int(kept.shape[0])), \
        ((s2, d2, x2), (s3, d3, x3))


def row_tolerance(got, want, rtol: float, atol: float):
    """Rowwise check for float32 sums: |got - want| <= atol + rtol * (the
    largest |want| in that row). At a hub (~126k in-edges in the live
    tree) a row's terms cancel to values near 0 in some columns, where an
    elementwise rtol * |want| holds for no float32 summation order (the
    plain version misses it against float64 too). Returns (ok, max abs
    err, worst err / tolerance)."""
    if not got.numel():
        return True, 0.0, 0.0
    want = want.double()
    err = (got.double() - want).abs()
    tol = atol + rtol * want.abs().amax(1, keepdim=True)
    ratio = float((err / tol).max())
    return ratio <= 1.0, float(err.max()), ratio


def fetched_row_bytes(idx, mask, x) -> int:
    """Bytes device memory moves to gather x's row of every live slot: it
    moves 64-byte pieces, so a row costs every piece it spans (a 400-byte
    row at a 16-byte-aligned offset spans seven)."""
    row = x.shape[1] * 4
    start = idx[mask].long() * row + x.data_ptr() % 64
    return int(((start + row - 1) // 64 - start // 64 + 1).sum()) * 64


def segment_ell_vs_plain(torch, se, se_kernel, ell, reps: int) -> dict:
    idx, mask, x, kept = ell
    N, K = idx.shape
    M, F = x.shape
    out = torch.empty((N, F), dtype=torch.float32, device=x.device)
    se_kernel.launch(idx, mask, x, out)
    plain = se.segment_ell_torch(idx, mask, x)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    check(torch.equal(out, plain),
          f"segment_ell kernel != plain version (max abs err {err})")
    del plain
    ms = cuda_ms(torch, lambda: se_kernel.launch(idx, mask, x, out), reps)
    plain_ms = cuda_ms(torch, lambda: se.segment_ell_torch(idx, mask, x),
                       max(1, reps // 4))
    w = mask.to(torch.float32)
    bag = torch.nn.functional.embedding_bag(idx.long(), x,
                                            per_sample_weights=w,
                                            mode="sum")
    torch.cuda.synchronize()
    lib_err = float((bag - out).abs().max())
    check(torch.allclose(bag, out, rtol=1e-5, atol=1e-5),
          f"embedding_bag != segment_ell kernel (max abs err {lib_err})")
    del bag
    ii = idx.long()
    library_ms = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
        ii, x, per_sample_weights=w, mode="sum"), reps)
    del ii, w
    bytes_once = N * K * 5 + M * F * 4 + N * F * 4
    gather_bytes = N * K * 5 + kept * F * 4 + N * F * 4
    ops = kept * F                     # one fp32 add per gathered element
    return {"N": N, "K": K, "F": F, "kept_edges": kept, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err,
            "bound_ms": max(bytes_once / HBM_BYTES_PER_S,
                            ops / FP32_OPS_PER_S) * 1e3,
            "bound_by": ("bytes" if bytes_once / HBM_BYTES_PER_S
                         >= ops / FP32_OPS_PER_S else "operations"),
            "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
            "gather64_bound_ms": (N * K * 5 + fetched_row_bytes(idx, mask, x)
                                  + N * F * 4) / HBM_BYTES_PER_S * 1e3,
            "bytes_once": bytes_once, "gather_bytes": gather_bytes}


def plain_f64(torch, ps, lay, x):
    """The plain version over x in float64, by column slabs that keep its
    gathered rows under ~2 GB: the sums the kernel is held to. In float32
    the plain version adds a row's terms in `index_add_`'s atomic order,
    which differs from run to run; at a 2.4M-entry hub row that rounding
    alone reached 1.12x the rowwise tolerance against the kernel in one
    run and 0.66x in another."""
    n, F = lay.n_rows, x.shape[1]
    want = torch.empty((n, F), dtype=torch.float64, device=x.device)
    w = max(1, min(F, (2 << 30) // max(1, lay.nnz * 8)))
    for a in range(0, F, w):
        want[:, a:a + w] = ps.psw_spmm_rows_torch(
            lay.row_ptr, lay.col, lay.val, x[:, a:a + w].double(), lay.block)
    return want


def psw_spmm_layout_vs_plain(torch, ps, ps_kernel, lay, x, reps: int):
    """The row-gather kernel on a prebuilt row layout against the plain
    version in float64 (rowwise 1e-5, repeat runs bitwise), with the
    float32 plain version's own error beside it, both versions timed.
    Returns (the kernel's output, the layout's shape, the errors and the
    times)."""
    n, F = lay.n_rows, x.shape[1]
    C = int(lay.chunks.shape[0])
    out = torch.empty((n, F), dtype=torch.float32, device=x.device)
    scratch = torch.empty((C, F), dtype=torch.float32, device=x.device)
    ps_kernel.launch(lay, x, out, scratch)
    want = plain_f64(torch, ps, lay, x)
    torch.cuda.synchronize()
    ok, err, ratio = row_tolerance(out, want, 1e-5, 1e-5)
    check(ok, f"psw_spmm kernel vs plain version (float64) at F={F}: max "
              f"abs err {err}, {ratio:.2f}x the tolerance")
    plain = ps.psw_spmm_rows_torch(lay.row_ptr, lay.col, lay.val, x,
                                   lay.block)
    _, plain_err, plain_ratio = row_tolerance(plain, want, 1e-5, 1e-5)
    del want, plain
    again = torch.empty_like(out)
    ps_kernel.launch(lay, x, again, scratch)
    torch.cuda.synchronize()
    check(torch.equal(out, again), "psw_spmm kernel: a second run differs")
    del again
    ms = cuda_ms(torch, lambda: ps_kernel.launch(lay, x, out, scratch), reps)
    plain_ms = cuda_ms(torch, lambda: ps.psw_spmm_rows_torch(
        lay.row_ptr, lay.col, lay.val, x, lay.block), max(1, reps // 4))
    return out, {
        "n": n, "nnz": lay.nnz, "F": F,
        "hub_rows": int(lay.hub_rows.shape[0]), "chunks": C,
        "longest_row": int((lay.row_ptr[1:] - lay.row_ptr[:-1]).max()),
        "max_abs_err": err, "err_over_tolerance": ratio,
        "plain_max_abs_err": plain_err,
        "plain_err_over_tolerance": plain_ratio, "ms": ms,
        "plain_ms": plain_ms}


def psw_spmm_rows_vs_plain(torch, ps, ps_kernel, edges, reps: int):
    """The row-gather kernel on its prebuilt row layout against the plain
    version (rowwise 1e-5, repeat runs bitwise), with times, the bound and
    the torch.sparse.mm yardstick on the same CSR, and `prepare_rows` from
    the edges timed on its own. Returns (result, layout, the kernel's
    output)."""
    src, dst, x = edges
    n, F = x.shape
    dev = x.device
    lay = ps.prepare_rows(src, dst, n, 128, device=dev)
    nnz = lay.nnz
    out, res = psw_spmm_layout_vs_plain(torch, ps, ps_kernel, lay, x, reps)
    rows_ms = cuda_ms(torch, lambda: ps.prepare_rows(src, dst, n, 128,
                                                     device=dev),
                      max(1, reps // 4))
    # yardstick: one cuSPARSE SpMM of the same CSR, multiplicities as values
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "sparse CSR is in beta"
        adj = torch.sparse_csr_tensor(lay.row_ptr, lay.col.long(), lay.val,
                                      size=(n, n))
    lib = torch.sparse.mm(adj, x)
    torch.cuda.synchronize()
    lib_ok, lib_err, _ = row_tolerance(lib, out, 1e-4, 1e-4)
    check(lib_ok, f"torch.sparse.mm vs psw_spmm kernel: max abs err "
                  f"{lib_err}")
    del lib
    library_ms = cuda_ms(torch, lambda: torch.sparse.mm(adj, x), reps)
    del adj
    # the function needs the CSR, the x rows some entry names and out moved
    # once, and one multiply-add per stored entry and column; the gathers
    # (every entry's x row) are a side figure
    csr_bytes = (n + 1) * 8 + nnz * 8
    x_rows = int(lay.col.unique().numel())
    bytes_once = csr_bytes + (x_rows + n) * F * 4
    ops = 2 * nnz * F
    return {"edges": int(src.shape[0]), "x_rows_read": x_rows, **res,
            "library_ms": library_ms,
            "library_max_abs_err": lib_err, "prepare_rows_ms": rows_ms,
            **bound(bytes_once, ops, FP32_OPS_PER_S),
            "gather_bound_ms": (csr_bytes + nnz * max(F * 4, 32)
                                + n * F * 4) / HBM_BYTES_PER_S * 1e3}, lay, out


def psw_spmm_vs_plain(torch, ps, ps_kernel, edges, reps: int) -> dict:
    """`psw_spmm_rows_vs_plain`, then the tile API: `compact_tiles` from
    the reference's host tiles (equal to `prepare_rows` bitwise) timed on
    its own, and `psw_spmm` over the tiles equal to the row kernel, with
    the dense-tile design's floor (the tiles read once) as a side
    figure."""
    src, dst, x = edges
    n, F = x.shape
    dev = x.device
    res, lay, out = psw_spmm_rows_vs_plain(torch, ps, ps_kernel, edges,
                                           reps)

    # the tile API: the reference's host tiles, compacted on the card
    coords_np, tiles_np, nb = ps.prepare_blocks(src, dst, n, 128)
    coords = torch.from_numpy(coords_np).to(dev)
    tiles = torch.from_numpy(tiles_np).to(dev)
    del coords_np, tiles_np                    # free the host copy
    T = int(coords.shape[0])
    tl = ps.compact_tiles(coords, tiles, nb, 128, nb)
    check(torch.equal(tl.row_ptr[:n + 1], lay.row_ptr)
          and torch.equal(tl.col, lay.col) and torch.equal(tl.val, lay.val)
          and torch.equal(tl.chunks, lay.chunks),
          f"compact_tiles != prepare_rows at F={F}")
    del tl
    compact_ms = cuda_ms(torch, lambda: ps.compact_tiles(coords, tiles, nb,
                                                         128, nb),
                         max(1, reps // 4))
    xp = torch.nn.functional.pad(x, (0, 0, 0, nb * 128 - n))
    tile_api = ps.psw_spmm(coords, tiles, xp, nb, 128)
    torch.cuda.synchronize()
    check(torch.equal(tile_api[:n], out) and not tile_api[n:].any(),
          f"the tile API psw_spmm != the row kernel at F={F}")
    del tile_api
    tile_api_ms = cuda_ms(torch, lambda: ps.psw_spmm(coords, tiles, xp, nb,
                                                     128), max(1, reps // 4))
    del coords, tiles, xp
    tile_bytes = T * 128 * 128 * 4
    return {**res, "compact_tiles_ms": compact_ms, "tile_api_ms": tile_api_ms,
            "tiles": T, "tile_bytes": tile_bytes,
            "tile_read_bound_ms": tile_bytes / HBM_BYTES_PER_S * 1e3}


BF16_OPS_PER_S = 989e12    # H100 SXM, dense bf16 on the tensor cores


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def first_layers(tree, n: int):
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def bound(bytes_once: float, ops: float, ops_per_s: float) -> dict:
    b, o = bytes_once / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": max(b, o) * 1e3,
            "bound_by": "bytes" if b >= o else "operations",
            "bytes_once": bytes_once, "ops": ops}


def attention_inputs(torch, tf, params, cfg, tokens):
    """Layer 0's q, k, v for `tokens`, as the prefill computes them."""
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device).expand(
        tokens.shape)
    h = tf.rms_norm(x, params["layers"]["ln1"][0].to(cfg.compute_dtype),
                    cfg.norm_eps)
    attn = {k: v[0] for k, v in params["layers"]["attn"].items()}
    return tf.qkv(attn, h, cfg, positions)


def attention_vs_plain(torch, fa, fa_kernel, q, k, v, tol: float,
                       reps: int, plain: bool = True) -> dict:
    """The kernel (causal) against its plain version on one layer's inputs,
    with times, the bound and the SDPA yardstick."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fa_kernel.launch(q, k, v, out, True)
    res = {"B": B, "S": S, "T": T, "H": H, "Hkv": Hkv, "D": D,
           "dtype": str(q.dtype).replace("torch.", "")}
    if plain:
        want = fa.flash_attention_torch(q, k, v, True)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        check(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol),
              f"flash_attention kernel vs plain {res}: max abs err {err}")
        res["max_abs_err"], res["tolerance"] = err, tol
        del want
        res["plain_ms"] = cuda_ms(torch, lambda: fa.flash_attention_torch(
            q, k, v, True), max(1, reps // 4))
    res["ms"] = cuda_ms(torch, lambda: fa_kernel.launch(q, k, v, out, True),
                        reps)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    torch.cuda.synchronize()
    lib_err = float((lib.float() - out.float()).abs().max())
    check(torch.allclose(lib.float(), out.float(), rtol=2e-2, atol=2e-2),
          f"SDPA vs flash_attention kernel {res}: max abs err {lib_err}")
    del lib
    res["library_ms"] = cuda_ms(torch, lambda: sdpa(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps)
    res["library_max_abs_err"] = lib_err
    pairs = sum(min(s + 1, T) for s in range(S))   # visible (query, key)
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    res.update(bound(q.element_size() * (2 * B * S * H * D
                                         + 2 * B * T * Hkv * D),
                     4 * B * H * D * pairs, peak))
    res["tflops_per_s"] = res["ops"] / (res["ms"] * 1e-3) / 1e12
    return res


def decode_ops(torch, tf, params, cfg, batch: int, dev) -> int:
    """The aten ops one decode step dispatches (TorchDispatchMode): each is
    a host-side call, most of them a kernel launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    toks = torch.ones((batch, 16), dtype=torch.long, device=dev)
    with torch.no_grad():
        logits, cache = tf.prefill(params, toks, cfg, 17)
        with Count():
            tf.decode_step(params, cache, logits.argmax(-1)[:, None], 16, cfg)
    return Count.n


class plain_attention:
    """Prefill attention through the kernel's plain version: the model's
    module-level name swapped for the duration (the check's reference)."""

    def __init__(self, tf, fa):
        self.tf, self.fa = tf, fa

    def __enter__(self):
        self.real = self.tf.flash_attention
        self.tf.flash_attention = (
            lambda q, k, v, causal=True:
            self.fa.flash_attention_torch(q, k, v, causal))

    def __exit__(self, *exc):
        self.tf.flash_attention = self.real


def phase_serve(torch, dev, cfg, args, clock, fa_kernel):
    """LM serving at `cfg` through `serve_requests`, then the checks:
    (i) the kernel against its plain version on layer 0's q/k/v at the
    serve shape, bf16 and fp32, with the SDPA yardstick (and at 32k tokens,
    and at qwen3-14b's D = 128 heads);
    (ii) a 2-layer fp32 cut of the model, prefill through the kernel against
    prefill through the plain version, decode against forward;
    (iii) the share of greedy tokens the plain path agrees with."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as tf
    log(f"phase 7 LM serving: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, kv {cfg.n_kv_heads}, d_head {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 20)
    params = clock("init_params (fp32, on the device)", tf.init_params, cfg,
                   gen, dev)
    n = sum(t.numel() for t in leaves(params))
    check(n == cfg.n_params, f"{n} params, config says {cfg.n_params}")
    R, P, G = args.lm_requests, args.prompt_len, args.gen
    prompts = np.random.default_rng(args.seed + 21).integers(
        1, cfg.vocab_size, (R, P))
    torch.cuda.reset_peak_memory_stats()
    fa.ops.launches = 0                        # the serving path...
    tokens, stats = clock(f"serve_requests ({R} requests of {P} tokens, "
                          f"batch {args.lm_batch}, {G} generated)",
                          serve_requests, params, cfg, prompts,
                          args.lm_batch, G, dev)
    launches = fa.ops.launches                 # ...ends here
    check(launches == cfg.n_layers * len(stats),
          f"{launches} flash_attention launches for {len(stats)} prefills "
          f"of {cfg.n_layers} layers")
    check(tokens.shape == (R, G) and tokens.min() >= 0
          and tokens.max() < cfg.padded_vocab, "serve_requests: bad tokens")
    cache_gib = (2 * cfg.n_layers * args.lm_batch * (P + G) * cfg.n_kv_heads
                 * cfg.head_dim * 2 / 2**30)
    batches = [{**s, "decode_ms_per_token": s["decode_s"] / max(G - 1, 1)
                * 1e3, "tokens_per_s": s["requests"] * G / s["latency_s"]}
               for s in stats]
    for s in batches:
        log(f"  batch of {s['requests']}: prefill {s['prefill_s']:.3f} s, "
            f"decode {s['decode_ms_per_token']:.2f} ms/token, "
            f"{s['tokens_per_s']:.1f} tokens/s, latency "
            f"{s['latency_s']:.3f} s")
    log(f"  {n} params ({n * 4 / 1e9:.2f} GB fp32, bf16 serving copy), "
        f"KV cache {cache_gib:.3f} GiB per batch, {launches} flash_attention "
        f"launches ({cfg.n_layers} per prefill), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # (i) the kernel on layer 0's q/k/v at the serve shape
    served = tf.cast_params(params, cfg)
    toks = torch.from_numpy(prompts[:args.lm_batch]).to(dev)
    q, k, v = attention_inputs(torch, tf, served, cfg, toks)
    serve_bf16 = attention_vs_plain(torch, fa, fa_kernel, q, k, v, 2e-2,
                                    args.reps)
    log("  kernel vs plain, serve shape: " + json.dumps(serve_bf16))
    q, k, v = (t.float() for t in (q, k, v))
    serve_fp32 = attention_vs_plain(torch, fa, fa_kernel, q, k, v, 2e-5,
                                    max(2, args.reps // 4))
    log("  kernel vs plain, serve shape fp32: " + json.dumps(serve_fp32))
    del q, k, v
    toks = torch.from_numpy(np.random.default_rng(args.seed + 22).integers(
        1, cfg.vocab_size, (1, args.long_prompt))).to(dev)
    q, k, v = attention_inputs(torch, tf, served, cfg, toks)
    long_bf16 = attention_vs_plain(torch, fa, fa_kernel, q, k, v, 2e-2,
                                   max(2, args.reps // 4), plain=False)
    log(f"  kernel vs SDPA, {args.long_prompt} tokens: "
        + json.dumps(long_bf16))
    del q, k, v
    # qwen3-14b's heads (H 40, Hkv 8, D 128): the D = 128 template at
    # S = T = 4,096, batch 1, on random inputs at the scale of layer 0's
    from repro_torch.configs import get_arch
    wide = get_arch("qwen3-14b").config
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 24)
    q, k, v = (torch.randn((1, args.prompt_len, h, wide.head_dim),
                           generator=gen, device=dev).to(torch.bfloat16)
               for h in (wide.n_heads, wide.n_kv_heads, wide.n_kv_heads))
    d128_bf16 = attention_vs_plain(torch, fa, fa_kernel, q, k, v, 2e-2,
                                   args.reps)
    log("  kernel vs plain, qwen3-14b heads (D 128): "
        + json.dumps(d128_bf16))
    del q, k, v
    n_ops = decode_ops(torch, tf, served, cfg, args.lm_batch, dev)
    del served
    log(f"  one decode step dispatches {n_ops} aten ops "
        f"({n_ops / cfg.n_layers:.1f} per layer)")

    # (ii) two layers at the full width, fp32: kernel against plain prefill,
    # decode against forward
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype=torch.float32)
    p2 = {**params, "layers": first_layers(params["layers"], 2)}
    S2, steps = 256, 8
    toks = torch.from_numpy(np.random.default_rng(args.seed + 23).integers(
        1, cfg.vocab_size, (2, S2 + steps))).to(dev)
    with torch.no_grad():
        full, _ = tf.forward(p2, toks, cfg2)
        lk, cache = tf.prefill(p2, toks[:, :S2], cfg2, S2 + steps,
                               cache_dtype=torch.float32)
        with plain_attention(tf, fa):
            lp, _ = tf.prefill(p2, toks[:, :S2], cfg2, S2 + steps,
                               cache_dtype=torch.float32)
        errs = {"prefill_kernel_vs_plain": float((lk - lp).abs().max()),
                "prefill_vs_forward": float((lk - full[:, S2 - 1]).abs().max())}
        check(torch.allclose(lk, lp, rtol=1e-4, atol=1e-4)
              and torch.allclose(lk, full[:, S2 - 1], rtol=1e-4, atol=1e-4),
              f"2-layer fp32 prefill logits: {errs}")
        dec = 0.0
        for i in range(S2, S2 + steps):
            lg, cache = tf.decode_step(p2, cache, toks[:, i:i + 1], i, cfg2)
            check(torch.allclose(lg, full[:, i], rtol=1e-4, atol=1e-4),
                  f"decode logits at {i} vs forward: max abs err "
                  f"{float((lg - full[:, i]).abs().max())}")
            dec = max(dec, float((lg - full[:, i]).abs().max()))
        errs["decode_vs_forward"] = dec
    log("  2-layer fp32 logits (limit 1e-4): " + json.dumps(errs))
    del p2, full, cache

    # (iii) greedy tokens of the first batch through the plain attention
    with plain_attention(tf, fa):
        plain_tokens, _ = serve_requests(params, cfg,
                                         prompts[:args.lm_batch],
                                         args.lm_batch, G, dev)
    agree = float((plain_tokens == tokens[:args.lm_batch]).mean())
    log(f"  greedy tokens of batch 1 equal on the kernel and plain paths: "
        f"{agree:.4f} (not a gate)")
    del params
    return launches, serve_bf16, [serve_bf16, serve_fp32, long_bf16,
                                   d128_bf16], {
        "batches": batches, "kv_cache_gib": cache_gib, "logit_errs": errs,
        "greedy_agreement": agree, "decode_aten_ops": n_ops}


def history_bags(n_bags: int, k_slots: int, n_items: int, seed: int):
    """bert4rec serving histories: item ids half zipf(1.8)-hot, half uniform
    over 1..n_items (power_law_graph's destination skew), lengths uniform
    in 1..k_slots, left-padded with item 0 and weight 0."""
    rng = np.random.default_rng(seed)
    _, items = power_law_graph(n_items, n_bags * k_slots, seed=seed)
    lens = rng.integers(1, k_slots + 1, n_bags)
    real = np.arange(k_slots)[None, :] >= (k_slots - lens)[:, None]
    idx = np.where(real, items.reshape(n_bags, k_slots) + 1, 0)
    return idx.astype(np.int32), real.astype(np.float32)


def bag_oracle(idx, w, table, mode: str) -> np.ndarray:
    """float64 numpy bag sums (or means), 1,024 bags at a time."""
    out = np.empty((idx.shape[0], table.shape[1]))
    for i in range(0, idx.shape[0], 1024):
        ii, ww = idx[i:i + 1024], w[i:i + 1024].astype(np.float64)
        out[i:i + 1024] = np.einsum("bk,bkd->bd", ww, table[ii])
    if mode == "mean":
        out /= np.maximum(w.sum(1, dtype=np.float64), 1e-9)[:, None]
    return out


def bag_inputs(torch, dev, args):
    """Phase 8's inputs: bert4rec's item table made on the card from
    --seed, and --bags left-padded histories of 200 slots (host numpy)."""
    V, D, K = 1_000_192, 64, 200               # bert4rec padded_vocab, d, seq
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 30)
    table = torch.randn((V, D), generator=gen, device=dev).mul_(0.02)
    idx_np, w_np = history_bags(args.bags, K, 1_000_000, args.seed + 31)
    return table, idx_np, w_np


def bags_rows_read(w) -> int:
    """Rows the kernel reads on left-padded histories: every slot of
    weight != 0, and the padding row once a padded bag."""
    return int((w != 0).sum()) + int((w == 0).any(1).sum())


def bag_checks(torch, eb, table, idx, w) -> dict:
    """The id check and the exact skip of weight-0 rows: at B = 64 an id
    of V and one of -1 must raise ValueError and a later call must be
    bitwise equal again; at B = 64 and 4,096 (few and many warps a SM:
    the kernel's two depths of loads in flight) a padding row holding inf
    or NaN must give the plain version's NaN columns."""
    B, V = 64, table.shape[0]
    i, ww = idx[:B], w[:B]
    for bad_id in (V, -1):
        bad = i.clone()
        bad[B // 2, -1] = bad_id
        try:
            eb.embedding_bag(bad, ww, table)
            fail(f"embedding_bag took id {bad_id} of a {V}-row table")
        except ValueError:
            pass
    check(torch.equal(eb.embedding_bag(i, ww, table),
                      eb.embedding_bag_torch(i, ww, table)),
          "embedding_bag after a refused call != plain version")
    nan_cols = {}
    for nb in (B, 4096):
        i, ww = idx[:nb], w[:nb]
        for poison in (float("inf"), float("nan")):
            t = table[:1000].clone()
            t[0, ::2] = poison                 # the padding row
            j = torch.where(ww == 0, i, i % 1000)
            got = eb.embedding_bag(j, ww, t)
            want = eb.embedding_bag_torch(j, ww, t)
            nan = want.isnan()
            check(bool(nan.any()) and torch.equal(got.isnan(), nan)
                  and torch.equal(got[~nan], want[~nan]),
                  f"embedding_bag B={len(i)} with a {poison} padding row "
                  "!= plain version")
            nan_cols[f"B={len(i)} {poison}"] = int(nan.sum())
    return {"B": B, "refused_ids": [V, -1], "nan_entries": nan_cols}


def phase_bags(torch, dev, args, clock, eb_kernel):
    """Pooled lookups at bert4rec's serving shape through `embedding_bag`,
    then each result against its plain version (bitwise) and float64
    numpy, with the kernel's and the wrapper's times (the wrapper reads
    the kernel's error word back: a sync), bound and the F.embedding_bag
    yardstick; then the id check and non-finite padding at a small B."""
    from repro_torch.kernels import embedding_bag as eb
    table, idx_np, w_np = clock(f"bag inputs ({args.bags} histories)",
                                bag_inputs, torch, dev, args)
    (V, D), K = table.shape, idx_np.shape[1]
    log(f"phase 8 pooled lookups: table {V} x {D} fp32, histories of {K}")
    idx, w = torch.from_numpy(idx_np).to(dev), torch.from_numpy(w_np).to(dev)
    runs = [(B, mode) for B in (args.bags, 512) for mode in ("sum", "mean")]
    eb.ops.launches = 0                        # the lookup path...
    outs = {r: eb.embedding_bag(idx[:r[0]], w[:r[0]], table, mode=r[1])
            for r in runs}
    torch.cuda.synchronize()
    launches = eb.ops.launches                 # ...ends here
    check(launches == len(runs), f"{launches} embedding_bag launches for "
                                 f"{len(runs)} calls")
    table_np = table.cpu().numpy()
    results = []
    for (B, mode), got in outs.items():
        i, ww = idx[:B], w[:B]
        plain_sum = eb.embedding_bag_torch(i, ww, table)
        want = plain_sum if mode == "sum" else plain_sum / torch.clamp_min(
            ww.sum(1, keepdim=True), 1e-9)
        check(torch.equal(got, want),
              f"embedding_bag B={B} {mode}: kernel != plain version")
        ref = bag_oracle(idx_np[:B], w_np[:B], table_np, mode)
        err = float(np.abs(got.cpu().numpy() - ref).max())
        check(err <= 1e-5, f"embedding_bag B={B} {mode} vs float64: {err}")
        out = torch.empty((B, D), device=dev)
        err_word = torch.zeros(1, dtype=torch.int32, device=dev)
        res = {"B": B, "K": K, "D": D, "mode": mode,
               "max_abs_err": float((got - want).abs().max()),
               "max_abs_err_vs_float64": err,
               "ms": cuda_ms(torch, lambda: eb_kernel.launch(
                   i, ww, table, out, err_word), args.reps),
               "graph_ms": graph_ms(torch, lambda: eb_kernel.launch(
                   i, ww, table, out, err_word), args.reps),
               "wrapper_ms": cuda_ms(torch, lambda: eb.embedding_bag(
                   i, ww, table, mode=mode), args.reps),
               "plain_ms": cuda_ms(torch, lambda: eb.embedding_bag_torch(
                   i, ww, table), max(1, args.reps // 4))}
        check(err_word.tolist() == [0] and torch.equal(out, plain_sum),
              f"embedding_bag B={B}: kernel after timing != plain version "
              f"(error word {err_word.tolist()})")
        # yardstick: F.embedding_bag's weighted sum (no weighted mean there)
        ii = i.long()
        lib = torch.nn.functional.embedding_bag(ii, table,
                                                per_sample_weights=ww,
                                                mode="sum")
        res["library_max_abs_err"] = float((lib - plain_sum).abs().max())

        def library():
            torch.nn.functional.embedding_bag(ii, table,
                                              per_sample_weights=ww,
                                              mode="sum")

        res["library_ms"] = cuda_ms(torch, library, args.reps)
        res["library_graph_ms"] = graph_ms(torch, library, args.reps)
        distinct = int(torch.unique(i).numel())
        res.update(bound(distinct * D * 4 + B * K * 8 + B * D * 4,
                         2 * B * K * D, FP32_OPS_PER_S))
        res["distinct_rows"] = distinct
        res["rows_read"] = bags_rows_read(ww)
        res["gather_bound_ms"] = (B * K * D * 4 + B * K * 8 + B * D * 4) \
            / HBM_BYTES_PER_S * 1e3
        results.append(res)
        log(f"  B={B} {mode}: " + json.dumps(res))
        del ii, lib, want, plain_sum
    log(f"  {launches} embedding_bag launches; every result bitwise equal to "
        "the plain version and within 1e-5 of float64 numpy")
    log("  id check and non-finite padding: "
        + json.dumps(bag_checks(torch, eb, table, idx, w)))
    del table, outs
    return launches, results


def pin_mmap_threshold() -> bool:
    """benchmarks/bench_disk.py's pin: glibc's dynamic M_MMAP_THRESHOLD
    keeps freed multi-MB merge scratch in the heap (RSS that has nothing to
    do with the storage tier); pinned, large temporaries come from and
    return to mmap. It stays pinned for the rest of the run."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        return libc.mallopt(-3, 256 * 1024) == 1  # M_MMAP_THRESHOLD
    except OSError:
        return False


def peak_rss_bytes() -> int:
    """Peak RSS so far, as bench_disk reads it (ru_maxrss is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def current_rss_bytes() -> int:
    """VmRSS from `/proc/self/status`, in bytes."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return -1


def filesystem_of(path: str) -> str:
    """The type and mount point of the filesystem holding `path`."""
    path, best = os.path.realpath(path), ("", "unknown")
    with open("/proc/mounts") as fh:
        for line in fh:
            mnt, fstype = line.split()[1:3]
            mnt = mnt.replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return f"{best[1]} at {best[0]}"


def disk_probes_ok(db, probes) -> bool:
    """bench_disk's probe check: every kept (s, d) edge is in s's
    out-neighbours and d's in-neighbours, through the batched engine."""
    eng = db.storage_engine()
    ps_ = np.asarray([s for s, _ in probes], np.int64)
    pd_ = np.asarray([d for _, d in probes], np.int64)
    vals, offs = eng.out_neighbors_batch(ps_)
    ok_out = all(pd_[i] in vals[offs[i]:offs[i + 1]] for i in range(len(ps_)))
    vals, offs = eng.in_neighbors_batch(pd_)
    ok_in = all(ps_[i] in vals[offs[i]:offs[i + 1]] for i in range(len(pd_)))
    return ok_out and ok_in


def same_coo(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def phase_disk(torch, core, fe_ops, ps, dev, args, clock) -> dict:
    """Phase 9, the disk tier, at benchmarks/bench_disk.py's scale-1.0
    configuration (--disk-budget-mb sets the budget and with it the edge
    count). Steps a-c and e-g run in the letters' order; d, the crash
    recovery, runs last, so that the store of e-g is the one whose
    out-of-core ranks step b computed. Returns the disk path's kernel
    launches."""
    import shutil
    budget = int(args.disk_budget_mb * 1e6)
    rss_limit = max(96_000_000, budget)        # bench_disk's floor
    n_edges = int(4.2 * budget / 41)           # ~41 bytes an edge on disk
    max_id = max(100_000, n_edges // 30)
    chunk = 100_000
    max_part = max(50_000, int(budget / (30 * 41)))
    work = os.path.join(ROOT, "build", "disk_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dbdir, crash_dir = os.path.join(work, "db"), os.path.join(work, "crash")
    log(f"phase 9 the disk tier: bench_disk.py's configuration, a "
        f"{budget / 1e6:.0f} MB budget, {n_edges} edges over {max_id} "
        f"vertex ids; the store on {filesystem_of(work)}")
    pinned = pin_mmap_threshold()
    # a baseline peak above the current RSS would hide growth up to the
    # difference from the delta: both are logged
    base_peak, base_now = peak_rss_bytes(), current_rss_bytes()
    log(f"  baseline RSS {base_now / 1e6:.1f} MB (peak so far "
        f"{base_peak / 1e6:.1f} MB); M_MMAP_THRESHOLD pinned: {pinned}")

    # a. build
    rng = np.random.default_rng(7)
    probes = []
    db = core.GraphDB.create(
        dbdir, max_id=max_id - 1, n_partitions=64, n_levels=3, branching=4,
        buffer_cap=min(chunk, max_part // 2), max_partition_edges=max_part,
        persist_min_edges=4096, resident_budget_bytes=budget // 8)

    def build():
        inserted = 0
        while inserted < n_edges:
            m = min(chunk, n_edges - inserted)
            src = rng.integers(0, max_id, m)
            dst = rng.integers(0, max_id, m)
            db.insert_edges(src, dst)
            if len(probes) < 500:
                probes.extend(zip(src[:25].tolist(), dst[:25].tolist()))
            inserted += m
            if inserted % (chunk * 10) == 0:
                db.checkpoint()
        db.checkpoint()

    clock("9a build", build)
    parts = db._disk_partitions()
    on_disk = sum(p.nbytes() for p in parts)
    resident = db.resident_nbytes()
    rss_a = peak_rss_bytes() - base_peak
    res = {"budget_bytes": budget, "n_edges": int(db.n_edges),
           "disk_partitions": len(parts), "on_disk_bytes": on_disk,
           "resident": resident, "peak_rss_delta_build": rss_a}
    del parts
    log(f"  9a: {db.n_edges} edges, {res['disk_partitions']} disk "
        f"partitions, {on_disk} bytes on disk ({on_disk / budget:.2f}x the "
        f"budget), pinned index {resident['pinned_index']} bytes, peak RSS "
        f"delta {rss_a / 1e6:.1f} MB")
    check(on_disk >= 4 * budget,
          f"9a: {on_disk} bytes on disk, under 4x the {budget}-byte budget")

    # b. out-of-core PageRank
    db.evict()
    ranks = clock("9b pagerank_out_of_core (5 iterations)",
                  core.pagerank_out_of_core, db.tree, n_iters=5,
                  evict_each=True)
    rss_ab = peak_rss_bytes() - base_peak
    res["peak_rss_delta"] = rss_ab
    res["peak_rss_over_current_baseline"] = peak_rss_bytes() - base_now
    log(f"  9b: rank sum {float(ranks.sum()):.1f}; peak RSS delta of a and "
        f"b {rss_ab / 1e6:.1f} MB against {rss_limit / 1e6:.0f} MB (over "
        f"the baseline's current RSS: "
        f"{res['peak_rss_over_current_baseline'] / 1e6:.1f} MB)")
    check(bool(np.all(np.isfinite(ranks))), "9b: non-finite ranks")
    check(rss_ab <= rss_limit,
          f"9b: peak RSS delta {rss_ab} bytes over the {rss_limit}-byte "
          "budget")

    # c. close and reopen
    before = db.to_coo()
    clock("9c close", db.close)
    db = clock("9c GraphDB.open", core.GraphDB.open, dbdir)
    check(same_coo(db.to_coo(), before), "9c: to_coo changed across reopen")
    check(disk_probes_ok(db, probes), "9c: a probe edge is missing")
    log(f"  9c: reopened bitwise ({before[0].shape[0]} edges), "
        f"{len(probes)} probe edges found both ways")
    del before

    # e. dense queries on the card over the reopened store
    seeds = np.random.default_rng(args.seed + 20).choice(max_id, 256,
                                                         replace=False)
    clock("9e dense_plan of the store (edge keys from the memmaps, the plan "
          "on the card)", core.dense_plan, db, "out", device=dev)
    fe_ops.launches = 0                        # the disk path's hops...
    dense = clock("9e two_hop_counts dense (256 seeds)", core.two_hop_counts,
                  db, seeds, dense="kernel", device=dev)
    kd = clock("9e khop dense k=3 (64 seeds)", core.khop, db, seeds[:64], 3,
               dense="kernel", device=dev)
    fe_launches = fe_ops.launches              # ...end here
    check(fe_launches > 0, "9e: the disk path launched no frontier_expand")
    sparse = clock("9e two_hop_counts sparse (256 seeds)",
                   core.two_hop_counts, db, seeds, dense="never")
    ks = clock("9e khop sparse k=3 (64 seeds)", core.khop, db, seeds[:64], 3,
               dense="never")
    check(same_two_hop(dense, sparse), "9e two_hop_counts: dense != sparse")
    check(same_levels(kd, ks), "9e khop: dense != sparse")
    src, dst = db.to_coo()
    pal = clock("9e GraphPAL.from_edges of to_coo()", core.GraphPAL.from_edges,
                src, dst, n_partitions=64, max_id=max_id - 1)
    check(same_two_hop(core.two_hop_counts(pal, seeds, dense="kernel",
                                           device=dev), dense),
          "9e two_hop_counts: the store != its GraphPAL")
    check(same_levels(core.khop(pal, seeds[:64], 3, dense="kernel",
                                device=dev), kd),
          "9e khop: the store != its GraphPAL")
    log(f"  9e: two_hop {dense.ids.shape[0]} pairs, khop levels "
        f"{[int(lv.shape[0]) for lv in kd.levels]}; dense == sparse == the "
        f"GraphPAL's, bitwise; {fe_launches} frontier_expand launches")
    del dense, sparse, kd, ks

    # f. PSW on the card
    dg = clock("9f GraphDB.snapshot", db.snapshot, device=dev)
    dg_pal = clock("9f build_device_graph(GraphPAL)", core.build_device_graph,
                   pal, device=dev)
    check(same_device_graph(torch, dg, dg_pal),
          "9f: the snapshot != the GraphPAL's DeviceGraph")
    del dg_pal, pal
    pr = {mode: clock(f"9f pagerank_device {mode} (5 iterations)",
                      core.pagerank_device, dg, 5, mode=mode)
          for mode in PR_MODES}
    check(torch.equal(pr["dense_gather"], pr["psw_windows"]),
          "9f pagerank_device: dense_gather != psw_windows")
    got = pr["dense_gather"].reshape(-1).double().cpu().numpy()
    err = float(np.abs(got - ranks).max())
    check(bool(np.allclose(got, ranks, rtol=1e-4, atol=1e-4)),
          f"9f: snapshot PageRank vs out-of-core: max abs err {err}")
    res["pagerank_max_abs_err_vs_out_of_core"] = err
    log(f"  9f: snapshot bitwise equal to the GraphPAL's in every array "
        f"({dg.n_edges} edges, {dg_bytes(dg) / 2**30:.2f} GiB); PageRank "
        f"modes bitwise equal, max abs err vs step b's out-of-core ranks "
        f"{err:.3e} (rtol/atol 1e-4)")
    del dg, pr, got

    # g. aggregation
    x = randn(torch, (max_id, 128), dev, args.seed + 21)
    ps.ops.launches = 0                        # the disk path's aggregation...
    y = clock("9g psw_spmm_edges over the store's edges (F=128)",
              ps.psw_spmm_edges, src, dst, x, max_id)
    ps_launches = ps.ops.launches              # ...ends here
    check(ps_launches > 0, "9g: the disk path launched no psw_spmm")
    si, di = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    del src, dst
    for oracle, tol in ((x, 1e-5), (x.double(), 1e-4)):
        want = ps.spmm_dense_torch(si, di, oracle, max_id)
        ok, err, ratio = row_tolerance(y, want, tol, tol)
        check(ok, f"9g psw_spmm vs the {want.dtype} edge oracle: max abs err "
                  f"{err}, {ratio:.2f}x the rowwise tolerance {tol}")
        res[f"psw_spmm_max_abs_err_vs_{str(want.dtype)[6:]}"] = err
        del want
    log(f"  9g: psw_spmm within rowwise 1e-5 of the float32 edge oracle "
        f"(max abs err {res['psw_spmm_max_abs_err_vs_float32']:.3e}) and "
        f"1e-4 of float64 ({res['psw_spmm_max_abs_err_vs_float64']:.3e}); "
        f"{ps_launches} psw_spmm launches")
    del x, y, si, di

    # d. crash recovery (bench_disk.py's)
    s2, d2 = rng.integers(0, max_id, 20_000), rng.integers(0, max_id, 20_000)
    n_before = db.n_edges
    db.insert_edges(s2, d2)
    acked = db.n_edges
    live = db.to_coo()
    db.tree.wal_flush()
    shutil.copytree(dbdir, crash_dir)
    db.close()
    db = clock("9d GraphDB.open of the copy (WAL tail replayed)",
               core.GraphDB.open, crash_dir)
    check(acked == n_before + 20_000 and db.n_edges == acked,
          f"9d: {db.n_edges} edges recovered of {acked} acknowledged")
    check(same_coo(db.to_coo(), live), "9d: to_coo differs after recovery")
    log(f"  9d: {acked} acknowledged edges recovered bitwise from a copy "
        "taken while the store was live")
    db.close()
    del live, db
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {"frontier_expand": fe_launches, "psw_spmm": ps_launches}
    log("disk path: " + json.dumps(launches) + " launches; "
        + json.dumps(res))
    return launches


# benchmarks/bench_shard.py's per-store configuration (`_db_kw`)
SERVICE_DB_KW = dict(n_partitions=8, n_levels=2, branching=8,
                     buffer_cap=50_000, max_partition_edges=16_000_000,
                     persist_min_edges=4096, checkpoint_interval_ops=10 ** 9,
                     wal_tail_budget_bytes=1 << 40)
# benchmarks/bench_chaos.py's request budgets and its client-side slack for
# "completed past the deadline without a typed error"
READ_DEADLINE_S, INSERT_DEADLINE_S, LATE_TOL_S = 0.25, 1.0, 0.025
FRONTDESK_REQUESTS = 4_000


def service_op_prefix(n_vertices: int, n_edges: int):
    """benchmarks/bench_shard.py's `_op_prefix` at its batch size: the
    power-law edges of seed 8 in 16 insert batches, then 50 deletes of
    edges known to be present."""
    batch = max(10_000, n_edges // 16)
    src, dst = power_law_graph(n_vertices, n_edges, seed=8)
    batches = [(src[i:i + batch], dst[i:i + batch])
               for i in range(0, n_edges, batch)]
    deletes = [(int(src[i]), int(dst[i]))
               for i in range(0, min(n_edges, 50 * 97), 97)]
    return batches, deletes


def ingest(store, batches, deletes) -> None:
    for s, d in batches:
        store.insert_edges(s, d)
    for s, d in deletes:
        store.delete_edge(s, d)


def quiesce(svc, timeout_s: float = 120.0) -> None:
    """benchmarks/bench_service.py's `_quiesce`: wait until the
    maintenance pipeline has drained the backlog."""
    t_end = time.perf_counter() + timeout_s
    while ((svc.tree.total_buffered() > svc.tree.buffer_cap
            or svc.tree.inflight_edges()) and time.perf_counter() < t_end):
        time.sleep(0.02)


def percentiles(ms) -> dict:
    if not ms:
        return {"n": 0}
    a = np.asarray(ms, np.float64)
    return {"n": int(a.size), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


class PlanBuilds:
    """Counts and times the dense plan's builds from any thread
    (`build_frontier_plan`, on the card), wrapped where
    `multihop.dense_plan` imports it at call time. `restore()` puts the
    original back."""

    def __init__(self, fe):
        self.fe, self.lock = fe, threading.Lock()
        self.orig = fe.build_frontier_plan
        self.builds, self.build_s = 0, 0.0
        fe.build_frontier_plan = self._timed

    def _timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = self.orig(*a, **kw)
        with self.lock:
            self.build_s += time.perf_counter() - t0
            self.builds += 1
        return out

    def restore(self) -> None:
        self.fe.build_frontier_plan = self.orig


def timed(torch, dev, fn, *a, **kw):
    """(result, host seconds ending in a synchronize of `dev`)."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def service_reads(torch, core, svc, dev, n_vertices, n_write, seed):
    """Step 10b, as bench_service.py's `contended` section: a writer
    thread streams `n_write` power-law edges (seed 9) in 10,000-edge
    batches, paced at bench_service's 60,000 edges/s, while the
    maintenance pipeline merges; two reader threads each pin a
    `read_view()` and run dense `two_hop_counts` (256 seeds) and `khop`
    (64 seeds, k = 3) on the card, each checked bitwise against the sparse
    host path on the same view. The readers pin a first view before the
    writer starts and a second after it has written half its edges; each
    half of the writes starts as the readers pin, so both rounds' queries
    run while it writes."""
    ws, wd = power_law_graph(n_vertices, n_write, seed=9)
    step, rate = 10_000, 60_000
    barrier = threading.Barrier(3, timeout=900)
    half_written = threading.Event()
    errors, rounds, writes = [], [], []

    def writer():
        try:
            cut = (n_write // step // 2) * step
            for lo, hi in ((0, cut), (cut, n_write)):
                barrier.wait()
                t0 = time.perf_counter()
                for i in range(lo, hi, step):
                    svc.insert_edges(ws[i:min(i + step, hi)],
                                     wd[i:min(i + step, hi)])
                    ahead = (min(i + step, hi) - lo) / rate - (
                        time.perf_counter() - t0)
                    if ahead > 0:
                        time.sleep(ahead)
                writes.append((t0, time.perf_counter(), hi - lo))
                half_written.set()
        except threading.BrokenBarrierError:
            pass
        except Exception as exc:  # noqa: BLE001 - reported by the caller
            errors.append(f"writer: {exc!r}")
            barrier.abort()

    def reader(i):
        rng = np.random.default_rng(seed + i)
        seeds = rng.choice(n_vertices, 256, replace=False)
        try:
            for rnd in range(2):
                if rnd:
                    half_written.wait(900)
                with svc.read_view() as view:
                    barrier.wait()
                    rec = {"reader": i, "round": rnd,
                           "version": int(view.version),
                           "n_edges": int(view.n_edges)}
                    t0 = time.perf_counter()
                    _, rec["plan_s"] = timed(torch, dev, core.dense_plan,
                                             view, "out", device=dev)
                    d2, rec["two_hop_dense_s"] = timed(
                        torch, dev, core.two_hop_counts, view, seeds,
                        dense="kernel", device=dev)
                    dk, rec["khop_dense_s"] = timed(
                        torch, dev, core.khop, view, seeds[:64], 3,
                        dense="kernel", device=dev)
                    rec["dense_window"] = (t0, time.perf_counter())
                    s2, rec["two_hop_sparse_s"] = timed(
                        torch, dev, core.two_hop_counts, view, seeds)
                    sk, rec["khop_sparse_s"] = timed(
                        torch, dev, core.khop, view, seeds[:64], 3)
                rec["pairs"] = int(d2.ids.shape[0])
                rec["khop_levels"] = [int(lv.shape[0]) for lv in dk.levels]
                rec["bitwise"] = bool(same_two_hop(d2, s2)
                                      and same_levels(dk, sk))
                rounds.append(rec)
        except threading.BrokenBarrierError:
            errors.append(f"reader {i}: the barrier broke")
        except Exception as exc:  # noqa: BLE001 - reported by the caller
            errors.append(f"reader {i}: {exc!r}")
            barrier.abort()
            half_written.set()

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader, args=(i,)) for i in range(2)]
    flushes0 = svc.stats.flushes
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, "10b: " + "; ".join(errors))
    check(len(rounds) == 4 and all(r["bitwise"] for r in rounds),
          "10b: a dense answer on a live view != the sparse host path: "
          + json.dumps([{k: r[k] for k in ("reader", "round", "bitwise")}
                        for r in rounds]))
    by_round = [sorted({r["version"] for r in rounds if r["round"] == k})
                for k in range(2)]
    check(min(by_round[1]) > max(by_round[0]),
          f"10b: the second views {by_round[1]} are not later publications "
          f"than the first {by_round[0]}")
    busy = sum(t1 - t0 for t0, t1, _ in writes)
    for r in rounds:                      # dense seconds overlapping writes
        a, b = r.pop("dense_window")
        r["dense_s_while_writing"] = sum(max(0.0, min(b, t1) - max(a, t0))
                                         for t0, t1, _ in writes)
    return {"writer_edges": n_write,
            "writer_edges_per_s": n_write / busy if busy else None,
            "flushes_during": svc.stats.flushes - flushes0,
            "publications_served_dense": sorted(
                {r["version"] for r in rounds}),
            "rounds": rounds}


def frontdesk_clients(core, data, fd, n_vertices, n_requests, seed):
    """Step 10c's traffic: the edge part of the LinkBench mix
    (`edge_outnbrs` -> out_neighbors, `edge_getrange` -> getrange,
    `edge_insert_or_update` -> insert) with a fof request after every 19,
    from 8 closed-loop client threads, each request under bench_chaos.py's
    budget. Classified as there; a result delivered past its deadline by
    more than LATE_TOL_S without a typed error is counted as late."""
    ops = {"edge_outnbrs": "out_neighbors", "edge_getrange": "getrange",
           "edge_insert_or_update": "insert"}
    wl = data.LinkBenchWorkload(data.LinkBenchConfig(n_vertices=n_vertices,
                                                     seed=seed))
    reqs = []
    for r in wl.requests(4 * n_requests):
        if r["op"] in ops:
            reqs.append((ops[r["op"]], r["u"], r.get("v")))
            if len(reqs) % 20 == 19:
                reqs.append(("fof", r["v"], None))
        if len(reqs) >= n_requests:
            break
    lock = threading.Lock()
    tally = {"ok": 0, "typed_deadline": 0, "late_untyped": 0,
             "other_errors": [], "sheds": {}, "by_op": {}}
    lat_ms = {}

    def client(part):
        mine = []
        for op, u, v in part:
            budget = INSERT_DEADLINE_S if op == "insert" else READ_DEADLINE_S
            dl = core.Deadline.after(budget)
            t0 = time.perf_counter()
            outcome = "ok"
            try:
                if op == "insert":
                    fut = fd.submit("insert", deadline=dl,
                                    src=np.asarray([u], np.int64),
                                    dst=np.asarray([v], np.int64))
                else:
                    fut = fd.submit(op, deadline=dl, v=u)
                fut.result(timeout=120)
            except core.OverloadError as exc:
                outcome = "shed:" + exc.reason
            except core.DeadlineExceeded:
                outcome = "typed_deadline"
            except Exception as exc:  # noqa: BLE001 - reported below
                outcome = f"error:{exc!r}"
            el = time.perf_counter() - t0
            mine.append((op, outcome, el, budget))
        with lock:
            for op, outcome, el, budget in mine:
                per = tally["by_op"].setdefault(op, {})
                per[outcome.split(":")[0]] = per.get(
                    outcome.split(":")[0], 0) + 1
                if outcome == "ok":
                    tally["ok"] += 1
                    lat_ms.setdefault(op, []).append(el * 1e3)
                    tally["late_untyped"] += el > budget + LATE_TOL_S
                elif outcome == "typed_deadline":
                    tally["typed_deadline"] += 1
                elif outcome.startswith("shed:"):
                    why = outcome[5:]
                    tally["sheds"][why] = tally["sheds"].get(why, 0) + 1
                else:
                    tally["other_errors"].append(outcome)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(reqs[i::8],))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    tally["requests"] = len(reqs)
    tally["completed_per_s"] = tally["ok"] / wall
    tally["latency_ms"] = percentiles([x for v in lat_ms.values()
                                       for x in v])
    tally["latency_ms_by_op"] = {op: percentiles(v)
                                 for op, v in sorted(lat_ms.items())}
    tally["other_errors"] = tally["other_errors"][:5]
    return tally


def phase_service(torch, core, fe, fe_ops, ps, dev, args, clock) -> dict:
    """Phase 10, the service tier, at benchmarks/bench_shard.py's scale-1.0
    configuration (--service-vertices and --service-edges set its size):
    a live `ServiceDB` whose readers run dense hops on the card while its
    writer and merges run (10b), a `FrontDesk` in front of it (10c), a
    4-shard `ShardRouter` held bitwise against it (10d), and a `Snapshot`
    session analysed on the card (10e). Returns the phase's kernel
    launches: frontier_expand over 10b-10d, psw_spmm in 10e."""
    import shutil
    from repro_torch import data
    t_phase = time.perf_counter()
    n, e = args.service_vertices, args.service_edges
    work = os.path.join(ROOT, "build", "service_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log(f"phase 10 the service tier: bench_shard.py's configuration, {e} "
        f"power-law edges over {n} vertex ids, 4 shards; the stores on "
        f"{filesystem_of(work)}")
    batches, deletes = service_op_prefix(n, e)

    # a. build
    svc = core.ServiceDB.create(os.path.join(work, "svc"), max_id=n - 1,
                                **SERVICE_DB_KW)
    clock("10a ServiceDB ingest (the op prefix)", ingest, svc, batches,
          deletes)
    res = {"ingest_edges_per_s": e / clock.seconds[
        "10a ServiceDB ingest (the op prefix)"]}
    clock("10a checkpoint + quiesce",
          lambda: (svc.checkpoint(), quiesce(svc)))
    v0 = svc.read_view()              # the op prefix's state, held to 10d
    log(f"  10a: {v0.n_edges} edges at publication {v0.version}, ingest "
        f"{res['ingest_edges_per_s']:.0f} edges/s")

    # b. dense reads under a writer
    plans = PlanBuilds(fe)
    fe_ops.launches = 0                        # the service path's hops...
    try:
        reads = clock("10b dense reads on live views under a writer",
                      service_reads, torch, core, svc, dev, n, e // 10,
                      args.seed + 40)
    finally:
        plans.restore()
    res["reads"] = reads
    res["plan_builds_10b"] = plans.builds
    res["plan_build_s_10b"] = plans.build_s
    for r in reads["rounds"]:
        log("  10b " + json.dumps(r))
    log(f"  10b: writer {reads['writer_edges_per_s']:.0f} edges/s, "
        f"{reads['flushes_during']} flushes; publications served dense "
        f"{reads['publications_served_dense']}; {plans.builds} plan builds "
        f"({plans.build_s:.3f} s); {fe_ops.launches} frontier_expand "
        f"launches so far")

    # c. the front desk
    fd = core.FrontDesk(svc, queue_cap=1024, max_batch=256)
    try:
        traffic = clock("10c FrontDesk: LinkBench edge mix + fof, 8 clients",
                        frontdesk_clients, core, data, fd, n,
                        FRONTDESK_REQUESTS, args.seed + 60)
        res["frontdesk"] = traffic
        log("  10c " + json.dumps(traffic))
        check(not traffic["other_errors"],
              f"10c: untyped errors {traffic['other_errors']}")
        check(traffic["late_untyped"] == 0,
              f"10c: {traffic['late_untyped']} requests completed past "
              "their deadline without a typed error")
        check(traffic["ok"] > 0, "10c: no request completed")
        clock("10c checkpoint + quiesce",
              lambda: (svc.checkpoint(), quiesce(svc)))
        seeds = np.random.default_rng(args.seed + 61).choice(n, 256,
                                                             replace=False)
        with svc.read_view() as view:
            dense = clock("10c two_hop_counts dense on the quiesced view "
                          "(256 seeds, plan build included)",
                          core.two_hop_counts, view, seeds, dense="kernel",
                          device=dev)
            futs = [fd.submit("fof", v=int(v)) for v in seeds]
            got = clock("10c fof through the FrontDesk (256 seeds)",
                        lambda: [f.result(timeout=300) for f in futs])
            with svc.read_view() as after:
                same_pub = after.version == view.version
        check(same_pub, "10c: the store published during the fof check")
        check(all(np.array_equal(g, dense.ids[dense.slice_of(i)])
                  for i, g in enumerate(got)),
              "10c: FrontDesk fof != two_hop_counts dense on the card")
        res["frontdesk"]["fd_stats"] = {
            "batches": fd.stats.batches, "batched_ops": fd.stats.batched_ops,
            "shed": fd.stats.shed, "deadline_misses":
            fd.stats.deadline_misses}
        log(f"  10c: fof for 256 seeds through the FrontDesk bitwise equal "
            f"to the dense kernel's ({dense.ids.shape[0]} pairs); "
            f"{json.dumps(res['frontdesk']['fd_stats'])}")
    finally:
        fd.close()

    # d. shards
    t0 = time.perf_counter()
    with core.ShardRouter.create(os.path.join(work, "shards"), max_id=n - 1,
                                 n_shards=4, **SERVICE_DB_KW) as router:
        res["router_spawn_s"] = time.perf_counter() - t0
        runtime = router.worker_runtime()
        log(f"  10d: 4 shard workers up in {res['router_spawn_s']:.3f} s: "
            + json.dumps(runtime))
        check(all(rt["modules"] == ["torch"] and not rt["cuda_initialized"]
                  for rt in runtime),
              "10d: a shard worker loaded jax or the reference, or made a "
              "CUDA context")
        clock("10d ShardRouter ingest (the op prefix)", ingest, router,
              batches, deletes)
        res["router_ingest_edges_per_s"] = e / clock.seconds[
            "10d ShardRouter ingest (the op prefix)"]
        clock("10d checkpoint_all", router.checkpoint_all)
        rng = np.random.default_rng(17)
        sample = rng.integers(0, n, 512)
        seeds = rng.integers(0, n, 64)
        eq = {}
        ref_eng = v0.storage_engine()
        eq["n_edges"] = router.n_edges == v0.n_edges
        vals, offs = ref_eng.out_neighbors_batch(sample)
        eq["out_neighbors"] = all(
            np.array_equal(np.sort(router.out_neighbors(int(v))),
                           np.sort(vals[offs[i]:offs[i + 1]]))
            for i, v in enumerate(sample))
        with core.consistent_engine(router) as eng:
            kh = clock("10d khop k=2 sharded (64 seeds)", core.khop, eng,
                       seeds, 2)
            fof = clock("10d two_hop_counts sharded (512 ids)",
                        core.two_hop_counts, eng, sample)
        kh_ref = core.khop(ref_eng, seeds, 2)
        fof_ref = core.two_hop_counts(ref_eng, sample)
        kh_dense = clock("10d khop k=2 dense on the unsharded view",
                         core.khop, v0, seeds, 2, dense="kernel", device=dev)
        fof_dense = clock("10d two_hop_counts dense on the unsharded view",
                          core.two_hop_counts, v0, sample, dense="kernel",
                          device=dev)
        eq["khop_levels"] = same_levels(kh, kh_ref) and same_levels(
            kh, kh_dense)
        eq["fof_counts"] = same_two_hop(fof, fof_ref) and same_two_hop(
            fof, fof_dense)
        res["equality"] = eq
        check(all(eq.values()), f"10d: sharded != unsharded: {eq}")
        reads = clock("10d router reads: 8 client threads x 5 s",
                      router_reads, router, n, 8, 5.0)
        res["router_reads"] = reads
        log(f"  10d: bitwise equal to the unsharded store and its dense "
            f"kernel answers ({json.dumps(eq)}); router ingest "
            f"{res['router_ingest_edges_per_s']:.0f} edges/s; reads "
            + json.dumps(reads))
    v0.release()
    fe_launches = fe_ops.launches              # ...end here
    check(fe_launches > 0, "phase 10 launched no frontier_expand")

    # e. a snapshot session on the card
    sess = clock("10e begin_snapshot", svc.begin_snapshot)
    sess.close()
    snap = clock("10e Snapshot.open", core.Snapshot.open, sess.dir)
    dg = clock("10e Snapshot.snapshot on the card", snap.snapshot,
               device=dev)
    src, dst = snap.to_coo()
    pal = core.GraphPAL.from_edges(src, dst, n_partitions=8, max_id=n - 1)
    dg_pal = clock("10e build_device_graph(GraphPAL of to_coo())",
                   core.build_device_graph, pal, device=dev)
    check(same_device_graph(torch, dg, dg_pal),
          "10e: the session's DeviceGraph != the GraphPAL's")
    pr = {mode: clock(f"10e pagerank_device {mode} (5 iterations)",
                      core.pagerank_device, dg, 5, mode=mode)
          for mode in PR_MODES}
    check(torch.equal(pr["dense_gather"], pr["psw_windows"])
          and torch.equal(core.pagerank_device(dg_pal, 5), pr["dense_gather"]),
          "10e pagerank_device: the modes or the GraphPAL's differ")
    del dg_pal, pal, pr
    x = randn(torch, (n, 128), dev, args.seed + 62)
    ps.ops.launches = 0                        # the session's aggregation...
    y = clock("10e psw_spmm_edges over the session's edges (F=128)",
              ps.psw_spmm_edges, src, dst, x, n)
    ps_launches = ps.ops.launches              # ...ends here
    check(ps_launches > 0, "10e: the session launched no psw_spmm")
    si, di = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    # the float32 edge oracle adds the hub's in-edges (over a quarter of
    # all edges) one at a time and misses float64 itself by several times
    # the rowwise 1e-5, so the kernel is held to float64 at that tolerance
    # (tighter than phase 9g's 1e-4); its distance from the float32 oracle
    # and the oracle's own are logged
    w32 = ps.spmm_dense_torch(si, di, x, n)
    w64 = ps.spmm_dense_torch(si, di, x.double(), n)
    ratios = {"oracle32_vs_float64": row_tolerance(w32, w64, 1e-5, 1e-5)[2]}
    for name, want in (("float32", w32), ("float64", w64)):
        _, err, ratios[f"kernel_vs_{name}"] = row_tolerance(y, want, 1e-5,
                                                            1e-5)
        res[f"psw_spmm_max_abs_err_vs_{name}"] = err
    res["psw_spmm_rowwise_1e-5_ratios"] = ratios
    check(ratios["kernel_vs_float64"] <= 1.0,
          f"10e psw_spmm vs the float64 edge oracle: max abs err "
          f"{res['psw_spmm_max_abs_err_vs_float64']}, "
          f"{ratios['kernel_vs_float64']:.2f}x the rowwise tolerance 1e-5")
    del w32, w64
    log(f"  10e: the session's DeviceGraph ({dg.n_edges} edges) bitwise "
        f"equal to the GraphPAL's, PageRank modes bitwise equal; psw_spmm "
        f"within rowwise 1e-5 of float64 (max abs err "
        f"{res['psw_spmm_max_abs_err_vs_float64']:.3e}; "
        f"{res['psw_spmm_max_abs_err_vs_float32']:.3e} from the float32 "
        f"oracle; in tolerances: {json.dumps(ratios)}); {ps_launches} "
        "psw_spmm launches")
    del x, y, si, di, dg
    snap.close()
    sess.release()
    svc.close()
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {"frontier_expand": fe_launches, "psw_spmm": ps_launches}
    res["phase_s"] = time.perf_counter() - t_phase
    log("service path: " + json.dumps(launches) + " launches; "
        + json.dumps({k: v for k, v in res.items()
                      if k not in ("reads", "frontdesk")}))
    return launches


def router_reads(router, n_vertices: int, n_threads: int,
                 duration_s: float) -> dict:
    """bench_shard.py's `_read_phase`: client threads issue batched
    out-neighbour reads of 512 random ids against the live router."""
    barrier = threading.Barrier(n_threads)
    out = [None] * n_threads

    def worker(i):
        rng = np.random.default_rng(800 + i)
        eng = router.storage_engine()
        lat, done = [], 0
        barrier.wait()
        t_end = time.perf_counter() + duration_s
        while time.perf_counter() < t_end:
            vs = rng.integers(0, n_vertices, 512)
            t0 = time.perf_counter()
            eng.out_neighbors_batch(vs)
            lat.append((time.perf_counter() - t0) * 1e3)
            done += int(vs.shape[0])
        out[i] = (lat, done)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"vertices_per_s": sum(d for _, d in out) / duration_s,
            "latency_ms": percentiles([x for lat, _ in out for x in lat])}


class plain_neighbour_sum:
    """GIN's neighbour sum through psw_spmm's plain version: the model's
    module-level name swapped for the duration (the check's reference)."""

    def __init__(self, gin, ps):
        self.gin, self.ps = gin, ps

    def __enter__(self):
        self.real = self.gin.psw_spmm_rows
        self.gin.psw_spmm_rows = (
            lambda lay, x: self.ps.psw_spmm_rows_torch(
                lay.row_ptr, lay.col, lay.val, x, lay.block))

    def __exit__(self, *exc):
        self.gin.psw_spmm_rows = self.real


def padding_ok(sub, seeds, n_vertices: int, fanouts, n_pad: int,
               e_pad: int) -> bool:
    """A sampled subgraph's invariants: the padded shapes, masks that are
    prefixes, the seeds first, live ids distinct and in range, edges
    between live nodes, at most sum(fanouts) in-edges a node, padding 0."""
    n, e = int(sub.node_mask.sum()), int(sub.edge_mask.sum())
    live, s, d = sub.nodes[:n], sub.src[:e], sub.dst[:e]
    return (sub.nodes.shape == sub.node_mask.shape == (n_pad,)
            and sub.src.shape == sub.dst.shape == sub.edge_mask.shape
            == (e_pad,)
            and sub.node_mask[:n].all() and sub.edge_mask[:e].all()
            and sub.n_seeds == len(seeds)
            and np.array_equal(sub.nodes[:len(seeds)], seeds)
            and np.unique(live).size == n and live.min() >= 0
            and live.max() < n_vertices
            and (e == 0 or (min(s.min(), d.min()) >= 0
                            and max(s.max(), d.max()) < n
                            and np.bincount(d).max() <= sum(fanouts)))
            and not sub.nodes[n:].any() and not sub.src[e:].any()
            and not sub.dst[e:].any())


def device_profile(torch, fn, steps: int) -> dict:
    """`fn` run `steps` times under torch.profiler (CPU and CUDA
    activities): the device's busy ms a call (the summed device time of
    its kernels, memcpys and memsets), the kernels a call, and the ten
    with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    on_device = sorted((e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA),
                       key=lambda e: -e.self_device_time_total)
    return {"device_busy_ms": sum(e.self_device_time_total
                                  for e in on_device) / 1e3 / steps,
            "kernels": sum(e.count for e in on_device) / steps,
            "top": [[e.key[:60], e.self_device_time_total / 1e3 / steps,
                     e.count / steps] for e in on_device[:10]]}


def gnn_models(torch, dev, seed: int):
    """(modules, configs, params) of gin-tu, pna and meshgraphnet at their
    full widths, adapted to the minibatch_lg cell as
    repro/launch/steps.py::_adapt_gnn_config adapts them (node readout;
    edge_chunks 1, that rule's value below 1M edges, which MB_EDGES is),
    params drawn on `dev` from `seed`."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.models.gnn import gin, meshgraphnet, pna
    cell = GNN_SHAPES["minibatch_lg"]
    d_feat, n_cls = cell["d_feat"], cell["n_classes"]
    models = {"gin-tu": gin, "pna": pna, "meshgraphnet": meshgraphnet}
    cfgs = {
        "gin-tu": dataclasses.replace(
            get_arch("gin-tu").config, d_in=d_feat, n_classes=n_cls,
            readout="node", edge_chunks=1),
        "pna": dataclasses.replace(
            get_arch("pna").config, d_in=d_feat, n_classes=n_cls,
            readout="node", edge_chunks=1),
        "meshgraphnet": dataclasses.replace(
            get_arch("meshgraphnet").config, d_node_in=d_feat, d_edge_in=4,
            d_out=n_cls, edge_chunks=1)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {k: m.init_params(gen, cfgs[k], dev) for k, m in models.items()}
    return models, cfgs, params


def phase_gnn(torch, core, ps, ps_kernel, dev, args, clock) -> dict:
    """Phase 11, GNN serving on sampled minibatches (the repo's
    minibatch_lg cell, configs/gnn_common.py): a stand-in with Reddit's
    published sizes (--gnn-vertices and --gnn-edges shrink it) in a
    `GraphPAL` of 16 partitions, a `NeighborSampler` over its in-edge CSC,
    the 602-wide feature table on the card; 4 batches of 1,024 seeds with
    fanouts 15-10, padded to MB_NODES / MB_EDGES, uploaded, their features
    gathered on the card, and gin-tu, pna and meshgraphnet at their full
    widths (adapted as repro/launch/steps.py::_adapt_gnn_config adapts
    them) computing the seeds' logits. GIN's neighbour sum runs on
    psw_spmm. Gates: the card's logits against the same forward on the
    CPU and GIN's against its plain neighbour sum, within 1e-4; no NaN or
    inf; the padding invariants; psw_spmm at the GIN shape against its
    plain version (rowwise 1e-5). Each model's first-batch forward is
    also profiled (the device's busy ms and idle share). Returns
    psw_spmm's launches on the path and its result at the GIN shape, and
    the sampler, which phase 12 serves from."""
    from repro_torch import convert
    from repro_torch.configs.gnn_common import GNN_SHAPES, MB_EDGES, MB_NODES
    from repro_torch.graph import NeighborSampler
    from repro_torch.models.gnn import gin
    from repro_torch.models.gnn.common import mlp_apply
    t_phase = time.perf_counter()
    cell = GNN_SHAPES["minibatch_lg"]
    n, e = args.gnn_vertices, args.gnn_edges
    d_feat, n_cls, fanouts, B = (cell["d_feat"], cell["n_classes"],
                                 cell["fanout"], cell["seeds"])
    log(f"phase 11 GNN serving on sampled minibatches: minibatch_lg's "
        f"stand-in, {n} vertices, {e} power-law edges, {d_feat} features, "
        f"{n_cls} classes; {B} seeds a batch, fanouts {fanouts}, padded to "
        f"{MB_NODES} nodes and {MB_EDGES} edges")
    src, dst = clock("11 power_law_graph (the stand-in's edges)",
                     power_law_graph, n, e, seed=args.seed + 30)
    g = clock("11 GraphPAL.from_edges (16 partitions)",
              core.GraphPAL.from_edges, src, dst, n_partitions=16,
              max_id=n - 1)
    del src, dst
    sampler = clock("11 NeighborSampler (the in-edge CSC)", NeighborSampler,
                    g, seed=args.seed + 31)
    table = randn(torch, (n, d_feat), dev, args.seed + 32)
    models, cfgs, params = gnn_models(torch, dev, args.seed + 33)
    gin_forwards = [0]

    def forward(name, batch):
        if name == "gin-tu" and batch["x"].device.type == "cuda":
            gin_forwards[0] += 1
        return models[name].forward(params[name], batch, cfgs[name])

    rng = np.random.default_rng(args.seed + 34)
    reps = max(2, args.reps // 4)
    rows, first = [], None
    ps.ops.launches = 0                        # the GNN path...
    with torch.no_grad():
        for b in range(4):
            seeds = rng.choice(n, B, replace=False)
            t0 = time.perf_counter()
            sub = sampler.sample(seeds, fanouts, pad_nodes=MB_NODES,
                                 pad_edges=MB_EDGES)
            row = {"sample_s": time.perf_counter() - t0,
                   "nodes": int(sub.node_mask.sum()),
                   "edges": int(sub.edge_mask.sum())}
            check(padding_ok(sub, seeds, n, fanouts, MB_NODES, MB_EDGES),
                  f"11: batch {b}'s sampled subgraph breaks the padding "
                  "invariants")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nodes = torch.from_numpy(sub.nodes).to(dev)
            batch = {k: torch.from_numpy(getattr(sub, k)).to(dev)
                     for k in ("src", "dst", "edge_mask", "node_mask")}
            torch.cuda.synchronize()
            row["upload_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            batch["x"] = (table.index_select(0, nodes)
                          * batch["node_mask"][:, None])
            torch.cuda.synchronize()
            row["gather_ms"] = (time.perf_counter() - t0) * 1e3
            batch["edge_attr"] = randn(torch, (MB_EDGES, 4), dev,
                                       args.seed + 40 + b)
            for name in models:
                row[f"{name}_ms"] = cuda_ms(
                    torch, lambda: forward(name, batch), reps)
            rows.append(row)
            log(f"  batch {b}: " + json.dumps(row))
            if first is None:
                first = (sub.n_seeds, batch)
                res_sub = sub
            del nodes
    launches = ps.ops.launches                 # ...ends here
    n_fwd, n_layers = gin_forwards[0], cfgs["gin-tu"].n_layers
    check(n_fwd > 0 and launches == n_layers * n_fwd,
          f"11: {launches} psw_spmm launches for {n_fwd} GIN forwards of "
          f"{n_layers} layers")
    res = {"launches": launches, "gin_forwards": n_fwd, "batches": rows,
           "sub": res_sub}                    # phase 15 trains on it

    # where a forward's time goes: the device's busy share of batch 0's
    # forward time, from torch.profiler
    s, batch = first
    with torch.no_grad():
        for name in models:
            prof = device_profile(torch, lambda: forward(name, batch), 3)
            ms = rows[0][f"{name}_ms"]
            busy = prof["device_busy_ms"]     # 0: the profiler saw no device
            prof["idle_share"] = 1 - busy / ms if busy else None
            res[f"{name}_profile"] = prof
            log(f"  {name} profile (forward {ms:.3f} ms): "
                + json.dumps(prof))

    # gates on the first batch: the card against the CPU, GIN's kernel
    # against its plain neighbour sum, nothing non-finite
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    errs = {}
    with torch.no_grad():
        for name in models:
            out = forward(name, batch)
            check(tuple(out.shape) == (MB_NODES, n_cls)
                  and bool(torch.isfinite(out).all()),
                  f"11: {name} logits of shape {tuple(out.shape)} hold NaN "
                  "or inf")
            p_cpu = convert.gnn_params_from_arrays(
                convert.gnn_params_to_arrays(params[name]), params[name],
                "cpu")
            want = models[name].forward(p_cpu, cpu_batch, cfgs[name])
            got = out.cpu()
            live = cpu_batch["node_mask"]
            errs[f"{name}_seeds_vs_cpu"] = float((got[:s] - want[:s]).abs()
                                                 .max())
            errs[f"{name}_live_nodes_vs_cpu"] = float(
                (got[live] - want[live]).abs().max())
            check(torch.allclose(got[live], want[live], rtol=1e-4,
                                 atol=1e-4),
                  f"11: {name} live nodes' logits on the card vs the CPU: "
                  f"max abs err {errs[f'{name}_live_nodes_vs_cpu']}")
            if name == "gin-tu":
                n0 = ps.ops.launches
                with plain_neighbour_sum(gin, ps):
                    plain = gin.forward(params[name], batch, cfgs[name])
                check(ps.ops.launches == n0, "11: GIN's plain neighbour sum "
                      "launched the kernel")
                errs["gin-tu_kernel_vs_plain"] = float(
                    (out - plain).abs().max())
                check(torch.allclose(out, plain, rtol=1e-4, atol=1e-4),
                      f"11: GIN on psw_spmm vs its plain neighbour sum: max "
                      f"abs err {errs['gin-tu_kernel_vs_plain']}")
                del plain
            del out, want, got
        log("  logits within 1e-4 (max abs err): " + json.dumps(errs))
        res["logit_errs"] = errs

        # psw_spmm at the GIN shape: one batch's layout over its live edges,
        # x = GIN's encoder output, the x the first layer's sum reads
        live = batch["edge_mask"]
        gx = mlp_apply(params["gin-tu"]["encoder"], batch["x"],
                       final_act=True)
        spmm, _, _ = psw_spmm_rows_vs_plain(
            torch, ps, ps_kernel, (batch["src"][live], batch["dst"][live],
                                   gx), args.reps)
    res["psw_spmm"] = spmm
    log("  psw_spmm at the GIN shape: " + json.dumps(spmm))
    del first, batch, cpu_batch, gx, table, params, g
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"gnn path: {launches} psw_spmm launches ({n_fwd} GIN forwards of "
        f"{n_layers} layers); "
        + json.dumps({k: v for k, v in res.items()
                      if k in ("logit_errs", "phase_s")}))
    return res, sampler


def psw_spmm_scatter_vs_plain(torch, ps, ps_kernel, lay, msg, dst_c,
                              reps: int) -> dict:
    """psw_spmm at EquiformerV2's scatter shape: one chunk's layout (rows
    the destinations, sources the chunk's live edges, values 1) applied to
    the first layer's messages msg (E_c, F), against its plain version,
    with the bytes-read-once bound (the live message rows, out and the
    CSR) and the one PyTorch call `graph/segment_ops.py::scatter_sum`
    runs: an `index_add_` of every edge's message into zeros (a masked
    edge's message is 0: so is its attention weight)."""
    out, res = psw_spmm_layout_vs_plain(torch, ps, ps_kernel, lay, msg, reps)
    n, (E, F) = lay.n_rows, msg.shape
    d = dst_c.long()

    def library():
        return torch.zeros((n, F), dtype=torch.float32,
                           device=msg.device).index_add_(0, d, msg)

    lib = library()
    torch.cuda.synchronize()
    lib_ok, lib_err, _ = row_tolerance(lib, out, 1e-4, 1e-4)
    check(lib_ok, f"index_add_ vs psw_spmm kernel at F={F}: max abs err "
                  f"{lib_err}")
    del lib, out
    library_ms = cuda_ms(torch, library, reps)
    bytes_once = (n + 1) * 8 + lay.nnz * 8 + (lay.nnz + n) * F * 4
    return {"edges": E, **res, "library": "index_add_",
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "out_bytes": n * F * 4,
            **bound(bytes_once, 2 * lay.nnz * F, FP32_OPS_PER_S)}


def equiformer_config(torch):
    """equiformer-v2's full config adapted to the minibatch_lg cell as
    repro/launch/steps.py::_adapt_gnn_config adapts it at MB_EDGES >=
    100,000: 41 outputs, 128 species, 4 edge chunks, the PSW ring (one
    rank here), remat on (no effect under no_grad)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import GNN_SHAPES
    return dataclasses.replace(
        get_arch("equiformer-v2").config,
        d_out=GNN_SHAPES["minibatch_lg"]["n_classes"], n_species=128,
        edge_chunks=4, gather_mode="psw_ring", remat_layers=True)


def phase_equiformer(torch, ps, ps_kernel, sampler, n: int, cfg, dev, args,
                     clock) -> dict:
    """Phase 12, EquiformerV2 serving sampled minibatches of phase 11's
    stand-in (its `NeighborSampler`, n vertices) at `cfg`
    (`equiformer_config`: 12 layers x 128 channels, l_max 6, m_max 2, 8
    heads; psw_ring on one rank, 4 edge chunks). Reddit has no geometry,
    so the node inputs are made as the reference's config says ("unit-ball
    positions and hashed species ids"): one position a vertex drawn
    uniformly in the unit ball from --seed (a direction from a normal
    draw, a radius u^(1/3)), a table on the card; species (vertex id *
    2654435761 mod 2^32) mod 128. 2 batches of 1,024 seeds at 15-10,
    padded to MB_NODES / MB_EDGES, each forward timed with CUDA events
    (one warm-up, 2 timed); the first batch's forward profiled. Gates:
    logits (MB_NODES, 41), finite; the kernel's forward against the same
    forward with psw_spmm's plain version swapped in, both under
    deterministic algorithms (1e-4; the plain one launches nothing); the card's forward in take mode at edge_chunks 1
    and 4 against the CPU's on a 64-seed batch at 15-10 (padded only to
    the sampler's 128-multiple), every live node within 1e-4; psw_spmm
    launches exactly n_layers x edge_chunks a forward; psw_spmm at the
    scatter shape (the first layer's first chunk, F = 6,272) against its
    plain version. Logged: the seeds' logits under a random global
    rotation of every position. Returns the path's launches and the
    psw_spmm result."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs.gnn_common import GNN_SHAPES, MB_EDGES, MB_NODES
    from repro_torch.models.gnn import equiformer_v2 as eq
    t_phase = time.perf_counter()
    cell = GNN_SHAPES["minibatch_lg"]
    fanouts, B = cell["fanout"], cell["seeds"]
    K = (cfg.l_max + 1) ** 2
    log(f"phase 12 EquiformerV2 serving on sampled minibatches: "
        f"{cfg.n_layers} layers, {cfg.d_hidden} channels, l_max "
        f"{cfg.l_max}, m_max {cfg.m_max}, {cfg.n_heads} heads, "
        f"{cfg.edge_chunks} edge chunks, {cfg.gather_mode}; {B} seeds a "
        f"batch at {fanouts}, padded to {MB_NODES} nodes and {MB_EDGES} "
        f"edges ({K} x {cfg.d_hidden} irreps an edge)")
    pos_table, species_table, rng = equiformer_inputs(torch, n,
                                                      args.seed + 50, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 51)
    params = eq.init_params(gen, cfg, dev)

    def batch_of(sub, device, pos=None):
        nodes = torch.from_numpy(sub.nodes).to(dev)
        b = {"species": species_table[nodes],
             "pos": (pos_table if pos is None else pos)[nodes]}
        b.update({k: torch.from_numpy(getattr(sub, k)).to(dev)
                  for k in ("src", "dst", "edge_mask", "node_mask")})
        return {k: v.to(device) for k, v in b.items()}

    forwards = [0, 0]             # on the card; their psw_spmm launches

    def forward(p, b, c):
        if b["pos"].device.type == "cuda":
            forwards[0] += 1
            forwards[1] += c.n_layers * c.edge_chunks
        with torch.no_grad():
            return eq.forward(p, b, c)

    rows, batches = [], []
    ps.ops.launches = 0                       # the EquiformerV2 path...
    for i in range(2):
        seeds = rng.choice(n, B, replace=False)
        t0 = time.perf_counter()
        sub = sampler.sample(seeds, fanouts, pad_nodes=MB_NODES,
                             pad_edges=MB_EDGES)
        row = {"sample_s": time.perf_counter() - t0,
               "nodes": int(sub.node_mask.sum()),
               "edges": int(sub.edge_mask.sum())}
        check(padding_ok(sub, seeds, n, fanouts, MB_NODES, MB_EDGES),
              f"12: batch {i}'s sampled subgraph breaks the padding "
              "invariants")
        b = batch_of(sub, dev)
        row["forward_ms"] = cuda_ms(torch, lambda: forward(params, b, cfg),
                                    2)
        rows.append(row)
        batches.append((sub, b))
        log(f"  batch {i}: " + json.dumps(row))
    sub, b = batches[0]
    prof = device_profile(torch, lambda: forward(params, b, cfg), 1)
    busy = prof["device_busy_ms"]         # 0: the profiler saw no device
    prof["idle_share"] = 1 - busy / rows[0]["forward_ms"] if busy else None
    log(f"  profile (forward {rows[0]['forward_ms']:.3f} ms): "
        + json.dumps(prof))

    # gates on the 1,024-seed batch: shape, finite, kernel against plain;
    # the first layer's first chunk captured for the kernel's own check
    captured = []
    real = eq.psw_spmm_rows

    def capture(lay, x):
        if not captured:
            captured.append((lay, x))
        return real(lay, x)

    eq.psw_spmm_rows = capture
    try:
        out = forward(params, b, cfg)
    finally:
        eq.psw_spmm_rows = real
    check(tuple(out.shape) == (MB_NODES, cfg.d_out)
          and bool(torch.isfinite(out).all()),
          f"12: logits of shape {tuple(out.shape)} hold NaN or inf")
    # x crosses the ring in bf16, so a float32 difference of one ulp
    # upstream (another order of addition anywhere: the edge softmax's
    # index_add_ adds in whatever order its atomics land) can flip a bf16
    # rounding and move logits by ~1e-3 after 12 layers. Both forwards of
    # the gate run under deterministic algorithms, where index_add_ adds
    # each row's entries in entry order: the plain scatter's order of
    # addition is then the kernel's, and every other sum's is the same in
    # both forwards. Warnings only, silenced, where an op has no
    # deterministic version.
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            det = forward(params, b, cfg)
            n0 = ps.ops.launches
            eq.psw_spmm_rows = lambda lay, x: ps.psw_spmm_rows_torch(
                lay.row_ptr, lay.col, lay.val, x, lay.block)
            with torch.no_grad():
                plain = eq.forward(params, b, cfg)
    finally:
        eq.psw_spmm_rows = real
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    check(ps.ops.launches == n0,
          "12: the plain message scatter launched the kernel")
    errs = {"kernel_vs_plain": float((det - plain).abs().max()),
            "kernel_vs_plain_bitwise": bool(torch.equal(det, plain)),
            "default_vs_deterministic": float((out - det).abs().max())}
    check(torch.allclose(det, plain, rtol=1e-4, atol=1e-4),
          f"12: EquiformerV2 on psw_spmm vs its plain scatter: max abs "
          f"err {errs['kernel_vs_plain']}")
    del plain, det

    # logged: a random global rotation of every position (here, and in
    # float32 take mode on the 64-seed batch below)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q = torch.from_numpy((q * np.sign(np.linalg.det(q))).astype(np.float32)
                         ).to(dev)
    pos_rot = pos_table @ q.T
    rotated = forward(params, batch_of(sub, dev, pos_rot), cfg)
    s = sub.n_seeds
    rot = {"max_abs": float((rotated[:s] - out[:s]).abs().max()),
           "max_abs_logit": float(out[:s].abs().max())}
    del rotated, out

    # gate: the card against the CPU on a 64-seed batch, take mode
    small = sampler.sample(rng.choice(n, 64, replace=False), fanouts)
    p_cpu = convert.gnn_params_from_arrays(
        convert.gnn_params_to_arrays(params), params, "cpu")
    live = torch.from_numpy(small.node_mask)
    for chunks in (1, 4):
        c = dataclasses.replace(cfg, gather_mode="take", edge_chunks=chunks)
        got = forward(params, batch_of(small, dev), c).cpu()
        t0 = time.perf_counter()
        want = forward(p_cpu, batch_of(small, "cpu"), c)
        cpu_s = time.perf_counter() - t0
        key = f"take_chunks{chunks}_live_vs_cpu"
        errs[key] = float((got[live] - want[live]).abs().max())
        errs[f"take_chunks{chunks}_cpu_s"] = cpu_s
        check(bool(torch.isfinite(got[live]).all())
              and torch.allclose(got[live], want[live], rtol=1e-4,
                                 atol=1e-4),
              f"12: take mode at edge_chunks {chunks}, card vs CPU: max abs "
              f"err {errs[key]}")
    rotated = forward(params, batch_of(small, dev, pos_rot), c).cpu()
    s = small.n_seeds
    rot["take_64_seeds_max_abs"] = float((rotated[:s] - got[:s]).abs().max())
    rot["take_64_seeds_max_abs_logit"] = float(got[:s].abs().max())
    log("  rotation invariance (seeds' logits, logged): " + json.dumps(rot))
    del p_cpu, pos_rot
    launches = ps.ops.launches                # ...ends here
    n_fwd, want_launches = forwards
    check(launches == want_launches,
          f"12: {launches} psw_spmm launches for {n_fwd} forwards on the "
          f"card; expected {want_launches}, n_layers x edge_chunks each")
    errs["small_batch"] = {"nodes": int(small.node_mask.sum()),
                           "edges": int(small.edge_mask.sum())}
    log("  logits (max abs err; gates 1e-4): " + json.dumps(errs))

    lay, msg = captured[0]
    Ec = msg.shape[0]
    spmm = psw_spmm_scatter_vs_plain(torch, ps, ps_kernel, lay, msg,
                                     b["dst"][:Ec], args.reps)
    log("  psw_spmm at the EquiformerV2 scatter shape: " + json.dumps(spmm))
    del captured, lay, msg, batches, b, params, pos_table, species_table
    torch.cuda.empty_cache()
    res = {"launches": launches, "forwards": n_fwd, "batches": rows,
           "profile": prof, "rotation": rot, "logit_errs": errs,
           "psw_spmm": spmm, "phase_s": time.perf_counter() - t_phase,
           "sub": sub}                         # phase 15 trains on it
    log(f"equiformer path: {launches} psw_spmm launches ({n_fwd} forwards "
        f"on the card); " + json.dumps({"phase_s": res["phase_s"]}))
    return res


MOE_ARCHS = ("qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b")
MOE_LAYERS, MOE_REQUESTS, MOE_GEN = 4, 4, 16   # depth cut; 1 batch of 4


class routings:
    """Every routing group's expert ids (t, K), each token's set sorted,
    recorded from the model's `route_tokens` for the duration."""

    def __init__(self, tf):
        self.tf, self.ids = tf, []

    def __enter__(self):
        self.real = self.tf.route_tokens

        def record(router, xg, mo):
            out = self.real(router, xg, mo)
            self.ids.append(out[2].sort(-1).values)
            return out

        self.tf.route_tokens = record
        return self

    def __exit__(self, *exc):
        self.tf.route_tokens = self.real


def moe_layer_vs_bound(torch, tf, params, cfg, batch: int, seq: int, dev,
                       seed: int, reps: int) -> dict:
    """Layer 0's `moe_mlp` at the prefill shape (random unit-variance bf16
    input) timed with CUDA events, its three expert products alone, the
    bound (the expert FLOPs, 6·E·cap·d·f a routing group, in bf16) and a
    profile of one call."""
    mo, d = cfg.moe, cfg.d_model
    lp = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h = torch.randn((batch, seq, d), generator=gen, device=dev).to(
        cfg.compute_dtype)
    chunk = tf.MOE_SEQ_CHUNK
    groups = seq // chunk if seq > chunk and seq % chunk == 0 else 1
    cap = tf.moe_capacity(mo, batch * seq // groups)
    E, f = mo.n_experts, mo.d_ff_expert
    ein = torch.randn((E, cap, d), generator=gen, device=dev).to(
        cfg.compute_dtype)
    with torch.no_grad():
        out, aux = tf.moe_mlp(lp, h, cfg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux)),
              f"{cfg.moe}: moe_mlp gave non-finite values")
        res = {"B": batch, "S": seq, "groups": groups, "cap": cap,
               "E": E, "K": mo.top_k, "d": d, "f": f,
               "ms": cuda_ms(torch, lambda: tf.moe_mlp(lp, h, cfg), reps),
               "experts_ms": groups * cuda_ms(torch, lambda: tf.expert_ffn(
                   lp, ein, cfg.compute_dtype), reps)}
        res["profile"] = device_profile(torch, lambda: tf.moe_mlp(lp, h, cfg),
                                        1)
    flops = groups * 6 * E * cap * d * f
    res.update(bound(3 * E * d * f * 2 + 2 * batch * seq * d * 2, flops,
                     BF16_OPS_PER_S))
    res["tflops_per_s"] = flops / (res["ms"] * 1e-3) / 1e12
    res["dispatch_and_combine_ms"] = res["ms"] - res["experts_ms"]
    return res


def moe_groups_vs_halves(torch, tf, params, cfg, batch: int, seq: int,
                         dev, seed: int, reps: int, dp1_ms: float) -> dict:
    """Layer 0's `moe_mlp` on `moe_layer_vs_bound`'s input with each
    chunk routed in 2 groups (`_moe_core`'s grouped routine at groups=2,
    as a 2-way data mesh routes; one rank has no mesh) against two dp = 1
    calls on the batch's halves: per chunk the experts, slot tables, slots
    and expert counts of `route_groups` bitwise, the output within 2e-2
    (bf16). Timed with CUDA events beside the dp = 1 layer's `dp1_ms`."""
    import functools
    mo, d, half = cfg.moe, cfg.d_model, batch // 2
    lp = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h = torch.randn((batch, seq, d), generator=gen, device=dev).to(
        cfg.compute_dtype)
    chunk = tf.MOE_SEQ_CHUNK
    if not (seq > chunk and seq % chunk == 0):
        chunk = seq
    real = tf._moe_core
    with torch.no_grad():
        tf._moe_core = functools.partial(real, groups=2)
        try:
            out2, aux2 = tf.moe_mlp(lp, h, cfg)
            ms = cuda_ms(torch, lambda: tf.moe_mlp(lp, h, cfg), reps)
        finally:
            tf._moe_core = real
        out1 = torch.cat([tf.moe_mlp(lp, h[:half], cfg)[0],
                          tf.moe_mlp(lp, h[half:], cfg)[0]])
        tg = half * chunk
        cap = tf.moe_capacity(mo, tg)
        same = True
        for c in range(0, seq, chunk):
            xc = h[:, c:c + chunk]
            both = tf.route_groups(lp["router"], xc.reshape(2, tg, d), mo,
                                   cap)
            for g in range(2):
                alone = tf.route_groups(lp["router"], xc[g * half:(
                    g + 1) * half].reshape(1, tg, d), mo, cap)
                same &= all(torch.equal(both[i][g], alone[i][0])
                            for i in (0, 1, 2, 4))
        err = float((out2.float() - out1.float()).abs().max())
        close = torch.allclose(out2.float(), out1.float(), rtol=2e-2,
                               atol=2e-2)
    res = {"groups": 2, "tokens_a_group": tg, "cap": cap,
           "routing_bitwise": bool(same), "max_abs_err": err,
           "aux": float(aux2), "ms": ms, "dp1_ms": dp1_ms}
    check(same, f"dp = 2 routing differs from two dp = 1 calls: {res}")
    check(close and bool(torch.isfinite(out2).all()),
          f"dp = 2 MoE layer vs two dp = 1 calls beyond 2e-2: {res}")
    return res


def moe_gates(torch, fa, fa_kernel, tf, cfg, dev, args) -> dict:
    """Phase 13's gates on a 2-layer fp32 cut of `cfg` at full width and
    capacity factor E/K, where no token is dropped, so a routing that
    differs changes only its own prompt: the fp32 kernel on layer 0's
    q/k/v against its plain version; (a) prefill through the kernel
    against prefill through the plain attention, the routings of both
    compared first, then the last-token logits of every prompt whose
    routings all agree; (b) decode against forward; (c) finite logits."""
    import dataclasses
    mo = cfg.moe
    cfg2 = dataclasses.replace(
        cfg, n_layers=2, param_dtype=torch.float32,
        compute_dtype=torch.float32, moe=dataclasses.replace(
            mo, capacity_factor=mo.n_experts / mo.top_k))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 43)
    p2 = tf.init_params(cfg2, gen, dev)
    B2, S2, steps = 4, 256, 8
    toks = torch.from_numpy(np.random.default_rng(args.seed + 44).integers(
        1, cfg.vocab_size, (B2, S2 + steps))).to(dev)
    res = {}
    with torch.no_grad():
        q, k, v = attention_inputs(torch, tf, p2, cfg2, toks[:, :S2])
        res["attention"] = attention_vs_plain(torch, fa, fa_kernel, q, k, v,
                                              2e-5, max(2, args.reps // 4))
        del q, k, v
        with routings(tf) as rk:
            lk, cache = tf.prefill(p2, toks[:, :S2], cfg2, S2 + steps,
                                   cache_dtype=torch.float32)
        with routings(tf) as rp, plain_attention(tf, fa):
            lp, _ = tf.prefill(p2, toks[:, :S2], cfg2, S2 + steps,
                               cache_dtype=torch.float32)
        check(len(rk.ids) == len(rp.ids) == cfg2.n_layers,
              f"{len(rk.ids)} / {len(rp.ids)} routing groups for 2 layers")
        pairs = [(a != b).any(-1).reshape(B2, S2)
                 for a, b in zip(rk.ids, rp.ids)]
        differ = sum(int(p.sum()) for p in pairs)
        total = B2 * S2 * cfg2.n_layers
        agree = ~torch.stack(pairs).any(0).any(-1)           # (B2,)
        res.update(routings_differ=differ, token_layers=total,
                   prompts_compared=int(agree.sum()),
                   prefill_kernel_vs_plain=float((lk - lp)[agree].abs()
                                                 .max()))
        check(differ <= 0.01 * total,
              f"{differ} of {total} token-layer routings differ between "
              "the kernel's and the plain prefill")
        check(bool(agree.any()) and torch.allclose(
            lk[agree], lp[agree], rtol=1e-4, atol=1e-4),
              f"last-token logits of the prompts whose routings agree: {res}")
        del lp
        full, aux = tf.forward(p2, toks, cfg2)
        check(bool(torch.isfinite(full).all()) and bool(torch.isfinite(aux)),
              "2-layer fp32 forward: non-finite logits")
        res["prefill_vs_forward"] = float((lk - full[:, S2 - 1]).abs().max())
        check(torch.allclose(lk, full[:, S2 - 1], rtol=1e-4, atol=1e-4),
              f"prefill vs forward at capacity factor E/K: {res}")
        dec = 0.0
        for i in range(S2, S2 + steps):
            lg, cache = tf.decode_step(p2, cache, toks[:, i:i + 1], i, cfg2)
            err = float((lg - full[:, i]).abs().max())
            check(torch.allclose(lg, full[:, i], rtol=1e-4, atol=1e-4),
                  f"decode logits at {i} vs forward: max abs err {err}")
            dec = max(dec, err)
        res["decode_vs_forward"] = dec
        res["aux"] = float(aux)
    del p2, full, cache, lk
    torch.cuda.empty_cache()
    return res


def phase_moe(torch, dev, args, clock, fa_kernel) -> dict:
    """Phase 13, MoE serving: qwen3-moe and phi3.5-moe at full width, cut
    to MOE_LAYERS layers with bf16 params drawn on the card, through
    `serve_requests` (every prefill layer's attention on the
    flash_attention kernel, its MoE dispatch in torch); the kernel against
    its plain version on layer 0's q/k/v at the serve shape; then one MoE
    layer timed against its bound, the greedy tokens and prefill routings
    of the plain path, and, for qwen3-moe, the gates of `moe_gates`.
    Returns the path's flash_attention launches and the results."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as tf
    t_phase = time.perf_counter()
    R, B, P, G = MOE_REQUESTS, args.lm_batch, args.prompt_len, MOE_GEN
    chunks = P // tf.MOE_SEQ_CHUNK if P > tf.MOE_SEQ_CHUNK \
        and P % tf.MOE_SEQ_CHUNK == 0 else 1
    res = {"launches": 0}
    for i, arch in enumerate(MOE_ARCHS):
        full = get_arch(arch).config
        cfg = dataclasses.replace(full, n_layers=MOE_LAYERS,
                                  param_dtype=torch.bfloat16)
        mo = cfg.moe
        log(f"phase 13 MoE serving, {arch}: {cfg.n_layers} of "
            f"{full.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
            f"kv {cfg.n_kv_heads}, d_head {cfg.head_dim}, {mo.n_experts} "
            f"experts, top-{mo.top_k}, d_ff_expert {mo.d_ff_expert}, vocab "
            f"{cfg.vocab_size} -> {cfg.padded_vocab}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 40 + i)
        params = clock(f"{arch}: init_params (bf16, on the device)",
                       tf.init_params, cfg, gen, dev)
        n = sum(t.numel() for t in leaves(params))
        check(n == cfg.n_params, f"{n} params, config says {cfg.n_params}")
        prompts = np.random.default_rng(args.seed + 41 + i).integers(
            1, cfg.vocab_size, (R, P))
        fa.ops.launches = 0                    # the MoE serving path...
        with routings(tf) as rk:
            tokens, stats = clock(f"{arch}: serve_requests ({R} requests "
                                  f"of {P} tokens, batch {B}, {G} "
                                  "generated)", serve_requests, params, cfg,
                                  prompts, B, G, dev)
        launches = fa.ops.launches             # ...ends here
        check(launches == cfg.n_layers * len(stats),
              f"{launches} flash_attention launches for {len(stats)} "
              f"prefills of {cfg.n_layers} layers")
        check(tokens.shape == (R, G) and tokens.min() >= 0
              and tokens.max() < cfg.padded_vocab,
              f"{arch} serve_requests: bad tokens")
        out = {"params": n, "launches": launches,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "batches": [{**s, "decode_ms_per_token": s["decode_s"]
                            / max(G - 1, 1) * 1e3} for s in stats]}
        for s in out["batches"]:
            log(f"  batch of {s['requests']}: prefill {s['prefill_s']:.3f} "
                f"s, decode {s['decode_ms_per_token']:.2f} ms/token, "
                f"latency {s['latency_s']:.3f} s")
        log(f"  {n} params ({n * 2 / 1e9:.2f} GB bf16), {launches} "
            f"flash_attention launches ({cfg.n_layers} per prefill), peak "
            f"device memory {out['peak_gib']:.2f} GiB")
        res["launches"] += launches
        toks = torch.from_numpy(prompts[:B]).to(dev)
        q, k, v = attention_inputs(torch, tf, params, cfg, toks)
        out["attention"] = attention_vs_plain(torch, fa, fa_kernel, q, k, v,
                                              2e-2, args.reps)
        log("  kernel vs plain, serve shape: " + json.dumps(out["attention"]))
        del q, k, v, toks
        with routings(tf) as rp, plain_attention(tf, fa):
            plain_tokens, _ = serve_requests(params, cfg, prompts[:B], B, G,
                                             dev)
        out["greedy_agreement"] = float((plain_tokens == tokens[:B]).mean())
        n_pre = cfg.n_layers * chunks          # the first prefill's groups
        out["prefill_routings_differ_by_layer"] = [
            sum(float((a != b).any(-1).float().mean())
                for a, b in zip(rk.ids[i:i + chunks], rp.ids[i:i + chunks]))
            / chunks for i in range(0, n_pre, chunks)]
        log(f"  greedy tokens of batch 1 equal on the kernel and plain "
            f"paths: {out['greedy_agreement']:.4f}; share of prefill "
            "tokens routed differently, by layer: "
            f"{out['prefill_routings_differ_by_layer']} (not gates)")
        del rk, rp
        out["moe_layer"] = moe_layer_vs_bound(
            torch, tf, params, cfg, B, P, dev, args.seed + 42,
            max(2, args.reps // 4))
        log("  one MoE layer at the prefill shape: "
            + json.dumps(out["moe_layer"]))
        if arch == MOE_ARCHS[0]:
            out["moe_layer_dp2"] = moe_groups_vs_halves(
                torch, tf, params, cfg, B, P, dev, args.seed + 42,
                max(2, args.reps // 4), out["moe_layer"]["ms"])
            log("  the same layer routed in 2 groups a chunk (dp = 2) vs "
                "two dp = 1 calls on the halves: "
                + json.dumps(out["moe_layer_dp2"]))
        del params
        torch.cuda.empty_cache()
        if arch == MOE_ARCHS[0]:
            out["gates"] = moe_gates(torch, fa, fa_kernel, tf, cfg, dev,
                                     args)
            log("  2-layer fp32 cut at capacity factor E/K (limit 1e-4; "
                "routings compared first): " + json.dumps(out["gates"]))
        res[arch] = out
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"moe path: {res['launches']} flash_attention launches; "
        + json.dumps({"phase_s": res["phase_s"]}))
    return res


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def phase_bert4rec(torch, dev, args, clock) -> dict:
    """Phase 14, bert4rec serving at its full config (fp32 params drawn on
    the card): serve_p99, `score_all_items` of 512 of phase 8's histories
    over the whole table and their top 100; retrieval_cand, one history's
    `score_candidates` against 1,000,000 candidate ids and their top 100.
    Gates: 8 rows within 1e-4 of the CPU's; the candidates' scores within
    1e-5 of the full scores at their columns; no NaN in a row with an
    item. Times with CUDA events, the scoring pass against its bound."""
    from repro_torch.configs import get_arch
    from repro_torch.models import bert4rec as b4r
    t_phase = time.perf_counter()
    spec = get_arch("bert4rec")
    cfg = spec.config
    B = spec.shapes["serve_p99"].dims["batch"]
    n_cand = spec.shapes["retrieval_cand"].dims["n_candidates"]
    k, reps = 100, args.reps
    log(f"phase 14 bert4rec serving: {cfg.n_items} items (table "
        f"{cfg.padded_vocab} x {cfg.embed_dim} fp32), {cfg.n_blocks} blocks, "
        f"{cfg.n_heads} heads, {cfg.seq_len} slots")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 50)
    params = clock("bert4rec init_params (fp32, on the device)",
                   b4r.init_params, gen, cfg, dev)
    idx_np, _ = history_bags(args.bags, cfg.seq_len, cfg.n_items,
                             args.seed + 31)
    seq = torch.from_numpy(idx_np[:B]).to(dev)
    cand = torch.from_numpy(np.random.default_rng(args.seed + 51)
                            .permutation(n_cand) + 1).to(dev)
    res = {"B": B, "n_candidates": n_cand, "k": k}
    with torch.no_grad():
        scores = b4r.score_all_items(params, seq, cfg)
        top = torch.topk(scores, k, dim=-1)
        cs = b4r.score_candidates(params, seq[:1], cand, cfg)
        ctop = torch.topk(cs, k, dim=-1)
        torch.cuda.synchronize()
        check(scores.shape == (B, cfg.padded_vocab)
              and cs.shape == (1, n_cand), "bert4rec scores: bad shapes")
        has_item = (seq != 0).any(1)
        check(int(has_item.sum()) == B
              and not bool(scores[has_item].isnan().any()),
              "bert4rec: NaN in a row with an item")
        rows = torch.from_numpy(np.linspace(0, B - 1, 8).astype(np.int64))
        want = b4r.score_all_items(to_device(params, "cpu"),
                                   seq[rows.to(dev)].cpu(), cfg)
        got = scores[rows.to(dev)].cpu()
        res["rows_vs_cpu"] = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"bert4rec rows on the card vs the CPU: {res['rows_vs_cpu']}")
        res["top_vs_cpu"] = float((top.values[rows.to(dev)].cpu()
                                   - torch.topk(want, k, -1).values).abs().max())
        at_cand = scores[:1, cand]
        res["candidates_vs_all"] = float((cs - at_cand).abs().max())
        check(torch.allclose(cs, at_cand, rtol=1e-5, atol=1e-5),
              f"score_candidates vs score_all_items: "
              f"{res['candidates_vs_all']}")
        res["candidate_top_in_all_top"] = len(
            set(cand[ctop.indices[0]].tolist())
            & set(top.indices[0].tolist())) / k
        del want, got, at_cand

        last = b4r.encode(params, seq, cfg)[:, -1]
        table, bias = params["item_embed"], params["out_bias"]
        res.update(
            encode_ms=cuda_ms(torch, lambda: b4r.encode(params, seq, cfg),
                              reps),
            scoring_ms=cuda_ms(torch, lambda: torch.addmm(bias, last,
                                                          table.T), reps),
            topk_ms=cuda_ms(torch, lambda: torch.topk(scores, k, -1), reps),
            serve_p99_ms=cuda_ms(torch, lambda: torch.topk(
                b4r.score_all_items(params, seq, cfg), k, -1), reps),
            retrieval_ms=cuda_ms(torch, lambda: torch.topk(
                b4r.score_candidates(params, seq[:1], cand, cfg), k, -1),
                reps),
            candidates_topk_ms=cuda_ms(torch, lambda: torch.topk(cs, k, -1),
                                       reps))
        V, d = table.shape
        res["scoring_bound"] = bound(V * d * 4 + V * 4 + B * d * 4
                                     + B * V * 4, 2 * B * V * d,
                                     FP32_OPS_PER_S)
        res["retrieval_bound"] = bound(n_cand * (d * 4 + 4 + 8 + 4)
                                       + cfg.seq_len * 4, 2 * n_cand * d,
                                       FP32_OPS_PER_S)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, scores, top, cs, ctop, last
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log("  bert4rec: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 15: training on the card
# ---------------------------------------------------------------------------
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 2, 4096   # train_4k's 256
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 2       # of phi3.5-moe's 32 layers
REC_TRAIN_BATCH, REC_MASKED, REC_CHUNK = 8192, 40, 8192   # a microbatch
GIN_TRAIN_STEPS = 3
EQ_TRAIN_LAYERS = 4                            # of EquiformerV2's 12


def node_ce(torch, out, labels, mask):
    """The node cross-entropy of repro/launch/steps.py::_gnn_loss: the mean
    over the live nodes, in fp32."""
    logits = out.float()
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.long()[:, None])[:, 0]
    m = mask.to(ce.dtype)
    return (ce * m).sum() / torch.clamp_min(m.sum(), 1)


def timed_steps(torch, dev, step, n_steps: int):
    """`step(i)` for i < n_steps, each ending in a device synchronize:
    (seconds a step, the losses as floats, peak GiB over the steps)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        loss = step(i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return secs, losses, torch.cuda.max_memory_allocated() / 2**30


def grads_of(torch, loss_of, params):
    """(loss, gradients in the tree's leaf order) of loss_of(params)."""
    from torch.utils import _pytree as pytree
    leaves, spec = pytree.tree_flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    loss = loss_of(pytree.tree_unflatten(live, spec))
    return loss.detach(), torch.autograd.grad(loss, live)


def attention_backward_vs_sdpa(torch, fa, q, k, v, reps: int) -> dict:
    """flash_attention's backward (the plain recompute by query chunks)
    against SDPA's backward at one training layer's q, k, v, both timed
    with CUDA events."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    B, S, H, D = q.shape
    g = randn(torch, q.shape, q.device, 7).to(q.dtype)
    dq, dk, dv = fa_ops._backward(q, k, v, g, True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    gt = g.transpose(1, 2)
    lib = torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
    torch.cuda.synchronize()
    errs = [float((a.float() - b.transpose(1, 2).float()).abs().max())
            for a, b in zip((dq, dk, dv), lib)]
    res = {"B": B, "S": S, "H": H, "Hkv": k.shape[2], "D": D,
           "dtype": str(q.dtype).replace("torch.", ""),
           "vs_sdpa_max_abs_err": max(errs)}
    res["ms"] = cuda_ms(torch, lambda: fa_ops._backward(q, k, v, g, True),
                        reps)
    res["sdpa_backward_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), gt, retain_graph=True), reps)
    return res


def train_granite(torch, fa, dev, args, clock) -> dict:
    """(a) granite-3-2b at its full config: fp32 master params and AdamW
    state, bf16 compute, remat "full"; `launch/train.py::train_step` for
    the first 4 steps of the trainer's default 200-step schedule on one
    TokenStream batch of 2 x 4,096 tokens. Gates: finite
    losses, the loss falling from step 0 to step 3, 80 flash_attention
    launches a step; on a 2-layer fp32 cut at full width, the gradient
    with the kernel forward within 1e-4 of the plain forward's."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import (AdamWConfig, adamw_init,
                                   linear_warmup_cosine)
    cfg = get_arch("granite-3-2b").config
    n_steps = LM_TRAIN_STEPS
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 60)
    params = clock("15a granite-3-2b init_params (fp32)", tf.init_params,
                   cfg, gen, dev)
    opt = adamw_init(params)
    ocfg = AdamWConfig()
    # the first steps of the trainer's default run (--steps 200: a 20-step
    # warm-up); a 4-step run's own schedule (1 warm-up step) takes a full
    # 3e-4 step at once, and from random init the loss then climbs
    sched = linear_warmup_cosine(min(20, 200 // 10 + 1), 200)
    np_batch = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, batch=LM_TRAIN_BATCH,
        seq_len=LM_TRAIN_SEQ, seed=args.seed)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    per_step = []

    def step(i):
        nonlocal params, opt
        n0 = fa_ops.launches
        params, opt, loss, _ = train_step(params, opt, batch, cfg, ocfg,
                                          sched)
        per_step.append(fa_ops.launches - n0)
        return loss

    fa_ops.launches = 0                        # the training path (a)...
    secs, losses, peak = timed_steps(torch, dev, step, n_steps)
    launches = fa_ops.launches                 # ...ends here
    check(all(np.isfinite(losses)), f"15a: a loss is not finite: {losses}")
    check(losses[-1] < losses[0],
          f"15a: the loss did not fall from step 0 to {n_steps - 1}: "
          f"{losses}")
    check(per_step == [2 * cfg.n_layers] * n_steps,
          f"15a: flash_attention launches a step {per_step}, expected "
          f"{2 * cfg.n_layers} (the forward and the remat recompute)")
    step_s = float(np.median(secs[1:]))
    flops = 6 * cfg.n_params * tokens
    res = {"n_params": cfg.n_params, "tokens_a_step": tokens,
           "step_s": secs, "losses": losses, "peak_gib": peak,
           "tokens_per_s": tokens / step_s,
           "model_tflops_per_s": flops / step_s / 1e12,
           "model_flops_share_of_989": flops / step_s / BF16_OPS_PER_S,
           "launches": launches, "launches_a_step": per_step}
    with torch.no_grad():
        q, k, v = attention_inputs(torch, tf, params, cfg, batch["tokens"])
    res["attention_backward"] = attention_backward_vs_sdpa(torch, fa, q, k,
                                                           v, 3)
    del q, k, v, opt

    # the 2-layer fp32 cut: the kernel's gradient against the plain one
    cut = dataclasses.replace(cfg, n_layers=2, compute_dtype=torch.float32)
    p2 = {"embed": params["embed"], "layers": first_layers(
        params["layers"], 2), "final_norm": params["final_norm"],
          "lm_head": params["lm_head"]}
    b2 = {k: v[:1, :2048] for k, v in batch.items()}
    n0 = fa_ops.launches
    loss_k, g_k = grads_of(torch, lambda p: tf.loss_fn(p, b2, cut), p2)
    check(fa_ops.launches == n0 + 2 * cut.n_layers,
          f"15a: {fa_ops.launches - n0} flash_attention launches in the "
          f"2-layer cut's gradient")
    with plain_attention(tf, fa):
        loss_p, g_p = grads_of(torch, lambda p: tf.loss_fn(p, b2, cut), p2)
    err = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
             for a, b in zip(g_k, g_p))
    res["fp32_cut"] = {"tokens": int(b2["tokens"].numel()),
                       "loss_kernel": float(loss_k), "loss_plain":
                       float(loss_p), "grad_max_abs_err": err}
    check(ok, f"15a: 2-layer fp32 cut, gradient with the kernel vs the "
              f"plain forward: max abs err {err}")
    del params, p2, g_k, g_p, batch
    torch.cuda.empty_cache()
    return res


def train_moe(torch, dev, args, clock) -> dict:
    """(b) phi3.5-moe at full width cut to 2 of 32 layers, fp32 master
    params and AdamW state, bf16 compute: 2 `train_step`s on 1 x 4,096
    tokens. Gates: finite losses, the balance loss above 0, the router's
    gradient not 0 (its first moment after step 0 is (1 - b1) times the
    clipped gradient)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b").config,
                              n_layers=MOE_TRAIN_LAYERS,
                              param_dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 61)
    params = clock("15b phi3.5-moe init_params (fp32, 2 layers)",
                   tf.init_params, cfg, gen, dev)
    opt = adamw_init(params)
    ocfg = AdamWConfig()
    np_batch = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, batch=1, seq_len=LM_TRAIN_SEQ,
        seed=args.seed + 1)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
    with torch.no_grad():
        _, aux = tf.forward(params, batch["tokens"], cfg)
    aux = float(aux)
    router_m = []

    def step(i):
        nonlocal params, opt
        params, opt, loss, _ = train_step(params, opt, batch, cfg, ocfg)
        if i == 0:
            router_m.append(float(opt["m"]["layers"]["mlp"]["router"]
                                  .abs().sum()))
        return loss

    fa_ops.launches = 0                        # the training path (b)...
    secs, losses, peak = timed_steps(torch, dev, step, MOE_TRAIN_STEPS)
    launches = fa_ops.launches                 # ...ends here
    check(all(np.isfinite(losses)), f"15b: a loss is not finite: {losses}")
    check(aux > 0, f"15b: the MoE balance loss is {aux}")
    check(router_m[0] > 0, "15b: the router's gradient is 0")
    check(launches == 2 * cfg.n_layers * MOE_TRAIN_STEPS,
          f"15b: {launches} flash_attention launches")
    res = {"n_params": cfg.n_params, "tokens_a_step": LM_TRAIN_SEQ,
           "step_s": secs, "losses": losses, "aux": aux,
           "router_m_abs_sum": router_m[0], "peak_gib": peak,
           "launches": launches}
    del params, opt, batch
    torch.cuda.empty_cache()
    return res


def train_bert4rec(torch, dev, args, clock) -> dict:
    """(c) bert4rec at its full config, one of train_batch's 8
    microbatches (8,192 sequences), 40 masked slots a sequence, vocab
    chunks of 8,192: 2 `train_step`s of `masked_lm_loss`. Gates: finite
    losses, the item table's gradient not 0 (its first moment after step
    0)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_step
    from repro_torch.models import bert4rec as b4r
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_arch("bert4rec").config
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 62)
    params = clock("15c bert4rec init_params (fp32)", b4r.init_params, gen,
                   cfg, dev)
    opt = adamw_init(params)
    seq, _ = history_bags(REC_TRAIN_BATCH, cfg.seq_len, cfg.n_items,
                          args.seed + 63)
    # 40 slots a sequence, its items first: a shorter history's other
    # slots stay padding with label 0 (unused)
    rng = np.random.default_rng(args.seed + 64)
    mpos = np.argsort(rng.random(seq.shape) + (seq == 0), 1)[
        :, :REC_MASKED].astype(np.int32)
    labels = np.take_along_axis(seq, mpos, 1)
    np.put_along_axis(seq, mpos, np.where(labels > 0, cfg.vocab - 1, 0), 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             (("item_seq", seq), ("masked_positions", mpos),
              ("labels", labels))}

    def loss_fn(p, b, c):
        return b4r.masked_lm_loss(p, b, c, vocab_chunk=REC_CHUNK)

    table_m = []

    def step(i):
        nonlocal params, opt
        params, opt, loss, _ = train_step(params, opt, batch, cfg,
                                          AdamWConfig(), loss_fn=loss_fn)
        if i == 0:
            table_m.append(float(opt["m"]["item_embed"].abs().sum()))
        return loss

    secs, losses, peak = timed_steps(torch, dev, step, 2)
    check(all(np.isfinite(losses)), f"15c: a loss is not finite: {losses}")
    check(table_m[0] > 0, "15c: the item table's gradient is 0")
    R = REC_TRAIN_BATCH * REC_MASKED
    res = {"sequences": REC_TRAIN_BATCH, "masked_rows": R,
           "labelled_rows": int((labels > 0).sum()),
           "vocab_chunks": -(-cfg.padded_vocab // REC_CHUNK),
           "step_s": secs, "losses": losses, "peak_gib": peak,
           # the scores forward, their recompute, d(rows) and d(table)
           "scoring_flop_a_step": 4 * 2 * R * cfg.padded_vocab
           * cfg.embed_dim}
    del params, opt, batch
    torch.cuda.empty_cache()
    return res


def gnn_batch(torch, sub, table, labels_seed: int, n_cls: int, dev):
    """A sampled subgraph on `dev` with its features gathered from the
    card's table and seeded labels."""
    nodes = torch.from_numpy(sub.nodes).to(table.device)
    b = {k: torch.from_numpy(getattr(sub, k)).to(dev)
         for k in ("src", "dst", "edge_mask", "node_mask")}
    b["x"] = (table.index_select(0, nodes)
              * b["node_mask"].to(table.device)[:, None]).to(dev)
    b["labels"] = torch.from_numpy(np.random.default_rng(labels_seed)
                                   .integers(0, n_cls, len(sub.nodes))).to(dev)
    return b


def train_gin(torch, ps, sub, n: int, dev, args) -> dict:
    """(d) gin-tu (5 x 64, adapted to minibatch_lg) on phase 11's first
    sampled minibatch: 3 AdamW steps of the node cross-entropy. Gates: the
    first step's gradient on the card within 1e-4 of the CPU's; losses
    finite; psw_spmm launches 10 a step (the forward's 5 and the
    transpose's 5)."""
    from repro_torch import convert
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.launch.train import train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    cell = GNN_SHAPES["minibatch_lg"]
    models, cfgs, params = gnn_models(torch, dev, args.seed + 33)
    gin, cfg, params = models["gin-tu"], cfgs["gin-tu"], params["gin-tu"]
    table = randn(torch, (n, cell["d_feat"]), dev, args.seed + 32)
    batch = gnn_batch(torch, sub, table, args.seed + 65, cell["n_classes"],
                      dev)
    del table

    def loss_fn(p, b, c):
        return node_ce(torch, gin.forward(p, b, c), b["labels"],
                       b["node_mask"])

    p_cpu = convert.gnn_params_from_arrays(
        convert.gnn_params_to_arrays(params), params, "cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss_d, g_d = grads_of(torch, lambda p: loss_fn(p, batch, cfg), params)
    loss_c, g_c = grads_of(torch, lambda p: loss_fn(p, cpu_batch, cfg),
                           p_cpu)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(g_d, g_c))
    check(all(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4)
              for a, b in zip(g_d, g_c)),
          f"15d: GIN's gradient on the card vs the CPU: max abs err {err}")
    del g_d, g_c, p_cpu, cpu_batch
    opt = adamw_init(params)

    def step(i):
        nonlocal params, opt
        params, opt, loss, _ = train_step(params, opt, batch, cfg,
                                          AdamWConfig(), loss_fn=loss_fn)
        return loss

    ps.ops.launches = 0                        # the training path (d)...
    secs, losses, peak = timed_steps(torch, dev, step, GIN_TRAIN_STEPS)
    launches = ps.ops.launches                 # ...ends here
    check(all(np.isfinite(losses)), f"15d: a loss is not finite: {losses}")
    check(launches == 2 * cfg.n_layers * GIN_TRAIN_STEPS,
          f"15d: {launches} psw_spmm launches in {GIN_TRAIN_STEPS} steps")
    res = {"nodes": int(sub.node_mask.sum()), "edges":
           int(sub.edge_mask.sum()), "loss_card": float(loss_d),
           "loss_cpu": float(loss_c), "grad_max_abs_err": err,
           "step_s": secs, "losses": losses, "peak_gib": peak,
           "launches": launches}
    return res, batch


def equiformer_inputs(torch, n: int, seed: int, dev):
    """Reddit has no geometry, so EquiformerV2's node inputs are made as
    the reference's config says ("unit-ball positions and hashed species
    ids"): one position a vertex drawn uniformly in the unit ball (a
    direction from a normal draw, a radius u^(1/3)), a table on the card;
    species (vertex id * 2654435761 mod 2^32) mod 128. Returns (the
    positions, the species, the generator the draw leaves)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    pos_np = u / np.linalg.norm(u, axis=1, keepdims=True) \
        * rng.random((n, 1)) ** (1 / 3)
    pos_table = torch.from_numpy(pos_np.astype(np.float32)).to(dev)
    species_table = torch.arange(n, device=dev) * 2654435761 % 2**32 % 128
    return pos_table, species_table, rng


def train_equiformer(torch, ps, sub, n: int, dev, args) -> dict:
    """(e) EquiformerV2 at phase 12's config (psw_ring on one rank, 4 edge
    chunks, remat) cut to 4 of 12 layers, one AdamW step of the node
    cross-entropy on phase 12's first batch. Gates: finite gradients (a
    finite global norm above 0); psw_spmm launches 3 a layer and chunk
    (the forward, the layer's recompute, the transpose)."""
    import dataclasses
    from repro_torch.launch.train import train_step
    from repro_torch.models.gnn import equiformer_v2 as eq
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = dataclasses.replace(equiformer_config(torch),
                              n_layers=EQ_TRAIN_LAYERS)
    pos, species, _ = equiformer_inputs(torch, n, args.seed + 50, dev)
    nodes = torch.from_numpy(sub.nodes).to(dev)
    batch = {"species": species[nodes], "pos": pos[nodes]}
    batch.update({k: torch.from_numpy(getattr(sub, k)).to(dev)
                  for k in ("src", "dst", "edge_mask", "node_mask")})
    batch["labels"] = torch.from_numpy(np.random.default_rng(
        args.seed + 66).integers(0, cfg.d_out, len(sub.nodes))).to(dev)
    del pos, species, nodes
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 51)
    params = eq.init_params(gen, cfg, dev)
    opt = adamw_init(params)

    def loss_fn(p, b, c):
        return node_ce(torch, eq.forward(p, b, c), b["labels"],
                       b["node_mask"])

    gnorm = []

    def step(i):
        nonlocal params, opt
        params, opt, loss, metrics = train_step(
            params, opt, batch, cfg, AdamWConfig(), loss_fn=loss_fn)
        gnorm.append(float(metrics["grad_norm"]))
        return loss

    ps.ops.launches = 0                        # the training path (e)...
    secs, losses, peak = timed_steps(torch, dev, step, 1)
    launches = ps.ops.launches                 # ...ends here
    want = 3 * cfg.n_layers * cfg.edge_chunks
    check(np.isfinite(losses[0]) and np.isfinite(gnorm[0]) and gnorm[0] > 0,
          f"15e: loss {losses[0]}, gradient norm {gnorm[0]}")
    check(launches == want, f"15e: {launches} psw_spmm launches, expected "
          f"{want} (forward, recompute and transpose a layer and chunk)")
    res = {"layers": cfg.n_layers, "edge_chunks": cfg.edge_chunks,
           "nodes": int(sub.node_mask.sum()),
           "edges": int(sub.edge_mask.sum()), "step_s": secs,
           "losses": losses, "grad_norm": gnorm[0], "peak_gib": peak,
           "launches": launches}
    del params, opt, batch
    torch.cuda.empty_cache()
    return res


def transpose_vs_plain(torch, ps, ps_kernel, lay, g, reps: int,
                       tag: str = "15f") -> dict:
    """psw_spmm's backward on the card: A^T g over `transpose_rows(lay)`
    (built on the card, timed on its own; equal to `prepare_rows` of the
    swapped edges) against its plain version (rowwise 1e-5), with the
    bytes-read-once bound and `torch.sparse.mm` over the same CSR. `tag`
    names the phase in a failure."""
    t0 = time.perf_counter()
    lay.cache.pop("transpose", None)
    tr = ps.transpose_rows(lay)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    rows = torch.repeat_interleave(
        torch.arange(lay.n_rows, device=lay.col.device),
        lay.row_ptr[1:] - lay.row_ptr[:-1])
    cols = lay.col.long()
    want = ps.prepare_rows(rows.repeat_interleave(lay.val.long()),
                           cols.repeat_interleave(lay.val.long()),
                           lay.n_src, lay.block, device=g.device,
                           n_src=lay.n_rows)
    same = all(torch.equal(getattr(tr, f), getattr(want, f)) for f in
               ("row_ptr", "col", "val", "hub_rows", "hub_ptr", "chunks"))
    check(same, f"{tag}: transpose_rows != prepare_rows of the swapped "
                "edges")
    del want, rows, cols
    out, res = psw_spmm_layout_vs_plain(torch, ps, ps_kernel, tr, g, reps)
    n, F = tr.n_rows, g.shape[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "sparse CSR is in beta"
        adj = torch.sparse_csr_tensor(tr.row_ptr, tr.col.long(), tr.val,
                                      size=(n, tr.n_src))
    lib = torch.sparse.mm(adj, g)
    torch.cuda.synchronize()
    lib_ok, lib_err, _ = row_tolerance(lib, out, 1e-4, 1e-4)
    check(lib_ok, f"{tag}: torch.sparse.mm vs the transpose: {lib_err}")
    del lib, out
    library_ms = cuda_ms(torch, lambda: torch.sparse.mm(adj, g), reps)
    del adj
    g_rows = int(tr.col.unique().numel())
    bytes_once = (n + 1) * 8 + tr.nnz * 8 + (g_rows + n) * F * 4
    return {"transpose_rows_ms": build_ms, "g_rows_read": g_rows, **res,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            **bound(bytes_once, 2 * tr.nnz * F, FP32_OPS_PER_S)}


def phase_train(torch, ps, ps_kernel, subs, n: int, dev, args,
                clock) -> dict:
    """Phase 15, training on the card, each model freed before the next:
    (a) granite-3-2b, (b) phi3.5-moe cut to 2 layers, (c) bert4rec, (d)
    GIN on phase 11's batch, (e) EquiformerV2 cut to 4 layers on phase
    12's, (f) psw_spmm's transpose at the GIN shape and EquiformerV2's
    scatter shape against its plain version."""
    from repro_torch.kernels import flash_attention as fa
    t_phase = time.perf_counter()
    log("phase 15 training on the card")
    res = {"granite": train_granite(torch, fa, dev, args, clock)}
    log("  15a granite-3-2b: " + json.dumps(res["granite"]))
    res["phi_moe"] = train_moe(torch, dev, args, clock)
    log("  15b phi3.5-moe: " + json.dumps(res["phi_moe"]))
    res["bert4rec"] = train_bert4rec(torch, dev, args, clock)
    log("  15c bert4rec: " + json.dumps(res["bert4rec"]))
    res["gin"], gin_batch = train_gin(torch, ps, subs["gin"], n, dev, args)
    log("  15d gin-tu: " + json.dumps(res["gin"]))
    res["equiformer"] = train_equiformer(torch, ps, subs["equiformer"], n,
                                         dev, args)
    log("  15e EquiformerV2: " + json.dumps(res["equiformer"]))

    # (f) the transpose: GIN's layout (the batch's live edges) and one
    # EquiformerV2 scatter chunk (rows the destinations, sources the
    # chunk's live edges), each against the cotangent's width
    live = gin_batch["edge_mask"]
    lay = ps.prepare_rows(gin_batch["src"][live], gin_batch["dst"][live],
                          gin_batch["x"].shape[0], device=dev)
    g = randn(torch, (lay.n_rows, 64), dev, args.seed + 67)
    res["transpose_gin"] = transpose_vs_plain(torch, ps, ps_kernel, lay, g,
                                              args.reps)
    log("  15f transpose at the GIN shape: "
        + json.dumps(res["transpose_gin"]))
    del gin_batch, lay, g
    sub = subs["equiformer"]
    cfg = equiformer_config(torch)
    E = len(sub.edge_mask)
    Ec = E // cfg.edge_chunks
    emask = torch.from_numpy(sub.edge_mask[:Ec]).to(dev)
    dst = torch.from_numpy(sub.dst[:Ec]).to(dev).long()
    live = torch.nonzero(emask).flatten()
    lay = ps.prepare_rows(live, dst[live], len(sub.nodes), device=dev,
                          n_src=Ec)
    K = (cfg.l_max + 1) ** 2
    g = randn(torch, (lay.n_rows, K * cfg.d_hidden), dev, args.seed + 68)
    res["transpose_equiformer"] = transpose_vs_plain(torch, ps, ps_kernel,
                                                     lay, g, args.reps)
    log("  15f transpose at the EquiformerV2 scatter shape: "
        + json.dumps(res["transpose_equiformer"]))
    del lay, g
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"train path: {res['granite']['launches']} + "
        f"{res['phi_moe']['launches']} flash_attention launches, "
        f"{res['gin']['launches']} + {res['equiformer']['launches']} "
        f"psw_spmm launches; " + json.dumps({"phase_s": res["phase_s"]}))
    return res


# ---------------------------------------------------------------------------
# phase 16: the cell steps of launch/steps.py on the card
# ---------------------------------------------------------------------------
CELL_REC_TRAIN_BATCH = 16_384          # train_batch's 65,536 cut, accum 8
CELL_LM_TRAIN_BATCH = 8                # train_4k's 256 cut, accum 2
CELL_PREFILL_BATCH, CELL_DECODE_BATCH = 2, 8   # prefill 32 / decode 128 cut
CELL_SAMPLE = 512                      # serve_bulk requests held to topk


def cell_rules():
    from repro_torch.sharding import DEFAULT_RULES, ShardingRules
    return ShardingRules(rules=dict(DEFAULT_RULES), mesh=None)


def cut_cell(spec, shape: str, config=None, **dims):
    """The spec with one cell's dims overridden (and its config)."""
    import dataclasses
    cell = spec.shapes[shape]
    return dataclasses.replace(
        spec, config=spec.config if config is None else config,
        shapes={shape: dataclasses.replace(cell,
                                           dims={**cell.dims, **dims})})


def topk_swaps(v, i, v_ref, i_ref, tol: float) -> int:
    """Values within tol; ids equal but where two scores tie within float
    rounding and swap (the reference's id then sits elsewhere in the row
    with its value, or fell off the end beside an equal last value).
    Returns the swaps; fails on any other difference."""
    check(np.allclose(v, v_ref, rtol=tol, atol=tol),
          f"top-k values: max abs err {np.abs(v - v_ref).max()}")
    rows, cols = np.nonzero(i != i_ref)
    for r, c in zip(rows, cols):
        at = np.nonzero(i[r] == i_ref[r, c])[0]
        got = v[r, at[0]] if at.size else v[r, -1]
        check(abs(got - v_ref[r, c]) <= tol,
              f"top-k ids differ beyond a tie at row {r}, slot {c}")
    return len(rows)


def cell_serve_bulk(torch, dev, args) -> dict:
    """16a: bert4rec serve_bulk through `build_cell` at full size: 262,144
    histories of 200 slots, every one of the 1,000,192 rows, top 100, in
    request chunks of 16,384 and vocab chunks of 65,536. Gates: (B, 100)
    finite values in descending order; for 512 sampled requests the ids
    and values of `torch.topk` over `score_all_items` (ids < vocab) within
    1e-5 (a tie may swap ids)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import bert4rec as b4r
    spec = get_arch("bert4rec")
    cfg = spec.config
    plan = steps.build_cell(spec, "serve_bulk", cell_rules(), 1)
    B = spec.shapes["serve_bulk"].dims["batch"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 90)
    params = b4r.init_params(gen, cfg, dev)
    seq = torch.from_numpy(history_bags(B, cfg.seq_len, cfg.n_items,
                                        args.seed + 91)[0]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v, i = plan.fn(params, seq)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(tuple(v.shape) == (B, 100) and tuple(i.shape) == (B, 100),
          f"16a: shapes {tuple(v.shape)}, {tuple(i.shape)}")
    check(bool(torch.isfinite(v).all()) and bool((v[:, 1:] <= v[:, :-1])
                                                 .all()),
          "16a: top-100 values not finite or not descending")
    sample = torch.from_numpy(np.sort(np.random.default_rng(
        args.seed + 92).choice(B, CELL_SAMPLE, replace=False))).to(dev)
    with torch.no_grad():
        want = torch.topk(b4r.score_all_items(params, seq[sample], cfg)[
            :, :cfg.vocab], 100, dim=-1)
    swaps = topk_swaps(v[sample].cpu().numpy(), i[sample].cpu().numpy(),
                       want.values.cpu().numpy(),
                       want.indices.int().cpu().numpy(), 1e-5)
    res = {"requests": B, "s": secs, "requests_per_s": B / secs,
           "sample": CELL_SAMPLE, "sample_id_swaps": swaps,
           "sample_max_abs_err": float((v[sample] - want.values).abs()
                                       .max()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params, seq, v, i, want
    torch.cuda.empty_cache()
    return res


def accumulated_vs_one_pass(torch, steps, plan, params, opt, batch, loss_of,
                            cast=None) -> dict:
    """The plan's step (its microbatches) against `_accumulated_step` with
    one microbatch on copies of the same params. The gradient norms before
    the clip within 1e-4 relative: the clip (to norm 1) would hide a fault
    that only scales the gradient, such as summing microbatches where they
    are averaged. The clipped gradients (each first moment over 1 - b1)
    within rtol 1e-4 and atol 1e-5 x the largest |g| of the one pass.
    Returns the norms, the largest |g| and the errors."""
    from torch.utils import _pytree as pytree
    from repro_torch.optim import AdamWConfig, adamw_init
    p1 = pytree.tree_map(lambda t: t.clone(), params)
    o1 = adamw_init(p1)
    _, _, met = plan.fn(params, opt, batch)
    _, _, met1 = steps._accumulated_step(p1, o1, batch, 1, loss_of,
                                         AdamWConfig(), cast)
    norm, norm1 = float(met["grad_norm"]), float(met1["grad_norm"])
    norm_err = abs(norm - norm1) / norm1
    check(norm_err <= 1e-4, f"accumulated gradient norm {norm} vs one pass "
                            f"{norm1}")
    b1 = AdamWConfig().b1
    ga = [m / (1 - b1) for m in pytree.tree_leaves(opt["m"])]
    g1 = [m / (1 - b1) for m in pytree.tree_leaves(o1["m"])]
    gmax = max(float(b.abs().max()) for b in g1)
    err = max(float((a - b).abs().max()) for a, b in zip(ga, g1))
    ratio = max(float(((a - b).abs() / (1e-4 * b.abs() + 1e-5 * gmax))
                      .max()) for a, b in zip(ga, g1))
    check(ratio <= 1.0, f"accumulated gradient vs one pass: max abs err "
                        f"{err}, largest |g| {gmax}, {ratio:.2f}x the "
                        f"tolerance")
    return {"grad_norm": norm, "one_pass_grad_norm": norm1,
            "grad_norm_rel_err": norm_err, "grad_max_abs": gmax,
            "grad_max_abs_err": err, "err_over_tolerance": ratio}


def cell_rec_train(torch, dev, args) -> dict:
    """16b: bert4rec train_batch cut to B = 16,384, which the cell's rule
    runs as 8 microbatches of 2,048 (40 masked slots, vocab chunks of
    8,192): one step at the full config. Gates: a finite loss, the item
    table's gradient not 0; on a cut that fits one pass (100,000 items,
    20 slots, 4 masked a sequence, all labelled) the 8-microbatch gradient
    against one pass over the same rows (`accumulated_vs_one_pass`)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import bert4rec as b4r
    spec = cut_cell(get_arch("bert4rec"), "train_batch",
                    batch=CELL_REC_TRAIN_BATCH)
    plan = steps.build_cell(spec, "train_batch", cell_rules(), 1)
    check(plan.meta["grad_accum"] == 8,
          f"16b: {plan.meta['grad_accum']} microbatches, expected 8")
    gen = torch.Generator()
    gen.manual_seed(args.seed + 93)
    params, opt, batch = steps.materialize(plan, dev, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, met = plan.fn(params, opt, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    loss = float(met["loss"])
    check(np.isfinite(loss), f"16b: loss {loss}")
    check(float(opt["m"]["item_embed"].abs().sum()) > 0,
          "16b: the item table's gradient is 0")
    res = {"sequences": CELL_REC_TRAIN_BATCH, "microbatches": 8,
           "step_s": secs, "loss": loss,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params, opt, batch
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(spec.config, n_items=100_000, seq_len=20)
    cut = cut_cell(spec, "train_batch", config=cfg,
                   batch=CELL_REC_TRAIN_BATCH)
    plan = steps.build_cell(cut, "train_batch", cell_rules(), 1)
    params, opt, batch = steps.materialize(plan, dev, gen)
    batch = {**batch, "masked_positions": batch["masked_positions"][
        :, :4].contiguous(), "labels": batch["labels"][:, :4].contiguous()}
    res["cut_vs_one_pass"] = accumulated_vs_one_pass(
        torch, steps, plan, params, opt, batch,
        lambda p, mb: b4r.masked_lm_loss(p, mb, cfg, vocab_chunk=8192))
    del params, opt, batch
    torch.cuda.empty_cache()
    return res


def cell_gin_products(torch, ps, ps_kernel, dev, args) -> dict:
    """16c: gin-tu x ogb_products through `build_cell` at full size:
    2,449,029 nodes (padded to 2,449,408) and 61,859,140 power-law edges
    from --seed (padded to 61,865,984, masked), 100 features, 47 classes,
    16 edge chunks (no effect on the row gather); 2 train steps. Gates:
    finite losses, 10 psw_spmm launches a step (5 forward, 5 transpose).
    Then the kernel at the cell's shape: the step's row layout (the
    batch's live edges, as GIN builds it) at F = 64, forward and
    transpose, each against its plain version (rowwise 1e-5), with their
    bounds and torch.sparse.mm."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    spec = get_arch("gin-tu")
    dims = spec.shapes["ogb_products"].dims
    plan = steps.build_cell(spec, "ogb_products", cell_rules(), 1)
    gen = torch.Generator()
    gen.manual_seed(args.seed + 94)
    params, opt, batch = steps.materialize(plan, dev, gen)
    src, dst = power_law_graph(dims["n_nodes"], dims["n_edges"],
                               seed=args.seed + 95)
    e = len(src)
    batch["src"][:e] = torch.from_numpy(src.astype(np.int32)).to(dev)
    batch["dst"][:e] = torch.from_numpy(dst.astype(np.int32)).to(dev)
    del src, dst
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    ps.ops.launches = 0                        # the cell path (16c)...
    for _ in range(2):
        t0 = time.perf_counter()
        params, opt, met = plan.fn(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    launches = ps.ops.launches                 # ...ends here
    n_layers = len(params["layers"])
    check(all(np.isfinite(losses)), f"16c: losses {losses}")
    check(launches == 2 * 2 * n_layers,
          f"16c: {launches} psw_spmm launches in 2 steps, expected "
          f"{4 * n_layers}")
    res = {"nodes": dims["n_nodes"], "edges": e, "padded": [
        plan.meta["n_nodes"], plan.meta["n_edges"]], "step_s": secs,
           "losses": losses, "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params, opt
    torch.cuda.empty_cache()
    live = batch["edge_mask"]
    n = batch["x"].shape[0]
    F = spec.config.d_hidden
    edges = (batch["src"][live], batch["dst"][live],
             randn(torch, (n, F), dev, args.seed + 97))
    del batch
    res["psw_spmm"], lay, out = psw_spmm_rows_vs_plain(torch, ps, ps_kernel,
                                                       edges, args.reps)
    del edges, out
    g = randn(torch, (n, F), dev, args.seed + 98)
    res["transpose"] = transpose_vs_plain(torch, ps, ps_kernel, lay, g,
                                          args.reps, "16c")
    del lay, g
    torch.cuda.empty_cache()
    return res


def cell_lm(torch, dev, args) -> tuple:
    """16d: granite-3-2b x train_4k at full depth cut to B = 8, which the
    cell's rule splits into 2 microbatches of 4 x 4,096; one step (fp32
    master params, bf16 compute, remat "full"). Gates: a finite loss, 160
    flash_attention launches (2 microbatches x 40 layers x forward and
    recompute); on a 2-layer fp32 cut at full width (4 x 2,048 tokens, 2
    microbatches) the accumulated gradient against one pass
    (`accumulated_vs_one_pass`). 16e:
    prefill_32k cut to B = 2 (2 x 32,768 tokens, 40 launches) and
    decode_32k cut to B = 8 at a 32,768-slot cache (random bf16 entries),
    through the cells' functions: finite logits. Returns (the result, the
    16d step's clipped gradient tree for 16f)."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    full = get_arch("granite-3-2b")
    cfg = full.config
    spec = cut_cell(full, "train_4k", batch=CELL_LM_TRAIN_BATCH)
    plan = steps.build_cell(spec, "train_4k", cell_rules(), 1)
    check(plan.meta["grad_accum"] == 2,
          f"16d: {plan.meta['grad_accum']} microbatches, expected 2")
    gen = torch.Generator()
    gen.manual_seed(args.seed + 96)
    params, opt, batch = steps.materialize(plan, dev, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = 0                        # the cell path (16d)...
    t0 = time.perf_counter()
    params, opt, met = plan.fn(params, opt, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fa_ops.launches                 # ...ends here
    loss = float(met["loss"])
    tokens = CELL_LM_TRAIN_BATCH * 4096
    check(np.isfinite(loss), f"16d: loss {loss}")
    check(launches == 2 * 2 * cfg.n_layers,
          f"16d: {launches} flash_attention launches, expected "
          f"{4 * cfg.n_layers}")
    res = {"train": {"tokens": tokens, "microbatches": 2, "step_s": secs,
                     "tokens_per_s": tokens / secs, "loss": loss,
                     "grad_norm": float(met["grad_norm"]),
                     "launches": launches,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}}
    grads = pytree.tree_map(lambda m: m.div_(0.1), opt["m"])   # 1 - b1
    del opt, batch
    torch.cuda.empty_cache()

    # the 2-layer fp32 cut: 2 microbatches against one pass
    c2 = dataclasses.replace(cfg, n_layers=2, compute_dtype=torch.float32)
    cut = cut_cell(full, "train_4k", config=c2, batch=4, seq=2048)
    rule = steps.lm_grad_accum
    steps.lm_grad_accum = lambda *a, **k: 2    # the cut's rule would say 1
    try:
        plan_c = steps.build_cell(cut, "train_4k", cell_rules(), 1)
    finally:
        steps.lm_grad_accum = rule
    p2, o2, b2 = steps.materialize(plan_c, dev, gen)
    n0 = fa_ops.launches
    res["train"]["fp32_cut_vs_one_pass"] = accumulated_vs_one_pass(
        torch, steps, plan_c, p2, o2, b2,
        lambda p, mb: tf.loss_fn(p, mb, c2))
    res["train"]["fp32_cut_launches"] = fa_ops.launches - n0
    del p2, o2, b2
    torch.cuda.empty_cache()

    # 16e: prefill and decode through the cells' functions
    S = full.shapes["prefill_32k"].dims["seq"]
    pplan = steps.build_cell(cut_cell(full, "prefill_32k",
                                      batch=CELL_PREFILL_BATCH),
                             "prefill_32k", cell_rules(), 1)
    tokens = torch.randint(0, cfg.vocab_size, (CELL_PREFILL_BATCH, S),
                           generator=gen).to(dev)
    fa_ops.launches = 0                        # the cell path (16e)...
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = pplan.fn(params, tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    p_launches = fa_ops.launches               # ...ends here
    check(bool(torch.isfinite(logits.float()).all())
          and tuple(cache["k"].shape) == (cfg.n_layers, CELL_PREFILL_BATCH,
                                          S, cfg.n_kv_heads, cfg.head_dim),
          "16e: prefill logits not finite or a bad cache")
    check(p_launches == cfg.n_layers,
          f"16e: {p_launches} flash_attention launches in the prefill")
    del logits, cache, tokens
    torch.cuda.empty_cache()
    dplan = steps.build_cell(cut_cell(full, "decode_32k",
                                      batch=CELL_DECODE_BATCH),
                             "decode_32k", cell_rules(), 1)
    _, cache, tok, pos = steps.materialize(dplan, dev, gen)
    torch.cuda.empty_cache()
    times = []
    with torch.no_grad():
        for p in range(pos - 3, pos + 1):
            t0 = time.perf_counter()
            logits, cache = dplan.fn(params, cache, tok, p)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            tok = logits.argmax(-1, keepdim=True).int()
    check(bool(torch.isfinite(logits.float()).all()),
          "16e: decode logits not finite")
    res["serve"] = {"prefill_tokens": CELL_PREFILL_BATCH * S,
                    "prefill_s": prefill_s, "prefill_launches": p_launches,
                    "decode_batch": CELL_DECODE_BATCH, "cache_slots": S,
                    "decode_ms_a_token": [t * 1e3 for t in times]}
    del params, cache, logits
    torch.cuda.empty_cache()
    return res, grads


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cell_collectives(torch, core, dev, args, grads) -> dict:
    """16f: a one-rank NCCL process group on the card. `pagerank_device`
    with the group (the ranked sweep: one all_to_all_single of the window
    rows, or one all_gather_into_tensor) bitwise equal to the group-less
    one in both modes, on a DeviceGraph of bench_shard's 3M power-law
    edges (200,000 ids, 8 intervals); `compressed_psum_tree` over 16d's
    gradient tree bitwise the local ef_compress / ef_decompress round trip
    (values and residuals), with the bytes its all-reduces take (the int8
    payloads widened to int32, 4 bytes a value, and one fp32 scale a leaf)
    and its ms: on one rank NCCL moves nothing, so the time is the
    quantization and the rank's own reduce."""
    import torch.distributed as dist
    from repro_torch.optim import (compressed_psum_tree, ef_compress,
                                   ef_decompress)
    from torch.utils import _pytree as pytree
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        pg = dist.group.WORLD
        n = args.service_vertices
        src, dst = power_law_graph(n, args.service_edges, seed=8)
        g = core.GraphPAL.from_edges(src, dst, n_partitions=8, max_id=n - 1)
        dg = core.build_device_graph(g, device=dev)
        mine = dg.shard(0, 1)
        res = {"edges": int(dg.n_edges)}
        for mode in PR_MODES:
            one = core.pagerank_device(dg, mode=mode)
            ranked = core.pagerank_device(mine, mode=mode, group=pg)
            check(torch.equal(one, ranked),
                  f"16f: ranked PageRank ({mode}) differs from one device")
            res[mode + "_ms"] = cuda_ms(torch, lambda: core.pagerank_device(
                mine, mode=mode, group=pg), 3)
        del dg, mine, g
        leaves = pytree.tree_leaves(grads)
        zeros = pytree.tree_map(torch.zeros_like, grads)
        mean, new_r = compressed_psum_tree(grads, zeros, pg)
        for gl, rl, ml, nl in zip(leaves, pytree.tree_leaves(zeros),
                                  pytree.tree_leaves(mean),
                                  pytree.tree_leaves(new_r)):
            q, s, nr = ef_compress(gl, rl)
            check(torch.equal(ml, ef_decompress(q, s))
                  and torch.equal(nl, nr),
                  "16f: compressed_psum_tree on one rank differs from the "
                  "local round trip")
        del mean, new_r, q, s, nr
        res["psum_leaves"] = len(leaves)
        res["psum_values"] = sum(t.numel() for t in leaves)
        res["psum_payload_bytes"] = 4 * res["psum_values"]     # int32
        res["psum_scale_bytes"] = 4 * len(leaves)
        res["psum_ms"] = cuda_ms(torch, lambda: compressed_psum_tree(
            grads, zeros, pg), 2)
    finally:
        dist.destroy_process_group()
    return res


DRYRUN_CELLS = (("gin-tu", "full_graph_sm"),
                ("equiformer-v2", "minibatch_lg"))


def start_dryrun():
    """16g's subprocess, started first: the DRYRUN_CELLS on the
    single-pod mesh of a fake world of 256, one after the other in one
    interpreter on the host."""
    out = os.path.join(ROOT, "build", "dryrun_phase")
    os.makedirs(out, exist_ok=True)
    code = ("import sys\nfrom repro_torch.launch import dryrun\n"
            "for arch, shape in %r:\n"
            "    dryrun.main(['--arch', arch, '--shape', shape, '--mesh', "
            "'single', '--out', sys.argv[1]])\n" % (DRYRUN_CELLS,))
    env = {**os.environ, "PYTHONPATH": SRC}
    return out, subprocess.Popen([sys.executable, "-c", code, out],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def finish_dryrun(out, proc) -> dict:
    import shutil
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"16g: the dry-run failed: {err[-2000:]}")
    res = {}
    for arch, shape in DRYRUN_CELLS:
        path = os.path.join(out, f"{arch}__{shape}__single.json")
        check(os.path.exists(path), f"16g: no record of {arch} x {shape}")
        with open(path) as fh:
            rec = json.load(fh)
        check(rec.get("status") == "ok",
              f"16g: {arch} x {shape} dry-run status {rec}")
        res[f"{arch} x {shape}"] = {k: rec[k] for k in (
            "status", "n_devices", "compile_s", "flops_per_device",
            "collective_bytes_by_kind", "collective_op_counts")}
    shutil.rmtree(out, ignore_errors=True)
    ring = res["equiformer-v2 x minibatch_lg"]["collective_bytes_by_kind"]
    check(ring.get("collective-permute", 0) > 0,
          f"16g: the psw_ring cell counted no collective-permute: {ring}")
    return res


def phase_cells(torch, core, ps, ps_kernel, dev, args, clock) -> dict:
    """Phase 16, the cells of launch/steps.py on the card: 16g's dry-run
    starts in a subprocess first and is read last; 16a bert4rec
    serve_bulk, 16b bert4rec train_batch, 16c gin-tu x ogb_products, 16d-e
    granite-3-2b train_4k, prefill_32k and decode_32k, 16f a one-rank NCCL
    group (ranked PSW, the compressed all-reduce)."""
    t_phase = time.perf_counter()
    log("phase 16 the cells of launch/steps.py on the card")
    torch.cuda.empty_cache()
    out, proc = start_dryrun()
    try:
        res = {"serve_bulk": cell_serve_bulk(torch, dev, args)}
        log("  16a bert4rec serve_bulk: " + json.dumps(res["serve_bulk"]))
        res["rec_train"] = cell_rec_train(torch, dev, args)
        log("  16b bert4rec train_batch: " + json.dumps(res["rec_train"]))
        res["gin"] = cell_gin_products(torch, ps, ps_kernel, dev, args)
        log("  16c gin-tu ogb_products: " + json.dumps(res["gin"]))
        res["lm"], grads = cell_lm(torch, dev, args)
        log("  16d-e granite-3-2b: " + json.dumps(res["lm"]))
        res["collectives"] = cell_collectives(torch, core, dev, args, grads)
        log("  16f one-rank NCCL: " + json.dumps(res["collectives"]))
        del grads
        torch.cuda.empty_cache()
        res["dryrun"] = finish_dryrun(out, proc)
        log("  16g dry-run: " + json.dumps(res["dryrun"]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"cell path: {res['lm']['train']['launches']} + "
        f"{res['lm']['serve']['prefill_launches']} flash_attention "
        f"launches, {res['gin']['launches']} psw_spmm launches; "
        + json.dumps({"phase_s": res["phase_s"]}))
    return res


def build_kernels(common, kernels) -> None:
    """Build every kernel's library at once (one nvcc each, all started
    together), load them, then print ptxas's register and spill report."""
    t0 = time.perf_counter()
    common.build_libraries({k.NAME: k.SOURCE for k in kernels})
    for k in kernels:
        k.load_library()
    log(f"kernel build/load: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(k.library_path().name for k in kernels)})")
    for k in kernels:
        log_path = k.library_path().with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  ptxas {k.NAME}: " + line.strip())


def host_memory() -> str:
    total = "unknown"
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                total = f"{int(line.split()[1]) / 2**20:.2f} GiB"
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return f"peak host RSS {peak:.2f} GiB, MemTotal {total}"


def kernel_entry(name, source, replaces, launches, main, shapes) -> dict:
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches}
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        entry[key] = main[key]
    entry["shapes"] = shapes
    return entry


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=4_000_000)
    ap.add_argument("--edges", type=int, default=56_000_000)
    ap.add_argument("--live-edges", type=int, default=2_000_000)
    ap.add_argument("--bfs-depth", type=int, default=8)
    ap.add_argument("--lm-requests", type=int, default=8)
    ap.add_argument("--lm-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--long-prompt", type=int, default=32768)
    ap.add_argument("--bags", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--disk-budget-mb", type=float, default=96.0)
    ap.add_argument("--service-vertices", type=int, default=200_000)
    ap.add_argument("--service-edges", type=int, default=3_000_000)
    ap.add_argument("--gnn-vertices", type=int, default=232_965)
    ap.add_argument("--gnn-edges", type=int, default=114_615_892)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch is missing: run from a checkout of the repo")
    sys.path.insert(0, SRC)
    import repro_torch.core as core
    from repro_torch.configs import get_arch
    from repro_torch.kernels import common
    from repro_torch.kernels import frontier_expand as fe
    from repro_torch.kernels import psw_spmm as ps
    from repro_torch.kernels import psw_sweep as pw
    from repro_torch.kernels import segment_ell as se
    from repro_torch.kernels.frontier_expand import kernel, ops as fe_ops
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.psw_spmm import kernel as ps_kernel
    from repro_torch.kernels.psw_sweep import kernel as pw_kernel
    from repro_torch.kernels.segment_ell import kernel as se_kernel

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_kernels(common, [kernel, se_kernel, ps_kernel, fa_kernel,
                           eb_kernel, pw_kernel])

    clock = Clock(torch)
    disk_launches = phase_disk(torch, core, fe_ops, ps, dev, args, clock)
    phase_small(core, dev, args.seed)

    torch.cuda.reset_peak_memory_stats()
    widths, counts = {}, fe.frontier_expand_counts

    def counted(plan, x):                      # calls by panel width B
        widths[int(x.shape[1])] = widths.get(int(x.shape[1]), 0) + 1
        return counts(plan, x)

    fe.frontier_expand_counts = counted        # what multihop imports
    fe_ops.launches = 0                        # the main path starts here
    g, seeds, frontier = phase_bulk(torch, core, fe_ops, dev, args, clock)
    t = phase_live(core, fe_ops, dev, args, clock)
    launches = fe_ops.launches                 # ...and ends here
    fe.frontier_expand_counts = counts
    check(launches > 0, "the main path launched no frontier_expand kernel")
    log(f"main path: {launches} frontier_expand launches (calls by panel "
        f"width: {json.dumps(widths)}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        + host_memory())

    fe_res = phase_kernel(torch, core, fe, kernel, g, seeds, frontier, dev,
                          args.reps, args.seed + 5)
    pw_launches, pw_res = phase_psw(torch, core, pw, g, dev, args, clock)
    phase_snapshots(torch, core, t, dev, args, clock)
    del t
    agg_launches, ell, spmm_edges = phase_aggregate(torch, core, se, ps, g,
                                                    dev, args, clock)
    log(f"aggregation path: {agg_launches} launches")
    del g
    ell_res = segment_ell_vs_plain(torch, se, se_kernel, ell, args.reps)
    log("  segment_ell K=15 F=100: " + json.dumps(ell_res))
    del ell
    spmm_res = [psw_spmm_vs_plain(torch, ps, ps_kernel, e, args.reps)
                for e in spmm_edges]
    for r in spmm_res:
        log(f"  psw_spmm F={r['F']}: " + json.dumps(r))
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, " + host_memory())
    del spmm_edges
    torch.cuda.empty_cache()

    fa_launches, fa_main, fa_shapes, serving = phase_serve(
        torch, dev, get_arch("granite-3-2b").config, args, clock, fa_kernel)
    log("serving: " + json.dumps(serving))
    eb_launches, eb_res = phase_bags(torch, dev, args, clock, eb_kernel)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (since phase 7), " + host_memory())
    torch.cuda.reset_peak_memory_stats()
    service_launches = phase_service(torch, core, fe, fe_ops, ps, dev, args,
                                     clock)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (phase 10), " + host_memory())
    torch.cuda.reset_peak_memory_stats()
    gnn, sampler = phase_gnn(torch, core, ps, ps_kernel, dev, args, clock)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (phase 11), " + host_memory())
    torch.cuda.reset_peak_memory_stats()
    eqv = phase_equiformer(torch, ps, ps_kernel, sampler, args.gnn_vertices,
                           equiformer_config(torch), dev, args, clock)
    del sampler
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (phase 12), " + host_memory())
    moe = phase_moe(torch, dev, args, clock, fa_kernel)
    fa_shapes += [moe[a]["attention"] for a in MOE_ARCHS] \
        + [moe[MOE_ARCHS[0]]["gates"]["attention"]]
    rec = phase_bert4rec(torch, dev, args, clock)
    log(f"peak device memory {max(moe[a]['peak_gib'] for a in MOE_ARCHS):.2f}"
        f" GiB (phase 13), {rec['peak_gib']:.2f} GiB (phase 14), "
        + host_memory())
    train = phase_train(torch, ps, ps_kernel, {"gin": gnn.pop("sub"),
                                               "equiformer": eqv.pop("sub")},
                        args.gnn_vertices, dev, args, clock)
    log("peak device memory (phase 15): " + json.dumps(
        {k: v["peak_gib"] for k, v in train.items()
         if isinstance(v, dict) and "peak_gib" in v}) + ", " + host_memory())
    cells = phase_cells(torch, core, ps, ps_kernel, dev, args, clock)
    log("peak device memory (phase 16): " + json.dumps(
        {k: v["peak_gib"] for k, v in cells.items()
         if isinstance(v, dict) and "peak_gib" in v}) + ", " + host_memory())

    kernels = [
        kernel_entry("frontier_expand",
                     "src/repro_torch/kernels/frontier_expand/csrc/"
                     "frontier_expand.cu",
                     "src/repro/kernels/frontier_expand/frontier_expand.py:52",
                     launches, fe_res["hop2_128"], list(fe_res.values())),
        kernel_entry("segment_ell",
                     "src/repro_torch/kernels/segment_ell/csrc/"
                     "segment_ell.cu",
                     "src/repro/kernels/segment_ell/segment_ell.py:49",
                     agg_launches["segment_ell"], ell_res, [ell_res]),
        kernel_entry("psw_spmm",
                     "src/repro_torch/kernels/psw_spmm/csrc/psw_spmm.cu",
                     "src/repro/kernels/psw_spmm/psw_spmm.py:49",
                     agg_launches["psw_spmm"], spmm_res[0],
                     spmm_res + [gnn["psw_spmm"], eqv["psw_spmm"],
                                 train["transpose_gin"],
                                 train["transpose_equiformer"],
                                 cells["gin"]["psw_spmm"],
                                 cells["gin"]["transpose"]]),
        kernel_entry("embedding_bag",
                     "src/repro_torch/kernels/embedding_bag/csrc/"
                     "embedding_bag.cu",
                     "src/repro/kernels/embedding_bag/embedding_bag.py:48",
                     eb_launches, eb_res[0], eb_res),
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
                     "src/repro/kernels/flash_attention/flash_attention.py:69",
                     fa_launches, fa_main,
                     fa_shapes + [train["granite"]["attention_backward"]]),
        kernel_entry("psw_sweep",
                     "src/repro_torch/kernels/psw_sweep/csrc/psw_sweep.cu",
                     "src/repro/core/psw.py:436",
                     pw_launches, pw_res, [pw_res]),
    ]
    for entry in kernels:
        if entry["name"] in disk_launches:
            entry["disk_path_launches"] = disk_launches[entry["name"]]
        if entry["name"] in service_launches:
            entry["service_path_launches"] = service_launches[entry["name"]]
        if entry["name"] == "psw_spmm":
            entry["cell_path_launches"] = {"gin_ogb_products":
                                           cells["gin"]["launches"]}
            entry["gnn_path_launches"] = gnn["launches"]
            entry["equiformer_path_launches"] = eqv["launches"]
            entry["train_path_launches"] = {
                "gin": train["gin"]["launches"],
                "equiformer": train["equiformer"]["launches"]}
        if entry["name"] == "flash_attention":
            entry["cell_path_launches"] = {
                "granite_train_4k": cells["lm"]["train"]["launches"],
                "granite_prefill_32k": cells["lm"]["serve"][
                    "prefill_launches"]}
            entry["moe_path_launches"] = moe["launches"]
            entry["train_path_launches"] = {
                "granite": train["granite"]["launches"],
                "phi_moe": train["phi_moe"]["launches"]}
    log("phase seconds: " + json.dumps(clock.seconds))
    log(json.dumps({"kernels": kernels}))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
