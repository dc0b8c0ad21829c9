#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--vertices N] [--edges N] [--seed S]

Run from the root of a checkout: the port is imported from `src/`, and its
CUDA kernel is built from the checkout's sources into `build/kernels/` at
first use. The main path is the graph store read by multi-hop queries:

  0. a small graph: the dense kernel path against the per-hop baselines
     (`bfs_perhop`, `friends_of_friends_perhop`);
  1. bulk store: a LiveJournal-like power-law graph (SNAP soc-LiveJournal1:
     4,847,571 vertices, 68,993,773 edges; cut to 4M vertices and 56M edges,
     about 14 per vertex as there) in a `GraphPAL`, its dense plan resident
     on the GPU; `two_hop_counts(dense="kernel")` on 256 seeds,
     `khop(dense="kernel", k=3)` from 64 seeds, and `query.bfs` from one
     seed with the `dense="auto"` heuristic, each bitwise against the sparse
     host path;
  2. live store: edges streamed into an `LSMTree` with deletes, then
     `two_hop_counts(dense="kernel")` on the live tree and on a pinned
     `read_view()`, bitwise against sparse;
  3. the frontier_expand kernel against its plain torch version at the main
     path's shapes (B = 128 seed panels, B = 1 BFS frontiers): bitwise equal,
     with times, the bound and a `torch.sparse.mm` yardstick.

The kernel launch count is zeroed before phases 1-2 and read after them.
Any failed check exits non-zero. The second-to-last line is the card's name
and power limit from nvidia-smi; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores


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


def phase_bulk(core, fe_ops, dev, args, clock):
    log(f"phase 1 bulk store: {args.vertices} vertices, {args.edges} edges")
    src, dst = clock("generate", power_law_graph, args.vertices, args.edges,
                     seed=args.seed)
    g = clock("GraphPAL.from_edges", core.GraphPAL.from_edges, src, dst,
              n_partitions=16, max_id=args.vertices - 1)
    del src, dst
    plan = clock("dense_plan (host build + upload)", core.dense_plan, g,
                 "out", device=dev)
    rows = int(plan.dst_ptr[-1])
    log(f"  plan: {plan.n_edges} distinct edges, {rows} virtual rows "
        f"(K={plan.k_slots}), {plan.idx.shape[0]} padded; "
        f"{plan.heavy_dst.shape[0]} heavy destinations "
        f"(> {plan.split_rows} rows) in {plan.chunks.shape[0]} chunks, "
        f"longest {int((plan.dst_ptr[1:] - plan.dst_ptr[:-1]).max())} rows")
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


def kernel_vs_plain(torch, fe, kernel, plan, x, reps: int) -> dict:
    """Kernel against the plain version on one panel: bitwise check, times,
    the bound and the torch.sparse.mm yardstick."""
    out = torch.empty((plan.n_dst, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    scratch = torch.empty((plan.chunks.shape[0], x.shape[1]),
                          dtype=torch.float32, device=x.device)
    kernel.launch(plan, x, out, scratch)
    plain = fe.frontier_expand_torch(plan.idx, plan.mask, x, plan.row_dst,
                                     plan.n_dst)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    check(torch.equal(out, plain),
          f"kernel != plain version at B={x.shape[1]} (max abs err {err})")
    del plain
    ms = cuda_ms(torch, lambda: kernel.launch(plan, x, out, scratch), reps)
    plain_ms = cuda_ms(torch, lambda: fe.frontier_expand_torch(
        plan.idx, plan.mask, x, plan.row_dst, plan.n_dst), max(1, reps // 4))

    # yardstick: the same product as one cuSPARSE SpMM of the CSR adjacency
    per_row = plan.mask.sum(1)
    per_dst = torch.zeros(plan.n_dst + 1, dtype=torch.int64,
                          device=x.device)
    per_dst.index_add_(0, plan.row_dst.long(), per_row)
    crow = torch.zeros(plan.n_dst + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(per_dst[:plan.n_dst], 0, out=crow[1:])
    col = plan.idx[plan.mask].long()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # "sparse CSR is in beta"
        adj = torch.sparse_csr_tensor(
            crow, col, torch.ones(col.shape[0], device=x.device),
            size=(plan.n_dst, plan.n_src))
    lib = torch.sparse.mm(adj, x)
    torch.cuda.synchronize()
    check(torch.equal(lib, out), f"torch.sparse.mm != kernel at B={x.shape[1]}")
    del lib
    library_ms = cuda_ms(torch, lambda: torch.sparse.mm(adj, x), reps)
    del adj, col

    B = int(x.shape[1])
    R, K = int(plan.dst_ptr[-1]), plan.k_slots
    E, M, N = plan.n_edges, plan.n_src, plan.n_dst
    # each input read once, each output written once
    bytes_once = R * K * 5 + (N + 1) * 8 + M * B * 4 + N * B * 4
    ops = E * B                       # one fp32 add per gathered element
    bound_s = max(bytes_once / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    # what the gathers move: every edge's x row (a 32-byte sector at least)
    gather_bytes = R * K * 5 + E * max(B * 4, 32) + N * B * 4
    return {"B": B, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if bytes_once / HBM_BYTES_PER_S
                         >= ops / FP32_OPS_PER_S else "operations"),
            "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
            "bytes_once": bytes_once, "gather_bytes": gather_bytes,
            "rows": R, "edges": E}


def phase_kernel(torch, core, fe, kernel, g, seeds, frontier, dev, reps):
    log("phase 3 kernel against plain version at the main path's shapes")
    plan = core.dense_plan(g, "out", device=dev)
    iv = g.intervals
    M = plan.n_src
    si = torch.from_numpy(np.asarray(iv.to_internal(seeds[:128]),
                                     np.int64)).to(dev)
    x = torch.zeros((M, 128), dtype=torch.float32, device=dev)
    x[si, torch.arange(128, device=dev)] = 1.0
    hop1 = fe.frontier_expand_counts(plan, x)
    panel = (hop1 > 0).to(torch.float32)       # two_hop's hop-2 input
    del x, hop1
    wide = kernel_vs_plain(torch, fe, kernel, plan, panel, reps)
    del panel
    log("  B=128: " + json.dumps(wide))
    x1 = torch.zeros((M, 1), dtype=torch.float32, device=dev)
    fi = torch.from_numpy(np.asarray(iv.to_internal(frontier), np.int64))
    x1[fi.to(dev), 0] = 1.0                    # the largest BFS level
    narrow = kernel_vs_plain(torch, fe, kernel, plan, x1, reps)
    log(f"  B=1 ({frontier.shape[0]} frontier vertices): "
        + json.dumps(narrow))
    return wide, narrow


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=4_000_000)
    ap.add_argument("--edges", type=int, default=56_000_000)
    ap.add_argument("--live-edges", type=int, default=2_000_000)
    ap.add_argument("--bfs-depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch is missing: run from a checkout of the repo")
    sys.path.insert(0, SRC)
    import repro_torch.core as core
    from repro_torch.kernels import frontier_expand as fe
    from repro_torch.kernels.frontier_expand import kernel, ops as fe_ops

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernel.load_library()
    log(f"kernel build/load: {time.perf_counter() - t0:.1f} s "
        f"({kernel.library_path().name})")
    log_path = kernel.library_path().with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    clock = Clock(torch)
    phase_small(core, dev, args.seed)

    torch.cuda.reset_peak_memory_stats()
    fe_ops.launches = 0                        # the main path starts here
    g, seeds, frontier = phase_bulk(core, fe_ops, dev, args, clock)
    phase_live(core, fe_ops, dev, args, clock)
    launches = fe_ops.launches                 # ...and ends here
    check(launches > 0, "the main path launched no frontier_expand kernel")
    log(f"main path: {launches} frontier_expand launches, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak "
        f"host RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")

    wide, narrow = phase_kernel(torch, core, fe, kernel, g, seeds, frontier,
                                dev, args.reps)
    entry = {"name": "frontier_expand", "route": "cuda",
             "source": "src/repro_torch/kernels/frontier_expand/csrc/"
                       "frontier_expand.cu",
             "replaces": "src/repro/kernels/frontier_expand/"
                         "frontier_expand.py:52",
             "launches": launches}
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        entry[key] = wide[key]
    entry["shapes"] = [wide, narrow]
    log("phase seconds: " + json.dumps(clock.seconds))
    log(json.dumps({"kernels": [entry]}))

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
