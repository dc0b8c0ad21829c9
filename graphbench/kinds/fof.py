"""Friends-of-friends traffic: a closed loop of one client, each request one
`two_hop_counts` call over a batch of seeds drawn uniformly, without
replacement within a request.

The mix file gives `seeds_per_request`, `direction`, `dense`, `exclude`,
`pool_requests` (requests drawn in set-up and sent in turn, over again
where the window outlasts them), `fixed_work_seed` (optional: see
`Context.fixed_work`),
`warmup_requests` (drawn apart, sent in set-up) and `checked_requests` (how
many of the window's requests, drawn from the seed, the reference checks;
the request with the largest answer is checked besides).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import heapq
import time
from typing import List

import numpy as np
import torch

from .. import work
from ..reference import fof as ref
from .common import TRAFFIC, Context, Readings, log, sub_seed


def draw_requests(n_vertices: int, n_requests: int, size: int,
                  rng: np.random.Generator) -> np.ndarray:
    """(n_requests, size) int64 seed ids, distinct within each row."""
    if size > n_vertices:
        raise ValueError(f"{size} seeds a request from {n_vertices} vertices")
    out = np.empty((n_requests, size), np.int64)
    for i in range(n_requests):
        row = np.unique(rng.integers(0, n_vertices, size + size // 4 + 8))
        while row.shape[0] < size:
            row = np.unique(np.concatenate(
                [row, rng.integers(0, n_vertices, size)]))
        out[i] = rng.permutation(row)[:size]
    return out


@dataclasses.dataclass
class State:
    ctx: Context
    core: object
    g: object
    pool: np.ndarray
    prio: np.ndarray
    kept: list = dataclasses.field(default_factory=list)   # heap
    largest: tuple = None
    completed: int = 0


def setup(ctx: Context) -> State:
    import repro_torch.core as core
    mix = ctx.mix
    src, dst = ctx.host_edges()
    g = ctx.bulk_store(core, src, dst)
    del src, dst
    ctx.timed("plan_build", core.dense_plan, g, mix["direction"],
              device=ctx.dev, sync=True)
    rng = np.random.default_rng(sub_seed(ctx.seed, TRAFFIC))
    n, size = ctx.shape.vertices, int(mix["seeds_per_request"])
    n_pool, n_warm = int(mix["pool_requests"]), int(mix["warmup_requests"])
    if ctx.fixed_work is None:
        pool = draw_requests(n, n_pool, size, rng)
        warm = draw_requests(n, n_warm, size, rng)
    else:
        # the same requests in every run, under the run's labels and in
        # the run's order
        fixed = np.random.default_rng(sub_seed(ctx.fixed_work, TRAFFIC))
        labels = ctx.labels().cpu().numpy()
        pool = labels[draw_requests(n, n_pool, size, fixed)]
        warm = labels[draw_requests(n, n_warm, size, fixed)]
        pool = pool[rng.permutation(n_pool)]
    prio = rng.random(pool.shape[0])
    st = State(ctx, core, g, pool, prio)
    for seeds in warm:
        _request(st, seeds)
    return st


def _request(st: State, seeds: np.ndarray):
    mix = st.ctx.mix
    return st.core.two_hop_counts(
        st.g, seeds, direction=mix["direction"], dense=mix["dense"],
        exclude=bool(mix["exclude"]), device=st.ctx.dev)


@contextlib.contextmanager
def layer_spans(traced: bool):
    """In a traced run, a `layer.frontier_expand` annotation around each
    call of the program's frontier-expansion entry point, so that the
    trace can tell its device time from the rest of the request's. It
    reaches the calls that look the entry point up on the package at call
    time; `launches_unseen` fails a run whose calls it missed."""
    if not traced:
        yield
        return
    import repro_torch.kernels.frontier_expand as fe
    inner = fe.frontier_expand_counts

    def annotated(*a, **kw):
        with torch.profiler.record_function("layer.frontier_expand"):
            return inner(*a, **kw)
    fe.frontier_expand_counts = annotated
    try:
        yield
    finally:
        fe.frontier_expand_counts = inner


def window(st: State, seconds: float, traced: bool) -> dict:
    from repro_torch.core import telemetry
    from repro_torch.kernels.frontier_expand import ops as fe_ops
    k = int(st.ctx.mix["checked_requests"])
    lat: List[float] = []
    seeds_done = 0
    telemetry.trace_events(clear=True)
    launches0 = fe_ops.launches
    rf = torch.profiler.record_function
    with layer_spans(traced), rf("graphbench.window"):
        t_start = time.perf_counter()
        i = 0
        while True:
            seeds = st.pool[i % st.pool.shape[0]]
            t0 = time.perf_counter()
            with rf("graphbench.request"):
                res = _request(st, seeds)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            seeds_done += seeds.shape[0]
            p = -float(st.prio[i % st.prio.shape[0]])
            if len(st.kept) < k:
                heapq.heappush(st.kept, (p, i, res))
            elif p > st.kept[0][0]:
                heapq.heapreplace(st.kept, (p, i, res))
            if st.largest is None or res.ids.shape[0] > \
                    st.largest[1].ids.shape[0]:
                st.largest = (i, res)
            i += 1
            if t1 - t_start >= seconds:
                break
    window_s = t1 - t_start
    st.completed = i
    lat_ms = np.asarray(lat) * 1e3
    spans = [e for e in telemetry.trace_events(clear=True)
             if e["name"] == "multihop.two_hop"]
    log(f"window: {i} requests, {seeds_done} seeds in {window_s:.3f} s; "
        f"latency ms p50 {np.percentile(lat_ms, 50):.3f} p95 "
        f"{np.percentile(lat_ms, 95):.3f} max {lat_ms.max():.3f}; answers "
        f"of {st.largest[1].ids.shape[0]} pairs at most")
    return {
        "t_start": t_start,
        "values": {"fof_p95_ms": float(np.percentile(lat_ms, 95)),
                   "fof_seeds_per_s": seeds_done / window_s},
        "readings": dict(window_s=window_s, units=i, program_spans=spans,
                         latencies_ms=lat_ms.tolist(),
                         counters={"frontier_expand.launches":
                                   fe_ops.launches - launches0}),
        "attempted": i,
    }


def release(st: State) -> None:
    """Free the program's state (the store and its plan) before the
    reference runs."""
    st.g = None
    gc.collect()
    if st.ctx.dev.type == "cuda":
        torch.cuda.empty_cache()


def launches_unseen(readings: Readings) -> int:
    """The window's frontier_expand launches if the trace holds no device
    operation inside `layer.frontier_expand`, else 0. The kernel's and the
    panels' per-layer metrics read that annotation: launches counted with
    none under it mean the annotation was lost, and those metrics would be
    left out without a word."""
    n = int(readings.counters.get("frontier_expand.launches", 0))
    t = readings.trace
    seen = t is not None and t.op_seconds(inside="layer.frontier_expand") > 0
    return 0 if seen else n


def check(st: State, readings: Readings) -> dict:
    """Every checked request's answer against the reference's, seed by
    seed; in a traced run also the window's logical work, and that the
    trace saw the kernel's launches under their annotation."""
    ctx = st.ctx
    src, dst = ctx.edges()
    index = ref.EdgeIndex.build(src, dst, ctx.shape.vertices)
    del src, dst
    checked = {i: r for _, i, r in st.kept}
    checked[st.largest[0]] = st.largest[1]
    wrong = seeds = 0
    for i, res in sorted(checked.items()):
        seeds_i = torch.from_numpy(st.pool[i % st.pool.shape[0]]).to(ctx.dev)
        wrong += ref.seeds_differing(res, ref.two_hop(index, seeds_i))
        seeds += seeds_i.shape[0]
    log(f"check: {len(checked)} requests, {seeds} seeds against the "
        "reference")
    if ctx.traced:
        total = 0.0
        for i in range(st.completed):
            seeds_i = torch.from_numpy(
                st.pool[i % st.pool.shape[0]]).to(ctx.dev)
            total += work.fof_bound_s(index, seeds_i)
        readings.bounds_s["frontier_expand"] = total
    limit = int(ctx.mix["limits"]["seeds_wrong"])
    checks = {"seeds_wrong": (wrong, limit)}
    if ctx.traced:
        checks["launches_unseen"] = (launches_unseen(readings), 0)
    return checks
