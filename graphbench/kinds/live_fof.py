"""Friends-of-friends served live under LinkBench's link writes: one closed-
loop client; before each request a group of link writes lands on a durable
`ServiceDB`, then the request pins a `read_view()` and runs one
`two_hop_counts` call over a batch of uniform seeds on it.

The store is bulk-loaded (`GraphDB.bulk_load`) from the graph made from the
seed, with the configuration's edge column, and served by a `ServiceDB`
with its maintenance pipeline on. Set-up builds the view's dense plan, then
ages the store with `aging_writes` link writes in the request's
proportions, so that the window starts from buffers, merged levels and
tombstones, and from a dense plan that follows the store by its delta.

A request's writes (`writes_per_request`) are one grouped `insert_edges`
of `insert` links (the coalescing a front desk does for concurrent
writers), then `update` calls of `update_edge_column` on the configuration's
column and `delete` calls of `delete_edge`, one per link. Insert sources are
the tails of uniformly drawn generated edges and destinations the heads of
others: the graph's out- and in-degree weights. Updates and deletes take a
key drawn uniformly from the keys live at that moment. Every draw comes
from the run's seed.

The mix file gives what `kinds/fof.py` takes (`seeds_per_request`,
`direction`, `dense`, `exclude`, `pool_requests`, `warmup_requests`,
`checked_requests`) and `writes_per_request`, `aging_writes` and `limits`.
`fof_seeds_per_s` counts the seeds answered over the whole window, writes
included; `fof_p95_ms` is send to answer of the fof call alone. After the
window `reference/live.py` holds the store to what it acknowledged: the
checked requests' answers; the final view's key set and the time of every
copy that a write set (the read-back of every acknowledged write); and the
same key set and times from a copy of the store's files taken before it
closes, reopened by `GraphDB.open` (a process crash's stand-in: every
acknowledged write was flushed to the OS, so it is there).
"""
from __future__ import annotations

import dataclasses
import gc
import heapq
import os
import shutil
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from .. import work
from ..gen.powerlaw import degree_summary
from ..reference import fof as ref
from ..reference import live as live_ref
from .common import TRAFFIC, Context, Readings, log, sub_seed, synchronize
from .fof import draw_requests, launches_unseen, layer_spans

WRITES, TIMES = 4, 5          # further streams of the run's seed
STORE_DIR = Path(__file__).resolve().parents[2] / "build" / "graphbench"
# LinkBench's link times: seconds, below 2**31. The generated edges' times
# lie below CLOCK0 and written times count up from it, so a copy's time
# tells whether a write set it
CLOCK0 = 2 ** 30
INSERT, UPDATE, DELETE = live_ref.INSERT, live_ref.UPDATE, live_ref.DELETE


@dataclasses.dataclass
class Links:
    """The run's own account of the live key set and its mutation log. Keys
    are packed `src * n + dst` in original ids. The candidates, `base` and
    then `added`, are every key that was ever live, once each; a key's
    presence is `changed[key]` where it changed, else True (every candidate
    was live when it joined)."""

    n: int
    src: np.ndarray            # the generated edges: degree-weighted draws
    dst: np.ndarray
    base: np.ndarray           # the generated edges' keys, sorted, distinct
    rng: np.random.Generator
    added: list = dataclasses.field(default_factory=list)
    added_set: set = dataclasses.field(default_factory=set)
    changed: dict = dataclasses.field(default_factory=dict)
    log_keys: List[np.ndarray] = dataclasses.field(default_factory=list)
    log_kind: List[np.ndarray] = dataclasses.field(default_factory=list)
    log_time: List[np.ndarray] = dataclasses.field(default_factory=list)
    n_log: int = 0
    missed: int = 0            # updates and deletes that found no edge
    clock: int = 0

    def _present(self, k: int) -> bool:
        return self.changed.get(k, True)

    def live_key(self) -> int:
        """A key drawn uniformly from the live ones: uniform over the
        candidates, drawn again while it is not live."""
        nb = self.base.shape[0]
        while True:
            i = int(self.rng.integers(0, nb + len(self.added)))
            k = int(self.base[i]) if i < nb else self.added[i - nb]
            if self._present(k):
                return k

    def _known(self, k: int) -> bool:
        i = np.searchsorted(self.base, k)
        return (i < self.base.shape[0] and self.base[i] == k) \
            or k in self.added_set

    def _log(self, keys, kind: int, times) -> None:
        keys = np.asarray(keys, np.int64)
        self.log_keys.append(keys)
        self.log_kind.append(np.full(keys.shape[0], kind, np.int8))
        self.log_time.append(np.broadcast_to(
            np.asarray(times, np.int64), keys.shape))
        self.n_log += keys.shape[0]

    def times(self, k: int) -> np.ndarray:
        """The next `k` times of the run's clock, each written once."""
        self.clock += k
        return np.arange(CLOCK0 + self.clock - k, CLOCK0 + self.clock,
                         dtype=np.int64)

    def write(self, svc, column: str, n_ins: int, n_upd: int,
              n_del: int) -> None:
        """One group of link writes on `svc`, logged in the order sent."""
        n = self.n
        pick = self.rng.integers(0, self.src.shape[0], (2, n_ins))
        s, d = self.src[pick[0]], self.dst[pick[1]]
        if n_ins:
            t = self.times(n_ins)
            svc.insert_edges(s, d, columns={column: t})
            keys = s * n + d
            self._log(keys, INSERT, t)
            for k in keys.tolist():
                if not self._known(k):
                    self.added.append(k)
                    self.added_set.add(k)
                elif not self._present(k):
                    self.changed[k] = True
        for _ in range(n_upd):
            k = self.live_key()
            t = int(self.times(1)[0])
            ok = svc.update_edge_column(k // n, k % n, column, t)
            self.missed += not ok
            self._log([k], UPDATE, t)
        for _ in range(n_del):
            k = self.live_key()
            ok = svc.delete_edge(k // n, k % n)
            self.missed += not ok
            self.changed[k] = False
            self._log([k], DELETE, -1)

    def log(self):
        """(keys int64, kind int8, time int64) of every write sent, in
        order; a delete's time is -1."""
        if not self.log_keys:
            return (np.empty(0, np.int64), np.empty(0, np.int8),
                    np.empty(0, np.int64))
        return (np.concatenate(self.log_keys), np.concatenate(self.log_kind),
                np.concatenate(self.log_time))


@dataclasses.dataclass
class State:
    ctx: Context
    core: object
    svc: object
    store_dir: Path
    links: Links
    pool: np.ndarray
    prio: np.ndarray
    column: str
    writes: tuple
    kept: list = dataclasses.field(default_factory=list)   # heap
    largest: tuple = None
    positions: dict = dataclasses.field(default_factory=dict)
    completed: int = 0
    final: tuple = None        # (keys, written keys, their times): live
    reopened: tuple = None     # the same, from the crash copy reopened


def _edges(ctx: Context):
    """The generated edges as host arrays and their distinct keys, sorted
    on the device; the device's copies are freed and its peak reset, so
    that it reads the program's own."""
    src, dst = ctx.timed("generate", ctx.edges, sync=True)
    shape = ctx.shape
    log(f"graph: {degree_summary(src, dst, shape.vertices, shape.id_classes)}")
    base = torch.unique(src * shape.vertices + dst).cpu().numpy()
    src_np, dst_np = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.dev)
    return src_np, dst_np, base


def _store(ctx: Context, core, src, dst, directory: Path):
    """The configuration's durable store, bulk-loaded, under a ServiceDB."""
    store = ctx.config["store"]
    if store["build"] != "GraphDB.bulk_load":
        raise ValueError(f"no store build {store['build']!r}")
    (column, dtype), = store["column_dtypes"].items()
    times = np.random.default_rng(sub_seed(ctx.seed, TIMES)).integers(
        0, CLOCK0, src.shape[0]).astype(dtype)
    if directory.exists():
        shutil.rmtree(directory)
    directory.parent.mkdir(parents=True, exist_ok=True)
    db = ctx.timed(
        "store_build", core.GraphDB.bulk_load, str(directory), src, dst,
        ctx.shape.vertices - 1, columns={column: times},
        n_partitions=int(store["n_partitions"]),
        n_levels=int(store["n_levels"]), branching=int(store["branching"]),
        buffer_cap=int(store["buffer_cap"]),
        max_partition_edges=int(store["max_partition_edges"]),
        column_dtypes=store["column_dtypes"], wal_sync=store["wal_sync"],
        persist_min_edges=int(store["persist_min_edges"]))
    svc = core.ServiceDB(
        db, checkpoint_interval_ops=int(store["checkpoint_interval_ops"]),
        pipeline=bool(store["pipeline"]),
        maintenance_workers=int(store["maintenance_workers"]),
        wal_tail_budget_bytes=int(store["wal_tail_budget_bytes"]))
    return svc, column


def _drain(svc, timeout_s: float = 600.0) -> None:
    """Wait until the maintenance pipeline has merged the backlog over the
    buffer cap."""
    end = time.perf_counter() + timeout_s
    while ((svc.tree.total_buffered() > svc.tree.buffer_cap
            or svc.tree.inflight_edges()) and time.perf_counter() < end):
        time.sleep(0.02)


def _age(st: State, total: int) -> None:
    """`total` link writes in the request's proportions, in its groups."""
    per = np.asarray(st.writes)
    left = np.round(total * per / per.sum()).astype(int)
    left[-1] = total - left[:-1].sum()
    while left.any():
        now = np.minimum(per, left)
        st.links.write(st.svc, st.column, *now.tolist())
        left -= now


def setup(ctx: Context) -> State:
    import repro_torch.core as core
    mix = ctx.mix
    src, dst, base = _edges(ctx)
    store_dir = STORE_DIR / f"store.{ctx.cell}.{os.getpid()}"
    svc, column = _store(ctx, core, src, dst, store_dir)
    with svc.read_view() as view:
        ctx.timed("plan_build", core.dense_plan, view, mix["direction"],
                  device=ctx.dev, sync=True)
    rng = np.random.default_rng(sub_seed(ctx.seed, TRAFFIC))
    n, size = ctx.shape.vertices, int(mix["seeds_per_request"])
    pool = draw_requests(n, int(mix["pool_requests"]), size, rng)
    warm = draw_requests(n, int(mix["warmup_requests"]), size, rng)
    prio = rng.random(pool.shape[0])
    w = mix["writes_per_request"]
    links = Links(n, src, dst, base,
                  np.random.default_rng(sub_seed(ctx.seed, WRITES)))
    st = State(ctx, core, svc, store_dir, links, pool, prio, column,
               (int(w["insert"]), int(w["update"]), int(w["delete"])))
    ctx.timed("aging", _age, st, int(mix["aging_writes"]))
    ctx.timed("drain", _drain, svc)
    for seeds in warm:
        _writes(st)
        _request(st, seeds)
    synchronize(ctx.dev)
    return st


def _writes(st: State) -> None:
    st.links.write(st.svc, st.column, *st.writes)


def _request(st: State, seeds: np.ndarray):
    mix = st.ctx.mix
    with st.svc.read_view() as view:
        return st.core.two_hop_counts(
            view, seeds, direction=mix["direction"], dense=mix["dense"],
            exclude=bool(mix["exclude"]), device=st.ctx.dev)


def _counter(name: str):
    from repro_torch.core import telemetry
    return telemetry.snapshot()["counters"].get(name)


def window(st: State, seconds: float, traced: bool) -> dict:
    from repro_torch.core import telemetry
    from repro_torch.kernels.frontier_expand import ops as fe_ops
    k = int(st.ctx.mix["checked_requests"])
    lat: List[float] = []
    write_s: List[float] = []
    seeds_done = 0
    telemetry.trace_events(clear=True)
    launches0 = fe_ops.launches
    builds0 = _counter("x.multihop.base_builds")
    rf = torch.profiler.record_function
    with layer_spans(traced), rf("graphbench.window"):
        t_start = time.perf_counter()
        i = 0
        while True:
            seeds = st.pool[i % st.pool.shape[0]]
            t0 = time.perf_counter()
            with rf("graphbench.writes"):
                _writes(st)
            t1 = time.perf_counter()
            with rf("graphbench.request"):
                res = _request(st, seeds)
            t2 = time.perf_counter()
            write_s.append(t1 - t0)
            lat.append(t2 - t1)
            st.positions[i] = st.links.n_log
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
            if t2 - t_start >= seconds:
                break
    window_s = t2 - t_start
    st.completed = i
    st.positions = {j: st.positions[j]
                    for j in {j for _, j, _ in st.kept} | {st.largest[0]}}
    lat_ms = np.asarray(lat) * 1e3
    spans = [e for e in telemetry.trace_events(clear=True)
             if e["name"] in ("multihop.two_hop", "x.multihop.delta")]
    counters = {"frontier_expand.launches": fe_ops.launches - launches0}
    builds = _counter("x.multihop.base_builds")
    if builds is not None:
        counters["x.multihop.base_builds"] = builds - (builds0 or 0)
    delta = [e["args"]["delta_edges"] for e in spans
             if "delta_edges" in e.get("args", {})]
    log(f"window: {i} requests, {seeds_done} seeds in {window_s:.3f} s; "
        f"fof latency ms p50 {np.percentile(lat_ms, 50):.3f} p95 "
        f"{np.percentile(lat_ms, 95):.3f} max {lat_ms.max():.3f}; writes "
        f"ms a request {1e3 * np.mean(write_s):.3f}; answers of "
        f"{st.largest[1].ids.shape[0]} pairs at most; base builds "
        f"{counters.get('x.multihop.base_builds')}; delta entries "
        f"{delta[0] if delta else None} to {delta[-1] if delta else None}")
    return {
        "t_start": t_start,
        "values": {"fof_p95_ms": float(np.percentile(lat_ms, 95)),
                   "fof_seeds_per_s": seeds_done / window_s},
        "readings": dict(window_s=window_s, units=i, program_spans=spans,
                         latencies_ms=lat_ms.tolist(), counters=counters),
        "attempted": i,
    }


def _edges_of(view, column: str, n: int):
    """(keys, written keys, their times) of `view`: the packed key of every
    live copy of an edge, and the key and time of every copy whose time a
    write set (at or above CLOCK0), each sorted by key."""
    iv = view.intervals
    ss, dd, tt = [], [], []
    for mp in view.manifest.partitions():
        part = mp.part
        if part.n_edges == 0:
            continue
        live = slice(None) if mp.dead is None else ~mp.dead
        ss.append(np.asarray(part.src)[live])
        dd.append(np.asarray(part.dst)[live])
        tt.append(np.asarray(part.columns[column])[live])
    for stg, _ in view.manifest.staging_slabs():
        ss.append(stg.src)
        dd.append(stg.dst)
        tt.append(np.asarray(stg.columns[column]))
    s = np.asarray(iv.to_original(np.concatenate(ss)), np.int64)
    d = np.asarray(iv.to_original(np.concatenate(dd)), np.int64)
    keys = s * n + d
    del s, d
    times = np.concatenate(tt).astype(np.int64)
    written = times >= CLOCK0
    wk, wt = keys[written], times[written]
    order = np.lexsort((wt, wk))
    return keys, wk[order], wt[order]


def _crash_copy(svc, directory: Path, to: Path) -> None:
    """Copy the store's files while the service holds its exclusive window
    (every interval lock, then the service lock, as a checkpoint's last
    phase takes them): no merge commits and no checkpoint writes its
    manifest mid-copy, so the copy is the files at one instant, as a
    process crash leaves them."""
    if to.exists():
        shutil.rmtree(to)
    with svc._all_merge_slots(), svc._lock:
        shutil.copytree(directory, to)


def release(st: State) -> None:
    """Read the final view's edges and written times (the read-back of
    every acknowledged write); copy the store's files as a process crash
    would leave them; close the store; reopen the copy with
    `GraphDB.open` and read the same from it; then remove both and free
    the program's device state."""
    n = st.ctx.shape.vertices
    with st.svc.read_view() as view:
        st.final = _edges_of(view, st.column, n)
    crash = st.store_dir.with_name(st.store_dir.name + ".crash")
    t0 = time.perf_counter()
    _crash_copy(st.svc, st.store_dir, crash)
    st.svc.close()
    st.svc = None
    shutil.rmtree(st.store_dir, ignore_errors=True)
    gc.collect()
    t1 = time.perf_counter()
    db = st.core.GraphDB.open(str(crash))
    with db.read_view() as view:
        st.reopened = _edges_of(view, st.column, n)
    db.tree.close()         # only read: no checkpoint, the copy goes
    db.evict()
    del db
    shutil.rmtree(crash, ignore_errors=True)
    gc.collect()
    log(f"release: crash copy and close {t1 - t0:.3f} s, reopen and read "
        f"{time.perf_counter() - t1:.3f} s")
    if st.ctx.dev.type == "cuda":
        torch.cuda.empty_cache()


def check(st: State, readings: Readings) -> dict:
    """Each checked request's answer against the reference's on the key set
    its view held (the generated edges with the log's writes before the
    request, a key's last write winning), seed by seed; the final view's
    key set and written times against the reference's after every write,
    and the same of the crash copy reopened; and the updates and deletes
    that found no edge. In a traced run also that the trace saw the
    kernel's launches under their annotation, and the window's logical
    work (on the generated edges: the kernel works the base plan, built
    from them before the aging, and the delta is under 0.3% of it)."""
    ctx = st.ctx
    n = ctx.shape.vertices
    src, dst = ctx.edges()
    base = torch.unique(src * n + dst)
    keys, kind, times = (torch.from_numpy(a).to(ctx.dev)
                         for a in st.links.log())
    if ctx.traced:
        index = ref.EdgeIndex.build(src, dst, n)
        total = 0.0
        for i in range(st.completed):
            seeds_i = torch.from_numpy(
                st.pool[i % st.pool.shape[0]]).to(ctx.dev)
            total += work.fof_bound_s(index, seeds_i)
        readings.bounds_s["frontier_expand"] = total
        del index
    del src, dst
    checked = {i: r for _, i, r in st.kept}
    checked[st.largest[0]] = st.largest[1]
    wrong = seeds = 0
    for i, res in sorted(checked.items()):
        edges = live_ref.key_set(base, keys, kind, st.positions[i])
        index = live_ref.edge_index(edges, n)
        seeds_i = torch.from_numpy(st.pool[i % st.pool.shape[0]]).to(ctx.dev)
        wrong += ref.seeds_differing(res, ref.two_hop(index, seeds_i))
        seeds += seeds_i.shape[0]
        del edges, index
    final = live_ref.key_set(base, keys, kind, keys.shape[0])
    want_k, want_t = live_ref.written_times(base, keys, kind, times,
                                            keys.shape[0])

    def differing(got):
        k, wk, wt = (torch.from_numpy(a).to(ctx.dev) for a in got)
        return (live_ref.keys_differing(k, final),
                live_ref.pairs_differing(wk, wt, want_k, want_t))
    edges_live, times_live = differing(st.final)
    edges_reopened, times_reopened = differing(st.reopened)
    log(f"check: {len(checked)} requests, {seeds} seeds against the "
        f"reference; final key set of {final.shape[0]} keys and "
        f"{want_k.shape[0]} written times after {keys.shape[0]} writes; "
        f"reopened copy: {edges_reopened} keys and {times_reopened} times "
        f"differing")
    limits = ctx.mix["limits"]
    checks = {"seeds_wrong": (wrong, int(limits["seeds_wrong"])),
              "edges_differing": (edges_live,
                                  int(limits["edges_differing"])),
              "times_differing": (times_live,
                                  int(limits["times_differing"])),
              "reopened_edges_differing": (
                  edges_reopened, int(limits["reopened_edges_differing"])),
              "reopened_times_differing": (
                  times_reopened, int(limits["reopened_times_differing"])),
              "writes_missed": (st.links.missed,
                                int(limits["writes_missed"]))}
    if ctx.traced:
        checks["launches_unseen"] = (launches_unseen(readings), 0)
    return checks
