"""The concurrent service tier: lock-free live reads, snapshot-isolated
reader sessions, and a parallel maintenance pipeline over a live GraphDB
(paper §1, §5 — an *online* graph database serves
queries and fast insertions concurrently).

Three read/write surfaces:

  * **Lock-free live reads** (`read_view`). Every mutation batch
    and merge commit publishes an immutable `LevelManifest`
    (core/manifest.py); a reader pins the current one under an epoch guard
    and runs point queries, batched engine slabs, FoF/BFS, and PSW
    streaming against it without EVER taking the service lock — read
    latency no longer spikes when the writer appends or a merge runs.
    Superseded manifests (and the partition files they reference) are
    reclaimed only once no epoch pins them.

  * `Snapshot` — a read-only, self-contained session directory produced by
    `GraphDB.pin_snapshot`: hard links to the pinned manifest's immutable
    partition files (+ dead sidecars) and to the WAL segments covering
    [manifest.wal_offset, pinned_offset). Opening one rebuilds the exact
    logical state at the pinned WAL offset; the decoded tail records are
    shared across opens at the same pinned offset through a small
    process-wide cache, so the Nth session of a pin
    skips the decode entirely. Sessions are directory-addressed: any
    number of reader threads or *processes* can `Snapshot.open(path)` the
    same pin concurrently.

  * `ServiceDB` — the single-writer front end. One lock serializes
    mutations, snapshot pinning, and maintenance COMMITS; the insert path
    only appends to the WAL and the in-memory buffers (`LSMTree.auto_flush`
    is off). Maintenance is a pipeline: a scheduler thread
    dispatches independent top-level buffer merges to a small worker pool —
    each flush drains its buffer under the service lock (cheap), runs the
    merge + partition-sink persistence under only its top-interval lock
    (expensive, concurrent across intervals), and commits + publishes under
    the service lock again (cheap). Checkpoints overlap in-flight merges:
    phase A persists RAM/dirty partitions with NO locks held; phase B takes
    a short exclusive window (all interval locks + the service lock — which
    blocks writers briefly, never readers) for the residual flush, manifest
    write, epoch-aware store GC, and WAL compaction. Reader-latency
    feedback steers cadence: a WAL tail over `wal_tail_budget_bytes`, or a
    `begin_snapshot` whose session rebuild exceeded
    `snapshot_open_budget_s`, schedules a checkpoint early so tail replays
    stay short. The dirty set is bounded: once buffered + in-flight edges
    exceed `backpressure_edges`, writers block until the pipeline drains
    below the high-water mark.

Maintenance pipeline (DESIGN.md §9):

    scheduler --buffered > cap----> worker pool: FLUSH(j)   [interval lock j]
       |                            FLUSH(k) runs CONCURRENTLY  [lock k]
       |--ops/WAL-tail/feedback---> CHECKPOINT: phase A (no locks) overlaps
       |                            the flushes; phase B brief exclusive
       '--close()-----------------> drain pool, final checkpoint, exit

Lock order (deadlock-free): interval locks in ascending index, THEN the
service lock. Deletes/column updates take their one interval lock first for
the same reason. Readers take neither.

Host copy of the reference `repro/core/service.py` (numpy): the same
store and session directories byte for byte, so either package opens the
other's. `Snapshot.snapshot` compiles to the port's torch `DeviceGraph`
(core/psw.py), and the dense hops on a `read_view()` run the port's
frontier_expand kernel (core/multihop.py).
"""
from __future__ import annotations

import dataclasses
import errno
import itertools
import json
import os
import shutil
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from . import telemetry
from .disk import DiskPartition, GraphDB, open_partition_file, replay_ops
from .failpoints import failpoint
from .integrity import ReadOnlyError
from .lsm import LSMTree
from .pal import IntervalMap
from .walog import SegmentedWAL

__all__ = ["ServiceDB", "Snapshot", "ServiceStats", "tail_cache_stats"]


# ---------------------------------------------------------------------------
# Shared replayed-WAL-tail cache
# ---------------------------------------------------------------------------
# Decoded tail records keyed by the *inode identity* of the segments plus
# the [offset, end) window. Session directories of the same pin hard-link
# the same segment inodes, so every `Snapshot.open` at one pinned offset —
# from any thread, over any session dir — hits the same entry and skips the
# decode. Records are numpy views over immutable segment bytes; applying
# them into each session's private tree copies, so sharing is safe.
_TAIL_CACHE_MAX = 4
_TAIL_CACHE: "OrderedDict[tuple, list]" = OrderedDict()
_TAIL_CACHE_LOCK = threading.Lock()
_TAIL_CACHE_STATS = {"hits": 0, "misses": 0}
_M_TAIL_HITS = telemetry.counter("service.tail_cache.hits")
_M_TAIL_MISSES = telemetry.counter("service.tail_cache.misses")
_M_WAL_TAIL = telemetry.gauge("service.wal_tail_bytes")
_M_BACKLOG = telemetry.gauge("service.backlog_edges")
_M_JOB_S = telemetry.histogram("service.job.seconds")


def tail_cache_stats() -> Dict[str, int]:
    with _TAIL_CACHE_LOCK:
        return dict(_TAIL_CACHE_STATS)


def _cached_tail_ops(wal: SegmentedWAL, offset: int, end: int) -> list:
    key = wal.segment_identity(offset, end)
    with _TAIL_CACHE_LOCK:
        ops = _TAIL_CACHE.get(key)
        if ops is not None:
            _TAIL_CACHE.move_to_end(key)
            _TAIL_CACHE_STATS["hits"] += 1
            _M_TAIL_HITS.inc()
            return ops
        _TAIL_CACHE_STATS["misses"] += 1
        _M_TAIL_MISSES.inc()
    # strict_head: a session dir is a CLOSED set of hard links — a missing
    # first segment is loss (someone deleted a link), never compaction
    ops = list(wal.replay(offset=offset, end=end, strict_head=True))
    with _TAIL_CACHE_LOCK:
        _TAIL_CACHE[key] = ops
        while len(_TAIL_CACHE) > _TAIL_CACHE_MAX:
            _TAIL_CACHE.popitem(last=False)
    return ops


# ---------------------------------------------------------------------------
# Snapshot — a pinned, read-only, process-shareable session
# ---------------------------------------------------------------------------
class Snapshot:
    """A consistent read-only view of a GraphDB at one WAL offset.

    Built from a session directory written by `GraphDB.pin_snapshot`. The
    reconstruction is exactly the recovery path: open the pinned manifest's
    partition files (mmap-backed, shared page cache across sessions), then
    replay the typed WAL records in [wal_offset, pinned_offset) into
    private in-memory state. Mutating methods are deliberately absent."""

    def __init__(self, directory: str, doc: Optional[Dict[str, Any]] = None):
        # resolve once, against the CALLER's cwd: every store path below is
        # derived from the session dir (SNAPSHOT.json stores only digests,
        # never absolute paths), so a session dir can be renamed, moved, or
        # handed to another process and opened there. The abspath matters
        # because partition mmaps open lazily — a relative path captured
        # here would break on the first read after any chdir.
        directory = os.path.abspath(directory)
        self.dir = directory
        if doc is None:
            with open(os.path.join(directory, GraphDB.SNAPSHOT)) as f:
                doc = json.load(f)
        self.doc = doc
        self.pinned_offset = int(doc["pinned_offset"])
        config = doc["config"]
        iv = IntervalMap(n_partitions=config["n_partitions"],
                         interval_len=config["interval_len"])
        column_dtypes = {k: np.dtype(s)
                         for k, s in config["column_dtypes"].items()}
        tree = LSMTree(
            iv, n_levels=config["n_levels"], branching=config["branching"],
            buffer_cap=config["buffer_cap"],
            max_partition_edges=config["max_partition_edges"],
            column_dtypes=column_dtypes, durable=False)
        for li, level in enumerate(doc["levels"]):
            for pi, entry in enumerate(level):
                if entry is None:
                    continue
                part = open_partition_file(
                    os.path.join(directory, f"part_{entry['digest']}.pal"))
                # sessions carry no residency budget: decode pointer
                # indexes once and keep them (repeat-query speed)
                part.index_resident = True
                dead = os.path.join(directory,
                                    f"part_{entry['digest']}.dead.npy")
                if entry.get("dead") and os.path.exists(dead):
                    part.dead = np.load(dead)
                tree.levels[li][pi] = part
        wal = SegmentedWAL(os.path.join(directory, "wal"), readonly=True)
        replay_ops(tree, _cached_tail_ops(wal, int(doc["wal_offset"]),
                                          self.pinned_offset))
        tree.publish()  # cover the directly-installed pinned partitions
        self.tree = tree
        self._engine = None

    @classmethod
    def open(cls, directory: str) -> "Snapshot":
        """Open an existing session directory — the cross-process entry
        point (reader processes share nothing but the immutable files)."""
        return cls(directory)

    # -- read surface ---------------------------------------------------------
    @property
    def intervals(self) -> IntervalMap:
        return self.tree.intervals

    @property
    def n_edges(self) -> int:
        return self.tree.n_edges

    def storage_engine(self):
        if self._engine is None:
            from .engine import SnapshotEngine
            self._engine = SnapshotEngine(self.tree)
        return self._engine

    def out_neighbors(self, v: int) -> np.ndarray:
        return self.tree.out_neighbors(v)

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.tree.in_neighbors(v)

    def to_coo(self):
        return self.tree.to_coo()

    def all_partitions(self):
        return self.tree.all_partitions()

    def snapshot(self, **kw):
        """Compile the pinned state into a DeviceGraph for PSW analytics
        (`LSMTree.snapshot`: `device=None` means the GPU)."""
        return self.tree.snapshot(**kw)

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        """Drop mappings and decoded caches; the session dir stays openable."""
        for part in self.tree.all_partitions():
            ev = getattr(part, "evict", None)
            if ev is not None:
                ev()

    def release(self) -> None:
        """Close AND delete the session directory — the last hard link to
        any GC'd partition file or compacted WAL segment drops here."""
        self.close()
        shutil.rmtree(self.dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# ServiceDB — single writer, parallel maintenance pipeline, lock-free reads
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServiceStats:
    flushes: int = 0          # committed buffer drains (merges + sink)
    checkpoints: int = 0      # maintenance checkpoints (manifest + GC)
    snapshots: int = 0        # sessions pinned
    backpressure_waits: int = 0  # insert calls that blocked on the bound
    feedback_checkpoints: int = 0  # checkpoints scheduled by reader feedback
    max_concurrent_flushes: int = 0  # peak in-flight flush jobs (pipeline)
    job_retries: int = 0      # supervised job failures that were retried
    poisoned_jobs: int = 0    # jobs quarantined after repeated failure
    read_only_entries: int = 0   # times the service shed to read-only
    read_only_exits: int = 0     # times auto-recovery cleared it
    scrubs: int = 0           # background integrity scrub passes


# registry names for the ServiceStats collector: the dataclass
# stays the live state its `+=` sites mutate under the service lock;
# telemetry.snapshot() reads it through a weakref at aggregation time
_SERVICE_STATS_METRICS = {
    "flushes": "service.flushes",
    "checkpoints": "service.checkpoints",
    "snapshots": "service.snapshots",
    "backpressure_waits": "service.backpressure_waits",
    "feedback_checkpoints": "service.feedback_checkpoints",
    "max_concurrent_flushes": "service.max_concurrent_flushes",
    "job_retries": "service.job_retries",
    "poisoned_jobs": "service.poisoned_jobs",
    "read_only_entries": "service.read_only_entries",
    "read_only_exits": "service.read_only_exits",
    "scrubs": "service.scrubs",
}


# __init__ kwargs that ServiceDB.create must keep for itself rather than
# forward to GraphDB.create
_SUPERVISION_KW = ("max_job_failures", "backoff_base_s", "backoff_max_s",
                   "recovery_probe_s", "scrub_interval_s", "scrub_limit")


class ServiceDB:
    """Concurrent front end over a durable GraphDB.

    Writer methods (insert/delete/update) append to the WAL + buffers under
    the service lock and return; merges, partition persistence, checkpoint
    GC, and WAL compaction run on the maintenance pipeline. Live reads go
    through `read_view()` — epoch-pinned manifests, NO lock shared with any
    of the above. `begin_snapshot` pins the current logical state into a
    session directory and returns a `Snapshot` any number of readers can
    query (or re-open by path from other processes).

    `pipeline=True` (default) runs the parallel pipeline: flush
    merges of distinct top-level intervals proceed concurrently on
    `maintenance_workers` threads, and checkpoints overlap them.
    `pipeline=False` keeps the serial loop (one thread, every step
    under the service lock) — the in-run baseline `bench_service.py`'s
    contended-read benchmark measures against."""

    def __init__(self, db: GraphDB,
                 checkpoint_interval_ops: int = 500_000,
                 backpressure_edges: Optional[int] = None,
                 maintenance: bool = True,
                 pipeline: bool = True,
                 maintenance_workers: Optional[int] = None,
                 wal_tail_budget_bytes: int = 64 << 20,
                 snapshot_open_budget_s: float = 1.0,
                 max_job_failures: int = 3,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 5.0,
                 recovery_probe_s: float = 0.5,
                 scrub_interval_s: Optional[float] = None,
                 scrub_limit: Optional[int] = None):
        if db.tree.wal is None:
            raise ValueError("ServiceDB needs a durable GraphDB")
        self.db = db
        self.tree = db.tree
        self.tree.auto_flush = False  # inserts never merge on their thread
        self.checkpoint_interval_ops = int(checkpoint_interval_ops)
        self.backpressure_edges = int(backpressure_edges
                                      if backpressure_edges is not None
                                      else 4 * self.tree.buffer_cap)
        self.pipeline = bool(pipeline)
        self.maintenance_workers = int(
            maintenance_workers if maintenance_workers is not None
            else max(2, min(4, (os.cpu_count() or 2) - 1)))
        self.wal_tail_budget_bytes = int(wal_tail_budget_bytes)
        self.snapshot_open_budget_s = float(snapshot_open_budget_s)
        self.stats = ServiceStats()
        telemetry.register_stats(self.stats, _SERVICE_STATS_METRICS)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._drained = threading.Condition(self._lock)
        self._closing = False
        self._ops_since_ckpt = 0
        self._snap_ids = itertools.count()
        self.maintenance_error: Optional[BaseException] = None
        # -- supervision: maintenance jobs are retried with
        # exponential backoff, quarantined ("poisoned") after K failures,
        # and persist-path failure sheds the service to READ-ONLY mode —
        # writes raise ReadOnlyError, epoch reads and snapshots stay live,
        # and a periodic probe auto-recovers once the condition clears
        self.max_job_failures = int(max_job_failures)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.recovery_probe_s = float(recovery_probe_s)
        self.scrub_interval_s = scrub_interval_s
        self.scrub_limit = scrub_limit
        self._job_failures: Dict[str, int] = {}
        self._job_backoff: Dict[str, float] = {}   # key -> monotonic deadline
        self._poisoned: set = set()
        self.read_only = False
        self.read_only_reason: Optional[str] = None
        self._next_probe = 0.0
        self._last_scrub = time.monotonic()
        self._scrubbing = False
        # merge slots: one lock per top-level destination interval. A flush
        # job owns its subtree for the whole merge; deletes/column updates
        # take the one slot their destination maps to. Lock ORDER: interval
        # locks (ascending index) strictly before the service lock. RLocks,
        # so a caller may pre-acquire a slot (in order) around a compound
        # operation that itself takes it.
        self._interval_locks = [threading.RLock() for _ in self.tree.buffers]
        self._flushing: set = set()       # top indexes with a job in flight
        self._ckpt_running = False
        self._ckpt_requested = False      # reader-feedback checkpoint ask
        # the tail budget measures what a new session must REPLAY, i.e.
        # bytes past the manifest-covered offset — a store reopened with a
        # big pre-existing tail must count it (initializing to the current
        # tail would report 0 until new writes accrue)
        try:
            self._last_ckpt_offset = int(
                db._read_manifest().get("wal_offset", 0))
        except OSError:
            self._last_ckpt_offset = self.tree.wal.tail_offset()
        self.last_snapshot_open_s = 0.0
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        if maintenance:
            if self.pipeline:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.maintenance_workers,
                    thread_name_prefix="graphdb-mw")
                target = self._scheduler_loop
            else:
                target = self._maintenance_loop
            self._thread = threading.Thread(
                target=target, name="graphdb-maintenance", daemon=True)
            self._thread.start()

    # -- lifecycle -------------------------------------------------------------
    @classmethod
    def create(cls, directory: str, max_id: int,
               checkpoint_interval_ops: int = 500_000,
               backpressure_edges: Optional[int] = None,
               maintenance: bool = True, pipeline: bool = True,
               maintenance_workers: Optional[int] = None,
               wal_tail_budget_bytes: int = 64 << 20,
               snapshot_open_budget_s: float = 1.0,
               **graphdb_kw) -> "ServiceDB":
        graphdb_kw.setdefault("durable", True)
        service_kw = {k: graphdb_kw.pop(k) for k in _SUPERVISION_KW
                      if k in graphdb_kw}
        db = GraphDB.create(directory, max_id=max_id, **graphdb_kw)
        return cls(db, checkpoint_interval_ops=checkpoint_interval_ops,
                   backpressure_edges=backpressure_edges,
                   maintenance=maintenance, pipeline=pipeline,
                   maintenance_workers=maintenance_workers,
                   wal_tail_budget_bytes=wal_tail_budget_bytes,
                   snapshot_open_budget_s=snapshot_open_budget_s,
                   **service_kw)

    @classmethod
    def open(cls, directory: str, **service_kw) -> "ServiceDB":
        return cls(GraphDB.open(directory), **service_kw)

    def close(self) -> None:
        with self._lock:
            self._closing = True
            self._work.notify_all()
            self._drained.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)  # in-flight jobs finish cleanly
            self._pool = None
        with self._lock:
            self.db.close()  # final checkpoint + WAL close

    # -- writer surface --------------------------------------------------------
    def _check_writable(self) -> None:
        """Caller holds the lock. Raises BEFORE the mutation is applied."""
        if self.read_only:
            raise ReadOnlyError(self.read_only_reason or "degraded")
        if self.maintenance_error is not None:
            raise RuntimeError("maintenance thread died") \
                from self.maintenance_error

    def _after_mutation(self, n_ops: int) -> None:
        """Caller holds the lock. Account ops, wake maintenance, apply
        backpressure: block while the dirty set (buffered + in-flight
        drained edges) exceeds the bound."""
        self._ops_since_ckpt += n_ops
        if telemetry.enabled():
            _M_WAL_TAIL.set(int(self.wal_tail_bytes()))
            _M_BACKLOG.set(int(self.tree.total_buffered()
                               + self.tree.inflight_edges()))
        if self._pending_work():
            self._work.notify()
        waited = False
        while (self.tree.total_buffered() + self.tree.inflight_edges()
               > self.backpressure_edges
               and not self._closing and not self.read_only
               and self.maintenance_error is None
               and self._thread is not None
               and self._thread.is_alive()):
            waited = True
            self._work.notify()
            self._drained.wait(timeout=1.0)
        if waited:
            self.stats.backpressure_waits += 1
        if self.read_only:
            # the pipeline degraded while this writer waited: the mutation
            # IS applied (buffered + WAL) but the writer must learn the
            # service stopped accepting more
            raise ReadOnlyError(self.read_only_reason or "degraded")
        if self.maintenance_error is not None:
            # a dead maintenance thread would leave backpressure waiting
            # forever — surface its failure to the writer instead
            raise RuntimeError("maintenance thread died") \
                from self.maintenance_error

    def insert_edge(self, src: int, dst: int, etype: int = 0, **cols) -> None:
        with self._lock:
            self._check_writable()
            self.tree.insert_edge(src, dst, etype=etype, **cols)
            self._after_mutation(1)

    def insert_edges(self, src, dst, etype=None, columns=None) -> None:
        n = int(np.asarray(src).shape[0])
        with self._lock:
            self._check_writable()
            self.tree.insert_edges(src, dst, etype=etype, columns=columns)
            self._after_mutation(n)

    def _merge_slot_of(self, dst: int) -> threading.Lock:
        """The interval lock owning `dst`'s top-level subtree. Structural
        partition mutations (tombstones, in-place column writes) must hold
        it so they serialize with an in-flight merge of the same subtree —
        otherwise the merge's rebuilt partitions would drop a tombstone
        landed mid-merge. Acquired BEFORE the service lock (lock order)."""
        idst = int(self.tree.intervals.to_internal_scalar(dst))
        return self._interval_locks[self.tree._top_index_of(idst)]

    def delete_edge(self, src: int, dst: int) -> bool:
        with self._merge_slot_of(dst):
            with self._lock:
                self._check_writable()
                found = self.tree.delete_edge(src, dst)
                self._after_mutation(1)
                return found

    def update_edge_column(self, src: int, dst: int, name: str, value) -> bool:
        with self._merge_slot_of(dst):
            with self._lock:
                self._check_writable()
                ok = self.tree.update_edge_column(src, dst, name, value)
                self._after_mutation(1)
                return ok

    def _all_merge_slots(self):
        """Context acquiring every interval lock in index order — the brief
        exclusive window of checkpoint phase B (writers blocked, epoch
        readers unaffected)."""
        class _All:
            def __init__(_s, locks):
                _s.locks = locks

            def __enter__(_s):
                for lk in _s.locks:
                    lk.acquire()

            def __exit__(_s, *exc):
                for lk in reversed(_s.locks):
                    lk.release()

        return _All(self._interval_locks)

    def checkpoint(self) -> Dict[str, Any]:
        with self._all_merge_slots():
            with self._lock:
                manifest = self.db.checkpoint()
                self._ops_since_ckpt = 0
                self._last_ckpt_offset = self.tree.wal.tail_offset()
                return manifest

    # -- snapshot sessions -----------------------------------------------------
    def begin_snapshot(self, view=None) -> Snapshot:
        """Pin the current logical state and return a read-only session.
        The pin (hard links + SNAPSHOT.json) happens under the lock — a
        few syscalls, no data copy; the session rebuild (mmap + WAL tail
        replay) happens outside it, off the writer's critical path.

        With `view` (a pinned `ManifestView`), the session is pinned at the
        view's logical offset instead of the current tail: the rebuilt
        state is bitwise the view's state, which is how an in-process epoch
        crosses the process boundary (shard workers export their pinned
        epoch this way — core/shardrouter.py)."""
        offset = None if view is None else int(view.wal_tail)
        with self._lock:
            base = os.path.join(self.db.dir, "snapshots")
            os.makedirs(base, exist_ok=True)
            while True:
                # the counter restarts per instance and pids recycle, so a
                # reopened ServiceDB can land on a still-live session name —
                # skip collisions instead of crashing
                sid = f"snap_{os.getpid()}_{next(self._snap_ids):06d}"
                dest = os.path.join(base, sid)
                try:
                    doc = self.db.pin_snapshot(dest, pinned_offset=offset)
                    break
                except FileExistsError:
                    continue
            self.stats.snapshots += 1
        t0 = time.perf_counter()
        snap = Snapshot(dest, doc=doc)
        open_s = time.perf_counter() - t0
        self.last_snapshot_open_s = open_s
        if open_s > self.snapshot_open_budget_s:
            # reader-latency feedback: the session rebuild (mmap + tail
            # replay) is getting slow — a checkpoint shrinks the tail
            with self._lock:
                if not self._ckpt_requested:
                    self._ckpt_requested = True
                    self.stats.feedback_checkpoints += 1
                self._work.notify()
        return snap

    # -- live reads (lock-free: epoch-pinned manifests) ------------------------
    def read_view(self):
        """Pin the current published manifest and return a read-only store
        view (core/manifest.py). The whole query session on one view —
        point lookups, batched engine slabs, FoF/BFS, PSW streaming — runs
        against a single frozen state and NEVER takes the service lock, so
        read latency is flat while the writer appends and merges run.
        Release the view (context manager) when done."""
        return self.tree.read_view()

    def out_neighbors(self, v: int) -> np.ndarray:
        with self.read_view() as view:
            return view.out_neighbors(v)

    def in_neighbors(self, v: int) -> np.ndarray:
        with self.read_view() as view:
            return view.in_neighbors(v)

    @property
    def n_edges(self) -> int:
        with self.read_view() as view:
            return view.n_edges

    @property
    def intervals(self) -> IntervalMap:
        return self.tree.intervals

    def storage_engine(self):
        """The LIVE engine — only safe while no concurrent writer runs
        (e.g. single-thread benchmarking). Concurrent readers should use
        `read_view().storage_engine()` (lock-free, one consistent manifest)
        or `begin_snapshot().storage_engine()` (process-shareable)."""
        return self.db.storage_engine()

    def health(self) -> Dict[str, Any]:
        """One liveness/progress probe, cheap enough to poll: what a shard
        router's supervisor (core/shardrouter.py) uses to decide a worker
        is alive and making progress, and what `bench_shard.py` records
        per shard. Taken without the service lock — every field is a
        single read of published state (approximate by design)."""
        with self.read_view() as view:
            n_edges = view.n_edges
            epoch = view.version
        tail = int(self.wal_tail_bytes())
        backlog = int(self.tree.total_buffered()
                      + self.tree.inflight_edges())
        alive = bool(self._thread is not None and self._thread.is_alive())
        poisoned = sorted(self._poisoned)
        # metric-derived readiness: ready means "a new
        # request will be served promptly AND durably" — not read-only, a
        # live maintenance pipeline, the WAL tail within its replay budget,
        # backlog under the backpressure bound, and no quarantined jobs
        wal_tail_ok = tail <= self.wal_tail_budget_bytes
        backlog_ok = backlog <= self.backpressure_edges
        return {
            "pid": os.getpid(),
            "n_edges": int(n_edges),
            "epoch": int(epoch),
            "read_only": bool(self.read_only),
            "read_only_reason": self.read_only_reason,
            "wal_tail_bytes": tail,
            "wal_tail_budget_bytes": int(self.wal_tail_budget_bytes),
            "wal_tail_ok": bool(wal_tail_ok),
            "buffered": int(self.tree.total_buffered()),
            "backlog_edges": backlog,
            "backlog_ok": bool(backlog_ok),
            "poisoned_jobs": poisoned,
            "poisoned_count": len(poisoned),
            "maintenance_alive": alive,
            "ready": bool(not self.read_only and alive and wal_tail_ok
                          and backlog_ok and not poisoned),
            "io": self.db.io.snapshot(),
        }

    def admission_state(self) -> Dict[str, Any]:
        """The three facts front-end admission control (core/frontdesk.py)
        polls before queueing a WRITE: read-only degradation (shed now —
        the write would only fail later, typed the same), and how close
        the dirty set is to the backpressure bound (a front desk sheds
        instead of letting its dispatcher block inside `insert_edges`).
        Lock-free single reads, cheap enough for the admission fast path.
        """
        backlog = int(self.tree.total_buffered()
                      + self.tree.inflight_edges())
        return {
            "read_only": bool(self.read_only),
            "read_only_reason": self.read_only_reason,
            "backlog_edges": backlog,
            "backpressure_edges": int(self.backpressure_edges),
            "accepting_writes": bool(not self.read_only
                                     and backlog <= self.backpressure_edges),
        }

    def metrics_snapshot(self) -> Dict[str, Any]:
        """This process's aggregated telemetry: every registry
        counter/gauge/histogram summed across threads, legacy stats bags
        folded in. JSON-safe."""
        return telemetry.snapshot()

    def prometheus_text(self) -> str:
        return telemetry.prometheus_text()

    # -- maintenance -----------------------------------------------------------
    def wal_tail_bytes(self) -> int:
        """Un-checkpointed WAL bytes — what a new session must replay."""
        return self.tree.wal.tail_offset() - self._last_ckpt_offset

    def _checkpoint_due(self) -> bool:
        return (self._ops_since_ckpt >= self.checkpoint_interval_ops
                or self._ckpt_requested
                or self.wal_tail_bytes() >= self.wal_tail_budget_bytes)

    def _pending_work(self) -> bool:
        return (self.tree.total_buffered() > self.tree.buffer_cap
                or self._checkpoint_due())

    # -- the serial loop (pipeline=False: the measured baseline) ---------------
    def _maintenance_loop(self) -> None:
        try:
            self._maintenance_steps()
        except BaseException as e:
            # don't die silently: record the failure so the next writer
            # call raises it instead of hanging in the backpressure wait
            with self._lock:
                self.maintenance_error = e
                self._drained.notify_all()

    def _maintenance_steps(self) -> None:
        while True:
            # one lock acquisition per transition: the lock is actually
            # free between a flush and the next flush/checkpoint, so
            # writers interleave with a sustained drain instead of
            # stalling behind the whole backlog
            with self._lock:
                while (not self._pending_work() and not self._closing
                       and not self.read_only):
                    self._work.wait(timeout=0.5)
                if self._closing:
                    return  # close() checkpoints what remains
                if self.read_only:
                    self._probe_recovery()
                    if self.read_only:
                        self._work.wait(timeout=self.recovery_probe_s)
                    continue
                if (self.tree.total_buffered() > self.tree.buffer_cap
                        and self._backoff_ready("flush")):
                    # FLUSH: one whole buffer per merge — back-to-back
                    # small flushes of the same top partition batch into
                    # one rewrite instead of many
                    try:
                        self.tree.flush_fullest_buffer()
                    except BaseException as e:
                        self._job_failed("flush", e)
                    else:
                        self._job_ok("flush")
                        self.stats.flushes += 1
                elif self._checkpoint_due() and self._backoff_ready(
                        "checkpoint"):
                    # CHECKPOINT: persist + manifest + store GC + WAL
                    # segment compaction
                    try:
                        self.db.checkpoint()
                    except BaseException as e:
                        self._job_failed("checkpoint", e)
                    else:
                        self._job_ok("checkpoint")
                        self._ops_since_ckpt = 0
                        self._last_ckpt_offset = self.tree.wal.tail_offset()
                        self._ckpt_requested = False
                        self.stats.checkpoints += 1
                else:
                    # pending work, but every step is backing off
                    self._work.wait(timeout=0.1)
                self._drained.notify_all()

    # -- the parallel pipeline (pipeline=True) ---------------------------------
    def _scheduler_loop(self) -> None:
        """Dispatch flush jobs (one per top-level interval, concurrent
        across intervals) and checkpoint jobs to the worker pool. Holds the
        service lock only to inspect state and enqueue; all heavy work runs
        on the workers."""
        try:
            with self._lock:
                while True:
                    while (not self._pending_work() and not self._closing
                           and not self.read_only
                           and not self._scrub_due()):
                        self._work.wait(timeout=0.5)
                    if self._closing:
                        return  # close() drains the pool + final checkpoint
                    if self.read_only:
                        # degraded: no new jobs; probe for recovery
                        self._probe_recovery()
                        if self.read_only:
                            self._work.wait(timeout=self.recovery_probe_s)
                        continue
                    submitted = self._schedule_flushes()
                    if (self._checkpoint_due() and not self._ckpt_running
                            and self._backoff_ready("checkpoint")):
                        self._ckpt_running = True
                        self._pool.submit(self._run_job, "checkpoint",
                                          self._checkpoint_job,
                                          ctx=telemetry.current_context())
                        submitted = True
                    if self._scrub_due():
                        self._scrubbing = True
                        self._pool.submit(self._run_job, "scrub",
                                          self._scrub_job,
                                          ctx=telemetry.current_context())
                        submitted = True
                    if not submitted:
                        # work is pending but every eligible job is already
                        # in flight (or backing off) — wait for a commit or
                        # a backoff expiry to change the state
                        self._work.wait(timeout=0.2)
        except BaseException as e:
            with self._lock:
                self.maintenance_error = e
                self._drained.notify_all()

    def _schedule_flushes(self) -> bool:
        """Caller holds the lock. Submit flush jobs for the fullest
        buffers not already in flight while the drainable backlog exceeds
        the cap — independent intervals drain CONCURRENTLY."""
        if self.tree.total_buffered() <= self.tree.buffer_cap:
            return False
        sizes = [(len(b), j) for j, b in enumerate(self.tree.buffers)
                 if len(b) and j not in self._flushing
                 and self._backoff_ready(f"flush:{j}")]
        sizes.sort(reverse=True)
        submitted = False
        remaining = self.tree.total_buffered()
        for n, j in sizes:
            if len(self._flushing) >= self.maintenance_workers:
                break
            self._flushing.add(j)
            self.stats.max_concurrent_flushes = max(
                self.stats.max_concurrent_flushes, len(self._flushing))
            self._pool.submit(self._run_job, f"flush:{j}",
                              self._flush_job, j,
                              ctx=telemetry.current_context())
            submitted = True
            remaining -= n
            if remaining <= self.tree.buffer_cap:
                break
        return submitted

    # -- supervision -----------------------------------------------------------
    def _job_ok(self, key: str) -> None:
        with self._lock:
            self._job_failures.pop(key, None)
            self._job_backoff.pop(key, None)

    def _job_failed(self, key: str, exc: BaseException) -> None:
        """Supervisor policy: exponential-backoff retry; poison-quarantine
        the job after `max_job_failures`; ENOSPC or a poisoned persist-path
        job sheds the whole service to read-only (writes rejected typed,
        epoch reads + snapshot sessions stay live; auto-recovery probes)."""
        with self._lock:
            n = self._job_failures.get(key, 0) + 1
            self._job_failures[key] = n
            is_enospc = (isinstance(exc, OSError)
                         and exc.errno == errno.ENOSPC)
            poisoned = n >= self.max_job_failures
            if poisoned and key not in self._poisoned:
                self._poisoned.add(key)
                self.stats.poisoned_jobs += 1
            if not poisoned:
                self.stats.job_retries += 1
                delay = min(self.backoff_max_s,
                            self.backoff_base_s * (2 ** (n - 1)))
                self._job_backoff[key] = time.monotonic() + delay
            if (is_enospc or poisoned) and not key.startswith("scrub"):
                # persist-path degradation: record the fault (legacy
                # `maintenance_error` surface) and shed to read-only
                self.maintenance_error = exc
                self._enter_read_only(
                    "ENOSPC" if is_enospc
                    else f"maintenance job {key!r} failed {n}x: {exc}")
            self._drained.notify_all()
            self._work.notify_all()

    def _enter_read_only(self, reason: str) -> None:
        """Caller holds the lock."""
        if not self.read_only:
            self.read_only = True
            self.read_only_reason = reason
            self.stats.read_only_entries += 1
            self._next_probe = time.monotonic() + self.recovery_probe_s

    def _exit_read_only(self) -> None:
        """Caller holds the lock. Clears degradation state entirely: the
        poisoned jobs get a fresh supervisor ledger — if the fault is
        still there they re-fail and the service re-degrades."""
        self.read_only = False
        self.read_only_reason = None
        self.maintenance_error = None
        self._job_failures.clear()
        self._job_backoff.clear()
        self._poisoned.clear()
        self.stats.read_only_exits += 1
        self._drained.notify_all()
        self._work.notify_all()

    def _probe_recovery(self) -> None:
        """Caller holds the lock, service is read-only. Probe the cheapest
        operation resembling the persist path (create + fsync + publish a
        tiny file); success clears read-only and un-poisons every job."""
        now = time.monotonic()
        if now < self._next_probe:
            return
        self._next_probe = now + self.recovery_probe_s
        probe = os.path.join(self.db.dir, ".recovery_probe.tmp")
        try:
            failpoint("part.write.fsync")
            with open(probe, "wb") as f:
                f.write(b"probe")
                f.flush()
                os.fsync(f.fileno())
            os.remove(probe)
        except OSError:
            return  # still degraded; probe again later
        self._exit_read_only()

    def _backoff_ready(self, key: str) -> bool:
        """Caller holds the lock: job not poisoned and past its backoff."""
        if key in self._poisoned:
            return False
        until = self._job_backoff.get(key)
        return until is None or time.monotonic() >= until

    def _scrub_due(self) -> bool:
        """Caller holds the lock."""
        return (self.scrub_interval_s is not None
                and not self._scrubbing
                and self._backoff_ready("scrub")
                and (time.monotonic() - self._last_scrub
                     >= self.scrub_interval_s))

    def _scrub_job(self) -> None:
        """Idle-cadence background scrub (worker pool): re-verify section
        CRCs + content digests of live partition files; corrupt ones are
        quarantined under the exclusive window, readers keep flowing from
        the surviving levels."""
        try:
            failpoint("service.scrub")
            with self._all_merge_slots():
                with self._lock:
                    self.db.scrub(limit=self.scrub_limit)
            with self._lock:
                self.stats.scrubs += 1
        finally:
            with self._lock:
                self._scrubbing = False
                self._last_scrub = time.monotonic()

    def _run_job(self, key: str, fn, *args, ctx=None) -> None:
        """Worker-pool entry point. `ctx` is the submitter's ambient
        [trace_id, span_id]: the job's span joins the submitting
        request's trace, so a write that triggered a flush shows the flush
        inside its own trace."""
        with telemetry.attach(ctx), \
                telemetry.span("service.job", job=key) as sp:
            t0 = time.perf_counter()
            try:
                fn(*args)
            except BaseException as e:
                self._job_failed(key, e)
                with self._lock:
                    sp.tag(error=type(e).__name__,
                           retries=self._job_failures.get(key, 0),
                           poisoned=key in self._poisoned,
                           read_only=self.read_only)
            else:
                self._job_ok(key)
            _M_JOB_S.observe(time.perf_counter() - t0,
                             label=key.split(":", 1)[0])

    def _flush_job(self, j: int) -> None:
        """One pipelined flush: drain under the service lock (cheap —
        detach staging views, publish), merge + persist under ONLY the
        interval lock (the expensive part, concurrent with other intervals'
        flushes, the writer, and every reader), commit + publish under the
        service lock again (cheap pointer swaps)."""
        try:
            with self._interval_locks[j]:
                with self._lock:
                    st = self.tree.drain_buffer(j)
                if st is None:
                    return
                failpoint("service.flush.merge")
                txn = self.tree.build_flush_txn(j, st)  # off the service lock
                with self._lock:
                    self.tree.commit_txn(txn)
                    self.stats.flushes += 1
        finally:
            with self._lock:
                self._flushing.discard(j)
                self._drained.notify_all()
                self._work.notify()

    def _checkpoint_job(self) -> None:
        """Checkpoint overlapping in-flight merges. Phase A persists every
        RAM/dirty partition with NO locks held (content-addressed puts are
        idempotent; a partition a concurrent merge replaces becomes an
        unreferenced file the next GC removes). Phase B takes all interval
        locks + the service lock for the residual buffer flush, manifest
        write, epoch-aware GC, and WAL compaction — by then phase A has
        already written the bulk of the bytes, so the exclusive window
        stays short. Writers stall only for phase B; readers never."""
        try:
            with self._lock:
                candidates = [
                    part for lv in self.tree.levels for part in lv
                    if part.n_edges
                    and (not isinstance(part, DiskPartition) or part.dirty)
                ]
            failpoint("service.ckpt.phaseA")
            for part in candidates:  # phase A: no locks, overlaps merges
                self.db.store.put(part)
            with self._all_merge_slots():  # phase B: brief exclusive window
                with self._lock:
                    failpoint("service.ckpt.phaseB")
                    self.db.checkpoint()
                    self._ops_since_ckpt = 0
                    self._last_ckpt_offset = self.tree.wal.tail_offset()
                    self.stats.checkpoints += 1
        finally:
            with self._lock:
                self._ckpt_running = False
                self._ckpt_requested = False
                self._drained.notify_all()
