"""LSM-tree of PAL edge partitions (paper §5).

Immutable edge partitions are stacked in a log-structured merge tree:

  * level 0 (top) is the coarsest — few partitions, each covering the union
    of its descendants' vertex intervals — and is the only level with
    in-memory edge buffers (paper §5.2);
  * inserts land in the buffer of the top partition whose interval contains
    the edge's destination;
  * when total buffered edges exceed `buffer_cap`, the fullest buffer is
    sort-merged with its on-disk partition into a NEW immutable partition
    (the old one is dropped only after the new one is built — paper §7.3's
    crash-integrity argument);
  * when a partition outgrows `max_partition_edges`, it is emptied downstream
    into its f children (push-down merge), so each edge is rewritten only
    O(log |E|) times instead of O(|E|/R) (paper §5.1 vs §5.2);
  * deletes are tombstones purged at merge time; attribute updates write the
    columns in place (paper §5.3);
  * optional durability: a write-ahead log capturing each insert before it
    reaches a buffer ("durable buffers", paper §7.3).

Host copy of the reference `repro/core/lsm.py` (numpy).
`LSMTree.snapshot` returns the port's torch `DeviceGraph` (core/psw.py).
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import os
import struct
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import telemetry
from .manifest import EpochGuard, LevelManifest, ManifestPartition, ManifestView
from .pal import (
    _MAX_PACKED_BOUND,
    EdgePartition,
    IntervalMap,
    SortedRun,
    build_partition,
    merge_runs,
    merge_runs_into_partition,
    partition_from_run,
    run_from_arrays,
    run_from_partition,
)

__all__ = ["BufferStaging", "EdgeBuffer", "LSMTree", "LSMStats", "MergeTxn",
           "MutationLog"]


class MutationLog:
    """The store's changes of key presence, in order: what a read structure
    derived from a whole edge set (core/multihop.py's live dense plans)
    reads to follow the store without a rebuild per publication.

    Entry i is a packed internal key (src * max_vertices + dst) with +1 for
    an insert and -1 for a delete that found the key. A delete removes every
    copy of its key and an insert makes it present, so a key's presence is
    its last entry. Merges, checkpoints and column writes change no key's
    presence and append nothing. `seq` counts the entries ever appended;
    every manifest records the `seq` its edge set covers
    (`LevelManifest.log_seq`). A reader that follows the log names itself
    when it reads (`entries(..., follower=)`): entries from the oldest
    position a follower has read up to are held, and with no follower only
    the last `LAG` (so that a structure built from a view pinned a little
    earlier can still follow), at most `KEEP` in any case. A reader that
    asks for entries no longer held gets None and rebuilds. `cut()` marks a
    change of the edge set that the log does not describe (a quarantined
    partition, a rebuild from the WAL): no range that spans it is served.

    Appends come from the serialized writer; readers of any thread call
    `entries`. One lock orders them."""

    KEEP = 1 << 22
    LAG = 1 << 18

    def __init__(self):
        self._lock = threading.Lock()
        self._starts: List[int] = []          # seq of each chunk's first entry
        self._chunks: List[Tuple[object, int]] = []   # (keys, sign)
        self._followers: Dict = {}            # follower -> position read to
        self.start = 0                        # seq of the oldest entry held
        self.seq = 0

    def append(self, keys, sign: int, n: Optional[int] = None) -> None:
        """`n` keys (an int64 array, or one int with n = 1), all of `sign`."""
        n = int(keys.shape[0]) if n is None else n
        if n == 0:
            return
        with self._lock:
            self._starts.append(self.seq)
            self._chunks.append((keys, sign))
            self.seq += n
            need = (min(self._followers.values()) if self._followers
                    else self.seq - self.LAG)
            i = bisect.bisect_right(self._starts,
                                    max(need, self.seq - self.KEEP)) - 1
            if i > 0:
                del self._starts[:i], self._chunks[:i]
                self.start = self._starts[0]

    def cut(self) -> None:
        with self._lock:
            self._starts.clear()
            self._chunks.clear()
            self._followers.clear()
            self.seq += 1
            self.start = self.seq

    def entries(self, a: int, b: int, follower=None):
        """(keys int64, signs int8) of entries [a, b), or None where the
        range starts before the oldest entry held. `follower` (any hashable
        name) has then read up to `b`: entries from `b` on are held for it."""
        with self._lock:
            if follower is not None:
                self._followers[follower] = b
            if a < self.start:
                return None
            i = max(bisect.bisect_right(self._starts, a) - 1, 0)
            j = bisect.bisect_left(self._starts, b)
            starts, chunks = self._starts[i:j], self._chunks[i:j]
        keys, signs = [], []
        for st, (k, sign) in zip(starts, chunks):
            k = np.atleast_1d(np.asarray(k, np.int64))
            k = k[max(a - st, 0):max(b - st, 0)]
            keys.append(k)
            signs.append(np.full(k.shape[0], sign, np.int8))
        if not keys:
            return np.empty(0, np.int64), np.empty(0, np.int8)
        return np.concatenate(keys), np.concatenate(signs)


class BufferStaging:
    """Immutable logical view of a buffer's first `n` rows, built lazily:
    construction only captures the backing-array references and the length
    (cheap enough to run on EVERY single-edge insert's manifest
    publish); the `[:n]` slice views and the src/dst sort orders
    (binary-searchable like a partition's pointer-array) materialize on
    first use. Captured backing arrays are append-stable: rows `[0, n)`
    never change after capture (growth reallocates, deletes compact into
    fresh arrays), so a staging stays bitwise-valid forever."""

    __slots__ = ("_fsrc", "_fdst", "_fetype", "_fcols", "n",
                 "_src", "_dst", "_etype", "_columns",
                 "_src_order", "_src_sorted", "_dst_order", "_dst_sorted")

    def __init__(self, src, dst, etype, columns, n: Optional[int] = None):
        self._fsrc = src
        self._fdst = dst
        self._fetype = etype
        self._fcols = columns
        self.n = int(src.shape[0] if n is None else n)
        self._src = self._dst = self._etype = self._columns = None
        self._src_order = self._src_sorted = None
        self._dst_order = self._dst_sorted = None

    # lazy [:n] views — idempotent benign-race fills, shared by readers
    @property
    def src(self) -> np.ndarray:
        v = self._src
        if v is None:
            v = self._fsrc[: self.n]
            self._src = v
        return v

    @property
    def dst(self) -> np.ndarray:
        v = self._dst
        if v is None:
            v = self._fdst[: self.n]
            self._dst = v
        return v

    @property
    def etype(self) -> np.ndarray:
        v = self._etype
        if v is None:
            v = self._fetype[: self.n]
            self._etype = v
        return v

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        v = self._columns
        if v is None:
            n = self.n
            v = {k: a[:n] for k, a in self._fcols.items()}
            self._columns = v
        return v

    def src_sorted_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """(order, sorted) over src — built once per staging generation.
        Published stagings are shared by concurrent reader threads: the
        build works on locals and assigns the guard field LAST, so a racing
        reader either sees both caches or rebuilds the same (deterministic)
        arrays itself — never a half-published pair."""
        order = self._src_order
        if order is None:
            order = np.argsort(self.src, kind="stable")
            srt = self.src[order]
            self._src_sorted = srt
            self._src_order = order  # publish last: guards _src_sorted
        else:
            srt = self._src_sorted
        return order, srt

    def dst_sorted_view(self) -> Tuple[np.ndarray, np.ndarray]:
        order = self._dst_order
        if order is None:
            order = np.argsort(self.dst, kind="stable")
            srt = self.dst[order]
            self._dst_sorted = srt
            self._dst_order = order
        else:
            srt = self._dst_sorted
        return order, srt


class EdgeBuffer:
    """Columnar in-memory buffer of new edges for one top-level partition
    (paper §5.1, DESIGN.md §6).

    All state lives in amortized-doubling numpy arrays (`_src/_dst/_etype`
    plus one array per declared attribute column) with a length counter, so
    `append`/`extend` are pure vectorized writes and `staging()` is a
    zero-copy slice view of the backing arrays. Staging views are cached
    and invalidated on any length-changing mutation; holders must not cache
    a staging across buffer mutations.
    """

    _INITIAL_CAP = 256

    def __init__(self, column_dtypes: Dict[str, np.dtype]):
        self.column_dtypes = dict(column_dtypes)
        self._cap = self._INITIAL_CAP
        self._len = 0
        self._src = np.empty(self._cap, np.int64)
        self._dst = np.empty(self._cap, np.int64)
        self._etype = np.empty(self._cap, np.int8)
        self._cols: Dict[str, np.ndarray] = {
            k: np.empty(self._cap, dt) for k, dt in self.column_dtypes.items()
        }
        self._staging: Optional[BufferStaging] = None

    def __len__(self) -> int:
        return self._len

    def _invalidate(self) -> None:
        self._staging = None

    def _reserve(self, extra: int) -> None:
        need = self._len + int(extra)
        if need <= self._cap:
            return
        cap = self._cap
        while cap < need:
            cap *= 2

        def grow(arr):
            out = np.empty(cap, arr.dtype)
            out[: self._len] = arr[: self._len]
            return out

        self._src = grow(self._src)
        self._dst = grow(self._dst)
        self._etype = grow(self._etype)
        self._cols = {k: grow(v) for k, v in self._cols.items()}
        self._cap = cap

    def staging(self) -> BufferStaging:
        if self._staging is None:
            self._staging = BufferStaging(
                self._src, self._dst, self._etype, self._cols, n=self._len)
        return self._staging

    def append(self, src: int, dst: int, etype: int, cols: Dict) -> None:
        self._reserve(1)
        i = self._len
        self._src[i] = src
        self._dst[i] = dst
        self._etype[i] = etype
        for k, col in self._cols.items():
            col[i] = cols.get(k, 0)
        self._len = i + 1
        self._invalidate()

    def extend(self, src, dst, etype, cols: Dict) -> None:
        src = np.asarray(src, dtype=np.int64)
        n = src.shape[0]
        if n == 0:
            return
        self._reserve(n)
        i = self._len
        self._src[i:i + n] = src
        self._dst[i:i + n] = np.asarray(dst, dtype=np.int64)
        self._etype[i:i + n] = np.asarray(etype, dtype=np.int8)
        for k, col in self._cols.items():
            v = cols.get(k)
            col[i:i + n] = 0 if v is None else np.asarray(v, dtype=col.dtype)
        self._len = i + n
        self._invalidate()

    def drain(self) -> BufferStaging:
        """Hand out the current staging and DETACH: the buffer restarts on
        fresh backing arrays, so the drained views stay bitwise-valid for
        as long as anyone holds them — the merge worker consuming them off
        the writer's lock, and every published manifest that still lists
        them as a pending slab (core/manifest.py)."""
        st = self.staging()
        # fresh arrays at the SAME capacity: the old blocks (released when
        # the merge commits and the last manifest drops the staging) and
        # the next drain's allocations share size classes, so the
        # detach-per-drain churn doesn't fragment the allocator heap
        self._len = 0
        self._src = np.empty(self._cap, np.int64)
        self._dst = np.empty(self._cap, np.int64)
        self._etype = np.empty(self._cap, np.int8)
        self._cols = {k: np.empty(self._cap, dt)
                      for k, dt in self.column_dtypes.items()}
        self._invalidate()
        return st

    def set_column(self, name: str, pos: int, value) -> None:
        # staging columns alias the backing arrays and sort orders are
        # unaffected by an attribute write, so no invalidation needed.
        # Published manifests alias these arrays too: column writes are
        # deliberately non-transactional (paper §5.3 in-place semantics) —
        # a pinned view may see a newer value, never a torn structure.
        self._cols[name][pos] = value

    def filter_mask(self, keep: np.ndarray) -> None:
        """Drop rows where keep is False (buffer-side delete, paper §5.3).
        The kept rows are compacted into FRESH backing arrays (same cost as
        the old in-place fancy-index compaction, which also copied every
        kept row) — published manifests and in-flight merges keep aliasing
        the untouched old arrays, so a buffered delete can never tear a
        lock-free reader's view."""
        keep = np.asarray(keep, dtype=bool)
        n = self._len
        m = int(keep.sum())
        if m != n:
            def compact(arr):
                out = np.empty(self._cap, arr.dtype)
                out[:m] = arr[:n][keep]
                return out

            self._src = compact(self._src)
            self._dst = compact(self._dst)
            self._etype = compact(self._etype)
            self._cols = {k: compact(v) for k, v in self._cols.items()}
            self._len = m
        self._invalidate()

    # point queries: binary search when the sorted view already exists (a
    # batched query built it), linear scan on the staged array otherwise
    def out_edges_of(self, v: int):
        st = self.staging()
        if st._src_order is None:
            return np.nonzero(st.src == v)[0]
        order, keys = st.src_sorted_view()
        a = np.searchsorted(keys, v, side="left")
        b = np.searchsorted(keys, v, side="right")
        return order[a:b]  # stable sort → ascending positions

    def in_edges_of(self, v: int):
        st = self.staging()
        if st._dst_order is None:
            return np.nonzero(st.dst == v)[0]
        order, keys = st.dst_sorted_view()
        a = np.searchsorted(keys, v, side="left")
        b = np.searchsorted(keys, v, side="right")
        return order[a:b]


_WAL_COUNTER = itertools.count()


def _default_wal_path() -> str:
    """Per-instance WAL path: pid + a process-wide counter, never shared."""
    return os.path.join(
        tempfile.gettempdir(),
        f"graphchi_db_{os.getpid()}_{next(_WAL_COUNTER)}.wal")


# registry names for the LSMStats collector — live instances
# (trees of stores AND of open snapshots) are summed at snapshot time
_LSM_STATS_METRICS = {
    "inserts": "lsm.inserts",
    "buffer_flushes": "lsm.buffer_flushes",
    "pushdown_merges": "lsm.pushdown_merges",
    "edges_rewritten": "lsm.edges_rewritten",
    "splits": "lsm.splits",
    "deletes": "lsm.deletes",
    "purged_tombstones": "lsm.purged_tombstones",
}


@dataclasses.dataclass
class LSMStats:
    inserts: int = 0
    buffer_flushes: int = 0
    pushdown_merges: int = 0
    edges_rewritten: int = 0  # total edges written during merges
    splits: int = 0
    deletes: int = 0
    purged_tombstones: int = 0

    def merge_from(self, other: "LSMStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class MergeTxn:
    """One buffer-flush merge prepared OFF the writer's lock.

    The heavy work of a flush — sorting the drained run, the linear merge
    interleaves, partition rebuilds, and (via the partition sink) writing
    the new partition files — runs against a private overlay of the levels:
    `get` reads through to the live tree, `install` records the replacement
    locally. Nothing the tree publishes changes until `LSMTree.commit_txn`
    applies the whole overlay and publishes ONE new manifest, so concurrent
    lock-free readers see the pre-merge state or the post-merge state,
    never a half-distributed push-down. Disjointness is the caller's
    contract: at most one in-flight txn per top-level interval (the
    maintenance pipeline's per-interval locks), and a txn only ever touches
    partitions inside its top partition's destination interval."""

    def __init__(self, tree: "LSMTree", j: int, staging: BufferStaging):
        self.tree = tree
        self.j = j
        self.staging = staging
        self.updates: Dict[Tuple[int, int], EdgePartition] = {}
        self.stats = LSMStats()

    def get(self, level: int, j: int) -> EdgePartition:
        part = self.updates.get((level, j))
        return part if part is not None else self.tree.levels[level][j]

    def retire_live(self, level: int, j: int,
                    replacement: EdgePartition) -> None:
        """Drop the live (pre-merge) partition's mappings and decoded
        caches NOW, mid-cascade, like the pre-txn install path did — the
        merge just streamed its pages, and waiting for commit would keep
        every replaced partition of a push-down cascade resident at once.
        Safe under pinned manifests: eviction only unmaps; an epoch reader
        lazily re-mmaps (the file survives GC via pinned_digests)."""
        live = self.tree.levels[level][j]
        if live is not replacement and (level, j) not in self.updates:
            evict = getattr(live, "evict", None)
            if evict is not None:
                evict()

    def install(self, level: int, j: int, part: EdgePartition) -> None:
        """Route through the disk tier's sink (persistence happens HERE, on
        the worker, off every lock) and record the replacement."""
        if self.tree.partition_sink is not None:
            part = self.tree.partition_sink(level, j, part)
        self.retire_live(level, j, part)
        self.updates[(level, j)] = part


class LSMTree:
    """LSM-tree over PAL edge partitions.

    `levels[0]` is the top (coarsest, buffered); `levels[-1]` is the bottom
    with `n_partitions` leaf partitions — matching the paper's Figure 5
    orientation (buffers feed the top, overflow pushes toward the leaves).
    """

    def __init__(
        self,
        intervals: IntervalMap,
        n_levels: int = 3,
        branching: int = 4,
        buffer_cap: int = 100_000,
        max_partition_edges: int = 2_000_000,
        column_dtypes: Optional[Dict[str, np.dtype]] = None,
        durable: bool = False,
        wal_path: Optional[str] = None,
        wal_sync: str = "commit",
        wal: Optional[object] = None,
        auto_flush: bool = True,
        partition_sink: Optional[
            Callable[[int, int, EdgePartition], EdgePartition]] = None,
    ):
        p = intervals.n_partitions
        assert p % (branching ** (n_levels - 1)) == 0, (
            f"n_partitions={p} must be divisible by branching^(levels-1)="
            f"{branching ** (n_levels - 1)}"
        )
        self.intervals = intervals
        self.branching = branching
        self.buffer_cap = buffer_cap
        self.max_partition_edges = max_partition_edges
        self.column_dtypes = dict(column_dtypes or {})
        self.stats = LSMStats()
        # fold the per-tree counter bag into telemetry snapshots
        # (read-side collector — the attributes above stay the live state
        # and the `+=` write path is untouched)
        telemetry.register_stats(self.stats, _LSM_STATS_METRICS)

        # level i has p / f^(L-1-i) partitions; level L-1 has p
        self.levels: List[List[EdgePartition]] = []
        for i in range(n_levels):
            n_parts = p // (branching ** (n_levels - 1 - i))
            span = intervals.max_vertices // n_parts
            level = [
                build_partition(
                    (j * span, (j + 1) * span),
                    np.empty(0, np.int64),
                    np.empty(0, np.int64),
                    columns={k: np.empty(0, dt) for k, dt in self.column_dtypes.items()},
                )
                for j in range(n_parts)
            ]
            self.levels.append(level)
        self.buffers: List[EdgeBuffer] = [
            EdgeBuffer(self.column_dtypes) for _ in self.levels[0]
        ]
        # O(1) buffered-edge counter (maintained at every buffer mutation);
        # replaces the per-insert sum over all buffers
        self._buffered = 0
        # drained-but-not-yet-committed staging views, per top buffer: the
        # maintenance pipeline merges them off the writer's lock while
        # published manifests keep exposing them as read slabs
        self._pending: List[List[BufferStaging]] = [[] for _ in self.buffers]
        self._inflight_edges = 0
        # epoch-published manifests: the lock-free live read path
        self.epochs = EpochGuard()
        self._mversion = 0

        # durability (paper §7.3): group-commit WAL — records of one insert
        # call coalesce into ONE buffered write, then the sync policy runs:
        #   "always": flush + fsync per insert call (true durability)
        #   "commit": flush to the OS per insert call (survives process
        #             crash, not power loss) — the default
        #   "close":  buffered until flush()/close()
        self.durable = durable
        assert wal_sync in ("always", "commit", "close"), wal_sync
        self.wal_sync = wal_sync
        # typed WAL object (core/walog.SegmentedWAL): when set, it REPLACES
        # the legacy raw-record file below and additionally records columns,
        # tombstones, and in-place column writes
        self.wal = wal
        # with auto_flush off, inserts only append (WAL + buffers) on the
        # caller's thread; draining merges is the maintenance thread's job
        # (core/service.py) — the insert path never runs a merge
        self.auto_flush = auto_flush
        self._wal = None
        self.wal_path: Optional[str] = None
        if durable and wal is None:
            # every tree gets its OWN log: the old global /tmp default let
            # two trees in one process interleave records, and replay_wal
            # then resurrected foreign edges (regression-tested)
            self.wal_path = wal_path or _default_wal_path()
            self._wal = open(self.wal_path, "ab", buffering=1 << 20)
        # disk tier hook (core/disk.py): every partition a merge installs
        # is offered to the sink, which may persist it and hand back an
        # mmap-backed replacement
        self.partition_sink = partition_sink
        self._engine = None
        # changes of key presence, and the read structures that follow the
        # store by them (`ManifestEngine.live_state()`: core/multihop.py's
        # live dense plans)
        self.oplog = MutationLog()
        self.live_state: Dict = {}
        self.publish()  # manifest v0: readers can pin from birth

    def _wal_append(self, payload: bytes) -> None:
        self._wal.write(payload)
        if self.wal_sync == "commit":
            self._wal.flush()
        elif self.wal_sync == "always":
            self._wal.flush()
            os.fsync(self._wal.fileno())

    def storage_engine(self):
        """Vectorized set-at-a-time read interface across ALL levels and the
        live buffers (engine.py, DESIGN.md §5)."""
        if self._engine is None:
            from .engine import LSMEngine
            self._engine = LSMEngine(self)
        return self._engine

    # -- epoch publication (DESIGN.md §9) ------------------------------
    def publish(self) -> LevelManifest:
        """Full manifest publication: capture every partition (sealing its
        tombstone array — the next tombstone write copies), every buffer's
        staging, and the in-flight pending drains, and swap the manifest in
        ONE reference assignment. Caller must be the (serialized) writer:
        the mutating thread itself, or a maintenance job holding the
        service lock for its commit."""
        levels = []
        for lv in self.levels:
            row = []
            for part in lv:
                mp = ManifestPartition(part)
                if mp.dead is not None:
                    part._dead_sealed = True
                row.append(mp)
            levels.append(tuple(row))
        wal_tail = 0
        if self.wal is not None:
            try:
                wal_tail = self.wal.tail_offset()
            except Exception:
                wal_tail = 0
        self._mversion += 1
        m = LevelManifest(
            version=self._mversion,
            levels=tuple(levels),
            stagings=tuple(b.staging() for b in self.buffers),
            pending=tuple(tuple(p) for p in self._pending),
            wal_tail=wal_tail,
            log_seq=self.oplog.seq,
        )
        self.epochs.publish(m)
        return m

    def publish_partitions(self, coords, buffer_idxs) -> None:
        """Targeted publication for mutations that touch a known partition
        path (deletes): recapture and reseal only the partitions at
        `coords` = [(level, idx), ...] plus the listed buffers' stagings —
        O(levels + one level row) instead of a full O(partitions)
        recapture per delete."""
        cur = self.epochs.current
        levels = list(cur.levels)
        for li, pi in coords:
            part = self.levels[li][pi]
            mp = ManifestPartition(part)
            if mp.dead is not None:
                part._dead_sealed = True
            row = list(levels[li])
            row[pi] = mp
            levels[li] = tuple(row)
        stagings = list(cur.stagings)
        for j in buffer_idxs:
            stagings[j] = self.buffers[j].staging()
        self._mversion += 1
        m = LevelManifest(self._mversion, tuple(levels), tuple(stagings),
                          cur.pending, self._fresh_wal_tail(cur.wal_tail),
                          self.oplog.seq)
        self.epochs.publish(m)

    def _fresh_wal_tail(self, fallback: int) -> int:
        """The post-append WAL tail for a targeted publish. Stamping it on
        every manifest makes each published epoch *addressable*:
        `pin_snapshot(pinned_offset=view.wal_tail)` reconstructs exactly
        that view's logical state in another process. The mutation paths
        append to the WAL before publishing, so the tail read here covers
        everything the manifest contains."""
        if self.wal is None:
            return fallback
        try:
            return self.wal.tail_offset()
        except Exception:
            return fallback

    def publish_buffers(self, idxs) -> None:
        """Cheap publication for append-only buffer changes: splice the
        updated buffers' fresh stagings into the current manifest (no
        partition recapture — appends never disturb sealed state). This
        runs on EVERY insert call, single-edge included: staging capture,
        the manifest splice, and the epoch swap are all O(1) reference
        plumbing (measured ~a microsecond)."""
        cur = self.epochs.current
        stagings = list(cur.stagings)
        for j in idxs:
            stagings[j] = self.buffers[j].staging()
        self._mversion += 1
        self.epochs.publish(cur.with_stagings(
            self._mversion, tuple(stagings),
            wal_tail=self._fresh_wal_tail(cur.wal_tail),
            log_seq=self.oplog.seq))

    def read_view(self) -> ManifestView:
        """Pin the current manifest under an epoch guard and return a
        read-only store view — THE live read path: no lock shared with the
        writer or with maintenance is ever taken. Release (or use as a
        context manager) when done; an unreleased view defers reclamation
        of the partitions/files it references."""
        m, slot = self.epochs.pin()
        return ManifestView(self, m, slot)

    def pinned_digests(self) -> set:
        """Digests of disk partitions referenced by the current manifest or
        any retired manifest a reader may still pin — files checkpoint GC
        must NOT delete (deferred reclamation)."""
        out = set()
        for m in self.epochs.live_manifests():
            for mp in m.partitions():
                path = getattr(mp.part, "path", None)
                if path is not None:
                    out.add(os.path.basename(path)[5:-4])
        return out

    def pending_stagings(self) -> List[Tuple[BufferStaging, Tuple[int, int]]]:
        """(staging, top interval) of every drained-but-uncommitted batch —
        extra read slabs the LIVE engine must include mid-flight."""
        out = []
        for j, lst in enumerate(self._pending):
            for st in lst:
                out.append((st, self.levels[0][j].interval))
        return out

    def inflight_edges(self) -> int:
        return self._inflight_edges

    # -- geometry ---------------------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def partitions_per_level(self) -> List[int]:
        return [len(lv) for lv in self.levels]

    def _top_index_of(self, intern_dst: int) -> int:
        span = self.intervals.max_vertices // len(self.levels[0])
        return int(intern_dst) // span

    # -- inserts (paper §5) -------------------------------------------------------
    def insert_edge(self, src: int, dst: int, etype: int = 0, **cols) -> None:
        isrc = self.intervals.to_internal_scalar(src)
        idst = self.intervals.to_internal_scalar(dst)
        if self.wal is not None:
            self.wal.append_inserts([isrc], [idst], [etype], cols)
        elif self._wal is not None:
            self._wal_append(struct.pack("<qqb", isrc, idst, etype))
        j = self._top_index_of(idst)
        self.buffers[j].append(isrc, idst, etype, cols)
        self.oplog.append(isrc * self.intervals.max_vertices + idst, 1, 1)
        self.stats.inserts += 1
        self._buffered += 1
        self.publish_buffers((j,))
        if self._buffered > self.buffer_cap and self.auto_flush:
            self.flush_fullest_buffer()

    def insert_edges(self, src, dst, etype=None, columns: Optional[Dict] = None) -> None:
        """Bulk insert — still through the online path (buffers + merges)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        etype = np.zeros(src.shape[0], np.int8) if etype is None else np.asarray(etype)
        columns = columns or {}
        isrc = self.intervals.to_internal(src)
        idst = self.intervals.to_internal(dst)
        if self.wal is not None:
            # ONE group-commit record, attribute columns included
            self.wal.append_inserts(isrc, idst, etype, columns)
        elif self._wal is not None:
            rec = np.rec.fromarrays(
                [isrc, idst, etype.astype(np.int8)], names="s,d,t"
            )
            self._wal_append(rec.tobytes())  # ONE group-commit write
        if len(self.buffers) == 1:  # single top partition: no routing pass
            self.buffers[0].extend(isrc, idst, etype, columns)
            touched = (0,)
        else:
            span = self.intervals.max_vertices // len(self.levels[0])
            top = idst // span
            touched = tuple(int(i) for i in np.unique(top))
            for i in touched:
                m = top == i
                self.buffers[i].extend(
                    isrc[m], idst[m], etype[m],
                    {k: np.asarray(v)[m] for k, v in columns.items()},
                )
        self.oplog.append(isrc * np.int64(self.intervals.max_vertices)
                          + idst, 1)
        self.stats.inserts += int(src.shape[0])
        self._buffered += int(src.shape[0])
        self.publish_buffers(touched)
        while self._buffered > self.buffer_cap and self.auto_flush:
            self.flush_fullest_buffer()

    def total_buffered(self) -> int:
        return self._buffered

    # -- merges (txn-based: prepared off-lock, committed atomically) --------------
    def _empty_partition(self, interval) -> EdgePartition:
        return build_partition(
            interval, np.empty(0, np.int64), np.empty(0, np.int64),
            columns={k: np.empty(0, dt) for k, dt in self.column_dtypes.items()},
        )

    def _linear_merge_ok(self, n_total: int) -> bool:
        kb = self.intervals.max_vertices
        return kb <= _MAX_PACKED_BOUND and kb * (n_total + 1) < 2 ** 63

    def drain_buffer(self, j: int) -> Optional[BufferStaging]:
        """Detach buffer j's contents as an immutable staging and stage it
        on the pending list (published manifests keep serving it as a read
        slab until the merge commits). Caller must be the serialized
        writer side (service lock held, or single-threaded use)."""
        buf = self.buffers[j]
        if len(buf) == 0:
            return None
        st = buf.drain()
        n = int(st.src.shape[0])
        self._buffered -= n
        self._inflight_edges += n
        self._pending[j].append(st)
        self.stats.buffer_flushes += 1
        self.publish()  # readers now see (old partitions + pending slab)
        return st

    def build_flush_txn(self, j: int, st: BufferStaging) -> MergeTxn:
        """The expensive half of a flush, safe to run WITHOUT the writer
        lock as long as the caller holds the top-interval-j merge slot
        (core/service.py's per-interval locks): merge the drained staging
        through partition (0, j)'s subtree into a private overlay."""
        txn = MergeTxn(self, j, st)
        bsrc, bdst, btype, bcols = st.src, st.dst, st.etype, st.columns
        if self._linear_merge_ok(txn.get(0, j).n_edges + int(bsrc.shape[0])):
            run = run_from_arrays(bsrc, bdst, btype, bcols,
                                  key_bound=self.intervals.max_vertices)
            self._absorb(txn, 0, j, run)
        else:
            txn.install(0, j, self._merge_into(
                txn, txn.get(0, j), bsrc, bdst, btype, bcols))
            self._maybe_pushdown(txn, 0, j)
        return txn

    def commit_txn(self, txn: MergeTxn) -> None:
        """Apply a prepared merge atomically: swap every touched partition
        slot, retire the pending staging, fold the txn's stats in, and
        publish ONE post-merge manifest. Must run on the serialized writer
        side (service lock). Replaced partitions' mappings are dropped
        eagerly — epoch-pinned readers lazily re-mmap (their files survive
        GC via `pinned_digests`), so this only trims RSS."""
        for (li, pi), part in txn.updates.items():
            old = self.levels[li][pi]
            self.levels[li][pi] = part
            if old is not part:
                evict = getattr(old, "evict", None)
                if evict is not None:
                    evict()
        self._pending[txn.j].remove(txn.staging)
        self._inflight_edges -= int(txn.staging.src.shape[0])
        self.stats.merge_from(txn.stats)
        self.publish()

    def flush_fullest_buffer(self) -> None:
        """Merge the fullest buffer with its top-level partition (paper
        §5.2) — the synchronous path: drain, build, commit back-to-back.
        The pipelined path (core/service.py) runs the same three calls with
        only drain/commit under the service lock."""
        j = int(np.argmax([len(b) for b in self.buffers]))
        st = self.drain_buffer(j)
        if st is None:
            return
        self.commit_txn(self.build_flush_txn(j, st))

    def _absorb(self, txn: MergeTxn, level: int, j: int,
                run: "SortedRun") -> None:
        """Merge a sorted run into partition (level, j). When the merged
        partition would immediately overflow into its children anyway,
        short-circuit: combine partition + run into one sorted run and
        distribute it straight down, skipping a full partition (re)build —
        this halves rewrites at every non-leaf level."""
        part = txn.get(level, j)
        n_dead = 0 if part.dead is None else int(part.dead.sum())
        n_total = part.n_edges - n_dead + run.n_edges
        if (n_total > self.max_partition_edges and level < self.n_levels - 1
                and self._linear_merge_ok(n_total)):
            a = run_from_partition(
                part, live=None if part.dead is None else ~part.dead,
                columns=self.column_dtypes.keys())
            combined = merge_runs(a, run, self.intervals.max_vertices,
                                  self.column_dtypes)
            txn.stats.purged_tombstones += n_dead
            txn.stats.edges_rewritten += combined.n_edges
            txn.stats.pushdown_merges += 1
            empty = self._empty_partition(part.interval)
            txn.retire_live(level, j, empty)
            txn.updates[(level, j)] = empty
            self._distribute_to_children(txn, level, combined)
            return
        txn.install(level, j, self._merge_into(
            txn, part, run.src, run.dst, run.etype, run.columns,
            presorted=True, run=run))
        self._maybe_pushdown(txn, level, j)

    def _merge_into(self, txn: MergeTxn, part: EdgePartition,
                    src, dst, etype, cols, presorted: bool = False,
                    run: Optional["SortedRun"] = None) -> EdgePartition:
        """Linear-time sorted merge producing a NEW immutable partition
        (DESIGN.md §6); tombstoned edges of the old partition are purged
        here (paper §5.3). Only the incoming run is sorted (skipped when it
        is a presorted push-down subset, whose dst order arrives prebuilt in
        `run`); the partition side and every index rebuild are O(n) off the
        merge interleave permutation."""
        n_dead = 0 if part.dead is None else int(part.dead.sum())
        n_live = part.n_edges - n_dead
        txn.stats.purged_tombstones += n_dead
        n_total = n_live + int(src.shape[0])
        txn.stats.edges_rewritten += n_total
        key_bound = self.intervals.max_vertices
        if key_bound <= _MAX_PACKED_BOUND and key_bound * (n_total + 1) < 2 ** 63:
            b = run if run is not None else run_from_arrays(
                src, dst, etype, cols, presorted=presorted,
                key_bound=key_bound)
            if n_live == 0:  # empty target: index the run directly
                return partition_from_run(part.interval, b, self.column_dtypes)
            a = run_from_partition(
                part, live=None if part.dead is None else ~part.dead,
                columns=self.column_dtypes.keys())
            return merge_runs_into_partition(
                part.interval, a, b, key_bound, self.column_dtypes)
        # (src, dst) does not pack into an int64 merge key at this vertex
        # capacity — fall back to the full re-sort build
        live = np.ones(part.n_edges, bool) if part.dead is None else ~part.dead
        msrc = np.concatenate([part.src[live], src])
        mdst = np.concatenate([part.dst[live], dst])
        mtyp = np.concatenate([part.etype[live], etype])
        mcols = {}
        for k, dt in self.column_dtypes.items():
            old = part.columns.get(k, np.zeros(part.n_edges, dt))[live]
            new = cols.get(k, np.zeros(src.shape[0], dt))
            mcols[k] = np.concatenate([old, new])
        return build_partition(part.interval, msrc, mdst, mtyp, mcols)

    def _maybe_pushdown(self, txn: MergeTxn, level: int, j: int) -> None:
        """If partition (level, j) exceeds the size cap, empty it into its f
        children at the next level (paper §5.2). Bottom level splits instead."""
        part = txn.get(level, j)
        if part.n_edges <= self.max_partition_edges:
            return
        if level == self.n_levels - 1:
            # paper: "If leaves grow too large, we can add a new level";
            # equivalently we grow the leaf cap — record the event.
            txn.stats.splits += 1
            return
        n_dead = 0 if part.dead is None else int(part.dead.sum())
        parent = run_from_partition(
            part, live=None if part.dead is None else ~part.dead,
            columns=self.column_dtypes.keys())
        txn.stats.purged_tombstones += n_dead
        # emptied parent — new empty immutable partition
        empty = self._empty_partition(part.interval)
        txn.retire_live(level, j, empty)
        txn.updates[(level, j)] = empty
        txn.stats.pushdown_merges += 1
        self._distribute_to_children(txn, level, parent)

    def _distribute_to_children(self, txn: MergeTxn, level: int,
                                parent: "SortedRun") -> None:
        """Split a sorted run by child interval and merge each piece into
        its child partition (paper §5.2). Children cover disjoint dst
        ranges, so each child occupies one contiguous slice of the parent's
        dst order: its parent positions are that slice, its edge order is
        those positions sorted, and its local dst order is the slice ranked
        against them — O(m log m) per child, no full-parent passes."""
        if parent.n_edges == 0:
            return
        child_span = self.intervals.max_vertices // len(self.levels[level + 1])
        order = parent.dst_order
        pdst_sorted = parent.dst[order]
        c_lo = int(pdst_sorted[0]) // child_span
        c_hi = int(pdst_sorted[-1]) // child_span
        inv = np.empty(parent.n_edges, np.int64)  # parent pos -> child pos
        children = []
        for c in range(c_lo, c_hi + 1):
            lo = np.searchsorted(pdst_sorted, c * child_span, side="left")
            hi = np.searchsorted(pdst_sorted, (c + 1) * child_span, side="left")
            if hi == lo:
                continue
            slice_pos = order[lo:hi]          # parent positions, dst-ordered
            pos_c = np.sort(slice_pos)        # = child edges in (src, dst) order
            inv[pos_c] = np.arange(pos_c.shape[0], dtype=np.int64)
            child = SortedRun(
                src=parent.src[pos_c], dst=parent.dst[pos_c],
                etype=parent.etype[pos_c],
                columns={k: v[pos_c] for k, v in parent.columns.items()},
                dst_order=inv[slice_pos],
            )
            children.append((c, child))
        for c, child in children:
            self._absorb(txn, level + 1, c, child)

    def flush_all(self) -> None:
        # commit any orphaned in-flight drains first (a pipeline worker
        # that died between drain and commit leaves its staging pending;
        # checkpointing without merging it would advance the covered WAL
        # offset past edges no partition holds)
        for j, lst in enumerate(self._pending):
            for st in list(lst):
                self.commit_txn(self.build_flush_txn(j, st))
        while self.total_buffered() > 0:
            self.flush_fullest_buffer()

    # -- queries across the tree (paper §5.2.1) -------------------------------------
    BUFFER_LEVEL = -1  # hit level index addressing a live edge buffer

    @staticmethod
    def _add_hit_rows(rows: list, li: int, pi: int, pos: np.ndarray) -> None:
        """Append one slab's hits as (H, 3) rows of (level, idx, pos) —
        the single definition of the hit-row layout `columns_for_hits`
        consumes."""
        if pos.size:
            row = np.empty((pos.shape[0], 3), np.int64)
            row[:, 0] = li
            row[:, 1] = pi
            row[:, 2] = pos
            rows.append(row)

    def out_edge_hits(self, v: int) -> np.ndarray:
        """(H, 3) int64 array of (level, partition_idx, edge_pos) hits
        across all levels AND the live buffers — buffer hits carry level
        `BUFFER_LEVEL` (-1) and address buffer j's append order.
        Built with one
        stack per slab, no per-edge Python objects — feed it straight to
        `columns_for_hits`."""
        vi = int(self.intervals.to_internal(v))
        rows: list = []
        for li, level in enumerate(self.levels):
            for pi, part in enumerate(level):
                self._add_hit_rows(rows, li, pi, part.out_edges(vi))
        for bj, buf in enumerate(self.buffers):
            if len(buf):
                self._add_hit_rows(rows, self.BUFFER_LEVEL, bj,
                                   np.asarray(buf.out_edges_of(vi)))
        if not rows:
            return np.empty((0, 3), np.int64)
        return np.concatenate(rows)

    def in_edge_hits(self, v: int) -> np.ndarray:
        """Like `out_edge_hits` for in-edges: only ONE partition per level
        (and one buffer) can own v's in-edges (paper: cost bounded by
        L_G + edges)."""
        vi = int(self.intervals.to_internal(v))
        rows: list = []
        for li, level in enumerate(self.levels):
            span = self.intervals.max_vertices // len(level)
            pi = vi // span
            self._add_hit_rows(rows, li, pi, level[pi].in_edges(vi))
        bj = self._top_index_of(vi)
        if len(self.buffers[bj]):
            self._add_hit_rows(rows, self.BUFFER_LEVEL, bj,
                               np.asarray(self.buffers[bj].in_edges_of(vi)))
        if not rows:
            return np.empty((0, 3), np.int64)
        return np.concatenate(rows)

    def out_edges(self, v: int) -> List[Tuple[int, int, int]]:
        """Tuple-list form of `out_edge_hits` (compatibility surface)."""
        return [(int(a), int(b), int(c)) for a, b, c in self.out_edge_hits(v)]

    def in_edges(self, v: int) -> List[Tuple[int, int, int]]:
        """Tuple-list form of `in_edge_hits` (compatibility surface)."""
        return [(int(a), int(b), int(c)) for a, b, c in self.in_edge_hits(v)]

    def columns_for_hits(self, hits, name: str) -> np.ndarray:
        """Positional column values for a hit array/list from
        `out_edge_hits` / `out_edges` (+ `in_` variants) — ONE vectorized
        gather per distinct slab instead of a Python loop per hit, and
        buffer hits (level -1) resolve against the staged columns, which
        the per-hit pattern could not address at all
        (bench_linkbench `edge_getrange`)."""
        dtype = self.column_dtypes.get(name, np.dtype(np.float64))
        h = np.asarray(hits, np.int64).reshape(-1, 3)
        if h.shape[0] == 0:
            return np.empty(0, dtype)
        out = np.empty(h.shape[0], dtype)
        width = max(len(self.buffers), len(self.levels[-1])) + 1
        slab_key = h[:, 0] * width + h[:, 1]
        for key in np.unique(slab_key):
            m = slab_key == key
            hm = h[m]
            li, pi = int(hm[0, 0]), int(hm[0, 1])
            pos = hm[:, 2]
            if li == self.BUFFER_LEVEL:
                col = self.buffers[pi].staging().columns.get(name)
            else:
                col = self.levels[li][pi].columns.get(name)
            out[m] = np.zeros(1, dtype) if col is None \
                else np.asarray(col)[pos]
        return out

    def out_neighbors(self, v: int) -> np.ndarray:
        vi = int(self.intervals.to_internal(v))
        chunks = []
        for level in self.levels:
            for part in level:
                pos = part.out_edges(vi)
                if pos.size:
                    chunks.append(part.dst[pos])
        for buf in self.buffers:
            if len(buf):
                idx = buf.out_edges_of(vi)
                if idx.size:
                    chunks.append(buf.staging().dst[idx])
        for lst in self._pending:  # drained batches whose merge is in flight
            for st in lst:
                hit = st.dst[st.src == vi]
                if hit.size:
                    chunks.append(hit)
        if not chunks:
            return np.empty(0, np.int64)
        return np.asarray(self.intervals.to_original(np.concatenate(chunks)))

    def in_neighbors(self, v: int) -> np.ndarray:
        vi = int(self.intervals.to_internal(v))
        chunks = []
        for level in self.levels:
            span = self.intervals.max_vertices // len(level)
            part = level[vi // span]
            pos = part.in_edges(vi)
            if pos.size:
                chunks.append(part.src[pos])
        # buffers partition by destination interval: only the owning buffer
        # (and its in-flight drains) can hold v's in-edges — probe just those
        bj = self._top_index_of(vi)
        buf = self.buffers[bj]
        if len(buf):
            idx = buf.in_edges_of(vi)
            if idx.size:
                chunks.append(buf.staging().src[idx])
        for st in self._pending[bj]:
            hit = st.src[st.dst == vi]
            if hit.size:
                chunks.append(hit)
        if not chunks:
            return np.empty(0, np.int64)
        return np.asarray(self.intervals.to_original(np.concatenate(chunks)))

    # -- updates / deletes (paper §5.3) ----------------------------------------------
    def update_edge_column(self, src: int, dst: int, name: str, value) -> bool:
        """Direct in-place column write on the newest matching edge."""
        isrc = int(self.intervals.to_internal(src))
        idst = int(self.intervals.to_internal(dst))
        # buffers are newest
        bj = self._top_index_of(idst)
        buf = self.buffers[bj]
        if len(buf):
            st = buf.staging()
            hit = np.nonzero((st.src == isrc) & (st.dst == idst))[0]
            if hit.size:
                buf.set_column(name, int(hit[-1]), value)
                if self.wal is not None:
                    self.wal.append_column(name, isrc, idst, value)
                return True
        for level in self.levels:
            span = self.intervals.max_vertices // len(level)
            part = level[idst // span]
            a, b = part.out_edge_range(isrc)
            pos = np.arange(a, b)
            pos = pos[part.dst[pos] == idst] if pos.size else pos
            pos = part._live(pos)
            if pos.size:
                part.set_column(name, pos[-1], value)
                if self.wal is not None:
                    self.wal.append_column(name, isrc, idst, value)
                return True
        return False

    def delete_edge(self, src: int, dst: int) -> bool:
        """Tombstone the edge everywhere it appears (purged at merges)."""
        isrc = int(self.intervals.to_internal(src))
        idst = int(self.intervals.to_internal(dst))
        found = False
        bj = self._top_index_of(idst)
        buf = self.buffers[bj]
        if len(buf):
            st = buf.staging()
            keep = ~((st.src == isrc) & (st.dst == idst))
            removed = int(keep.shape[0] - keep.sum())
            if removed:
                found = True
                buf.filter_mask(keep)
                self._buffered -= removed
        for level in self.levels:
            span = self.intervals.max_vertices // len(level)
            part = level[idst // span]
            a, b = part.out_edge_range(isrc)
            pos = np.arange(a, b)
            if pos.size:
                pos = pos[part.dst[pos] == idst]
                pos = part._live(pos)
                if pos.size:
                    part.tombstone(pos)
                    found = True
        if found:
            self.stats.deletes += 1
            if self.wal is not None:  # tombstones are durable pre-checkpoint
                self.wal.append_delete(isrc, idst)
            self.oplog.append(isrc * self.intervals.max_vertices + idst, -1,
                              1)
            # targeted publish of exactly the touched dst path: tombstone
            # COW + buffer compaction left the old manifest bitwise-intact;
            # new readers must see the delete
            coords = [(li, idst // (self.intervals.max_vertices
                                    // len(level)))
                      for li, level in enumerate(self.levels)]
            self.publish_partitions(coords, (bj,))
        return found

    # -- exports ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        n = sum(p.n_live_edges for lv in self.levels for p in lv)
        return n + self.total_buffered() + self._inflight_edges

    def all_partitions(self) -> List[EdgePartition]:
        return [p for lv in self.levels for p in lv]

    def snapshot(self, with_window_plan: bool = True, device=None):
        """Compile ALL levels plus the live in-memory buffers into an
        immutable `DeviceGraph` (torch tensors on `device`; None means the
        GPU and raises without one) for the PSW compute path — analytics
        run directly against the online store without flushing or
        otherwise mutating it. Edges are re-bucketed by destination
        interval and canonically (dst, src)-sorted, so the snapshot of an
        LSM store is bit-identical to the snapshot of a bulk-built GraphPAL
        holding the same live edges."""
        from .psw import build_device_graph
        return build_device_graph(self, with_window_plan=with_window_plan,
                                  device=device)

    def to_coo(self):
        ss, dd = [], []
        for part in self.all_partitions():
            live = np.ones(part.n_edges, bool) if part.dead is None else ~part.dead
            ss.append(part.src[live])
            dd.append(part.dst[live])
        for buf in self.buffers:
            if len(buf):
                st = buf.staging()
                ss.append(st.src)
                dd.append(st.dst)
        for lst in self._pending:
            for st in lst:
                ss.append(st.src)
                dd.append(st.dst)
        s = np.concatenate(ss) if ss else np.empty(0, np.int64)
        d = np.concatenate(dd) if dd else np.empty(0, np.int64)
        return (np.asarray(self.intervals.to_original(s)),
                np.asarray(self.intervals.to_original(d)))

    def wal_flush(self, fsync: bool = True) -> None:
        """Explicit durability point: push buffered WAL records to the OS
        and (optionally) to stable storage, regardless of sync policy."""
        if self.wal is not None:
            self.wal.flush(fsync=fsync)
        if self._wal is not None:
            self._wal.flush()
            if fsync:
                os.fsync(self._wal.fileno())

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()
            self.wal = None
        if self._wal is not None:
            self.wal_flush(fsync=True)
            self._wal.close()
            self._wal = None

    # -- WAL recovery (paper §7.3 durability) ----------------------------------------
    @staticmethod
    def replay_wal(path: str,
                   offset: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decode WAL records from byte `offset` on — a GraphDB manifest
        records the offset its persisted partitions cover, so recovery
        replays only the tail."""
        dt = np.dtype([("s", "<i8"), ("d", "<i8"), ("t", "i1")])
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read()
        n = len(buf) // dt.itemsize  # a torn trailing record is dropped
        raw = np.frombuffer(buf[: n * dt.itemsize], dtype=dt)
        return raw["s"], raw["d"], raw["t"]
