"""StorageEngine — the unified, vectorized read path over PAL / LSM storage.

DESIGN.md §5. The paper's promise is ONE structure serving both online
queries and analytical computation; this module is the interface that makes
the promise hold on both backends without the query layer knowing which one
it is talking to.

Primitives are *set-at-a-time*: a whole frontier of vertices goes in, a
CSR-grouped result comes out. Per storage slab (an immutable edge partition
on any LSM level, or a live in-memory edge buffer) the engine issues ONE
vectorized `searchsorted` of the frontier against the slab's pointer-array
(partitions) or staged sort order (buffers), expands the hit ranges without
a Python loop, and regroups the union by query vertex. This is the paper's
frontier-batched FoF strategy (§8.1) generalized to every traversal
operator.

Slab layout recap (why the binary searches below are correct):
  * a partition's edge-array is (src, dst)-sorted with a sparse CSR over
    sources (`src_vertices`/`src_ptr`) and a CSC permutation over
    destinations (`dst_vertices`/`dst_ptr`/`dst_perm`);
  * partitions on one level cover disjoint destination intervals, and each
    buffer feeds exactly one top-level partition — so in-edge queries may
    probe every slab: non-owners miss in O(log) with zero hits;
  * tombstoned edges (`dead`) are filtered after range expansion.

Host copy of the reference `repro/core/engine.py` (numpy).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import telemetry

# per-interval read heat: every edge position a disk-tier slab
# serves is charged to its interval — the input the ROADMAP's heat-aware
# merge scheduling reads
_M_READ_HEAT = telemetry.counter("disk.interval.read_edges")

__all__ = [
    "EdgeBatch",
    "EdgeChunk",
    "StorageEngine",
    "PALEngine",
    "LSMEngine",
    "ManifestEngine",
    "SnapshotEngine",
    "as_engine",
]


# ---------------------------------------------------------------------------
# Result containers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EdgeBatch:
    """CSR-grouped result of a batched edge query: the edges adjacent to
    vs[i] occupy flat positions offsets[i]:offsets[i+1]. IDs are original."""

    vs: np.ndarray                  # (Q,) the queried vertices
    offsets: np.ndarray             # (Q+1,) int64
    src: np.ndarray                 # (T,) int64 original IDs
    dst: np.ndarray                 # (T,) int64 original IDs
    etype: np.ndarray               # (T,) int8
    columns: Dict[str, np.ndarray]  # requested attribute columns, positional

    def slice_of(self, i: int) -> slice:
        return slice(int(self.offsets[i]), int(self.offsets[i + 1]))


@dataclasses.dataclass
class EdgeChunk:
    """One physical slab of live edges in INTERNAL IDs — what bottom-up
    sweeps and degree passes stream instead of branching on storage class."""

    src: np.ndarray
    dst: np.ndarray


# ---------------------------------------------------------------------------
# Vectorized range machinery
# ---------------------------------------------------------------------------
def _expand_ranges(starts: np.ndarray, ends: np.ndarray,
                   owners: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate [starts[k], ends[k]) ranges into one position array plus
    the owner id repeated per element — no Python loop. The classic
    cumsum-of-ones trick: within a run steps are +1; at each run boundary the
    step jumps to the next range's start."""
    counts = (ends - starts).astype(np.int64)
    nz = counts > 0
    if not nz.all():
        starts, counts, owners = starts[nz], counts[nz], owners[nz]
    if counts.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    cum = np.cumsum(counts)
    steps = np.ones(int(cum[-1]), np.int64)
    steps[0] = starts[0]
    steps[cum[:-1]] = starts[1:] - starts[:-1] - counts[:-1] + 1
    return np.cumsum(steps), np.repeat(owners, counts)


def _searchsorted_ranges(keys: np.ndarray,
                         vis: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One binary search of the whole frontier against a slab's sorted key
    array. Returns (hit query indices, index into keys per hit)."""
    if keys.shape[0] == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    idx = np.searchsorted(keys, vis)
    idx = np.minimum(idx, keys.shape[0] - 1)
    hit = np.nonzero(keys[idx] == vis)[0]
    return hit, idx[hit]


# ---------------------------------------------------------------------------
# Slab adapters: one batched lookup protocol over partitions and buffers
# ---------------------------------------------------------------------------
class _PartitionSlab:
    def __init__(self, part):
        self.part = part
        self.interval = part.interval  # [lo, hi) of internal destinations
        # disk tier (core/disk.py): mmap-backed partitions carry IOStats;
        # every gather from the edge arrays below is a real page-cache read
        # of only the hit ranges, and we account the blocks it touches
        self.io = getattr(part, "io", None)
        self._heat_label = (f"{self.interval[0]}:{self.interval[1]}"
                            if self.io is not None else None)
        self.n_edges = part.n_edges
        # chunked-decode hook, resolved once (slabs are reused across a
        # manifest's whole pin lifetime): None for RAM partitions and for
        # disk partitions preferring their decoded resident index
        self.lookup = (None if getattr(part, "index_resident", False)
                       else getattr(part, "lookup_adj_ranges", None))

    def positions_batch(self, vis: np.ndarray,
                        direction: str) -> Tuple[np.ndarray, np.ndarray]:
        """(edge-array positions, query-owner index) of live adjacent edges.
        The searchsorted runs against the RAM-resident pointer index; only
        the hit ranges are then read from the (possibly mmapped) edge
        arrays."""
        part = self.part
        if self.n_edges == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        # disk partitions resolve ranges against their COMPRESSED resident
        # index (chunked decode of only the touched blocks) instead of the
        # fully-decoded pointer arrays
        lookup = self.lookup
        ranges = lookup(vis, direction) if lookup is not None else None
        if ranges is not None:
            hit, starts, ends = ranges
        elif direction == "out":
            hit, ki = _searchsorted_ranges(part.src_vertices, vis)
            starts, ends = part.src_ptr[ki], part.src_ptr[ki + 1]
        else:
            hit, ki = _searchsorted_ranges(part.dst_vertices, vis)
            starts, ends = part.dst_ptr[ki], part.dst_ptr[ki + 1]
        if direction == "out":
            pos, owner = _expand_ranges(starts, ends, hit)
        else:
            perm_pos, owner = _expand_ranges(starts, ends, hit)
            if self.io is not None:
                self.io.account_gather(perm_pos, 8)  # dst_perm read
            pos = np.asarray(part.dst_perm[perm_pos], np.int64)
        if part.dead is not None and pos.size:
            live = ~part.dead[pos]
            pos, owner = pos[live], owner[live]
        if self._heat_label is not None and pos.size:
            _M_READ_HEAT.inc(int(pos.size), label=self._heat_label)
        return pos, owner

    def src_at(self, pos):
        if self.io is not None:
            self.io.account_gather(pos, 8)
        return self.part.src[pos]

    def dst_at(self, pos):
        if self.io is not None:
            self.io.account_gather(pos, 8)
        return self.part.dst[pos]

    def etype_at(self, pos):
        if self.io is not None:
            self.io.account_gather(pos, 1)
        return self.part.etype[pos]

    def column_at(self, name, pos, dtype):
        col = self.part.columns.get(name)
        if col is None:
            return np.zeros(pos.shape[0], dtype)
        if self.io is not None:
            self.io.account_gather(pos, col.dtype.itemsize)
        return col[pos]

    def column_names(self):
        return self.part.columns.keys()

    def column_dtype(self, name):
        col = self.part.columns.get(name)
        return None if col is None else col.dtype

    def chunk(self) -> Optional[EdgeChunk]:
        part = self.part
        if part.n_edges == 0:
            return None
        if self.io is not None:  # sequential whole-slab scan: src + dst
            self.io.account_range(0, part.n_edges, 16)
        if part.dead is None or not part.dead.any():
            return EdgeChunk(part.src, part.dst)
        live = ~part.dead
        return EdgeChunk(part.src[live], part.dst[live])


class _BufferSlab:
    """Batched lookups over one frozen BufferStaging — a live buffer's
    current staging (snapped once per slab, i.e. once per batched call), a
    manifest-published staging, or an in-flight drained batch awaiting its
    merge commit. Sort-order caches live on the staging itself, shared by
    every slab (and thread) that reads it — the lazy build is idempotent."""

    def __init__(self, st, interval):
        self.interval = interval  # the fed top-level partition's interval
        self.st = st

    def positions_batch(self, vis: np.ndarray,
                        direction: str) -> Tuple[np.ndarray, np.ndarray]:
        st = self.st
        order, keys = (st.src_sorted_view() if direction == "out"
                       else st.dst_sorted_view())
        lo = np.searchsorted(keys, vis, side="left")
        hi = np.searchsorted(keys, vis, side="right")
        spos, owner = _expand_ranges(lo, hi, np.arange(vis.shape[0], dtype=np.int64))
        return order[spos], owner

    def src_at(self, pos):
        return self.st.src[pos]

    def dst_at(self, pos):
        return self.st.dst[pos]

    def etype_at(self, pos):
        return self.st.etype[pos]

    def column_at(self, name, pos, dtype):
        col = self.st.columns.get(name)
        if col is None:
            return np.zeros(pos.shape[0], dtype)
        return col[pos]

    def column_names(self):
        return self.st.columns.keys()

    def column_dtype(self, name):
        col = self.st.columns.get(name)
        return None if col is None else col.dtype

    def chunk(self) -> Optional[EdgeChunk]:
        if self.st.src.shape[0] == 0:
            return None
        return EdgeChunk(self.st.src, self.st.dst)


def _slab_positions(slab, vis: np.ndarray,
                    direction: str) -> Tuple[np.ndarray, np.ndarray]:
    """Probe one slab with the frontier. Destinations partition by interval,
    so for in-edge queries only the sub-frontier inside the slab's interval
    can hit — the rest is masked off before the binary search (a buffer or
    partition is never probed for vertices it cannot own)."""
    if direction == "in":
        lo, hi = slab.interval
        m = (vis >= lo) & (vis < hi)
        if not m.any():
            return np.empty(0, np.int64), np.empty(0, np.int64)
        sel = np.flatnonzero(m)
        pos, owner = slab.positions_batch(vis[sel], direction)
        return pos, sel[owner]
    return slab.positions_batch(vis, direction)


def _group(chunks: List[np.ndarray], owners: List[np.ndarray],
           n_queries: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regroup concatenated per-slab hits by query vertex. Returns
    (stable sort order over the concatenation, owner per element, offsets)."""
    offsets = np.zeros(n_queries + 1, np.int64)
    if not chunks:
        return np.empty(0, np.int64), np.empty(0, np.int64), offsets
    owner = np.concatenate(owners)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_queries)
    np.cumsum(counts, out=offsets[1:])
    return order, owner, offsets


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class StorageEngine:
    """Vectorized set-at-a-time read interface over a graph store.

    Subclasses provide `_slabs()`; everything else is shared. All public
    methods take and return ORIGINAL vertex IDs (the reversible hash is
    applied at the boundary, paper §7.2).
    """

    #: hop-execution modes this engine can serve (core/multihop.py checks
    #: before choosing one): "sparse" = per-slab probes via expand_frontier;
    #: "stream" = whole-store edge_chunks sweeps; "kernel" = dense CUDA
    #: plans built from the full edge set. Engines that cannot enumerate
    #: every edge cheaply (the sharded scatter/gather engine — shipping the
    #: whole edge set over IPC per hop would drown the win) restrict this
    #: to ("sparse",) and the density heuristic clamps to it.
    supported_hop_modes: Tuple[str, ...] = ("sparse", "stream", "kernel")

    def __init__(self, graph):
        self.graph = graph

    @property
    def intervals(self):
        return self.graph.intervals

    @property
    def n_internal_vertices(self) -> int:
        return self.graph.intervals.max_vertices

    def _slabs(self) -> Iterator:
        raise NotImplementedError

    # -- batched traversal primitives ----------------------------------------
    def out_neighbors_batch(self, vs: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Out-neighbors of every v in vs. Returns (values, offsets):
        values[offsets[i]:offsets[i+1]] are vs[i]'s out-neighbors."""
        return self._neighbors_batch(vs, "out")

    def in_neighbors_batch(self, vs: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        return self._neighbors_batch(vs, "in")

    def expand_frontier(self, vs, direction: str = "out", predicate=None,
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Flat one-hop expansion: (owner index into vs, neighbor) pairs in
        ORIGINAL ids, UNGROUPED and in no particular order.

        This is the multi-hop fast path (core/multihop.py): operators that
        immediately re-sort the union by packed (owner, neighbor) keys do not
        need `_neighbors_batch`'s stable per-vertex regrouping, so the
        argsort over the whole hit set is skipped entirely.

        `predicate` is pushed into the slab scan: an object with
        `mask(slab, pos) -> bool array` evaluated on edge-array positions
        BEFORE the destination gather, so non-matching edges never
        materialize into the result (only their positions are touched).
        """
        vs = np.asarray(vs, dtype=np.int64).ravel()
        iv = self.intervals
        vis = np.asarray(iv.to_internal(vs))
        release = getattr(self.graph, "release_slab", None)
        vals, owners = [], []
        for slab in self._slabs():
            pos, owner = _slab_positions(slab, vis, direction)
            if pos.size and predicate is not None:
                keep = predicate.mask(slab, pos)
                pos, owner = pos[keep], owner[keep]
            if pos.size:
                vals.append(slab.dst_at(pos) if direction == "out"
                            else slab.src_at(pos))
                owners.append(owner)
            if release is not None:
                part = getattr(slab, "part", None)
                if part is not None:
                    release(part)
        if not vals:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        flat = np.concatenate(vals)
        return (np.concatenate(owners),
                np.asarray(iv.to_original(flat), np.int64))

    def out_degree_batch(self, vs) -> np.ndarray:
        return self._degree_batch(vs, "out")

    def in_degree_batch(self, vs) -> np.ndarray:
        return self._degree_batch(vs, "in")

    def _degree_batch(self, vs, direction: str) -> np.ndarray:
        """Live-edge degree per query vertex (multi-edges counted) without
        gathering a single endpoint: positions are counted per owner right
        after the range expansion, so the cost is the pointer-index probes
        plus one bincount per slab."""
        vs = np.asarray(vs, dtype=np.int64).ravel()
        vis = np.asarray(self.intervals.to_internal(vs))
        deg = np.zeros(vs.shape[0], np.int64)
        release = getattr(self.graph, "release_slab", None)
        for slab in self._slabs():
            pos, owner = _slab_positions(slab, vis, direction)
            if pos.size:
                deg += np.bincount(owner, minlength=vs.shape[0])
            if release is not None:
                part = getattr(slab, "part", None)
                if part is not None:
                    release(part)
        return deg

    # -- derived-plan memoization (dense frontier plans, edge-key sets) ------
    def plan_cache(self) -> Dict:
        """Mutable memo dict for whole-store derived read structures
        (core/multihop.py dense plans, packed edge-key sets). Entries are
        keyed by `cache_token()` so a stale plan is never served after the
        store mutates; engines over immutable state share the dict across
        readers (idempotent fills, same contract as the manifest cache)."""
        cache = getattr(self, "_plan_cache", None)
        if cache is None:
            cache = self._plan_cache = {}
        return cache

    def cache_token(self):
        """Content fingerprint for plan keying, or None when the store
        cannot be fingerprinted (disables caching, never staleness)."""
        g = self.graph
        epochs = getattr(g, "epochs", None)
        if epochs is not None:
            cur = epochs.current
            if cur is not None:
                return ("epoch", cur.version)
        n_edges = getattr(g, "n_edges", None)
        buffered = getattr(g, "total_buffered", None)
        if n_edges is None:
            return None
        return ("edges", int(n_edges),
                int(buffered()) if buffered is not None else 0)

    # -- live derived state (a store that logs its changes of key presence)
    def live_position(self) -> Optional[int]:
        """Where this engine reads one pinned edge set of a store that logs
        its changes of key presence: the number of log entries the edge set
        covers. Derived read structures may then follow the store by its
        log (`log_entries`, kept in `live_state()`) instead of being built
        per content (core/multihop.py's live dense plans). None here: build
        per `cache_token()`."""
        return None

    def log_entries(self, a: int, b: int, follower=None):
        """(keys int64, signs int8) of the store's log entries [a, b): a
        packed internal key (src * max_vertices + dst), +1 for an insert,
        -1 for a delete that found its key. None where the log no longer
        holds them. `follower` names a reader that has then read up to `b`
        and needs the entries from there on."""
        return None

    def live_state(self) -> Dict:
        """Mutable dict, kept on the store across its publications, for the
        derived structures that follow it by `log_entries`."""
        raise TypeError(f"{type(self).__name__} logs no changes")

    def _neighbors_batch(self, vs, direction: str):
        vs = np.asarray(vs, dtype=np.int64).ravel()
        iv = self.intervals
        vis = np.asarray(iv.to_internal(vs))
        # disk tier: a batch probes EVERY slab, so a store with a residency
        # budget can release each slab's decoded index/mmaps as soon as the
        # batch is done with it (all reads for a slab happen in its loop
        # iteration; the gathered results are copies)
        release = getattr(self.graph, "release_slab", None)
        vals, owners = [], []
        for slab in self._slabs():
            pos, owner = _slab_positions(slab, vis, direction)
            if pos.size:
                vals.append(slab.dst_at(pos) if direction == "out"
                            else slab.src_at(pos))
                owners.append(owner)
            if release is not None:
                part = getattr(slab, "part", None)
                if part is not None:
                    release(part)
        order, _, offsets = _group(vals, owners, vs.shape[0])
        if order.size == 0:
            return np.empty(0, np.int64), offsets
        flat = np.concatenate(vals)[order]
        return np.asarray(iv.to_original(flat), np.int64), offsets

    def edge_columns_batch(self, vs: Sequence[int],
                           names: Optional[Sequence[str]] = None,
                           direction: str = "out") -> EdgeBatch:
        """Adjacent edges of every v in vs with their attribute columns —
        the set-at-a-time analogue of the paper's positional column reads
        (§4.3), grouped CSR-style by query vertex."""
        vs = np.asarray(vs, dtype=np.int64).ravel()
        iv = self.intervals
        vis = np.asarray(iv.to_internal(vs))
        slabs = list(self._slabs())
        # declared dtypes (LSM) or whatever columns the slabs carry (PAL)
        dtypes = dict(getattr(self.graph, "column_dtypes", {}) or {})
        if names is None:
            names = list(dtypes) or sorted(
                {k for s in slabs for k in s.column_names()})

        def dtype_of(name):
            if name in dtypes:
                return dtypes[name]
            for s in slabs:
                dt = s.column_dtype(name)
                if dt is not None:
                    return dt
            return np.float64

        hits = []  # (slab, pos, owner)
        for slab in slabs:
            pos, owner = _slab_positions(slab, vis, direction)
            if pos.size:
                hits.append((slab, pos, owner))
        order, _, offsets = _group([h[1] for h in hits],
                                   [h[2] for h in hits], vs.shape[0])
        if order.size == 0:
            return EdgeBatch(vs, offsets, np.empty(0, np.int64),
                             np.empty(0, np.int64), np.empty(0, np.int8),
                             {k: np.empty(0, dtype_of(k)) for k in names})
        src = np.concatenate([s.src_at(p) for s, p, _ in hits])[order]
        dst = np.concatenate([s.dst_at(p) for s, p, _ in hits])[order]
        etype = np.concatenate([s.etype_at(p) for s, p, _ in hits])[order]
        columns = {}
        for k in names:
            dt = dtype_of(k)
            columns[k] = np.concatenate(
                [s.column_at(k, p, dt) for s, p, _ in hits])[order]
        release = getattr(self.graph, "release_slab", None)
        if release is not None:
            for slab in slabs:
                part = getattr(slab, "part", None)
                if part is not None:
                    release(part)
        return EdgeBatch(
            vs, offsets,
            np.asarray(iv.to_original(src), np.int64),
            np.asarray(iv.to_original(dst), np.int64),
            etype, columns,
        )

    # -- whole-store streaming (bottom-up sweeps, degree passes) -------------
    def edge_chunks(self) -> Iterator[EdgeChunk]:
        """Stream every live edge once, slab by slab, in internal IDs."""
        for slab in self._slabs():
            chunk = slab.chunk()
            if chunk is not None and chunk.src.shape[0]:
                yield chunk

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.graph.to_coo()


class PALEngine(StorageEngine):
    """StorageEngine over a bulk-built GraphPAL (one slab per partition)."""

    def _slabs(self):
        for part in self.graph.partitions:
            yield _PartitionSlab(part)


class LSMEngine(StorageEngine):
    """StorageEngine over a live LSMTree: every partition of every level,
    the in-memory edge buffers (newest data, staged sorted views), and any
    drained batches whose merge is still in flight on the maintenance
    pipeline (`pending_stagings`) — a mid-merge batch is visible exactly
    once: as a pending slab before its commit, in the merged partitions
    after."""

    def _slabs(self):
        for level in self.graph.levels:
            for part in level:
                yield _PartitionSlab(part)
        pending = getattr(self.graph, "pending_stagings", None)
        if pending is not None:
            for st, interval in pending():
                if st.src.shape[0]:
                    yield _BufferSlab(st, interval)
        for buf, top in zip(self.graph.buffers, self.graph.levels[0]):
            if len(buf):
                yield _BufferSlab(buf.staging(), top.interval)


class ManifestEngine(StorageEngine):
    """StorageEngine over a pinned `ManifestView` (core/manifest.py) — the
    LOCK-FREE live read path. Slabs come from one published manifest:
    partition proxies carrying publication-time tombstone arrays, plus the
    frozen buffer/pending stagings. Everything is immutable for the pin's
    lifetime, so any number of reader threads share one view (and its lazy
    sort/index caches) with zero coordination with the writer, merges,
    checkpoints, or GC. There is deliberately no release hook: views do
    not evict — reclamation is the epoch guard's job."""

    def _slabs(self):
        m = self.graph.manifest
        return m.derived("slabs", lambda: (
            [_PartitionSlab(mp) for lv in m.levels for mp in lv]
            + [_BufferSlab(st, interval)
               for st, interval in m.staging_slabs()]))

    def plan_cache(self):
        # derived plans live on the manifest itself: shared by every reader
        # of this publication, dropped wholesale when the writer republishes
        return self.graph.manifest.cache

    def cache_token(self):
        return ("manifest",)  # one manifest == one immutable edge set

    def live_position(self):
        return self.graph.manifest.log_seq

    def log_entries(self, a, b, follower=None):
        return self.graph.tree.oplog.entries(a, b, follower)

    def live_state(self):
        return self.graph.tree.live_state


class SnapshotEngine(LSMEngine):
    """Engine over a pinned `Snapshot`'s private tree (core/service.py).

    Same slab protocol as the live LSM engine, but the backing state is
    immutable for the session's whole lifetime: there is no release hook
    (the snapshot tree carries no residency budget), so decoded caches and
    staged sort orders persist across batches — a session issuing many
    frontier queries pays each slab's index materialization once. Mutation
    never reaches here; `Snapshot` exposes no write methods."""

    writable = False


def as_engine(g) -> StorageEngine:
    """Coerce a graph store (or an engine) to its StorageEngine — the only
    dispatch point; the query layer never inspects storage classes."""
    if isinstance(g, StorageEngine):
        return g
    maker = getattr(g, "storage_engine", None)
    if maker is None:
        raise TypeError(
            f"{type(g).__name__} exposes no storage_engine(); expected a "
            "GraphPAL, LSMTree, or StorageEngine")
    return maker()
