"""Partitioned Adjacency Lists (PAL) — the paper's core data structure.

Faithful to GraphChi-DB (Kyrola & Guestrin, 2014) §4 with the TPU adaptation
documented in DESIGN.md §2:

  * the vertex-ID range is split into P intervals; edge-partition(i) stores
    every edge whose *destination* lies in interval(i), sorted by *source*;
  * each edge is stored exactly once, both directions are queryable;
  * the paper's in-edge linked list (next-with-same-dst offsets) is replaced
    by an immutable dst-sort permutation + dst pointer array (CSC within the
    partition) — pointer chasing has no TPU analogue;
  * edge attributes are columnar and positional: the edge's index in the
    edge-array is the key into every column (paper §4.3);
  * vertex attributes are columnar per interval with O(1) positional access
    (paper §4.4);
  * interval balancing uses the paper's reversible hash (§7.2).

Construction and queries are host-side numpy (this is the database layer).

Host copy of the reference `repro/core/pal.py` (numpy; same names and
arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "IntervalMap",
    "EdgePartition",
    "GraphPAL",
    "SortedRun",
    "build_partition",
    "merge_sorted_runs",
    "merge_runs",
    "merge_runs_into_partition",
    "partition_from_run",
    "run_from_arrays",
    "run_from_partition",
    "sorted_run_index",
]


# ---------------------------------------------------------------------------
# Intervals + reversible hash (paper §4.1, §7.2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class IntervalMap:
    """P equal-length vertex intervals over internal IDs [0, P*L).

    The paper's reversible hash maps original IDs to internal IDs so that
    consecutive original IDs land in *different* intervals, balancing
    power-law edge distributions without dynamic interval management:

        intern = (orig mod P) * L + (orig div P)
        orig   = (intern mod L) * P + (intern div L)

    (The paper's §7.2 decode line swaps div/mod — an apparent typo; the
    formula above is the true inverse of its encode, verified by the
    round-trip property test.)
    """

    n_partitions: int
    interval_len: int

    @property
    def max_vertices(self) -> int:
        return self.n_partitions * self.interval_len

    @classmethod
    def for_capacity(cls, max_id: int, n_partitions: int) -> "IntervalMap":
        interval_len = -(-int(max_id + 1) // n_partitions)  # ceil div
        return cls(n_partitions=n_partitions, interval_len=interval_len)

    # -- reversible hash -----------------------------------------------------
    def to_internal(self, orig):
        orig = np.asarray(orig, dtype=np.int64)
        p, ell = self.n_partitions, self.interval_len
        return (orig % p) * ell + (orig // p)

    def to_internal_scalar(self, orig: int) -> int:
        """Scalar reversible hash in pure Python — hot single-edge paths
        avoid the per-call array round-trip of `to_internal`."""
        return (orig % self.n_partitions) * self.interval_len \
            + orig // self.n_partitions

    def to_original(self, intern):
        intern = np.asarray(intern, dtype=np.int64)
        p, ell = self.n_partitions, self.interval_len
        return (intern % ell) * p + (intern // ell)

    # -- interval lookup (O(1), "mathematically", paper §7.2) ----------------
    def interval_of(self, intern):
        return np.asarray(intern, dtype=np.int64) // self.interval_len

    def interval_range(self, i: int) -> Tuple[int, int]:
        lo = i * self.interval_len
        return lo, lo + self.interval_len

    def local_offset(self, intern):
        """Offset within owning interval — positional vertex-column key."""
        return np.asarray(intern, dtype=np.int64) % self.interval_len


# ---------------------------------------------------------------------------
# Edge partition (paper §4.1.1, with CSC-perm adaptation)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EdgePartition:
    """Immutable destination-interval edge partition.

    Edge order (the 'edge-array'): sorted by (src, dst). Attribute columns
    are positional w.r.t. this order. The only permitted in-place mutation
    mirrors the paper: edge-type change, attribute-column writes, and
    tombstoning (§5.3) — none of which reorder or resize the arrays.
    """

    interval: Tuple[int, int]  # [lo, hi) of internal destination IDs
    src: np.ndarray            # (E,) int64, ascending
    dst: np.ndarray            # (E,) int64, within interval
    etype: np.ndarray          # (E,) int8  (paper: 4-bit type)
    # sparse CSR over sources (paper's pointer-array; sparse format §4.1.1)
    src_vertices: np.ndarray   # (S,) unique sources, ascending
    src_ptr: np.ndarray        # (S+1,) offsets into edge-array
    # dst access (replaces the in-edge linked list; DESIGN.md §2)
    dst_perm: np.ndarray       # (E,) permutation sorting edges by dst
    dst_vertices: np.ndarray   # (D,) unique destinations, ascending
    dst_ptr: np.ndarray        # (D+1,) offsets into dst_perm
    # columnar edge attributes, positional (paper §4.3)
    columns: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # tombstones (paper §5.3): permanent removal happens at merge time
    dead: Optional[np.ndarray] = None  # (E,) bool or None
    # set by manifest publication (core/manifest.py): the NEXT tombstone
    # write must copy `dead` instead of mutating the published array
    _dead_sealed: bool = False

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_live_edges(self) -> int:
        if self.dead is None:
            return self.n_edges
        return int(self.n_edges - self.dead.sum())

    def nbytes(self) -> int:
        n = self.src.nbytes + self.dst.nbytes + self.etype.nbytes
        n += self.src_vertices.nbytes + self.src_ptr.nbytes
        n += self.dst_perm.nbytes + self.dst_vertices.nbytes + self.dst_ptr.nbytes
        for c in self.columns.values():
            n += c.nbytes
        return n

    # -- primitive queries (paper §4.2) --------------------------------------
    def out_edge_range(self, v: int) -> Tuple[int, int]:
        """Edge-array range [a, b) of v's out-edges (binary search on the
        pointer-array, paper §4.2.1). Empty range if none."""
        i = np.searchsorted(self.src_vertices, v)
        if i < self.src_vertices.shape[0] and self.src_vertices[i] == v:
            return int(self.src_ptr[i]), int(self.src_ptr[i + 1])
        return 0, 0

    def out_edges(self, v: int) -> np.ndarray:
        """Positions in the edge-array of v's live out-edges."""
        a, b = self.out_edge_range(v)
        pos = np.arange(a, b, dtype=np.int64)
        return self._live(pos)

    def in_edges(self, v: int) -> np.ndarray:
        """Positions in the edge-array of v's live in-edges (via dst-perm —
        the paper walks the linked list; we take one contiguous perm slice)."""
        i = np.searchsorted(self.dst_vertices, v)
        if i < self.dst_vertices.shape[0] and self.dst_vertices[i] == v:
            pos = self.dst_perm[self.dst_ptr[i]:self.dst_ptr[i + 1]]
            return self._live(np.asarray(pos, dtype=np.int64))
        return np.empty(0, dtype=np.int64)

    def _live(self, pos: np.ndarray) -> np.ndarray:
        if self.dead is None or pos.size == 0:
            return pos
        return pos[~self.dead[pos]]

    # -- mutations allowed by the model --------------------------------------
    def set_column(self, name: str, pos, values) -> None:
        self.columns[name][pos] = values

    def set_etype(self, pos, values) -> None:
        """Paper §4.1.1: edge-type change is the one allowed in-place edit."""
        self.etype[pos] = values

    def tombstone(self, pos) -> None:
        """Tombstone positions. Copy-on-write once a manifest publication
        sealed the current `dead` array (core/manifest.py): lock-free
        readers pinned to an older manifest keep the pre-delete array, so a
        delete can never tear a published view's structure."""
        if self.dead is None:
            dead = np.zeros(self.n_edges, dtype=bool)
        elif self._dead_sealed:
            dead = self.dead.copy()
        else:
            dead = self.dead
        dead[pos] = True
        self.dead = dead
        self._dead_sealed = False

    # -- PSW sliding window (paper §6.1) --------------------------------------
    def window(self, interval: Tuple[int, int]) -> Tuple[int, int]:
        """Contiguous edge-array range whose sources fall in `interval`.

        This is the paper's sliding window: because the partition is
        source-sorted, the out-edges of any vertex interval form one
        contiguous run.
        """
        lo, hi = interval
        a = int(np.searchsorted(self.src, lo, side="left"))
        b = int(np.searchsorted(self.src, hi, side="left"))
        return a, b

    # -- attribute → edge reverse lookup (paper §4.3) -------------------------
    def edge_at(self, pos: int) -> Tuple[int, int, int]:
        """Recover (src, dst, type) from an edge-array position: dst/type are
        stored at the position; src via pointer-array search (paper does the
        same binary search)."""
        j = int(np.searchsorted(self.src_ptr, pos, side="right")) - 1
        return int(self.src_vertices[j]), int(self.dst[pos]), int(self.etype[pos])


def build_partition(
    interval: Tuple[int, int],
    src: np.ndarray,
    dst: np.ndarray,
    etype: Optional[np.ndarray] = None,
    columns: Optional[Dict[str, np.ndarray]] = None,
    presorted: bool = False,
) -> EdgePartition:
    """Bulk-build an immutable edge partition (sort by (src, dst), index)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    etype = (
        np.zeros(src.shape[0], dtype=np.int8)
        if etype is None
        else np.asarray(etype, dtype=np.int8)
    )
    columns = dict(columns or {})
    if not presorted and src.size:
        order = np.lexsort((dst, src))
        src, dst, etype = src[order], dst[order], etype[order]
        columns = {k: np.asarray(v)[order] for k, v in columns.items()}

    src_vertices, first = np.unique(src, return_index=True)
    src_ptr = np.concatenate([first, [src.shape[0]]]).astype(np.int64)

    dst_perm = np.argsort(dst, kind="stable").astype(np.int64)
    dst_sorted = dst[dst_perm]
    dst_vertices, dfirst = np.unique(dst_sorted, return_index=True)
    dst_ptr = np.concatenate([dfirst, [dst.shape[0]]]).astype(np.int64)

    return EdgePartition(
        interval=interval,
        src=src,
        dst=dst,
        etype=etype,
        src_vertices=src_vertices,
        src_ptr=src_ptr,
        dst_perm=dst_perm,
        dst_vertices=dst_vertices,
        dst_ptr=dst_ptr,
        columns=columns,
    )


# ---------------------------------------------------------------------------
# Linear-time sorted merges (LSM write path, DESIGN.md §6)
# ---------------------------------------------------------------------------
# A partition's edge-array is (src, dst)-sorted, and boolean-masked subsets
# of it stay sorted. Merging a partition with an incoming run therefore
# never needs to re-sort the big side: sort only the small run, compute the
# interleave permutation with two binary searches, and rebuild every index
# array (CSR over sources, CSC perm over destinations) from that
# permutation in O(n) — no fresh `unique` / `argsort` over the merged data.

#: Largest vertex-ID bound for which (src, dst) packs into one int64 key.
_MAX_PACKED_BOUND = 3_037_000_499  # isqrt(2**63 - 1)


def sorted_run_index(sorted_vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse CSR (vertices, ptr) over an already-sorted key array in O(n) —
    the linear replacement for `np.unique(..., return_index=True)` on data
    whose order is known. Bitwise-identical to the unique-based build."""
    n = int(sorted_vals.shape[0])
    if n == 0:
        return sorted_vals[:0].astype(np.int64), np.zeros(1, np.int64)
    starts = np.concatenate(
        [[0], np.flatnonzero(sorted_vals[1:] != sorted_vals[:-1]) + 1]
    ).astype(np.int64)
    vertices = sorted_vals[starts].astype(np.int64)
    ptr = np.concatenate([starts, [n]]).astype(np.int64)
    return vertices, ptr


def merge_sorted_runs(
    a_src: np.ndarray, a_dst: np.ndarray,
    b_src: np.ndarray, b_dst: np.ndarray,
    key_bound: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable two-way merge of two (src, dst)-sorted edge runs in O(nA+nB).

    Returns `(pos_a, pos_b)`: the merged-array positions of A's and B's
    elements, with A before B on equal keys — exactly the order
    `np.lexsort((dst, src))` would give the concatenation [A, B], computed
    from two `searchsorted` passes instead of an O(n log n) sort.

    Requires `0 <= src, dst < key_bound <= _MAX_PACKED_BOUND` so the pair
    packs losslessly into one monotone int64 key.
    """
    ka = _pack_keys(a_src, a_dst, key_bound)
    kbq = _pack_keys(b_src, b_dst, key_bound)
    return _merge_positions(ka, kbq)


def _pack_keys(src: np.ndarray, dst: np.ndarray, bound: int) -> np.ndarray:
    k = src * np.int64(bound)
    k += dst  # in place: one temporary instead of two
    return k


_ARANGE_SCRATCH = np.empty(0, np.int64)


def _arange(n: int) -> np.ndarray:
    """Read-only view of [0, n) from a grow-only scratch — the merge path
    needs consecutive-integer vectors constantly and never mutates them.
    The scratch is marked non-writable so a view escaping through a public
    return value (merge_sorted_runs' disjoint fast path) cannot be mutated
    into corrupting later merges."""
    global _ARANGE_SCRATCH
    if _ARANGE_SCRATCH.shape[0] < n:
        _ARANGE_SCRATCH = np.arange(max(n, 2 * _ARANGE_SCRATCH.shape[0]),
                                    dtype=np.int64)
        _ARANGE_SCRATCH.flags.writeable = False
    return _ARANGE_SCRATCH[:n]


def _merge_positions(ka: np.ndarray, kbq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Merged positions of two sorted key arrays (A before B on ties). Only
    the small side is binary-searched; the big side's shifts come from a
    bincount + cumsum over the small side's insertion ranks — sequential
    passes instead of nA random binary searches."""
    nA, nB = ka.shape[0], kbq.shape[0]
    if nA == 0 or nB == 0 or ka[-1] <= kbq[0]:  # disjoint: A wholly first
        return _arange(nA), nA + _arange(nB)
    if kbq[-1] < ka[0]:  # disjoint: B wholly first
        return nB + _arange(nA), _arange(nB)
    rank_b = np.searchsorted(ka, kbq, side="right")  # #{a <= b} per b
    pos_b = rank_b + _arange(nB)
    # b precedes a[i] iff rank_b <= i: a[i]'s shift is a step function that
    # climbs at each insertion rank — expand it by run lengths, then add
    # i in place (two big temporaries total, not five)
    lengths = np.empty(nB + 1, np.int64)
    lengths[0] = rank_b[0]
    np.subtract(rank_b[1:], rank_b[:-1], out=lengths[1:nB])
    lengths[nB] = nA - rank_b[-1]
    pos_a = np.repeat(_arange(nB + 1), lengths)
    pos_a += _arange(nA)
    return pos_a, pos_b


@dataclasses.dataclass
class SortedRun:
    """A (src, dst)-sorted edge run plus its stable dst-sort order — the
    unit consumed by `merge_runs_into_partition`."""

    src: np.ndarray                 # (n,) int64, (src, dst)-ascending
    dst: np.ndarray                 # (n,) int64
    etype: np.ndarray               # (n,) int8
    columns: Dict[str, np.ndarray]  # positional
    dst_order: np.ndarray           # (n,) stable argsort of dst
    dst_sorted: Optional[np.ndarray] = None  # dst[dst_order], if already built

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def run_from_arrays(
    src: np.ndarray,
    dst: np.ndarray,
    etype: Optional[np.ndarray] = None,
    columns: Optional[Dict[str, np.ndarray]] = None,
    presorted: bool = False,
    key_bound: Optional[int] = None,
) -> SortedRun:
    """Sort a small incoming run (the only sort on the merge path). With
    `presorted=True` (push-down merges: masked subsets of a sorted partition
    stay sorted) the lexsort is skipped entirely; with `key_bound` set the
    two-key lexsort collapses into one packed-key argsort."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    n = int(src.shape[0])
    etype = (np.zeros(n, np.int8) if etype is None
             else np.asarray(etype, dtype=np.int8))
    columns = dict(columns or {})
    if presorted or n == 0:
        dst_order = np.argsort(dst, kind="stable").astype(np.int64)
        return SortedRun(src=src, dst=dst, etype=etype, columns=columns,
                         dst_order=dst_order)
    if key_bound is not None and key_bound * key_bound * (n + 1) < 2 ** 63:
        # (src, dst, position) packs into one int64, making every key
        # unique: a plain value sort (no stable argsort, no index array)
        # recovers both the stable (src, dst) order and — with the roles
        # swapped — the stable dst order of the sorted run
        k3 = _pack_keys(src, dst, key_bound) * np.int64(n)
        k3 += _arange(n)
        k4 = _pack_keys(dst, src, key_bound) * np.int64(n)
        k4 += _arange(n)
        k3.sort()
        k4.sort()
        order = k3 % n                      # original pos, (src, dst)-sorted
        inv = np.empty(n, np.int64)
        inv[order] = _arange(n)
        dst_order = inv[k4 % n]             # ties resolved by (src, insertion)
    else:
        order = np.lexsort((dst, src))
        dst_order = None
    src, dst, etype = src[order], dst[order], etype[order]
    columns = {k: np.asarray(v)[order] for k, v in columns.items()}
    if dst_order is None:
        dst_order = np.argsort(dst, kind="stable").astype(np.int64)
    return SortedRun(src=src, dst=dst, etype=etype, columns=columns,
                     dst_order=dst_order)


def run_from_partition(
    part: "EdgePartition",
    live: Optional[np.ndarray] = None,
    columns: Optional[Sequence[str]] = None,
) -> SortedRun:
    """View a partition's live edges as a SortedRun, reusing the stored
    `dst_perm` instead of re-sorting: a masked subset of a (src, dst)-sorted
    array stays sorted, and its stable dst order is the stored perm filtered
    to live positions and renumbered — all O(n)."""
    names = part.columns.keys() if columns is None else columns
    if live is None:
        cols = {k: part.columns[k] for k in names if k in part.columns}
        return SortedRun(src=part.src, dst=part.dst, etype=part.etype,
                         columns=cols,
                         dst_order=np.asarray(part.dst_perm, np.int64))
    new_pos = np.cumsum(live) - 1
    keep = live[part.dst_perm]
    dst_order = np.asarray(new_pos[part.dst_perm[keep]], np.int64)
    cols = {k: part.columns[k][live] for k in names if k in part.columns}
    return SortedRun(src=part.src[live], dst=part.dst[live],
                     etype=part.etype[live], columns=cols,
                     dst_order=dst_order)


def merge_runs(a: SortedRun, b: SortedRun, key_bound: int,
               column_dtypes: Optional[Dict[str, np.dtype]] = None) -> SortedRun:
    """O(n) stable merge of two sorted runs into one SortedRun (A before B
    on ties) — used when a flush overflows its partition and the combined
    edges go straight to the children without materializing the partition."""
    nA, nB = a.n_edges, b.n_edges
    n = nA + nB
    column_dtypes = dict(column_dtypes or {})
    pos_a, pos_b = merge_sorted_runs(a.src, a.dst, b.src, b.dst, key_bound)

    def scatter(xa, xb, dtype):
        out = np.empty(n, dtype)
        out[pos_a] = xa
        out[pos_b] = xb
        return out

    columns = {}
    for k, dt in column_dtypes.items():
        xa = a.columns.get(k)
        xb = b.columns.get(k)
        columns[k] = scatter(
            xa if xa is not None else np.zeros(nA, dt),
            xb if xb is not None else np.zeros(nB, dt), dt)
    # dst-sorted streams of each run, expressed in merged positions; keys
    # (dst, merged position) are strictly increasing within each stream and
    # globally distinct, so one more merge pass orders them. The merged
    # dst_order is bitwise identical to np.argsort(dst, kind="stable").
    ma = pos_a[a.dst_order]
    mb = pos_b[b.dst_order]
    da = a.dst[a.dst_order]
    db = b.dst[b.dst_order]
    qa, qb = _merge_positions(_pack_keys(da, ma, n), _pack_keys(db, mb, n))
    dst_order = np.empty(n, np.int64)
    dst_order[qa] = ma
    dst_order[qb] = mb
    # merged dst-sorted values by monotone scatter (no random gather)
    d_sorted = np.empty(n, np.int64)
    d_sorted[qa] = da
    d_sorted[qb] = db
    return SortedRun(
        src=scatter(a.src, b.src, np.int64),
        dst=scatter(a.dst, b.dst, np.int64),
        etype=scatter(a.etype, b.etype, np.int8),
        columns=columns,
        dst_order=dst_order,
        dst_sorted=d_sorted,
    )


def partition_from_run(
    interval: Tuple[int, int],
    run: SortedRun,
    column_dtypes: Optional[Dict[str, np.dtype]] = None,
) -> EdgePartition:
    """Build a partition straight from a SortedRun (the empty-target merge
    fast path) — indexes in O(n) off the run's existing order. The run's
    arrays must be freshly owned (not views of a live buffer/partition)."""
    n = run.n_edges
    column_dtypes = dict(column_dtypes or {})
    src_vertices, src_ptr = sorted_run_index(run.src)
    d_sorted = (run.dst[run.dst_order] if run.dst_sorted is None
                else run.dst_sorted)
    dst_vertices, dst_ptr = sorted_run_index(d_sorted)
    columns = {}
    for k, dt in column_dtypes.items():
        col = run.columns.get(k)
        columns[k] = np.asarray(col, dt) if col is not None else np.zeros(n, dt)
    return EdgePartition(
        interval=interval,
        src=run.src,
        dst=run.dst,
        etype=run.etype,
        src_vertices=src_vertices,
        src_ptr=src_ptr,
        dst_perm=run.dst_order,
        dst_vertices=dst_vertices,
        dst_ptr=dst_ptr,
        columns=columns,
    )


def merge_runs_into_partition(
    interval: Tuple[int, int],
    a: SortedRun,
    b: SortedRun,
    key_bound: int,
    column_dtypes: Optional[Dict[str, np.dtype]] = None,
) -> EdgePartition:
    """O(n) merge of two sorted runs into a NEW immutable partition.

    The edge-array is the stable (src, dst) interleave of A then B
    (`merge_runs`); the CSR source index comes from run boundaries of the
    merged (already sorted) src array and the CSC dst permutation from the
    merged dst order (`partition_from_run`) — bitwise identical to a
    from-scratch `build_partition`, without sorting.
    """
    return partition_from_run(
        interval, merge_runs(a, b, key_bound, column_dtypes), column_dtypes)


# ---------------------------------------------------------------------------
# The full PAL graph
# ---------------------------------------------------------------------------
class GraphPAL:
    """P destination-interval partitions + per-interval vertex columns.

    IDs handed to the public API are *original* IDs; the reversible hash is
    applied at the boundary (paper §7.2).
    """

    def __init__(self, intervals: IntervalMap, partitions: List[EdgePartition],
                 vertex_columns: Optional[Dict[str, List[np.ndarray]]] = None):
        assert len(partitions) == intervals.n_partitions
        self.intervals = intervals
        self.partitions = partitions
        # vertex columns: name -> list of per-interval arrays (positional)
        self.vertex_columns: Dict[str, List[np.ndarray]] = vertex_columns or {}
        self._engine = None

    def storage_engine(self):
        """Vectorized set-at-a-time read interface (engine.py, DESIGN.md §5)."""
        if self._engine is None:
            from .engine import PALEngine
            self._engine = PALEngine(self)
        return self._engine

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_edges(
        cls,
        src,
        dst,
        n_partitions: int = 8,
        max_id: Optional[int] = None,
        etype=None,
        columns: Optional[Dict[str, np.ndarray]] = None,
    ) -> "GraphPAL":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if max_id is None:
            max_id = int(max(src.max(initial=0), dst.max(initial=0)))
        iv = IntervalMap.for_capacity(max_id, n_partitions)
        isrc, idst = iv.to_internal(src), iv.to_internal(dst)
        part_of = iv.interval_of(idst)
        etype = None if etype is None else np.asarray(etype, dtype=np.int8)
        columns = columns or {}
        parts: List[EdgePartition] = []
        for i in range(n_partitions):
            m = part_of == i
            cols = {k: np.asarray(v)[m] for k, v in columns.items()}
            et = None if etype is None else etype[m]
            parts.append(build_partition(iv.interval_range(i), isrc[m], idst[m], et, cols))
        return cls(iv, parts)

    # -- stats ----------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return sum(p.n_edges for p in self.partitions)

    @property
    def n_live_edges(self) -> int:
        return sum(p.n_live_edges for p in self.partitions)

    def nbytes(self) -> int:
        n = sum(p.nbytes() for p in self.partitions)
        for col in self.vertex_columns.values():
            n += sum(a.nbytes for a in col)
        return n

    # -- vertex columns (paper §4.4: positional, O(1)) --------------------------
    def add_vertex_column(self, name: str, dtype, fill=0) -> None:
        ell = self.intervals.interval_len
        self.vertex_columns[name] = [
            np.full(ell, fill, dtype=dtype) for _ in range(self.intervals.n_partitions)
        ]

    def vertex_get(self, name: str, orig_ids):
        intern = self.intervals.to_internal(orig_ids)
        part = self.intervals.interval_of(intern)
        off = self.intervals.local_offset(intern)
        col = self.vertex_columns[name]
        out = np.empty(np.shape(intern), dtype=col[0].dtype)
        flat_p, flat_o = np.ravel(part), np.ravel(off)
        flat_out = out.reshape(-1)
        for i in np.unique(flat_p):
            m = flat_p == i
            flat_out[m] = col[int(i)][flat_o[m]]
        return out

    def vertex_set(self, name: str, orig_ids, values) -> None:
        intern = self.intervals.to_internal(orig_ids)
        part = self.intervals.interval_of(intern)
        off = self.intervals.local_offset(intern)
        col = self.vertex_columns[name]
        values = np.asarray(values)
        flat_p, flat_o = np.ravel(part), np.ravel(off)
        flat_v = values.reshape(flat_p.shape[0], *values.shape[len(np.shape(intern)):])
        for i in np.unique(flat_p):
            m = flat_p == i
            col[int(i)][flat_o[m]] = flat_v[m]

    # -- edge queries (original-ID API; paper §4.2) ----------------------------
    def out_edges(self, v: int) -> List[Tuple[int, int]]:
        """All (partition_idx, edge_pos) of v's out-edges. A vertex can have
        out-edges in every partition (paper: min(P, outdeg) random accesses)."""
        vi = int(self.intervals.to_internal(v))
        hits: List[Tuple[int, int]] = []
        for pi, part in enumerate(self.partitions):
            for pos in part.out_edges(vi):
                hits.append((pi, int(pos)))
        return hits

    def in_edges(self, v: int) -> List[Tuple[int, int]]:
        """All (partition_idx, edge_pos) of v's in-edges — exactly one
        partition owns them (paper: the interval containing v)."""
        vi = int(self.intervals.to_internal(v))
        pi = int(self.intervals.interval_of(vi))
        return [(pi, int(pos)) for pos in self.partitions[pi].in_edges(vi)]

    def out_neighbors(self, v: int) -> np.ndarray:
        vi = int(self.intervals.to_internal(v))
        chunks = []
        for part in self.partitions:
            pos = part.out_edges(vi)
            if pos.size:
                chunks.append(part.dst[pos])
        if not chunks:
            return np.empty(0, dtype=np.int64)
        return np.asarray(self.intervals.to_original(np.concatenate(chunks)))

    def in_neighbors(self, v: int) -> np.ndarray:
        vi = int(self.intervals.to_internal(v))
        pi = int(self.intervals.interval_of(vi))
        part = self.partitions[pi]
        pos = part.in_edges(vi)
        if pos.size == 0:
            return np.empty(0, dtype=np.int64)
        return np.asarray(self.intervals.to_original(part.src[pos]))

    def out_neighbors_batch(self, vs: Sequence[int]) -> List[np.ndarray]:
        """Batched out-neighbor query, one array per queried vertex (legacy
        shape; the flat CSR-grouped form lives on `storage_engine()`)."""
        vals, offsets = self.storage_engine().out_neighbors_batch(vs)
        return [vals[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]

    # -- exports ----------------------------------------------------------------
    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) in original IDs, live edges only, partition order."""
        ss, dd = [], []
        for part in self.partitions:
            live = (
                np.ones(part.n_edges, dtype=bool) if part.dead is None else ~part.dead
            )
            ss.append(part.src[live])
            dd.append(part.dst[live])
        s = np.concatenate(ss) if ss else np.empty(0, np.int64)
        d = np.concatenate(dd) if dd else np.empty(0, np.int64)
        return (np.asarray(self.intervals.to_original(s)),
                np.asarray(self.intervals.to_original(d)))

    def partition_sizes(self) -> np.ndarray:
        return np.asarray([p.n_edges for p in self.partitions])
