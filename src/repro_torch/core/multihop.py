"""Vectorized multi-hop execution over PAL/LSM slabs (DESIGN.md §10).

The query layer's single-hop primitives (engine.py) already beat per-vertex
calls ~40x by batching a whole frontier per slab probe; this module applies
the same set-at-a-time treatment ACROSS hops. A multi-hop query is composed
from four columnar operators — the factorized-list style of Gupta et al.
(PAPERS.md) over the paper's partitioned adjacency lists:

  * `expand`    — one hop for the whole frontier at once: flat
                  (owner, neighbor) pairs straight off the slab scan, no
                  per-vertex regrouping (engine.expand_frontier);
  * `filter`    — `EdgePredicate`, pushed INTO the slab scan: the predicate
                  is evaluated on edge-array positions before the endpoint
                  gather, so non-matching edges never materialize;
  * `semijoin`  — membership of packed keys against a sorted key set
                  (searchsorted), used for per-seed exclusion sets,
                  visited-set subtraction, and edge-set closure probes;
  * `aggregate` — distinct/count reduction of packed (group, value) keys
                  via one sort-unique.

Everything between engine calls is columnar numpy on packed int64 keys
(`group * n_internal_vertices + vertex`); per-hop dedup and frontier
compaction are sort/unique/searchsorted, never a Python loop over vertices.

Dense frontiers additionally get a device path: a `FrontierPlan`
(kernels/frontier_expand) lays the store's deduplicated edge set out as
virtual-row ELL tiles and a CUDA kernel expands indicator columns on the
GPU; `khop(dense="auto")` picks sparse probes, a bottom-up edge
stream, or the kernel by frontier density (§10.3). Plans and packed edge-key
sets are memoized on the engine's `plan_cache()` keyed by `cache_token()`,
so a `ManifestView` shares them across every reader of one publication and
a mutated store can never serve a stale plan.

All operators speak only the `StorageEngine` protocol — they run identically
on a live `LSMTree`, a bulk `GraphPAL`, an mmap-backed `GraphDB`, and a
lock-free `ManifestView` epoch snapshot.

Port of the reference `repro/core/multihop.py`: the host operators are a
copy; the dense path runs on a torch device. `device=None` means CUDA and
raises when no card is present; `device="cpu"` runs the kernel's plain
torch version. Plans stay resident on their device (memoized per device),
indicator panels are scattered there, hop 1's counts stay there for hop 2,
and only the nonzero indices and counts come back to the host.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import telemetry
from .engine import StorageEngine, _expand_ranges, as_engine

_M_HOPS = telemetry.counter("multihop.hops")

GraphLike = Any

__all__ = [
    "EdgePredicate",
    "KHopResult",
    "TwoHopResult",
    "aggregate_counts",
    "compact_frontier",
    "dense_plan",
    "expand",
    "khop",
    "semijoin",
    "triangle_count",
    "two_hop_counts",
]

# dense plans keep (n_internal_vertices × frontier_block) float32 indicator
# panels resident; past this vertex count the panel alone would dwarf the
# frontier work, so `dense="auto"` never picks the kernel path above it
DENSE_MAX_VERTICES = 4_000_000
_SEED_BLOCK = 128  # dense 2-hop: one kernel feature-tile of seed columns


# ---------------------------------------------------------------------------
# Columnar set primitives (sorted int64 arrays)
# ---------------------------------------------------------------------------
def compact_frontier(ids) -> np.ndarray:
    """Sorted-unique int64 frontier from any raw id batch."""
    return np.unique(np.asarray(ids, np.int64).ravel())


def semijoin(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Membership mask of `keys` (any order) against a SORTED key set —
    one searchsorted, the operator behind exclusion sets and closure
    probes."""
    keys = np.asarray(keys, np.int64)
    if table.shape[0] == 0:
        return np.zeros(keys.shape[0], bool)
    i = np.minimum(np.searchsorted(table, keys), table.shape[0] - 1)
    return table[i] == keys


def aggregate_counts(keys: np.ndarray):
    """Distinct packed keys + multiplicities: one sort-unique, the columnar
    GROUP BY COUNT over (group, value) keys."""
    return np.unique(np.asarray(keys, np.int64), return_counts=True)


def _setdiff_sorted(a: np.ndarray, table: np.ndarray) -> np.ndarray:
    """a (sorted) minus a sorted key set, order preserved."""
    return a[~semijoin(a, table)]


def _union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted arrays with b disjoint from a (one merge pass)."""
    if a.shape[0] == 0:
        return b
    if b.shape[0] == 0:
        return a
    return np.insert(a, np.searchsorted(a, b), b)


def _csr_offsets(groups: np.ndarray, n_groups: int) -> np.ndarray:
    offsets = np.zeros(n_groups + 1, np.int64)
    np.cumsum(np.bincount(groups, minlength=n_groups), out=offsets[1:])
    return offsets


# ---------------------------------------------------------------------------
# filter — predicate pushdown into the slab scan
# ---------------------------------------------------------------------------
_OPS = {
    "==": operator.eq, "!=": operator.ne,
    "<": operator.lt, "<=": operator.le,
    ">": operator.gt, ">=": operator.ge,
}


@dataclasses.dataclass(frozen=True)
class EdgePredicate:
    """Edge filter evaluated per slab on edge-array POSITIONS, before any
    endpoint gather — the engine drops failing positions, so filtered-out
    edges never reach the query layer (only their etype/attribute cells are
    read, positionally, per the paper's columnar edge-value layout §4.3).

    `etype` filters the type column; `column`/`op`/`value` filter one named
    attribute column. Both present means AND."""

    etype: Optional[int] = None
    column: Optional[str] = None
    op: str = ">="
    value: float = 0.0

    def mask(self, slab, pos: np.ndarray) -> np.ndarray:
        keep = np.ones(pos.shape[0], bool)
        if self.etype is not None:
            keep &= np.asarray(slab.etype_at(pos)) == self.etype
        if self.column is not None:
            col = np.asarray(slab.column_at(self.column, pos, np.float64))
            keep &= _OPS[self.op](col, self.value)
        return keep


# ---------------------------------------------------------------------------
# expand — one whole-frontier hop
# ---------------------------------------------------------------------------
def expand(g: GraphLike, frontier, direction: str = "out",
           predicate: Optional[EdgePredicate] = None):
    """One hop for the whole frontier: flat (owner index, neighbor) pairs in
    original ids, ungrouped. The multi-hop building block — downstream
    operators re-sort by packed keys anyway, so the per-vertex CSR regroup
    of `out_neighbors_batch` is skipped."""
    return as_engine(g).expand_frontier(frontier, direction, predicate)


def _expand_grouped(eng: StorageEngine, vs: np.ndarray, direction: str,
                    predicate: Optional[EdgePredicate]):
    """CSR regrouping of expand() by owner: (values, offsets) like
    `out_neighbors_batch`, but predicate-capable."""
    owner, nb = eng.expand_frontier(vs, direction, predicate)
    order = np.argsort(owner, kind="stable")
    return nb[order], _csr_offsets(owner, vs.shape[0])


def _expand_stream(eng: StorageEngine, frontier: np.ndarray,
                   direction: str = "out") -> np.ndarray:
    """Bottom-up expansion (Beamer / paper §7.4): stream every live edge
    once and keep endpoints whose other side is in the frontier — O(|E|)
    sequential, cheaper than per-slab probes once the frontier is a large
    fraction of V."""
    iv = eng.intervals
    n = eng.n_internal_vertices
    mask = np.zeros(n + 1, bool)
    mask[np.minimum(frontier, n)] = True
    out = []
    for chunk in eng.edge_chunks():
        key = chunk.src if direction == "out" else chunk.dst
        m = mask[np.asarray(iv.to_original(key), np.int64)]
        if m.any():
            other = chunk.dst if direction == "out" else chunk.src
            out.append(np.asarray(iv.to_original(other[m]), np.int64))
    if not out:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(out))


# ---------------------------------------------------------------------------
# Dense path: virtual-row ELL plan + CUDA frontier-expansion kernel
# ---------------------------------------------------------------------------
_PLAN_KEY = "multihop:dense_plan"
_EDGE_KEYS = "multihop:edge_keys"


def _memoized(eng: StorageEngine, name: str, builder):
    token = eng.cache_token()
    if token is None:
        return builder()
    cache = eng.plan_cache()
    key = (name, token)
    val = cache.get(key)
    if val is None:
        val = cache[key] = builder()
    return val


def _edge_keys_internal(eng: StorageEngine) -> np.ndarray:
    """Sorted-unique packed (src * M + dst) keys of the live edge set,
    internal ids — the closure table for semijoin probes (triangles) and
    the input to dense plans. Memoized per store content."""
    def build():
        M = np.int64(eng.n_internal_vertices)
        parts = [np.asarray(c.src, np.int64) * M + np.asarray(c.dst, np.int64)
                 for c in eng.edge_chunks()]
        if not parts:
            return np.empty(0, np.int64)
        from ..kernels.frontier_expand.ops import unique_sorted
        return unique_sorted(np.concatenate(parts))
    return _memoized(eng, _EDGE_KEYS, build)


def _resolve_device(device, what: str = "the dense frontier path"
                    ) -> torch.device:
    """`None` means the GPU: the device paths never drop to the CPU unless
    the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is present; pass "
                "device='cpu' for the plain torch version")
        return torch.device("cuda")
    return torch.device(device)


def _device_key(device) -> str:
    """One key per physical device: `None`, "cuda" and "cuda:<current>"
    name the same plan, so a plan built under one spelling is found (and
    never built twice) under another."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def dense_plan(g: GraphLike, direction: str = "out", device=None):
    """Build (or fetch the memoized) frontier-expansion plan: the store's
    deduplicated edge set as destination-grouped virtual-row ELL tiles
    (kernels/frontier_expand), resident on `device`. `direction="in"`
    builds the transposed plan."""
    eng = as_engine(g)
    dev = _resolve_device(device)
    M = eng.n_internal_vertices
    if M > DENSE_MAX_VERTICES:
        raise ValueError(
            f"dense plan disabled above {DENSE_MAX_VERTICES} internal "
            f"vertices (store has {M}): the indicator panel would dominate")

    def build():
        from ..kernels.frontier_expand import build_frontier_plan, plan_to_device
        keys = _edge_keys_internal(eng)
        s = keys // M
        d = keys % M
        if direction == "out":
            plan = build_frontier_plan(s, d, n_src=M, n_dst=M)
        else:
            plan = build_frontier_plan(d, s, n_src=M, n_dst=M)
        return plan_to_device(plan, dev)

    return _memoized(eng, (_PLAN_KEY, direction, _device_key(dev)), build)


def _plan_cached(eng: StorageEngine, direction: str, device=None) -> bool:
    token = eng.cache_token()
    return (token is not None
            and ((_PLAN_KEY, direction, _device_key(device)), token)
            in eng.plan_cache())


def _indicator(M: int, rows: torch.Tensor) -> torch.Tensor:
    """(M, len(rows)) float32 panel on `rows`' device with column j set at
    row rows[j] — scattered there, never built on the host."""
    x = torch.zeros((M, rows.shape[0]), dtype=torch.float32,
                    device=rows.device)
    x[rows, torch.arange(rows.shape[0], device=rows.device)] = 1.0
    return x


def _expand_dense(eng: StorageEngine, frontier: np.ndarray,
                  direction: str, device=None) -> np.ndarray:
    """Kernel hop: scatter the frontier into a one-column indicator on the
    device, run the frontier-expansion kernel, read back the touched
    destinations."""
    from ..kernels.frontier_expand import frontier_expand_counts
    plan = dense_plan(eng, direction, device)
    dev = plan.idx.device
    iv = eng.intervals
    fi = torch.from_numpy(np.asarray(iv.to_internal(frontier), np.int64))
    x = torch.zeros((eng.n_internal_vertices, 1), dtype=torch.float32,
                    device=dev)
    x[fi.to(dev), 0] = 1.0
    counts = frontier_expand_counts(plan, x)
    nxt = torch.nonzero(counts[:, 0] > 0).squeeze(1).cpu().numpy()
    return np.sort(np.asarray(iv.to_original(nxt), np.int64))


def _hop_mode(eng: StorageEngine, frontier_size: int, dense: str,
              threshold: float, predicate, device=None) -> str:
    """The density heuristic (§10.3). Predicates force the sparse path —
    pushdown only exists in the slab scan. Below `threshold · |V|` the
    frontier is sparse: per-slab searchsorted probes touch only adjacent
    edges. Above it, every edge is worth a look: use the kernel plan when
    one is already memoized on `device` for this store content (repeated
    analytics amortized it) and the store is small enough to hold
    indicator panels; otherwise a one-shot bottom-up edge stream, which
    needs no prep."""
    if predicate is not None or dense == "never":
        return "sparse"
    supported = getattr(eng, "supported_hop_modes",
                        ("sparse", "stream", "kernel"))
    if dense in ("kernel", "stream"):
        # an engine that cannot serve the requested mode (the sharded
        # scatter/gather engine only probes) clamps to sparse
        # rather than erroring: mode is an execution hint, not semantics
        return dense if dense in supported else "sparse"
    if frontier_size <= threshold * eng.n_internal_vertices:
        return "sparse"
    if ("kernel" in supported and _plan_cached(eng, "out", device)
            and eng.n_internal_vertices <= DENSE_MAX_VERTICES):
        return "kernel"
    return "stream" if "stream" in supported else "sparse"


# ---------------------------------------------------------------------------
# k-hop expansion (BFS levels) with columnar visited-set management
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KHopResult:
    """levels[d] = vertices first reached at depth d (sorted); levels[0] is
    the compacted seed set. visited = sorted union of all levels."""

    levels: list
    visited: np.ndarray

    def depth_of(self, v: int) -> Optional[int]:
        for d, lv in enumerate(self.levels):
            i = np.searchsorted(lv, v)
            if i < lv.shape[0] and lv[i] == v:
                return d
        return None


def khop(g: GraphLike, seeds, k: int, direction: str = "out",
         predicate: Optional[EdgePredicate] = None, dense: str = "auto",
         dense_threshold: float = 0.05, device=None) -> KHopResult:
    """Whole-frontier k-hop expansion. Each hop expands the previous level
    in ONE engine call (or one kernel launch / edge stream, per the density
    heuristic), then subtracts the visited set and merges — all columnar.
    With `predicate`, only edges passing the pushed-down filter are
    traversed (attribute-filtered traversal). Kernel hops run on `device`
    (None: the GPU)."""
    eng = as_engine(g)
    frontier = compact_frontier(seeds)
    visited = frontier
    levels = [frontier]
    for hop in range(k):
        if frontier.shape[0] == 0:
            break
        mode = _hop_mode(eng, frontier.shape[0], dense, dense_threshold,
                         predicate, device)
        with telemetry.span("multihop.hop", hop=hop, mode=mode,
                            frontier=int(frontier.shape[0])) as sp:
            if mode == "kernel":
                nxt = _expand_dense(eng, frontier, direction, device)
            elif mode == "stream":
                nxt = _expand_stream(eng, frontier, direction)
            else:
                _, nb = eng.expand_frontier(frontier, direction, predicate)
                nxt = np.unique(nb)
            fresh = _setdiff_sorted(nxt, visited)
            sp.tag(fresh=int(fresh.shape[0]))
            _M_HOPS.inc(label=mode)
        if fresh.shape[0] == 0:
            break
        visited = _union_sorted(visited, fresh)
        levels.append(fresh)
        frontier = fresh
    return KHopResult(levels, visited)


# ---------------------------------------------------------------------------
# 2-hop intersection: friends-of-friends with counts
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TwoHopResult:
    """CSR per seed: ids[offsets[i]:offsets[i+1]] are seed i's two-hop
    vertices (sorted), counts[...] the number of DISTINCT middle friends
    through which each is reachable — the paper's FoF answer (§8.4) plus
    the intersection cardinality."""

    seeds: np.ndarray
    offsets: np.ndarray
    ids: np.ndarray
    counts: np.ndarray

    def slice_of(self, i: int) -> slice:
        return slice(int(self.offsets[i]), int(self.offsets[i + 1]))


def _empty_two_hop(seeds: np.ndarray) -> TwoHopResult:
    return TwoHopResult(seeds, np.zeros(seeds.shape[0] + 1, np.int64),
                        np.empty(0, np.int64), np.empty(0, np.int64))


def two_hop_counts(g: GraphLike, seeds, direction: str = "out",
                   max_friends: Optional[int] = None, exclude: bool = True,
                   predicate: Optional[EdgePredicate] = None,
                   dense: str = "never", device=None) -> TwoHopResult:
    """Friends-of-friends with counts for a whole seed batch: expand twice,
    dedup (seed, friend) and (path, target) pairs on packed keys, aggregate
    distinct middles per (seed, target), and semijoin away the seeds' own
    friend sets (`exclude`, the paper's selectOut filter).

    `max_friends` truncates each seed's friend list to its first
    `max_friends` in sorted id order — bitwise the per-seed semantics of
    `query.friends_of_friends`. `dense="kernel"` routes both hops through
    the frontier-expansion plan on `device` (None: the GPU; requires no
    predicate/truncation); results are bitwise-identical to the sparse path
    (§10.4)."""
    n_seeds = int(np.asarray(seeds).size)
    with telemetry.span("multihop.two_hop", seeds=n_seeds, dense=dense):
        return _two_hop_counts(g, seeds, direction, max_friends, exclude,
                               predicate, dense, device)


def _two_hop_counts(g, seeds, direction, max_friends, exclude, predicate,
                    dense, device=None) -> TwoHopResult:
    eng = as_engine(g)
    seeds = np.asarray(seeds, np.int64).ravel()
    S = seeds.shape[0]
    if S == 0:
        return _empty_two_hop(seeds)
    if dense == "kernel":
        if predicate is not None or max_friends is not None:
            raise ValueError("dense 2-hop supports neither predicates nor "
                             "max_friends truncation")
        return _two_hop_dense(eng, seeds, direction, exclude, device)
    M = np.int64(eng.n_internal_vertices)

    # hop 1 + aggregate: distinct (seed, friend), sorted by packed key
    owner, nb = eng.expand_frontier(seeds, direction, predicate)
    fk = np.unique(owner * M + nb)
    s_idx, fr = fk // M, fk % M
    if max_friends is not None:
        cnt = np.bincount(s_idx, minlength=S)
        starts = np.repeat(np.cumsum(cnt) - cnt, cnt)
        keep = np.arange(fk.shape[0]) - starts < max_friends
        fk, s_idx, fr = fk[keep], s_idx[keep], fr[keep]
    if fr.shape[0] == 0:
        return _empty_two_hop(seeds)

    # hop 2 on the UNIQUE friend set, joined back to (seed, friend) pairs
    uf = np.unique(fr)
    vals, offs = _expand_grouped(eng, uf, direction, predicate)
    fpos = np.searchsorted(uf, fr)
    pos, pair = _expand_ranges(offs[fpos], offs[fpos + 1],
                               np.arange(fr.shape[0], dtype=np.int64))
    # aggregate twice: distinct (path, target) collapses multi-edges, then
    # distinct-middle counts per (seed, target)
    pk = np.unique(pair * M + vals[pos])
    sk, counts = aggregate_counts(s_idx[pk // M] * M + pk % M)
    if exclude:
        selfk = np.arange(S, dtype=np.int64) * M + seeds
        keep = ~(semijoin(sk, fk) | semijoin(sk, selfk))
        sk, counts = sk[keep], counts[keep]
    return TwoHopResult(seeds, _csr_offsets(sk // M, S), sk % M,
                        counts.astype(np.int64))


def _two_hop_dense(eng: StorageEngine, seeds: np.ndarray, direction: str,
                   exclude: bool, device=None) -> TwoHopResult:
    """Kernel 2-hop: seeds become indicator columns; hop 1 is binarized to
    the distinct-friend panel, hop 2's accumulation IS the distinct-middle
    count (float32 counts are integer-exact far below 2**24). Seeds stream
    through in `_SEED_BLOCK`-column panels. Panels, hop 1's counts and the
    binarized panel stay on the device; only nonzero (vertex, column)
    indices and counts cross to the host.

    Its phases are the spans `x.multihop.*` under `multihop.two_hop`: per
    block `expand` (host enqueue only), then `readback` and `id_map` in
    turn for the answer and for the friend set; `assemble` after the last
    block. None synchronizes: a `readback` lasts as long as the host waits
    for the block's hops."""
    from ..kernels.frontier_expand import frontier_expand_counts
    plan = dense_plan(eng, direction, device)
    dev = plan.idx.device
    iv = eng.intervals
    M = np.int64(eng.n_internal_vertices)
    S = seeds.shape[0]
    si = torch.from_numpy(np.asarray(iv.to_internal(seeds), np.int64)).to(dev)
    sk_parts, cnt_parts, fk_parts = [], [], []
    # each (M, B) panel is freed once consumed: 2 GB at 4M vertices
    for c0 in range(0, S, _SEED_BLOCK):
        with telemetry.span("x.multihop.expand"):
            x = _indicator(int(M), si[c0:c0 + _SEED_BLOCK])
            c1 = frontier_expand_counts(plan, x)        # (M, B) 0/1: edges
            del x
            c2 = frontier_expand_counts(plan, (c1 > 0).to(torch.float32))
        with telemetry.span("x.multihop.readback"):
            nz = torch.nonzero(c2)
            cnt = torch.round(c2[nz[:, 0], nz[:, 1]]).to(torch.int64)
            del c2
            nz = nz.cpu().numpy()
            w, j = nz[:, 0], nz[:, 1]
            cnt_parts.append(cnt.cpu().numpy())
        with telemetry.span("x.multihop.id_map"):
            wo = np.asarray(iv.to_original(w), np.int64)
            sk_parts.append((c0 + j) * M + wo)
        if exclude:
            with telemetry.span("x.multihop.readback"):
                fnz = torch.nonzero(c1).cpu().numpy()
            with telemetry.span("x.multihop.id_map"):
                fk_parts.append(
                    (c0 + fnz[:, 1]) * M
                    + np.asarray(iv.to_original(fnz[:, 0]), np.int64))
        del c1
    with telemetry.span("x.multihop.assemble"):
        if not sk_parts:
            return _empty_two_hop(seeds)
        sk = np.concatenate(sk_parts)
        counts = np.concatenate(cnt_parts)
        if exclude:
            fk = np.sort(np.concatenate(fk_parts)) if fk_parts \
                else np.empty(0, np.int64)
            selfk = np.arange(S, dtype=np.int64) * M + seeds
            keep = ~(semijoin(sk, fk) | semijoin(sk, selfk))
            sk, counts = sk[keep], counts[keep]
        order = np.argsort(sk)  # (seed, target-id) order, matching sparse
        sk, counts = sk[order], counts[order]
        return TwoHopResult(seeds, _csr_offsets(sk // M, S), sk % M, counts)


# ---------------------------------------------------------------------------
# Triangle counting: wedge cross-product + edge-set semijoin
# ---------------------------------------------------------------------------
def triangle_count(g: GraphLike, middles=None,
                   wedge_budget: int = 4_000_000) -> int:
    """Directed closed-wedge count: |{(u, v, w) : u→v, v→w, u→w}| over the
    DISTINCT edge set, summed per middle vertex v. Per chunk of middles the
    (distinct in-nbr × distinct out-nbr) wedge cross-product is built
    columnar and semijoined against the packed edge-key set; `wedge_budget`
    bounds resident wedges (chunks are sized by the degree product
    estimate, fetched via the no-gather degree batch)."""
    eng = as_engine(g)
    iv = eng.intervals
    M = np.int64(eng.n_internal_vertices)
    ekeys = _edge_keys_internal(eng)
    if ekeys.shape[0] == 0:
        return 0
    if middles is None:
        # only a vertex with both in- and out-edges closes a wedge
        mids_i = np.intersect1d(np.unique(ekeys // M), np.unique(ekeys % M),
                                assume_unique=True)
        mids = np.sort(np.asarray(iv.to_original(mids_i), np.int64))
    else:
        mids = compact_frontier(middles)
    if mids.shape[0] == 0:
        return 0
    est = eng.in_degree_batch(mids) * eng.out_degree_batch(mids)
    nz = est > 0
    mids, est = mids[nz], est[nz]
    total = 0
    cum = np.cumsum(est)
    start = 0
    while start < mids.shape[0]:
        limit = (cum[start - 1] if start else 0) + wedge_budget
        stop = max(int(np.searchsorted(cum, limit, side="right")), start + 1)
        total += _triangle_chunk(eng, mids[start:stop], ekeys, M)
        start = stop
    return int(total)


def _triangle_chunk(eng: StorageEngine, mids: np.ndarray, ekeys: np.ndarray,
                    M: np.int64) -> int:
    iv = eng.intervals
    o_in, u = eng.expand_frontier(mids, "in")
    if u.shape[0] == 0:
        return 0
    o_out, w = eng.expand_frontier(mids, "out")
    if w.shape[0] == 0:
        return 0
    # aggregate to distinct (middle, neighbor), internal ids for the probe
    ik = np.unique(o_in * M + np.asarray(iv.to_internal(u), np.int64))
    ok = np.unique(o_out * M + np.asarray(iv.to_internal(w), np.int64))
    io_, iu = ik // M, ik % M
    oo_, ow = ok // M, ok % M
    ooff = _csr_offsets(oo_, mids.shape[0])
    # expand: every in-entry against its middle's whole out-range
    pos, ie = _expand_ranges(ooff[io_], ooff[io_ + 1],
                             np.arange(io_.shape[0], dtype=np.int64))
    if pos.shape[0] == 0:
        return 0
    # semijoin the wedges against the edge-set closure table
    return int(semijoin(iu[ie] * M + ow[pos], ekeys).sum())
