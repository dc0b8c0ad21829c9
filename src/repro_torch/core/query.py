"""Graph queries over any StorageEngine (paper §4.2, §7.4, §8.4).

Implements the paper's query set:
  * friends-of-friends (FoF) with the frontier-batched out-edge strategy,
  * frontier traversal with the direction-optimizing top-down/bottom-up
    switch of Beamer et al. that the paper adopts in §7.4,
  * depth-limited unweighted shortest path (one- or two-sided BFS, §8.4).

The public operators are thin facades over the columnar
multi-hop layer (core/multihop.py, DESIGN.md §10): per-hop dedup, visited
sets, and meets are packed-key sort/unique/searchsorted, never Python
loops over vertices. The earlier per-hop implementations are kept as
`*_perhop` — they are the measured baselines in benchmarks/bench_multihop
and the reference oracles in tests/test_multihop.py; their answers are
bitwise-identical to the columnar path.

Every operator speaks only the vectorized set-at-a-time `StorageEngine`
interface (engine.py, DESIGN.md §5) — the same code path serves a bulk-built
`GraphPAL`, a live `LSMTree` (all levels + in-memory buffers), an on-disk
`GraphDB`, and a lock-free `ManifestView`, with no storage-class branching
anywhere in this module.

Port of the reference `repro/core/query.py`: a host copy whose `bfs`,
`shortest_path` and `friends_of_friends` pass `device` on to the
multi-hop operators' dense path.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

import numpy as np

from . import multihop as mh
from .engine import StorageEngine, as_engine

# a StorageEngine, or any store exposing storage_engine() — duck-typed via
# as_engine(), deliberately not a Union over concrete storage classes
GraphLike = Any

__all__ = [
    "Frontier",
    "bfs",
    "bfs_perhop",
    "consistent_engine",
    "dedup_frontier",
    "friends_of_friends",
    "friends_of_friends_perhop",
    "shortest_path",
    "shortest_path_perhop",
    "traverse_out",
]


class Frontier:
    """A set of vertices (original IDs) flowing through traversal operators —
    the paper's Scala-API frontier (§7.4)."""

    def __init__(self, ids: Sequence[int]):
        self.ids = np.unique(np.asarray(list(ids), dtype=np.int64))

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def has_vertex(self, v: int) -> bool:
        i = np.searchsorted(self.ids, v)
        return bool(i < self.ids.shape[0] and self.ids[i] == v)


def dedup_frontier(g: GraphLike, ids, visited=None,
                   degree_order: bool = False) -> np.ndarray:
    """Compact a raw neighbor batch into the next frontier: sorted-unique,
    minus the already-visited set, so repeated hops never re-expand a
    duplicate or settled vertex. With `degree_order`, the survivors are
    reordered by DESCENDING live out-degree (one no-gather degree batch):
    heavy hitters go first, which is the order truncated traversals keep
    and the order that fills slab ranges widest-first."""
    ids = np.unique(np.asarray(ids, np.int64).ravel())
    if visited is not None:
        vis = np.unique(np.asarray(list(visited), np.int64).ravel())
        if vis.shape[0]:
            ids = ids[~mh.semijoin(ids, vis)]
    if degree_order and ids.shape[0]:
        deg = as_engine(g).out_degree_batch(ids)
        ids = ids[np.argsort(-deg, kind="stable")]
    return ids


def _bottom_up_step(eng: StorageEngine, frontier_ids: np.ndarray,
                    visited=None) -> np.ndarray:
    """Bottom-up sweep (paper §7.4 / Beamer): stream ALL edges once and emit
    destinations whose source is in the frontier. Cost O(|E|/B) sequential —
    cheaper than per-vertex queries when the frontier is a large fraction of
    V. The frontier is compacted first (dedup_frontier) so the membership
    mask is built from distinct, still-unexpanded vertices only."""
    ids = dedup_frontier(eng, frontier_ids, visited=visited)
    n_vert = eng.n_internal_vertices
    mask = np.zeros(n_vert + 1, dtype=bool)
    mask[np.minimum(ids, n_vert)] = True
    iv = eng.intervals
    next_ids = []
    for chunk in eng.edge_chunks():
        src_orig = np.asarray(iv.to_original(chunk.src), dtype=np.int64)
        m = mask[src_orig]
        if m.any():
            next_ids.append(np.asarray(iv.to_original(chunk.dst[m]), np.int64))
    return np.concatenate(next_ids) if next_ids else np.empty(0, np.int64)


def traverse_out(g: GraphLike, frontier: Frontier,
                 bottom_up_threshold: float = 0.05,
                 visited=None) -> Frontier:
    """One traversal hop with the direction-optimizing switch (paper §7.4):
    if the frontier exceeds a fraction of |V|, sweep bottom-up over all
    edges instead of issuing batched out-edge queries. `visited` vertices
    are dropped from the frontier before expansion — a repeated hop never
    re-expands them."""
    eng = as_engine(g)
    ids = dedup_frontier(eng, frontier.ids, visited=visited)
    n_vert = eng.n_internal_vertices
    if (ids.shape[0] > bottom_up_threshold * n_vert
            and "stream" in getattr(eng, "supported_hop_modes",
                                    ("sparse", "stream", "kernel"))):
        # engines that cannot stream the whole edge set (the sharded
        # scatter/gather engine) stay on the batched probe path
        nbrs = _bottom_up_step(eng, ids)
    else:
        nbrs, _ = eng.out_neighbors_batch(ids)
    return Frontier(nbrs)


@contextlib.contextmanager
def consistent_engine(g: GraphLike):
    """One pinned StorageEngine for a multi-op read session, uniform over
    every tier: a `ServiceDB` yields its lock-free epoch view's
    engine, a `ShardRouter` pins one manifest in EVERY shard worker and
    yields the scatter/gather engine over those pins, and anything else
    (GraphPAL, LSMTree, GraphDB, ManifestView, Snapshot) passes through
    `as_engine` unchanged. The pin — single- or multi-process — is released
    on exit, so traversals composed of many engine calls (khop, FoF, BFS)
    read one frozen state per store regardless of concurrent writers."""
    pin_view = getattr(g, "pin_view", None)       # ShardRouter
    read_view = getattr(g, "read_view", None)     # ServiceDB / GraphDB
    if pin_view is not None:
        with pin_view() as view:
            yield view.storage_engine()
    elif read_view is not None:
        with read_view() as view:
            yield view.storage_engine()
    else:
        yield as_engine(g)


# ---------------------------------------------------------------------------
# Columnar operators (the public path)
# ---------------------------------------------------------------------------
def friends_of_friends(g: GraphLike, v: int,
                       max_friends: Optional[int] = None,
                       device=None) -> np.ndarray:
    """Paper §8.4: W = {w : ∃u, (v,u) ∈ E, (u,w) ∈ E}, excluding the friends
    themselves (and v). One columnar 2-hop (multihop.two_hop_counts) —
    bitwise the per-hop answer, including the sorted-first-`max_friends`
    truncation. `device` is where a dense hop would run (None: the GPU);
    this facade's 2-hop stays sparse."""
    res = mh.two_hop_counts(g, np.asarray([v], np.int64),
                            max_friends=max_friends, device=device)
    return res.ids[:int(res.offsets[1])]


def bfs(g: GraphLike, source: int, max_depth: int = 5,
        bottom_up_threshold: float = 0.05, device=None) -> dict:
    """Direction-optimizing BFS; returns {vertex: depth} for reached
    vertices. Levels come from the columnar k-hop operator — visited-set
    subtraction is a packed-key semijoin per hop, and dense frontiers take
    the bottom-up stream (or a memoized kernel plan) per the §10.3
    heuristic; only the final dict is materialized per vertex. Kernel hops
    run on `device` (None: the GPU), and only once a plan is memoized
    there."""
    res = mh.khop(g, [source], max_depth,
                  dense_threshold=bottom_up_threshold, device=device)
    depth = {}
    for d, level in enumerate(res.levels):
        for u in level.tolist():
            depth[u] = d
    return depth


def _lookup_sorted(ids: np.ndarray, dep: np.ndarray,
                   keys: np.ndarray) -> np.ndarray:
    """Depths of `keys` (all present) in the sorted id/depth columns."""
    return dep[np.searchsorted(ids, keys)]


def shortest_path(g: GraphLike, s: int, t: int, max_depth: int = 5,
                  two_sided: bool = True, device=None) -> Optional[int]:
    """Depth-limited unweighted shortest path (paper §8.4). Two-sided search
    expands the smaller frontier each round (backward over the batched
    in-neighbor primitive); meets are columnar: one semijoin of the new
    level against the other side's visited column, with the MINIMUM over
    all meeting vertices (the per-hop baseline settled for the first meet
    in id order). Search stops once no future meet can beat the best.
    `device` is where the one-sided search's kernel hops run (see `bfs`)."""
    eng = as_engine(g)
    if s == t:
        return 0
    if not two_sided:
        return bfs(eng, s, max_depth, device=device).get(int(t))

    f_ids = np.asarray([s], np.int64)
    f_dep = np.zeros(1, np.int64)
    b_ids = np.asarray([t], np.int64)
    b_dep = np.zeros(1, np.int64)
    f_lev, b_lev = f_ids, b_ids
    df = db = 0
    best = None
    while df + db < max_depth and (f_lev.shape[0] or b_lev.shape[0]):
        fwd = f_lev.shape[0] > 0 and (b_lev.shape[0] == 0
                                      or f_lev.shape[0] <= b_lev.shape[0])
        if fwd:
            _, nb = eng.expand_frontier(f_lev, "out")
            df += 1
            nxt = np.unique(nb)
            met = nxt[mh.semijoin(nxt, b_ids)]
            if met.shape[0]:
                cand = df + int(_lookup_sorted(b_ids, b_dep, met).min())
                best = cand if best is None else min(best, cand)
            f_lev = nxt[~mh.semijoin(nxt, f_ids)]
            pos = np.searchsorted(f_ids, f_lev)
            f_ids = np.insert(f_ids, pos, f_lev)
            f_dep = np.insert(f_dep, pos, df)
        else:
            _, nb = eng.expand_frontier(b_lev, "in")
            db += 1
            nxt = np.unique(nb)
            met = nxt[mh.semijoin(nxt, f_ids)]
            if met.shape[0]:
                cand = int(_lookup_sorted(f_ids, f_dep, met).min()) + db
                best = cand if best is None else min(best, cand)
            b_lev = nxt[~mh.semijoin(nxt, b_ids)]
            pos = np.searchsorted(b_ids, b_lev)
            b_ids = np.insert(b_ids, pos, b_lev)
            b_dep = np.insert(b_dep, pos, db)
        if best is not None and best <= df + db:
            break
    if best is not None and best <= max_depth:
        return best
    return None


# ---------------------------------------------------------------------------
# Per-hop baselines (earlier implementations, kept verbatim for the
# bench_multihop speedup gates and as test oracles)
# ---------------------------------------------------------------------------
def friends_of_friends_perhop(g: GraphLike, v: int,
                              max_friends: Optional[int] = None) -> np.ndarray:
    """Per-hop FoF: two grouped batch calls glued by Python (the earlier
    strategy the columnar operator is benchmarked against)."""
    eng = as_engine(g)
    friends, _ = eng.out_neighbors_batch(np.asarray([v], dtype=np.int64))
    friends = np.unique(friends)
    if max_friends is not None and friends.shape[0] > max_friends:
        friends = friends[:max_friends]
    if friends.size == 0:
        return np.empty(0, np.int64)
    fof, _ = eng.out_neighbors_batch(friends)
    fof = np.unique(fof)
    # exclude friends and the query vertex (paper's selectOut filter)
    return np.setdiff1d(fof, np.concatenate([friends, [v]]), assume_unique=False)


def bfs_perhop(g: GraphLike, source: int, max_depth: int = 5,
               bottom_up_threshold: float = 0.05) -> dict:
    """Per-hop BFS: one batched hop per level, visited-set management in a
    Python dict — the interpreter-bound loop bench_multihop measures."""
    eng = as_engine(g)
    depth = {int(source): 0}
    frontier = Frontier([source])
    for d in range(1, max_depth + 1):
        nxt = traverse_out(eng, frontier, bottom_up_threshold)
        fresh = [int(u) for u in nxt.ids if int(u) not in depth]
        if not fresh:
            break
        for u in fresh:
            depth[u] = d
        frontier = Frontier(fresh)
    return depth


def shortest_path_perhop(g: GraphLike, s: int, t: int, max_depth: int = 5,
                         two_sided: bool = True) -> Optional[int]:
    """Per-hop two-sided search; settles for the FIRST meeting vertex in id
    order (not necessarily the minimum over the meet set — the columnar
    path fixes that)."""
    eng = as_engine(g)
    if s == t:
        return 0
    if not two_sided:
        d = bfs_perhop(eng, s, max_depth)
        return d.get(int(t))

    fwd = {int(s): 0}
    bwd = {int(t): 0}
    f_front, b_front = Frontier([s]), Frontier([t])
    for _ in range(max_depth):
        if len(f_front) == 0 and len(b_front) == 0:
            return None
        expand_fwd = len(f_front) <= len(b_front) and len(f_front) > 0
        if expand_fwd or len(b_front) == 0:
            nxt = traverse_out(eng, f_front)
            fresh = []
            base = max(fwd.values())
            for u in nxt.ids:
                u = int(u)
                if u in bwd:
                    return base + 1 + bwd[u]
                if u not in fwd:
                    fwd[u] = base + 1
                    fresh.append(u)
            f_front = Frontier(fresh)
        else:
            # backward hop over in-neighbors, one batched query
            nbrs, _ = eng.in_neighbors_batch(b_front.ids)
            nbrs = np.unique(nbrs)
            fresh = []
            base = max(bwd.values())
            for u in nbrs:
                u = int(u)
                if u in fwd:
                    return fwd[u] + 1 + base
                if u not in bwd:
                    bwd[u] = base + 1
                    fresh.append(u)
            b_front = Frontier(fresh)
        total = max(fwd.values()) + max(bwd.values())
        if total >= max_depth and len(f_front) == 0 and len(b_front) == 0:
            break
    return None
