"""The port's multi-hop operators and query facades (repro_torch/core) against
the reference's (repro/core), on the same edges: a bulk `GraphPAL`, a live
`LSMTree` fed the same insert and delete batches (flushed levels,
tombstones, a buffered tail), its pinned `read_view()`, and a port
`GraphPAL` rebuilt from the reference's arrays by `convert`. Results are
vertex ids and integer counts, so every comparison is exact; the port's
dense path runs on the CPU (its plain torch version)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import multihop as tmh

N, E = 400, 3000


def edges(seed: int):
    """Power-law in-degrees (a zipf head of hubs) over uniform sources."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    hot = ((rng.zipf(1.8, E) - 1) * 2654435761) % N
    dst = np.where(rng.random(E) < 0.5, hot, rng.integers(0, N, E))
    return src, dst


def bulk(pkg, seed: int):
    src, dst = edges(seed)
    return pkg.GraphPAL.from_edges(src, dst, n_partitions=8, max_id=N - 1)


def live(pkg, seed: int):
    """LSM with flushed levels, tombstones and a still-buffered tail: the
    same batches into either package."""
    src, dst = edges(seed)
    t = pkg.LSMTree(pkg.IntervalMap.for_capacity(N - 1, 16), n_levels=3,
                    branching=4, buffer_cap=E // 8,
                    max_partition_edges=E // 4)
    k = E - E // 10
    t.insert_edges(src[:k], dst[:k])
    t.insert_edges(src[k:], dst[k:])
    rng = np.random.default_rng(seed + 1)
    for i in rng.choice(k, 60, replace=False):
        t.delete_edge(int(src[i]), int(dst[i]))
    return t


def same_two_hop(a, b):
    assert np.array_equal(a.seeds, b.seeds)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.counts, b.counts)
    assert a.ids.dtype == b.ids.dtype and a.counts.dtype == b.counts.dtype


def same_khop(a, b):
    assert len(a.levels) == len(b.levels)
    for x, y in zip(a.levels, b.levels):
        assert np.array_equal(x, y)
    assert np.array_equal(a.visited, b.visited)


def check_store(ref, port, seed: int):
    """Every multi-hop operator and facade, reference vs port."""
    rng = np.random.default_rng(seed)
    seeds = rng.choice(N, 24, replace=False)
    for kw in ({}, {"max_friends": 3}, {"exclude": False},
               {"direction": "in"}):
        same_two_hop(R.two_hop_counts(ref, seeds, **kw),
                     T.two_hop_counts(port, seeds, **kw))
    for kw in ({}, {"exclude": False}, {"direction": "in"}):
        want = R.two_hop_counts(ref, seeds, **kw)
        same_two_hop(want, T.two_hop_counts(port, seeds, dense="kernel",
                                            device="cpu", **kw))
        same_two_hop(want, R.two_hop_counts(ref, seeds, dense="kernel", **kw))
    for dense in ("never", "stream", "kernel"):
        for direction in ("out", "in"):
            same_khop(R.khop(ref, seeds[:3], 3, direction, dense=dense),
                      T.khop(port, seeds[:3], 3, direction, dense=dense,
                             device="cpu"))
    assert R.triangle_count(ref) == T.triangle_count(port)
    assert (R.triangle_count(ref, wedge_budget=50)
            == T.triangle_count(port, wedge_budget=50))
    s, t = (int(v) for v in seeds[:2])
    assert R.bfs(ref, s, 4) == T.bfs(port, s, 4, device="cpu")
    for two_sided in (True, False):
        assert (R.shortest_path(ref, s, t, 6, two_sided)
                == T.shortest_path(port, s, t, 6, two_sided, device="cpu"))
    assert np.array_equal(R.friends_of_friends(ref, s),
                          T.friends_of_friends(port, s))


@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_store_matches_reference(seed):
    check_store(bulk(R, seed), bulk(T, seed), seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_live_lsm_matches_reference(seed):
    ref, port = live(R, seed), live(T, seed)
    assert sum(len(b) for b in port.buffers) > 0     # a buffered tail
    assert port.n_edges == ref.n_edges
    check_store(ref, port, seed)


def test_pinned_read_view_matches_reference():
    ref, port = live(R, 2), live(T, 2)
    with ref.read_view() as rv, port.read_view() as pv:
        check_store(rv, pv, 2)


def test_convert_pal_from_reference_arrays():
    ref = bulk(R, 3)
    port = convert.pal_from_arrays(convert.pal_to_arrays(ref))
    assert isinstance(port, T.GraphPAL)
    for a, b in zip(ref.to_coo(), port.to_coo()):
        assert np.array_equal(a, b)
    check_store(ref, port, 3)


def test_dense_plans_are_memoized_per_device():
    g = bulk(T, 4)
    plan = T.dense_plan(g, "out", device="cpu")
    assert T.dense_plan(g, "out", device="cpu") is plan
    assert plan.device.type == "cpu"
    keys = [k for k in T.as_engine(g).plan_cache() if k[0][0] == tmh._PLAN_KEY]
    assert [k[0][1:] for k in keys] == [("out", "cpu")]
    # the auto heuristic takes the kernel only where a plan is memoized
    assert tmh._plan_cached(T.as_engine(g), "out", "cpu")
    assert not tmh._plan_cached(T.as_engine(g), "out", "cuda")


@pytest.mark.parametrize("direction", ["out", "in"])
def test_plan_of_a_multigraph_is_the_plan_of_its_distinct_edges(direction):
    """build_frontier_plan of raw edges with repeats and self-loops equals,
    tensor for tensor, `dense_plan`'s, which builds from the store's
    deduplicated keys."""
    from repro_torch.kernels.frontier_expand import build_frontier_plan
    src, dst = edges(5)
    src = np.concatenate([src, src[:500], np.arange(0, N, 7)])
    dst = np.concatenate([dst, dst[:500], np.arange(0, N, 7)])
    g = T.GraphPAL.from_edges(src, dst, n_partitions=8, max_id=N - 1)
    eng = T.as_engine(g)
    M = eng.n_internal_vertices
    s, d = (np.asarray(eng.intervals.to_internal(v), np.int64)
            for v in (src, dst))
    raw = build_frontier_plan(*((s, d) if direction == "out" else (d, s)),
                              M, M, "cpu")
    plan = T.dense_plan(g, direction, device="cpu")
    assert raw.n_edges == plan.n_edges < src.shape[0]
    for f in dataclasses.fields(plan):
        a, b = getattr(raw, f.name), getattr(plan, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n,hi", [(0, 5), (1, 5), (2000, 7), (50_000, 2**40),
                                  (50_000, 100)])
def test_unique_sorted_is_np_unique(n, hi):
    """The edge keys' dedup (a sort and a neighbour compare) gives what
    np.unique gives: the sorted distinct values, negatives included."""
    rng = np.random.default_rng(n + hi)
    a = rng.integers(-hi, hi, n, dtype=np.int64)
    got = tmh._unique_sorted(a)
    want = np.unique(a)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_snapshot_paths_wait_for_the_psw_slice():
    """The PSW slice has landed: both snapshot paths compile the live state
    into the port's DeviceGraph (held against the reference in
    tests/test_torch_psw.py), and device=None still means the GPU."""
    port = live(T, 5)
    dg = port.snapshot(device="cpu")
    assert isinstance(dg, T.DeviceGraph) and dg.n_edges == port.n_edges
    with port.read_view() as view:
        vdg = view.snapshot(device="cpu", with_window_plan=False)
        assert vdg.n_edges == dg.n_edges and vdg.send_idx is None
        assert torch.equal(vdg.src, dg.src)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                view.snapshot()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.snapshot()


@pytest.mark.parametrize("current", [0, 1])
def test_plan_cache_key_names_one_device_once(monkeypatch, current):
    """None, "cuda" and "cuda:<current device>" are one plan key, so a plan
    built under one spelling is found under another and never built twice;
    another index is another key. Checked without a card: torch.cuda's
    availability and current device are stubbed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    here = f"cuda:{current}"
    assert (tmh._device_key(None) == tmh._device_key("cuda")
            == tmh._device_key(torch.device("cuda"))
            == tmh._device_key(here) == here)
    assert tmh._device_key(f"cuda:{1 - current}") == f"cuda:{1 - current}"
    assert tmh._device_key("cpu") == "cpu"
    # a plan memoized under "cuda:<current>" is seen by the auto heuristic
    # asking with device=None (as bfs does)
    g = bulk(T, 6)
    eng = T.as_engine(g)
    eng.plan_cache()[((tmh._PLAN_KEY, "out", here), eng.cache_token())] = 0
    assert tmh._plan_cached(eng, "out", None)
    assert tmh._plan_cached(eng, "out", "cuda")
    assert not tmh._plan_cached(eng, "out", f"cuda:{1 - current}")


# ---------------------------------------------------------------------------
# the dense two-hop answer, assembled on the device, at its edge cases
# ---------------------------------------------------------------------------
# vertices past RAND_SRC take no random out-edges, only these: a 2-cycle
# (A <-> B), a self-loop (SL), a target that is also a friend (P -> Q -> R,
# P -> R), a sink (in-edges only) and R, whose one friend is the sink
SINK, A, B, SL, P, Q, R_ = N - 1, N - 2, N - 3, N - 4, N - 5, N - 6, N - 7
RAND_SRC = N - 8
CRAFTED = [(A, B), (B, A), (B, 5), (SL, SL), (SL, Q), (P, Q), (P, R_),
           (P, R_), (Q, R_), (Q, P), (Q, 7), (R_, SINK)]


def fof_store(pkg):
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, RAND_SRC, E), rng.integers(0, N, E)
    cs, cd = np.asarray(CRAFTED).T
    return pkg.GraphPAL.from_edges(np.concatenate([src, cs]),
                                   np.concatenate([dst, cd]),
                                   n_partitions=8, max_id=N - 1)


def _drawn(n):
    return np.random.default_rng(n).choice(N, n, replace=False)


DENSE_CASES = {
    **{f"seeds{n}": (lambda n=n: _drawn(n), {}) for n in (1, 127, 128, 129,
                                                           256)},
    # the same seed within a block and across the block edge
    "duplicates": (lambda: np.concatenate([_drawn(100), [A, A, SL],
                                           _drawn(60), [A, SL, P]]), {}),
    "two_cycle": (lambda: np.array([A, B]), {}),
    "self_loop": (lambda: np.array([SL]), {}),
    "friend_target": (lambda: np.array([P, Q]), {}),
    "no_out_edges": (lambda: np.concatenate([[SINK], _drawn(20)]), {}),
    "empty_answer": (lambda: np.array([SINK, R_, SINK]), {}),
    "keep_friends": (lambda: np.concatenate([_drawn(129), [A, SL, P]]),
                     {"exclude": False}),
    "in_edges": (lambda: np.concatenate([_drawn(129), [A, SL, P, SINK]]),
                 {"direction": "in"}),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_two_hop_answer_matches_reference(case):
    """The port's dense two-hop, which excludes friends by a gather from
    the hop-1 panel and sorts and reads back the answer on the device,
    bitwise against the reference's sparse and dense answers."""
    make, kw = DENSE_CASES[case]
    seeds = make()
    ref, port = fof_store(R), fof_store(T)
    got = T.two_hop_counts(port, seeds, dense="kernel", device="cpu", **kw)
    for dense in ("never", "kernel"):
        same_two_hop(R.two_hop_counts(ref, seeds, dense=dense, **kw), got)
    for f in ("offsets", "ids", "counts"):
        a = getattr(got, f)
        assert isinstance(a, np.ndarray) and a.dtype == np.int64, f
    if case == "empty_answer":
        assert got.ids.shape[0] == 0
    if case == "friend_target":
        # R is P's friend and reached through Q: excluded from P's answer
        assert R_ not in got.ids[got.slice_of(0)]
    if case in ("two_cycle", "self_loop"):
        assert seeds[0] not in got.ids[got.slice_of(0)]
    if case == "keep_friends":
        # kept: A reaches itself through B, SL through its loop, R from P
        for i, (v, t) in enumerate([(A, A), (SL, SL), (P, R_)], 129):
            assert seeds[i] == v and t in got.ids[got.slice_of(i)]
