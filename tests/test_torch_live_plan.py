"""The live dense plan (core/multihop.py's `_LivePlan`): dense hops on read
views of a live `LSMTree` run on a base plan kept across publications plus
the view's signed delta from the store's log of changes of key presence
(the tree's `MutationLog`, read through `StorageEngine.log_entries`). Every answer is held
bitwise against the sparse host path on the same view and against the
dense path over a plan rebuilt from scratch (a `GraphPAL` of the view's
edges), on the CPU (the kernel's plain torch version). Counters of
`x.multihop.base_builds` show where the base was, and was not, rebuilt."""
import numpy as np
import pytest

import repro_torch.core as T
from repro_torch.core import multihop as tmh
from repro_torch.core import telemetry
from repro_torch.core.lsm import MutationLog

N = 300


@pytest.fixture(autouse=True)
def telemetry_on():
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(was)


def builds() -> int:
    return int(telemetry.snapshot()["counters"].get(
        "x.multihop.base_builds", 0))


def tree(buffer_cap=400, max_partition_edges=800):
    return T.LSMTree(T.IntervalMap.for_capacity(N - 1, 16), n_levels=3,
                     branching=4, buffer_cap=buffer_cap,
                     max_partition_edges=max_partition_edges)


def fill(t, seed=0, n=2000):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, n), rng.integers(0, N, n)
    t.insert_edges(src, dst)
    return src, dst


def same(a, b):
    for f in ("seeds", "offsets", "ids", "counts"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def check(view, seeds, direction="out"):
    """The dense answers on `view` against the sparse path on it and the
    dense path over a plan built from scratch of its edges; khop too."""
    dense = T.two_hop_counts(view, seeds, direction=direction,
                             dense="kernel", device="cpu")
    same(dense, T.two_hop_counts(view, seeds, direction=direction))
    fresh = T.GraphPAL.from_edges(*view.to_coo(), n_partitions=8,
                                  max_id=N - 1)
    same(dense, T.two_hop_counts(fresh, seeds, direction=direction,
                                 dense="kernel", device="cpu"))
    kd = T.khop(view, seeds[:8], 3, direction=direction, dense="kernel",
                device="cpu")
    ks = T.khop(fresh, seeds[:8], 3, direction=direction)
    assert len(kd.levels) == len(ks.levels)
    for a, b in zip(kd.levels, ks.levels):
        assert np.array_equal(a, b)
    return dense


def seeds_of(*vs):
    """Seeds that reach the written keys, with others besides."""
    rest = np.random.default_rng(7).choice(N, 40, replace=False)
    return np.unique(np.concatenate([np.asarray(vs, np.int64).ravel(),
                                     rest]))


def slot_of(t, direction="out"):
    """The tree's live dense plan slot, as the engine hands it out."""
    with t.read_view() as v:
        return v.storage_engine().live_state()[
            (tmh._PLAN_KEY, direction, "cpu")]


def warm(t, seeds, direction="out"):
    """Build the base on the current view; returns the builds after."""
    with t.read_view() as v:
        check(v, seeds, direction)
    return builds()


@pytest.mark.parametrize("direction", ["out", "in"])
def test_repeated_edges_count_once(direction):
    t = tree()
    fill(t)
    seeds = seeds_of(3, 5, 8)
    n = warm(t, seeds, direction)
    # new repeated edges, and repeats of keys the base already holds
    t.insert_edges([3, 3, 3, 5, 5], [9, 9, 9, 11, 11])
    src, dst = t.to_coo()
    t.insert_edges(src[:50], dst[:50])
    with t.read_view() as v:
        check(v, seeds, direction)
    assert builds() == n


def test_a_delete_removes_every_copy_of_its_key():
    t = tree()
    fill(t)
    t.insert_edges([4, 4, 4], [17, 17, 17])
    seeds = seeds_of(4)
    n = warm(t, seeds)
    assert t.delete_edge(4, 17)
    with t.read_view() as v:
        assert not np.isin(17, v.out_neighbors(4))
        check(v, seeds)
    assert builds() == n


def test_a_delete_then_a_reinsert():
    t = tree()
    src, dst = fill(t)
    s, d = int(src[10]), int(dst[10])
    seeds = seeds_of(s, d)
    n = warm(t, seeds)
    assert t.delete_edge(s, d)
    between = t.read_view()
    t.insert_edge(s, d)
    with t.read_view() as after:
        assert np.isin(d, after.out_neighbors(s))
        check(after, seeds)
    assert not np.isin(d, between.out_neighbors(s))
    check(between, seeds)
    between.release()
    assert builds() == n


def test_an_insert_of_a_present_key_adds_nothing_to_the_delta():
    t = tree()
    src, dst = fill(t)
    seeds = seeds_of(src[:5])
    warm(t, seeds)
    slot = slot_of(t)
    t.insert_edges(src[:20], dst[:20])         # every key already present
    with t.read_view() as v:
        check(v, seeds)
    assert slot.live.n == 0
    t.insert_edges([1, 1], [299, 299])       # (1, 299) twice: one entry
    with t.read_view() as v:
        check(v, seeds)
    was = bool(np.any((src == 1) & (dst == 299)))
    assert slot.live.ent_sign[:slot.live.n].tolist() == ([] if was else [1])


def test_a_flush_and_a_pushdown_between_two_views():
    t = tree(buffer_cap=10_000, max_partition_edges=600)
    t.auto_flush = False
    src, dst = fill(t)
    seeds = seeds_of(src[:6])
    n = warm(t, seeds)
    t.insert_edges([6, 7], [8, 9])
    t.delete_edge(int(src[0]), int(dst[0]))
    before = t.read_view()
    check(before, seeds)
    pushdowns = t.stats.pushdown_merges
    t.flush_all()
    assert t.stats.pushdown_merges > pushdowns
    with t.read_view() as after:
        assert after.manifest.log_seq == before.manifest.log_seq
        a, b = check(before, seeds), check(after, seeds)
        same(a, b)           # merges change no key's presence
    before.release()
    assert builds() == n


def test_an_older_pinned_view_answers_after_newer_writes():
    t = tree()
    src, dst = fill(t)
    seeds = seeds_of(src[:10])
    n = warm(t, seeds)
    old = t.read_view()
    for i in range(10):
        t.delete_edge(int(src[i]), int(dst[i]))
        t.insert_edges([int(dst[i])], [int(src[i])])
    with t.read_view() as new:
        check(new, seeds)
    check(old, seeds)                        # a prefix of the delta
    assert builds() == n
    # a view pinned before the base was built gets a plan of its own
    t2 = tree()
    fill(t2, seed=3)
    first = t2.read_view()
    t2.insert_edges([1, 2], [3, 4])
    n = warm(t2, seeds)
    same(check(first, seeds),
         T.two_hop_counts(first, seeds))
    assert builds() == n
    first.release()
    old.release()


def test_a_base_rebuild_past_the_threshold_is_counted(monkeypatch):
    monkeypatch.setattr(tmh, "LIVE_DELTA_MAX", 6)
    t = tree()
    src, dst = fill(t)
    seeds = seeds_of(src[:10])
    n = warm(t, seeds)
    for i in range(5):
        t.delete_edge(int(src[i]), int(dst[i]))
    with t.read_view() as v:
        check(v, seeds)
    assert builds() == n                     # 5 entries: under the limit
    for i in range(5, 10):
        t.delete_edge(int(src[i]), int(dst[i]))
    with t.read_view() as v:
        check(v, seeds)
    assert builds() == n + 1                 # 10 entries: rebuilt
    assert slot_of(t).live.n == 0


def test_a_log_that_no_longer_reaches_back_rebuilds():
    t = tree()
    src, dst = fill(t)
    seeds = seeds_of(src[:4])
    n = warm(t, seeds)
    t.oplog.cut()                            # as a quarantine does
    t.insert_edges([1], [2])
    with t.read_view() as v:
        check(v, seeds)
    assert builds() == n + 1


def test_the_delta_span_tags_its_entries():
    t = tree()
    src, dst = fill(t)
    seeds = seeds_of(src[:4])
    warm(t, seeds)
    t.insert_edges([290, 291], [292, 293])
    telemetry.trace_events(clear=True)
    with t.read_view() as v:
        T.two_hop_counts(v, seeds, dense="kernel", device="cpu")
    spans = [e for e in telemetry.trace_events(clear=True)
             if e["name"] == "x.multihop.delta"]
    assert [e["args"]["delta_edges"] for e in spans] == [2]


def test_a_bulk_graphpal_reaches_no_delta_code(monkeypatch):
    rng = np.random.default_rng(5)
    g = T.GraphPAL.from_edges(rng.integers(0, N, 2000),
                              rng.integers(0, N, 2000), n_partitions=8,
                              max_id=N - 1)
    assert T.as_engine(g).live_position() is None
    assert T.as_engine(g).log_entries(0, 1) is None

    def never(*a, **kw):
        raise AssertionError("the live path on a bulk store")
    monkeypatch.setattr(tmh, "_live_inputs", never)
    monkeypatch.setattr(tmh, "_apply_delta", never)
    seeds = seeds_of(1, 2, 3)
    same(T.two_hop_counts(g, seeds, dense="kernel", device="cpu"),
         T.two_hop_counts(g, seeds))
    telemetry.trace_events(clear=True)
    T.khop(g, seeds[:4], 2, dense="kernel", device="cpu")
    assert not [e for e in telemetry.trace_events(clear=True)
                if e["name"].startswith("x.multihop.delta")]


def test_the_mutation_log_keeps_its_last_entries(monkeypatch):
    monkeypatch.setattr(MutationLog, "KEEP", 10)
    log = MutationLog()
    log.append(np.arange(4, dtype=np.int64), 1)
    log.append(7, -1, 1)
    keys, signs = log.entries(2, 5)
    assert keys.tolist() == [2, 3, 7] and signs.tolist() == [1, 1, -1]
    for i in range(4):
        log.append(np.arange(4, dtype=np.int64) + 10 * i, 1)
    assert log.seq == 21 and log.start > 0
    assert log.entries(0, 21) is None
    keys, _ = log.entries(log.start, log.seq)
    assert keys.shape[0] == log.seq - log.start >= 10
    log.cut()
    assert log.entries(21, 22) is None and log.start == log.seq == 22


def test_the_mutation_log_holds_entries_for_its_followers(monkeypatch):
    """With no follower only the last LAG entries are held; a follower
    holds every entry from the position it has read up to; a cut drops
    the followers with the entries."""
    monkeypatch.setattr(MutationLog, "LAG", 4)
    log = MutationLog()
    for i in range(6):
        log.append(np.arange(2, dtype=np.int64) + 10 * i, 1)
    assert log.start == 8 and log.entries(6, 12) is None
    assert log.entries(8, 12, follower="f")[0].tolist() == [40, 41, 50, 51]
    for i in range(6, 12):
        log.append(np.arange(2, dtype=np.int64) + 10 * i, 1)
    assert log.start == 12                   # held from the follower's 12
    keys, _ = log.entries(12, 24, follower="f")
    assert keys.shape[0] == 12
    log.append(np.arange(2, dtype=np.int64), 1)
    assert log.start == 24                   # from the follower's 24 on
    log.cut()
    for i in range(4):
        log.append(np.arange(2, dtype=np.int64), 1)
    assert log.start == log.seq - 4          # no follower left: LAG again


def test_an_idle_store_holds_few_log_entries():
    """A store that no live plan follows holds only the last LAG entries,
    whatever it ingests (a bulk ingest keeps no log of its own)."""
    t = tree(buffer_cap=10 ** 6)
    rng = np.random.default_rng(3)
    for _ in range(6):
        t.insert_edges(rng.integers(0, N, 1000), rng.integers(0, N, 1000))
    held = t.oplog.seq - t.oplog.start
    assert t.oplog.seq == 6000 and held <= MutationLog.LAG
