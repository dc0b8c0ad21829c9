"""`GraphDB.bulk_load`: a store's initial edges written straight into its
leaf partitions. Held against online `insert_edges` of the same arrays as an
edge multiset with columns, recovered bitwise by `GraphDB.open`, with the
WAL's later writes replayed on reopen, and served live by a `ServiceDB`
whose dense hops on read views equal the sparse host path."""
import os
import shutil

import numpy as np
import pytest

import repro_torch.core as T
from repro_torch.core.disk import DiskPartition

N, E = 500, 6000
GEOMETRY = dict(n_partitions=16, n_levels=3, branching=4, buffer_cap=800,
                max_partition_edges=1500, persist_min_edges=64,
                column_dtypes={"time": np.int64})


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    src[:200], dst[:200] = src[200:400], dst[200:400]       # repeated edges
    return (src, dst, rng.integers(0, 8, E).astype(np.int8),
            rng.integers(0, 1 << 40, E))


def rows(store):
    """Every live edge as sorted (src, dst, etype, time) rows, original
    ids: partitions of every level, the buffers and in-flight drains."""
    tree = getattr(store, "tree", store)
    parts = []
    for part in tree.all_partitions():
        live = (np.ones(part.n_edges, bool) if part.dead is None
                else ~np.asarray(part.dead))
        parts.append((np.asarray(part.src)[live], np.asarray(part.dst)[live],
                      np.asarray(part.etype)[live],
                      np.asarray(part.columns["time"])[live]))
    stagings = [b.staging() for b in tree.buffers if len(b)]
    stagings += [st for st, _ in tree.pending_stagings()]
    for st in stagings:
        parts.append((st.src, st.dst, st.etype, st.columns["time"]))
    s, d, t, c = (np.concatenate([p[i] for p in parts]) for i in range(4))
    iv = tree.intervals
    out = np.stack([iv.to_original(s), iv.to_original(d), t.astype(np.int64),
                    c])
    return out[:, np.lexsort(out[::-1])]


def loaded(path, seed=0):
    src, dst, ety, tm = arrays(seed)
    return T.GraphDB.bulk_load(str(path), src, dst, N - 1, etype=ety,
                               columns={"time": tm}, **GEOMETRY)


def test_bulk_load_holds_what_online_inserts_hold(tmp_path):
    db = loaded(tmp_path / "bulk")
    src, dst, ety, tm = arrays()
    online = T.GraphDB.create(str(tmp_path / "online"), max_id=N - 1,
                              **GEOMETRY)
    online.insert_edges(src, dst, etype=ety, columns={"time": tm})
    assert np.array_equal(rows(db), rows(online))
    leaves = db.tree.levels[-1]
    assert all(isinstance(p, DiskPartition) for p in leaves)
    assert all(p.n_edges == 0 for lv in db.tree.levels[:-1] for p in lv)
    assert sum(p.n_edges for p in leaves) == E
    with db.read_view() as v:
        assert v.n_edges == E
    db.close()
    online.close()


def test_reopen_recovers_the_load_bitwise(tmp_path):
    db = loaded(tmp_path / "db")
    before = [tuple(np.asarray(a).copy() for a in (
        p.src, p.dst, p.etype, p.columns["time"], p.dst_perm))
        for p in db.tree.levels[-1]]
    digests = sorted(os.listdir(os.path.join(db.dir, "parts")))
    db.close()
    back = T.GraphDB.open(str(tmp_path / "db"))
    assert sorted(os.listdir(os.path.join(back.dir, "parts"))) == digests
    for want, part in zip(before, back.tree.levels[-1]):
        got = (part.src, part.dst, part.etype, part.columns["time"],
               part.dst_perm)
        for a, b in zip(want, got):
            assert np.array_equal(a, np.asarray(b)) and a.dtype == b.dtype
    back.close()


@pytest.mark.parametrize("crash", [False, True])
def test_wal_writes_after_the_load_replay_on_reopen(tmp_path, crash):
    """After a close, and after a crash (the directory copied while the
    store is live: its manifest is the load's, its WAL every later write,
    each flushed to the OS as it was acknowledged)."""
    db = loaded(tmp_path / "db")
    src, dst, _, _ = arrays()
    rng = np.random.default_rng(1)
    db.insert_edges(rng.integers(0, N, 900), rng.integers(0, N, 900),
                    columns={"time": rng.integers(0, 99, 900)})
    for i in range(0, 60, 3):
        assert db.delete_edge(int(src[i]), int(dst[i]))
        assert db.update_edge_column(int(src[i + 1]), int(dst[i + 1]),
                                     "time", -i)
    want = rows(db)
    path = tmp_path / "db"
    if crash:
        path = tmp_path / "crash"
        shutil.copytree(tmp_path / "db", path)
    db.close()
    back = T.GraphDB.open(str(path))
    assert np.array_equal(rows(back), want)
    back.close()


def test_bulk_load_refuses_what_does_not_fit(tmp_path):
    src, dst, _, tm = arrays()
    with pytest.raises(ValueError, match="columns"):
        T.GraphDB.bulk_load(str(tmp_path / "a"), src, dst, N - 1,
                            **GEOMETRY)
    with pytest.raises(ValueError, match="outside"):
        T.GraphDB.bulk_load(str(tmp_path / "b"), src, dst, N - 2,
                            columns={"time": tm}, **GEOMETRY)
    with pytest.raises(ValueError, match="one entry"):
        T.GraphDB.bulk_load(str(tmp_path / "c"), src, dst[:-1], N - 1,
                            columns={"time": tm}, **GEOMETRY)


def test_a_service_over_a_bulk_load_serves_dense_views(tmp_path):
    """The live deployment: a bulk-loaded store under a ServiceDB with its
    pipeline, link writes between requests, dense friends-of-friends on
    each request's read view equal to the sparse path on it, and one base
    plan for the whole run."""
    from repro_torch.core import telemetry
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    svc = T.ServiceDB(loaded(tmp_path / "db"), checkpoint_interval_ops=400)
    try:
        src, dst, _, _ = arrays()
        rng = np.random.default_rng(2)
        seeds = rng.choice(N, 64, replace=False)
        c = telemetry.snapshot()["counters"]
        builds0 = int(c.get("x.multihop.base_builds", 0))
        for r in range(12):
            svc.insert_edges(rng.integers(0, N, 28), rng.integers(0, N, 28),
                             columns={"time": rng.integers(0, 99, 28)})
            for i in rng.integers(0, E, 7):
                svc.delete_edge(int(src[i]), int(dst[i]))
                svc.update_edge_column(int(dst[i]), int(src[i]), "time", r)
            with svc.read_view() as v:
                got = T.two_hop_counts(v, seeds, dense="kernel", device="cpu")
                want = T.two_hop_counts(v, seeds)
            for f in ("offsets", "ids", "counts"):
                assert np.array_equal(getattr(got, f), getattr(want, f))
        c = telemetry.snapshot()["counters"]
        assert int(c.get("x.multihop.base_builds", 0)) == builds0 + 1
    finally:
        svc.close()
        telemetry.set_enabled(was)
