"""The port's on-disk tier (repro_torch/core/disk.py and the failpoints,
integrity, codec and WAL modules under it) against the reference's
(repro/core/disk.py), on the CPU.

Exact throughout: partition files and whole `GraphDB` directories written
by the same operations are byte-identical across the two packages; each
package opens the other's store to equal answers; close→reopen and
crash→reopen are bitwise; out-of-core PSW and dense hops over a reopened
port store equal the reference's. The one tolerance is device PageRank of
a snapshot against the reference's, rtol 1e-5 / atol 1e-6 as in
tests/test_torch_psw.py: the reference sums each destination in float32,
the port in float64 rounded once."""
import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import disk as rdisk
from repro.core import psw as rpsw
import repro_torch.core as T
from repro_torch.core import disk as tdisk
from repro_torch.core import failpoints as tfp
from repro_torch.core import psw as tpsw
from repro_torch.kernels import psw_spmm as tps
from repro_torch.kernels import segment_ell as tse
from test_torch_psw import same_device_graph

MAX_ID = 9999
OPTS = dict(max_id=MAX_ID, n_partitions=16, n_levels=3, branching=4,
            buffer_cap=2000, max_partition_edges=8000, persist_min_edges=512,
            column_dtypes={"w": np.float32})


def tree_bytes(path):
    """{relative path: bytes} of every file under `path`."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for name in files:
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, path)] = open(full, "rb").read()
    return out


def drive(mod, path, seed: int = 0, n_chunks: int = 6, chunk: int = 5000,
          tail: int = 3000):
    """One seeded sequence through `mod.GraphDB`: inserts with a column, a
    mid-way checkpoint, deletes, column writes, a checkpoint, then a WAL
    tail of inserts. Returns the live store."""
    rng = np.random.default_rng(seed)
    db = mod.GraphDB.create(path, **OPTS)
    kept = []
    for i in range(n_chunks):
        s = rng.integers(0, MAX_ID + 1, chunk)
        d = rng.integers(0, MAX_ID + 1, chunk)
        db.insert_edges(s, d, columns={"w": rng.random(chunk).astype(
            np.float32)})
        kept.append((s[:40], d[:40]))
        if i == 2:
            db.checkpoint()
    for s, d in kept[:3]:
        for a, b in zip(s[:10].tolist(), d[:10].tolist()):
            db.delete_edge(a, b)
    for s, d in kept[3:]:
        for a, b in zip(s[10:15].tolist(), d[10:15].tolist()):
            db.update_edge_column(a, b, "w", 7.5)
    db.checkpoint()
    s = rng.integers(0, MAX_ID + 1, tail)
    d = rng.integers(0, MAX_ID + 1, tail)
    db.insert_edges(s, d, columns={"w": rng.random(tail).astype(np.float32)})
    db.delete_edge(int(s[0]), int(d[0]))
    db.tree.wal_flush()
    return db


def coo(db):
    s, d = db.to_coo()
    return np.asarray(s), np.asarray(d)


def same_coo(a, b) -> bool:
    return all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))


def same_two_hop(a, b) -> bool:
    return (np.array_equal(a.offsets, b.offsets)
            and np.array_equal(a.ids, b.ids)
            and np.array_equal(a.counts, b.counts))


def same_neighbours(x, y, vs) -> bool:
    return all(np.array_equal(x.out_neighbors(v), y.out_neighbors(v))
               and np.array_equal(x.in_neighbors(v), y.in_neighbors(v))
               for v in vs)


# -- partition files ----------------------------------------------------------
@pytest.mark.parametrize("n_edges,cols,checksums",
                         [(0, False, True), (1, False, True),
                          (5000, True, True), (5000, True, False),
                          (20000, False, True)])
def test_partition_file_byte_identical(tmp_path, n_edges, cols, checksums):
    rng = np.random.default_rng(n_edges)
    src = rng.integers(0, 2000, n_edges)
    dst = rng.integers(0, 500, n_edges)
    columns = ({"w": rng.random(n_edges).astype(np.float32),
                "t": rng.integers(0, 9, n_edges).astype(np.int32)}
               if cols else {})
    rp = R.build_partition((0, 500), src, dst, columns=columns)
    tp = T.build_partition((0, 500), src, dst, columns=columns)
    assert R.partition_digest(rp) == T.partition_digest(tp)
    R.write_partition_file(str(tmp_path / "r.pal"), rp, checksums=checksums)
    T.write_partition_file(str(tmp_path / "t.pal"), tp, checksums=checksums)
    raw = open(tmp_path / "r.pal", "rb").read()
    assert open(tmp_path / "t.pal", "rb").read() == raw
    # each package reads the other's file to the same arrays
    for mod, name in ((R, "t.pal"), (T, "r.pal")):
        dp = mod.open_partition_file(str(tmp_path / name))
        for f in ("src", "dst", "etype", "dst_perm", "src_vertices",
                  "src_ptr", "dst_vertices", "dst_ptr"):
            assert np.array_equal(getattr(dp, f), getattr(rp, f)), f
        for k in columns:
            assert np.array_equal(dp.columns[k], rp.columns[k]), k


# -- whole directories ----------------------------------------------------------
def test_graphdb_directories_byte_identical(tmp_path):
    rdb = drive(R, str(tmp_path / "ref"))
    tdb = drive(T, str(tmp_path / "port"))
    assert len(tdb._disk_partitions()) > 0, "nothing was flushed to disk"
    want = tree_bytes(str(tmp_path / "ref"))
    assert {k.split(os.sep)[0] for k in want} == {"parts", "wal",
                                                  "MANIFEST.json"}
    assert any(k.endswith(".dead.npy") for k in want)
    assert tree_bytes(str(tmp_path / "port")) == want
    assert tdb.resident_nbytes() == rdb.resident_nbytes()
    rdb.close()
    tdb.close()
    assert tree_bytes(str(tmp_path / "port")) == tree_bytes(
        str(tmp_path / "ref"))


@pytest.mark.parametrize("writer,reader", [(R, T), (T, R)])
def test_each_package_opens_the_others_store(tmp_path, writer, reader):
    path = str(tmp_path / "db")
    w = drive(writer, path, seed=1)
    want = coo(w)
    vs = list(range(0, MAX_ID + 1, 97))
    crash = str(tmp_path / "crash")
    shutil.copytree(path, crash)            # the writer is still live
    got = reader.GraphDB.open(crash)
    assert same_coo(coo(got), want)
    assert got.n_edges == w.n_edges
    assert same_neighbours(got, w, vs)
    w.close()
    got = reader.GraphDB.open(path)
    assert same_coo(coo(got), want)
    assert same_neighbours(got, w, vs)


@pytest.mark.parametrize("crash", [False, True])
def test_reopen_bitwise(tmp_path, crash):
    path = str(tmp_path / "db")
    db = drive(T, path, seed=2)
    want = coo(db)
    vs = list(range(3, MAX_ID + 1, 89))
    nbrs = {v: (db.out_neighbors(v), db.in_neighbors(v)) for v in vs}
    if crash:
        path = str(tmp_path / "crash")
        shutil.copytree(str(tmp_path / "db"), path)
    else:
        db.close()
    db2 = T.GraphDB.open(path)
    assert same_coo(coo(db2), want)
    assert db2.n_edges == want[0].shape[0]
    for v, (o, i) in nbrs.items():
        assert np.array_equal(db2.out_neighbors(v), o)
        assert np.array_equal(db2.in_neighbors(v), i)


def test_kill_between_manifest_writes_through_failpoints(tmp_path):
    """A checkpoint killed after MANIFEST.json.tmp is written but before its
    atomic rename (the port's `manifest.rename` failpoint) leaves the
    previous manifest fully restorable, and the same fault through the
    reference's failpoint leaves the same bytes."""
    trees, pre = {}, {}
    for name, mod, fp in (("ref", R, R), ("port", T, tfp)):
        path = str(tmp_path / name)
        db = drive(mod, path, seed=3, n_chunks=4)
        pre[name] = coo(db)
        fp.fp_set("manifest.rename", "raise")
        try:
            with pytest.raises(fp.FailpointError):
                db.checkpoint()
            assert fp.fp_hits("manifest.rename") == 1
        finally:
            fp.fp_clear()
        assert os.path.exists(os.path.join(path, "MANIFEST.json.tmp"))
        db.tree.wal_flush()
        shutil.copytree(path, str(tmp_path / (name + "_crash")))
        trees[name] = tree_bytes(str(tmp_path / (name + "_crash")))
    assert trees["port"] == trees["ref"]
    assert same_coo(pre["port"], pre["ref"])
    for mod in (R, T):
        db2 = mod.GraphDB.open(str(tmp_path / "port_crash"))
        assert same_coo(coo(db2), pre["ref"])


def test_port_failpoints_are_the_ports_own():
    """Arming a site in one package never fires in the other, and the
    catalogs name the same sites."""
    assert tfp.CATALOG == R.CATALOG
    tfp.fp_set("dir.fsync", "raise", count=None)
    try:
        assert tfp.fp_armed("dir.fsync") and not R.fp_armed("dir.fsync")
        with pytest.raises(tfp.FailpointError):
            T.fsync_dir(os.getcwd())
        R.fsync_dir(os.getcwd())
    finally:
        tfp.fp_clear()


# -- analytics and queries over a reopened store ---------------------------------
@pytest.fixture(scope="module")
def reopened(tmp_path_factory):
    """The same sequence in both packages, each closed and reopened, then
    a small WAL tail left unflushed to the levels."""
    root = tmp_path_factory.mktemp("reopened")
    dbs = {}
    for name, mod in (("ref", R), ("port", T)):
        path = str(root / name)
        drive(mod, path, seed=4).close()
        db = mod.GraphDB.open(path)
        rng = np.random.default_rng(44)
        db.insert_edges(rng.integers(0, MAX_ID + 1, 700),
                        rng.integers(0, MAX_ID + 1, 700))
        dbs[name] = db
    return dbs


def test_out_of_core_psw_matches_reference(reopened):
    rdb, tdb = reopened["ref"], reopened["port"]
    rb = list(rpsw.stream_interval_buckets(rdb.tree, evict_each=True))
    tb = list(tpsw.stream_interval_buckets(tdb.tree, evict_each=True))
    assert len(rb) == len(tb) == tdb.intervals.n_partitions
    for (ri, rs, rd), (ti, ts, td) in zip(rb, tb):
        assert ri == ti and same_coo((rs, rd), (ts, td))
    want = rpsw.pagerank_out_of_core(rdb.tree, n_iters=4)
    got = tpsw.pagerank_out_of_core(tdb.tree, n_iters=4)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tpsw.pagerank_out_of_core(tdb, n_iters=4,
                                                    evict_each=False), want)


def test_dense_hops_on_a_reopened_store_match_reference_sparse(reopened):
    rdb, tdb = reopened["ref"], reopened["port"]
    seeds = np.random.default_rng(5).choice(MAX_ID + 1, 64, replace=False)
    want = R.two_hop_counts(rdb, seeds, dense="never")
    got = T.two_hop_counts(tdb, seeds, dense="kernel", device="cpu")
    assert same_two_hop(got, want)
    assert same_two_hop(T.two_hop_counts(tdb, seeds), want)
    pal = T.GraphPAL.from_edges(*coo(tdb), n_partitions=16, max_id=MAX_ID)
    assert same_two_hop(T.two_hop_counts(pal, seeds, dense="kernel",
                                         device="cpu"), want)
    kr = R.khop(rdb, seeds[:8], 3, dense="never")
    kt = T.khop(tdb, seeds[:8], 3, dense="kernel", device="cpu")
    assert len(kr.levels) == len(kt.levels)
    assert all(np.array_equal(a, b) for a, b in zip(kr.levels, kt.levels))


@pytest.mark.parametrize("mode", ["dense_gather", "psw_windows"])
def test_snapshot_pagerank_matches_reference(reopened, mode):
    rdb, tdb = reopened["ref"], reopened["port"]
    rdg, tdg = rdb.snapshot(), tdb.snapshot(device="cpu")
    same_device_graph(rdg, tdg)
    pal = T.GraphPAL.from_edges(*coo(tdb), n_partitions=16, max_id=MAX_ID)
    tpal = T.build_device_graph(pal, device="cpu")
    for f in ("src", "dst_local", "mask", "outdeg", "send_idx", "edge_owner",
              "edge_slot", "seg_ptr"):
        assert torch.equal(getattr(tdg, f), getattr(tpal, f)), f
    want = np.asarray(rpsw.pagerank_device(rdg, n_iters=5, mode=mode))
    got = T.pagerank_device(tdg, n_iters=5, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # and within the out-of-core ranks' tolerance (tests/test_disk.py)
    ooc = tpsw.pagerank_out_of_core(tdb.tree, n_iters=5)
    np.testing.assert_allclose(got.numpy().ravel(), ooc, rtol=1e-4,
                               atol=1e-4)


def test_disk_arrays_reach_torch_without_a_warning_or_an_alias(tmp_path):
    """Every array that crosses from a reopened store into torch on the
    disk path (dense hops, the snapshot, aggregation over a partition
    file's read-only memmaps) is a copy: no non-writable-array warning,
    and evicting the mappings leaves the results intact."""
    path = str(tmp_path / "db")
    drive(T, path, seed=6).close()
    db = T.GraphDB.open(path)
    part = max(db._disk_partitions(), key=lambda p: p.n_edges)
    assert not part.src.flags.writeable       # a read-only memmap
    n = db.intervals.max_vertices
    x = torch.from_numpy(np.random.default_rng(6).random(
        (n, 8)).astype(np.float32))
    seeds = np.arange(0, MAX_ID + 1, 331)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        th = T.two_hop_counts(db, seeds, dense="kernel", device="cpu")
        dg = db.snapshot(device="cpu")
        pr = T.pagerank_device(dg, n_iters=3)
        y = tps.psw_spmm_edges(part.src, part.dst, x, n)
        h = tse.segment_ell_from_edges(part.src, part.dst, x, n, 15)
    want = tps.spmm_dense_torch(torch.from_numpy(np.array(part.src)),
                                torch.from_numpy(np.array(part.dst)), x, n)
    before = (y.clone(), h.clone(), pr.clone())
    for p in db._disk_partitions():
        p.advise_dontneed()
    db.evict()
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(before, (y, h, pr)))
    assert same_two_hop(th, T.two_hop_counts(db, seeds))


def test_snapshot_and_dense_hops_without_a_device_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    db = drive(T, str(tmp_path / "db"), seed=7, n_chunks=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        db.snapshot()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.two_hop_counts(db, [1, 2], dense="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.khop(db, [1], 2, dense="kernel")


def test_manifest_and_integrity_report_match_reference(tmp_path):
    """The recovery root and the integrity log after a scrub that finds a
    flipped byte: the same JSON and the same events in both packages."""
    out = {}
    for name, mod in (("ref", R), ("port", T)):
        path = str(tmp_path / name)
        db = drive(mod, path, seed=8, n_chunks=4)
        db.checkpoint()
        victim = sorted(db._disk_partitions(), key=lambda p: p.path)[0]
        with open(victim.path, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            b = f.read(1)
            f.seek(-3, os.SEEK_END)
            f.write(bytes([b[0] ^ 0xFF]))
        report = db.scrub()
        out[name] = (json.load(open(os.path.join(path, "MANIFEST.json"))),
                     report, [{k: v for k, v in e.items() if k != "detail"}
                              for e in db.integrity_report()["events"]],
                     coo(db))
    (rm, rr, re_, rc), (tm, tr, te, tc) = out["ref"], out["port"]
    assert tm == rm and tr == rr and te == re_ and same_coo(tc, rc)
    assert tr["quarantined"], "the scrub found no corruption"
