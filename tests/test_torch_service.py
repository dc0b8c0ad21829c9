"""The port's service tier (repro_torch/core/{service,deadline,frontdesk}.py)
against the reference's (repro/core/...), on the CPU: a reduced mirror of
tests/test_service.py, test_epoch.py and test_lifecycle.py.

Exact throughout: one seeded operation sequence through both packages'
`ServiceDB` leaves byte-identical directory trees, snapshot sessions open
in either package, a pinned `read_view()` stays frozen under a writer
thread, dense hops on a port view (the kernel's plain version here) equal
the reference's sparse answers on the same state, deadlines, backoff
jitter and breaker transitions agree for a seed, and the front desk
answers bitwise, sheds typed and never completes late without an error."""
import os
import random
import threading
import time

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core import failpoints as tfp
from test_torch_disk import same_coo, same_two_hop, tree_bytes

MAX_ID = 9999
OPTS = dict(max_id=MAX_ID, n_partitions=16, n_levels=3, branching=4,
            buffer_cap=2000, max_partition_edges=8000, persist_min_edges=512,
            wal_segment_bytes=64 << 10, checkpoint_interval_ops=10 ** 9,
            column_dtypes={"w": np.float32})


def drive(mod, path, seed: int = 0):
    """One seeded sequence through `mod.ServiceDB` with the maintenance
    thread off (every merge happens at a call, so both packages make the
    same files): inserts with a column, a checkpoint, deletes, column
    writes, a snapshot session, close, open, a WAL tail, close."""
    rng = np.random.default_rng(seed)
    svc = mod.ServiceDB.create(path, maintenance=False, **OPTS)
    kept = []
    for i in range(5):
        s = rng.integers(0, MAX_ID + 1, 3000)
        d = rng.integers(0, MAX_ID + 1, 3000)
        svc.insert_edges(s, d, columns={"w": rng.random(3000).astype(
            np.float32)})
        kept.append((s[:20].tolist(), d[:20].tolist()))
        if i == 2:
            svc.checkpoint()
    for s, d in kept[:2]:
        for a, b in zip(s[:8], d[:8]):
            svc.delete_edge(a, b)
    for s, d in kept[2:]:
        for a, b in zip(s[8:12], d[8:12]):
            svc.update_edge_column(a, b, "w", 2.5)
    svc.checkpoint()
    svc.begin_snapshot().close()
    svc.close()
    svc = mod.ServiceDB.open(path, maintenance=False)
    s = rng.integers(0, MAX_ID + 1, 1500)
    d = rng.integers(0, MAX_ID + 1, 1500)
    svc.insert_edges(s, d, columns={"w": rng.random(1500).astype(np.float32)})
    svc.delete_edge(int(s[0]), int(d[0]))
    svc.close()


def make(mod, path, **kw):
    opts = dict(OPTS)
    opts.update(kw)
    return mod.ServiceDB.create(str(path), **opts)


def feed(svc, seed: int, n: int = 12_000):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, MAX_ID + 1, n)
    d = rng.integers(0, MAX_ID + 1, n)
    svc.insert_edges(s, d, columns={"w": rng.random(n).astype(np.float32)})
    for a, b in zip(s[:30].tolist(), d[:30].tolist()):
        svc.delete_edge(a, b)
    return s, d


def same_levels(a, b) -> bool:
    return (len(a.levels) == len(b.levels)
            and all(np.array_equal(x, y) for x, y in zip(a.levels, b.levels))
            and np.array_equal(a.visited, b.visited))


def test_core_exports_the_references_names():
    missing = [n for n in R.__all__ if not hasattr(T, n)]
    assert not missing, missing
    for name in ("ServiceDB", "Snapshot", "FrontDesk", "ShardRouter",
                 "Deadline", "CircuitBreaker", "shard_of"):
        assert getattr(T, name).__module__.startswith("repro_torch.core.")


# -- byte-identical stores ------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_service_directory_byte_identical(tmp_path, seed):
    drive(R, str(tmp_path / "ref"), seed)
    drive(T, str(tmp_path / "port"), seed)
    ref, port = tree_bytes(tmp_path / "ref"), tree_bytes(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    assert any(k.startswith("snapshots") for k in ref)
    for name, data in ref.items():
        assert port[name] == data, name


@pytest.mark.parametrize("writer,reader", [(R, T), (T, R)])
def test_each_package_opens_the_others_service(tmp_path, writer, reader):
    path = str(tmp_path / "db")
    drive(writer, path, seed=2)
    back = reader.ServiceDB.open(path, maintenance=False)
    again = writer.ServiceDB.open(path, maintenance=False)
    try:
        assert same_coo(back.db.to_coo(), again.db.to_coo())
        with back.read_view() as a, again.read_view() as b:
            for v in range(0, MAX_ID, 97):
                assert np.array_equal(a.out_neighbors(v), b.out_neighbors(v))
                assert np.array_equal(a.in_neighbors(v), b.in_neighbors(v))
    finally:
        back.close()
        again.close()


# -- snapshot sessions across the packages -------------------------------------
@pytest.mark.parametrize("writer,reader", [(R, T), (T, R)])
def test_snapshot_session_opened_by_the_other_package(tmp_path, writer,
                                                      reader):
    svc = make(writer, tmp_path / "db")
    try:
        feed(svc, seed=3)
        svc.checkpoint()
        s, d = feed(svc, seed=4, n=3000)             # a WAL tail past it
        svc.update_edge_column(int(s[40]), int(d[40]), "w", 9.0)
        snap = svc.begin_snapshot()
        want = snap.to_coo()
        cols = snap.storage_engine().edge_columns_batch(s[:64], names=["w"])
        snap.close()
        svc.insert_edges([1, 2], [3, 4])             # after the pin
        other = reader.Snapshot.open(snap.dir)
        assert same_coo(other.to_coo(), want)
        got = other.storage_engine().edge_columns_batch(s[:64], names=["w"])
        assert np.array_equal(got.offsets, cols.offsets)
        assert np.array_equal(got.dst, cols.dst)
        assert np.array_equal(got.columns["w"], cols.columns["w"])
        other.close()
    finally:
        svc.close()


def test_snapshot_device_graph_is_the_pals(tmp_path):
    from test_torch_psw import same_tensors
    svc = make(T, tmp_path / "db")
    try:
        feed(svc, seed=5)
        snap = svc.begin_snapshot()
        s, d = snap.to_coo()
        pal = T.GraphPAL.from_edges(s, d, n_partitions=16, max_id=MAX_ID)
        same_tensors(snap.snapshot(device="cpu"),
                     T.build_device_graph(pal, device="cpu"))
        snap.release()
        assert not os.path.exists(snap.dir)
    finally:
        svc.close()


# -- epoch views ----------------------------------------------------------------
def test_read_view_frozen_under_a_writer_thread(tmp_path):
    svc = make(T, tmp_path / "db")
    try:
        feed(svc, seed=6)
        stop = threading.Event()
        errors = []

        def writer():
            rng = np.random.default_rng(60)
            try:
                while not stop.is_set():
                    svc.insert_edges(rng.integers(0, MAX_ID + 1, 500),
                                     rng.integers(0, MAX_ID + 1, 500))
            except Exception as exc:  # surfaced below
                errors.append(exc)

        seeds = np.arange(0, MAX_ID, 211)
        with svc.read_view() as view:
            coo = view.to_coo()
            hops = T.two_hop_counts(view, seeds)
            t = threading.Thread(target=writer)
            t.start()
            try:
                deadline = time.monotonic() + 20
                while (svc.n_edges < view.n_edges + 5000
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                assert svc.n_edges >= view.n_edges + 5000
                assert same_coo(view.to_coo(), coo)
                assert same_two_hop(T.two_hop_counts(view, seeds), hops)
            finally:
                stop.set()
                t.join(timeout=60)
        assert not t.is_alive() and not errors, errors
        with svc.read_view() as later:
            assert later.version > view.version
    finally:
        svc.close()


@pytest.mark.parametrize("direction", ["out", "in"])
def test_dense_hops_on_a_view_equal_the_reference_sparse(tmp_path, direction):
    """The port's dense path (the kernel's plain torch version on the CPU)
    over a live view with a buffered tail, against the reference's sparse
    host path on the same operations. The reference's own dense path
    reaches a Pallas body that jax 0.9 cannot trace."""
    port, ref = make(T, tmp_path / "p"), make(R, tmp_path / "r")
    try:
        for svc in (port, ref):
            feed(svc, seed=7)
            svc.checkpoint()
            feed(svc, seed=8, n=2500)
        seeds = np.random.default_rng(9).choice(MAX_ID + 1, 96,
                                                replace=False)
        with port.read_view() as pv, ref.read_view() as rv:
            want = R.two_hop_counts(rv, seeds, direction=direction)
            got = T.two_hop_counts(pv, seeds, direction=direction,
                                   dense="kernel", device="cpu")
            assert same_two_hop(got, want)
            assert same_levels(
                T.khop(pv, seeds[:16], 3, direction=direction,
                       dense="kernel", device="cpu"),
                R.khop(rv, seeds[:16], 3, direction=direction))
    finally:
        port.close()
        ref.close()


# -- deadlines, backoff, breakers -------------------------------------------------
def test_backoff_delays_equal_for_a_seed():
    for base, cap, n, seed in ((0.01, 0.25, 8, 42), (0.05, 5.0, 12, 7)):
        assert (list(T.backoff_delays(base, cap, n, random.Random(seed)))
                == list(R.backoff_delays(base, cap, n, random.Random(seed))))


def test_circuit_breakers_step_together():
    rng = np.random.default_rng(11)
    brs = [mod.CircuitBreaker(failure_threshold=3, open_s=0.02)
           for mod in (R, T)]
    for step in rng.choice(4, 80, p=[0.3, 0.55, 0.1, 0.05]).tolist():
        if step == 3:
            time.sleep(0.025)                    # past the cool-down
        outs = []
        for br in brs:
            if step == 0:
                outs.append(br.allow())
            elif step == 1:
                outs.append(br.record_failure())
            else:
                br.record_success()
                outs.append(None)
            outs.append((br.state, br.trips))
        assert outs[:2] == outs[2:]
    assert brs[0].trips == brs[1].trips > 0


def test_deadline_budget_scope_and_typed_expiry():
    dl = T.Deadline.after(5.0)
    assert 4.0 < dl.to_budget() <= 5.0
    assert abs(T.Deadline.from_budget(dl.to_budget()).at - dl.at) < 0.1
    assert T.Deadline.after(100.0).timeout(cap=5.0) == 5.0
    assert T.Deadline.after(-3.0).timeout() == pytest.approx(1e-3)
    with pytest.raises(T.DeadlineExceeded) as ei:
        T.Deadline.after(-0.5).check("late op")
    assert ei.value.late_by >= 0.5 and isinstance(ei.value, TimeoutError)
    assert T.current_deadline() is None
    with T.deadline_scope(dl):
        assert T.current_deadline() is dl
        with T.deadline_scope(None):
            assert T.current_deadline() is dl
    assert T.current_deadline() is None


# -- the front desk ---------------------------------------------------------------
@pytest.fixture(scope="module")
def desk_store(tmp_path_factory):
    """A port service and the reference's, fed the same edges."""
    base = tmp_path_factory.mktemp("frontdesk")
    port, ref = make(T, base / "p"), make(R, base / "r")
    for svc in (port, ref):
        feed(svc, seed=12)
    yield port, ref
    port.close()
    ref.close()


def test_frontdesk_coalesces_and_answers_bitwise(desk_store):
    port, ref = desk_store
    vs = list(range(3, 3000, 61))
    fd = T.FrontDesk(port, max_batch=64)
    try:
        tfp.fp_set("frontdesk.dispatch", "delay:40", count=1)
        futs = [fd.submit("out_neighbors", v=v) for v in vs]
        for v, f in zip(vs, futs):
            assert np.array_equal(f.result(timeout=30),
                                  np.sort(ref.out_neighbors(v)))
        assert fd.stats.batches < fd.stats.admitted == len(vs)
        seeds = np.asarray(vs[:16], np.int64)
        with ref.read_view() as rv:
            fof = R.two_hop_counts(rv.storage_engine(), seeds)
            eb = rv.storage_engine().edge_columns_batch(seeds)
        futs = [fd.submit("fof", v=int(v)) for v in seeds]
        rngs = [fd.submit("getrange", v=int(v)) for v in seeds]
        for i, (f, g) in enumerate(zip(futs, rngs)):
            assert np.array_equal(f.result(timeout=30),
                                  fof.ids[fof.slice_of(i)])
            sl = slice(int(eb.offsets[i]), int(eb.offsets[i + 1]))
            got = g.result(timeout=30)
            assert np.array_equal(got["dst"], eb.dst[sl])
            assert np.array_equal(got["columns"]["w"], eb.columns["w"][sl])
    finally:
        tfp.fp_clear("frontdesk.dispatch")
        fd.close()


def test_frontdesk_sheds_typed(desk_store):
    port, _ = desk_store
    fd = T.FrontDesk(port, queue_cap=3)
    try:
        tfp.fp_set("frontdesk.dispatch", "delay:300", count=None)
        first = fd.submit("out_neighbors", v=1)
        give_up = time.monotonic() + 5.0
        while fd.depth() > 0 and time.monotonic() < give_up:
            time.sleep(0.005)                   # picked up, then stalled
        queued = [fd.submit("out_neighbors", v=v) for v in (2, 3, 4)]
        with pytest.raises(T.OverloadError) as ei:
            fd.submit("out_neighbors", v=5)
        assert ei.value.reason == "queue_full"
        fd.queue_cap = 100
        fd._req_s_ewma = 0.1                    # 3 deep x 100 ms > 50 ms
        with pytest.raises(T.OverloadError) as ei:
            fd.submit("out_neighbors", deadline=T.Deadline.after(0.05), v=6)
        assert ei.value.reason == "queue_delay"
        fd._req_s_ewma = 0.0
        with pytest.raises(T.DeadlineExceeded):
            fd.submit("out_neighbors", deadline=T.Deadline.after(-1.0), v=7)
    finally:
        tfp.fp_clear("frontdesk.dispatch")
        fd.close()
    first.result(timeout=30)
    for f in queued:
        f.result(timeout=30)
    with pytest.raises(T.OverloadError) as ei:
        fd.submit("out_neighbors", v=1)
    assert ei.value.reason == "closed"
    assert fd.stats.shed == 3


def test_frontdesk_late_results_are_typed_errors(desk_store):
    """A request alive at dispatch whose budget runs out in the engine
    call is delivered as DeadlineExceeded, never as a late answer; one
    that expires in the queue never reaches the engine."""
    port, _ = desk_store
    fd = T.FrontDesk(port)
    try:
        tfp.fp_set("frontdesk.dispatch", "delay:150", count=1)
        late = fd.submit("fof", deadline=T.Deadline.after(0.06), v=8)
        exc = late.exception(timeout=30)
        assert isinstance(exc, T.DeadlineExceeded)
        assert "finished late" in str(exc)
        tfp.fp_set("frontdesk.dispatch", "delay:150", count=1)
        blocker = fd.submit("out_neighbors", v=9)
        give_up = time.monotonic() + 5.0
        while fd.depth() > 0 and time.monotonic() < give_up:
            time.sleep(0.005)
        doomed = fd.submit("out_neighbors", deadline=T.Deadline.after(0.04),
                           v=10)
        exc = doomed.exception(timeout=30)
        assert isinstance(exc, T.DeadlineExceeded)
        assert "expired in queue" in str(exc)
        blocker.result(timeout=30)
        assert fd.stats.deadline_misses == 2
    finally:
        tfp.fp_clear("frontdesk.dispatch")
        fd.close()


def test_frontdesk_write_admission_and_grouped_insert(tmp_path):
    svc = make(T, tmp_path / "db")
    try:
        fd = T.FrontDesk(svc, max_batch=16)
        try:
            tfp.fp_set("frontdesk.dispatch", "delay:40", count=1)
            futs = [fd.submit("insert", src=np.asarray([i], np.int64),
                              dst=np.asarray([i + 100], np.int64))
                    for i in range(8)]
            assert [f.result(timeout=30) for f in futs] == [1] * 8
            assert svc.n_edges == 8 and fd.stats.batches < 8
            svc._enter_read_only("test degradation")
            fd._adm_cache = (-1e9, None)
            with pytest.raises(T.OverloadError) as ei:
                fd.insert_edges([5], [6])
            assert ei.value.reason == "read_only"
            assert np.array_equal(fd.out_neighbors(3), [103])
        finally:
            tfp.fp_clear("frontdesk.dispatch")
            fd.close()
    finally:
        svc.close()
