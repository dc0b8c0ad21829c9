"""The port's shard tier (repro_torch/core/shardrouter.py) against the
reference's (repro/core/shardrouter.py), on the CPU: a reduced mirror of
tests/test_shard.py.

Exact throughout: `shard_of`, encoded payloads and whole frames are the
reference's bytes, and each package decodes the other's; a 2-shard port
router (spawned port workers) answers bitwise as both packages' unsharded
`ServiceDB` fed the same edges (in this process, so no jax worker is
spawned); a read retries across a worker crashed by the
`shard.worker.op` failpoint, and a write never retries."""
import socket

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import shardrouter as rsr
from repro_torch.core import shardrouter as tsr
from repro_torch.core.failpoints import ENV_VAR

N_ID = 20_000
DB_KW = dict(n_partitions=8, n_levels=2, branching=4, buffer_cap=4000,
             max_partition_edges=50_000, persist_min_edges=512)


def _edges(seed=7, n=30_000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ID, n, dtype=np.int64),
            rng.integers(0, N_ID, n, dtype=np.int64))


def _frame_bytes(sr, status, meta, arrays) -> bytes:
    a, b = socket.socketpair()
    try:
        sr.send_frame(a, status, meta, arrays)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


# -- ownership and the wire ------------------------------------------------------
@pytest.mark.parametrize("n_partitions,n_shards", [(8, 1), (8, 2), (8, 4),
                                                   (16, 8)])
def test_shard_of_equals_the_reference(n_partitions, n_shards):
    vs = np.random.default_rng(n_shards).integers(0, 1 << 40, 5000)
    got = T.shard_of(vs, n_partitions, n_shards)
    assert got.dtype == np.int64
    assert np.array_equal(got, R.shard_of(vs, n_partitions, n_shards))


@pytest.mark.parametrize("status", [0, 1, 2])
def test_payload_and_frame_bytes_equal_the_reference(status):
    meta = {"op": "expand", "kw": {"direction": "out", "epoch": 3},
            "deadline": 0.25, "trace": None}
    arrays = {"vs": np.arange(17, dtype=np.int64),
              "f": np.linspace(0, 1, 5, dtype=np.float32),
              "m": np.ones((3, 4), bool), "e": np.empty(0, np.int32)}
    assert (tsr.encode_payload(meta, arrays)
            == rsr.encode_payload(meta, arrays))
    raw = _frame_bytes(tsr, status, meta, arrays)
    assert raw == _frame_bytes(rsr, status, meta, arrays)
    for sender, receiver in ((tsr, rsr), (rsr, tsr)):
        a, b = socket.socketpair()
        try:
            sender.send_frame(a, status, meta, arrays)
            st, m2, a2 = receiver.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert st == status and m2 == meta
        for name, arr in arrays.items():
            assert a2[name].dtype == arr.dtype
            assert np.array_equal(a2[name], arr)


def test_corrupt_frame_is_rejected_typed():
    payload = tsr.encode_payload({"op": "ping"}, {"x": np.arange(9)})
    head = tsr._HEADER.pack(tsr._MAGIC, len(payload),
                            tsr.checksum32(payload), tsr.ST_REQUEST)
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0x40
    for frame in (head + bytes(bad),
                  tsr._HEADER.pack(0xDEAD, 4, 0, 0) + b"ABCD"):
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            with pytest.raises(T.ShardProtocolError):
                tsr.recv_frame(b)
        finally:
            a.close()
            b.close()


# -- the sharded store against both unsharded stores -------------------------------
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A 2-shard port router, and a port and a reference `ServiceDB`, all
    fed the same edges and deletes."""
    base = tmp_path_factory.mktemp("shard")
    src, dst = _edges()
    port = T.ServiceDB.create(str(base / "port"), max_id=N_ID, **DB_KW)
    ref = R.ServiceDB.create(str(base / "ref"), max_id=N_ID, **DB_KW)
    router = T.ShardRouter.create(str(base / "sharded"), max_id=N_ID,
                                  n_shards=2, **DB_KW)
    for store in (router, port, ref):
        store.insert_edges(src, dst)
        for i in range(0, 4000, 97):
            store.delete_edge(int(src[i]), int(dst[i]))
    yield router, port, ref, src, dst
    router.close()
    port.close()
    ref.close()


def test_edge_counts_and_single_reads_bitwise(stores):
    router, port, ref, src, dst = stores
    assert router.n_edges == port.n_edges == ref.n_edges
    for v in [int(src[0]), int(dst[1]), int(src[2]), 0, N_ID - 1]:
        want = np.sort(ref.out_neighbors(v))
        assert np.array_equal(np.sort(router.out_neighbors(v)), want)
        assert np.array_equal(np.sort(port.out_neighbors(v)), want)
        assert np.array_equal(router.in_neighbors(v),
                              np.sort(ref.in_neighbors(v)))


@pytest.mark.parametrize("direction", ["out", "in"])
def test_khop_fof_and_degrees_bitwise(stores, direction):
    router, port, ref, src, dst = stores
    seeds = np.unique(src[:64])
    vs = np.unique(np.concatenate([src[:200], dst[:200]]))
    with T.consistent_engine(router) as eng, port.read_view() as pv, \
            ref.read_view() as rv:
        for other, mod in ((pv, T), (rv, R)):
            oe = other.storage_engine()
            a = T.khop(eng, seeds, 2, direction=direction)
            b = mod.khop(oe, seeds, 2, direction=direction)
            assert len(a.levels) == len(b.levels)
            assert all(np.array_equal(x, y)
                       for x, y in zip(a.levels, b.levels))
            f1 = T.two_hop_counts(eng, seeds[:16], direction=direction)
            f2 = mod.two_hop_counts(oe, seeds[:16], direction=direction)
            for name in ("offsets", "ids", "counts"):
                assert np.array_equal(getattr(f1, name), getattr(f2, name))
            deg = getattr(eng, f"{direction}_degree_batch")(vs)
            assert np.array_equal(
                deg, getattr(oe, f"{direction}_degree_batch")(vs))
        # the sharded engine serves sparse hops only, whatever is asked
        assert eng.supported_hop_modes == ("sparse",)
        c = T.khop(eng, seeds, 2, direction=direction, dense="kernel",
                   device="cpu")
        d = T.khop(pv, seeds, 2, direction=direction, dense="kernel",
                   device="cpu")
        assert all(np.array_equal(x, y) for x, y in zip(c.levels, d.levels))


def test_sharded_view_frozen_and_workers_load_no_jax(stores):
    # mutates the router only: the comparisons with the unsharded stores
    # above run first
    router, _, _, src, _ = stores
    for rt in router.worker_runtime():
        assert rt["modules"] == ["torch"] and not rt["cuda_initialized"]
    v = int(src[0])
    with router.pin_view() as view:
        before = np.sort(view.out_neighbors(v))
        n_before = view.n_edges
        router.insert_edges([v] * 8, np.arange(8, dtype=np.int64) + 1)
        assert np.array_equal(np.sort(view.out_neighbors(v)), before)
        assert view.n_edges == n_before
    assert router.out_neighbors(v).shape[0] == before.shape[0] + 8
    with pytest.raises(T.ShardRemoteError):
        router._call(0, "no_such_op", {})


# -- failure and restart ---------------------------------------------------------
def test_read_retries_across_a_crashed_worker(tmp_path, monkeypatch):
    """`shard.worker.op=crash@1` through the environment: the worker
    passes its readiness ping, dies with the crash exit code on its first
    real op (a write, which must not retry), and the next read respawns
    it on its directory and retries."""
    monkeypatch.setenv(ENV_VAR, "shard.worker.op=crash@1")
    router = T.ShardRouter.create(str(tmp_path / "rt"), max_id=N_ID,
                                  n_shards=1, **DB_KW)
    monkeypatch.delenv(ENV_VAR)
    try:
        with pytest.raises(T.ShardUnavailable):
            router.insert_edges([1], [2])
        router.shards[0].proc.join(timeout=30)
        assert router.shards[0].proc.exitcode == T.CRASH_EXIT_CODE
        assert router.out_neighbors(1).shape[0] in (0, 1)
        assert router.restarts == 1
        router.insert_edges([3], [4])
        assert np.array_equal(router.out_neighbors(3), [4])
    finally:
        router.close()


def test_write_never_retries(tmp_path):
    router = T.ShardRouter.create(str(tmp_path / "rt"), max_id=N_ID,
                                  n_shards=1, **DB_KW)
    try:
        router.insert_edges([5], [6])
        router.shards[0].proc.kill()
        router.shards[0].proc.join()
        with pytest.raises(T.ShardUnavailable):
            router.insert_edges([1], [2])
        assert router.restarts == 0
        router.restart_shard(0)
        router.insert_edges([1], [2])
        assert np.array_equal(router.out_neighbors(1), [2])
        assert np.array_equal(router.out_neighbors(5), [6])
    finally:
        router.close()
    router.close()                                  # idempotent
