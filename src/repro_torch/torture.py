"""Crash-consistency torture workload + prefix-equality oracle.

The workload is a DETERMINISTIC op stream against a live `ServiceDB`
(`wal_sync="always"`: every mutation call is fsync-durable before it
returns) with aggressive maintenance settings, so a short run crosses
every stage of the pipeline — buffer flush merges, partition persistence,
checkpoint phase A/B, store GC, WAL rotation/compaction. Ops are derived
purely from (seed, op index): the verifier re-generates the exact same
stream without any channel from the crashed process.

Crash points are injected via the failpoint registry's environment
channel: the test or benchmark sets `GRAPHDB_FAILPOINTS="<site>=crash@N"`
and runs `python -m repro_torch.torture run <dbdir> ...` in a
subprocess, which dies mid-I/O with `os._exit(41)` — no cleanup, no
flushing, the power-pull analogue. After each acked batch the runner appends one line to an ORACLE
log (fsynced append: the ack itself is durable), so the caller knows a
lower bound on what recovery must reproduce.

The oracle (`verify`): recover with `GraphDB.open` in a fresh process and
require the recovered edge multiset to be bitwise-equal to the state after
SOME op-stream prefix k with k >= the acked count. `wal_sync="always"`
makes each op a durability point, so recovery to anything that is not an
exact op boundary — or to less than what was acked — is a correctness
bug, not bad luck.

Op stream (all derived from the seed):
  op 3i:   insert one batch of `batch_size` edges, unique src per edge
           (src = global edge index, so every (src, dst) pair is unique
           and every prefix state is distinct), with a float32 "w" column
           (exercises typed column records in the WAL).
  op 3i+1: delete the first edge of the PREVIOUS batch (i > 0) — each
           delete targets a distinct, known-live edge.
  op 3i+2: ack batch i to the oracle (not a db op; marks durability).

Host copy of the reference `repro/torture.py`: the same op stream and
store files, so either package's `verify` checks the other's crash.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_BATCHES = 24
DEFAULT_BATCH_SIZE = 200
DEFAULT_SEED = 7

# aggressive maintenance: a ~5k-edge run crosses flush, checkpoint A/B,
# GC, and several WAL segment rotations
DB_KW = dict(
    n_partitions=16, n_levels=3, branching=4,
    buffer_cap=400, max_partition_edges=8000,
    persist_min_edges=256, wal_segment_bytes=16 << 10,
    wal_sync="always",
)
SERVICE_KW = dict(
    checkpoint_interval_ops=900,
    backpressure_edges=4000,
)


def max_id_for(batches: int, batch_size: int) -> int:
    return batches * batch_size + 1


def gen_batch(i: int, batch_size: int, seed: int,
              max_id: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch i's edges: unique src ids (the global edge index), seeded
    random dst, seeded float32 weights."""
    rng = np.random.default_rng(seed * 1_000_003 + i)
    src = np.arange(i * batch_size, (i + 1) * batch_size, dtype=np.int64)
    dst = rng.integers(0, max_id, batch_size).astype(np.int64)
    w = rng.random(batch_size).astype(np.float32)
    return src, dst, w


def delete_target(i: int, batch_size: int, seed: int,
                  max_id: int) -> Tuple[int, int]:
    """The edge batch i's delete op removes: first edge of batch i-1."""
    src, dst, _ = gen_batch(i - 1, batch_size, seed, max_id)
    return int(src[0]), int(dst[0])


def reference_states(batches: int, batch_size: int, seed: int):
    """Yield (ops_done, sorted (src, dst) edge multiset) after every op
    boundary of the stream — the candidate durable prefixes."""
    max_id = max_id_for(batches, batch_size)
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    deleted: List[Tuple[int, int]] = []
    ops = 0

    def state():
        if not srcs:
            return (np.empty(0, np.int64), np.empty(0, np.int64))
        s = np.concatenate(srcs)
        d = np.concatenate(dsts)
        keep = np.ones(s.shape[0], bool)
        for ds, dd in deleted:
            keep &= ~((s == ds) & (d == dd))
        s, d = s[keep], d[keep]
        order = np.lexsort((d, s))
        return (s[order], d[order])

    yield ops, state()
    for i in range(batches):
        src, dst, _ = gen_batch(i, batch_size, seed, max_id)
        srcs.append(src)
        dsts.append(dst)
        ops += 1
        yield ops, state()
        if i > 0:
            deleted.append(delete_target(i, batch_size, seed, max_id))
            ops += 1
            yield ops, state()


def total_ops(batches: int) -> int:
    return batches + max(0, batches - 1)


def run_workload(dbdir: str, oracle_path: str,
                 batches: int = DEFAULT_BATCHES,
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 seed: int = DEFAULT_SEED) -> None:
    """The subprocess entry point: create the store, stream the ops, ack
    each batch to the oracle, clean close. A crash failpoint armed via
    GRAPHDB_FAILPOINTS kills the process anywhere along the way."""
    from .core.service import ServiceDB

    max_id = max_id_for(batches, batch_size)
    svc = ServiceDB.create(
        dbdir, max_id=max_id,
        column_dtypes={"w": np.float32},
        **SERVICE_KW, **DB_KW)
    with open(oracle_path, "a") as oracle:
        ops = 0
        for i in range(batches):
            src, dst, w = gen_batch(i, batch_size, seed, max_id)
            svc.insert_edges(src, dst, columns={"w": w})
            ops += 1
            if i > 0:
                ds, dd = delete_target(i, batch_size, seed, max_id)
                svc.delete_edge(ds, dd)
                ops += 1
            # the ack: this batch's ops were fsync-durable when the calls
            # returned (wal_sync="always"); make the ack itself durable
            oracle.write(f"{ops}\n")
            oracle.flush()
            os.fsync(oracle.fileno())
    svc.close()


def acked_ops(oracle_path: str) -> int:
    """Durable lower bound: the last fully-written ack line (a torn final
    line is ignored, exactly like a torn WAL record)."""
    if not os.path.exists(oracle_path):
        return 0
    with open(oracle_path, "rb") as f:
        data = f.read()
    acked = 0
    for line in data.split(b"\n"):
        if line.isdigit():
            acked = int(line)
    return acked


def verify_recovery(dbdir: str, oracle_path: str,
                    batches: int = DEFAULT_BATCHES,
                    batch_size: int = DEFAULT_BATCH_SIZE,
                    seed: int = DEFAULT_SEED) -> dict:
    """Recover the (possibly crashed) store and find the op-stream prefix
    it equals. Returns {"ok", "acked", "recovered_prefix", "n_edges"};
    raises AssertionError when no prefix >= acked matches."""
    from .core.disk import GraphDB

    acked = acked_ops(oracle_path)
    if not os.path.exists(os.path.join(dbdir, GraphDB.MANIFEST)):
        # the crash predates the store's creation — nothing was ever acked
        assert acked == 0, (
            f"{acked} ops acked but {dbdir} has no manifest")
        return {"ok": True, "acked": 0, "recovered_prefix": 0, "n_edges": 0}
    db = GraphDB.open(dbdir)
    try:
        s, d = db.to_coo()
        report = db.integrity_report()
    finally:
        db.tree.close()
    order = np.lexsort((d, s))
    got = (np.asarray(s)[order], np.asarray(d)[order])
    matches = [ops for ops, (rs, rd) in
               reference_states(batches, batch_size, seed)
               if got[0].shape == rs.shape
               and np.array_equal(got[0], rs) and np.array_equal(got[1], rd)]
    assert matches, (
        f"recovered state ({got[0].shape[0]} edges) matches NO op-stream "
        f"prefix (acked={acked}, report={report})")
    k = max(matches)
    assert k >= acked, (
        f"recovered prefix {k} < acked durable prefix {acked} — "
        f"acknowledged mutations were lost (report={report})")
    return {"ok": True, "acked": acked, "recovered_prefix": k,
            "n_edges": int(got[0].shape[0])}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "verify"):
        p = sub.add_parser(name)
        p.add_argument("dbdir")
        p.add_argument("--oracle", required=True)
        p.add_argument("--batches", type=int, default=DEFAULT_BATCHES)
        p.add_argument("--batch-size", type=int, default=DEFAULT_BATCH_SIZE)
        p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run_workload(args.dbdir, args.oracle, batches=args.batches,
                     batch_size=args.batch_size, seed=args.seed)
        return 0
    result = verify_recovery(args.dbdir, args.oracle, batches=args.batches,
                             batch_size=args.batch_size, seed=args.seed)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
