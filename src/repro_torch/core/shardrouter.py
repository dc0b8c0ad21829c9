"""Shared-nothing interval sharding (DESIGN.md §12).

The single-process engine is GIL-bound: epoch views, merges, and query
glue all share one interpreter, so reader threads scale at ~1.26x for 2
readers (BENCH_service). This module splits the vertex-interval space
across N *shard worker processes* — each running its own full `ServiceDB`
(own WAL, own partition store, own maintenance pipeline, own
epoch-published manifests) — fronted by a `ShardRouter` that:

  * routes single-shard ops (insert, out_neighbors, per-source range
    reads) by interval ownership,
  * scatter/gathers batched frontier expansions: `expand_frontier`
    slices the frontier by owner shard, ships each slice over a binary
    length-prefixed IPC protocol (checksummed with the existing wsum32,
    failpoint-instrumented), and fans the flat (owner, neighbor) results
    back into the columnar operator layer (core/multihop.py) unchanged,
  * maintains per-shard manifest epochs: a `ShardedView` pins one
    published manifest in every worker, so a cross-shard read is a vector
    of per-shard snapshot pins (the consistency model in DESIGN.md §12).

Ownership
---------
A vertex's owner shard is a pure function of its id:

    owner(v) = interval_of(to_internal(v)) % n_shards == (v % P) % n_shards

(`P` = n_partitions; the equality holds because the reversible hash puts
`v` into interval `v % P` — paper §7.2). Edges live on the shard owning
their SOURCE: `out_neighbors`/insert/source-range ops touch exactly one
shard, while in-direction ops broadcast to all shards and merge. With
`P % n_shards == 0` (enforced) the hash spreads consecutive original ids
uniformly across shards, so hot id ranges don't pile onto one worker.

Wire protocol
-------------
Frames over an AF_UNIX stream socket (one listener per worker, one
connection per router thread — the connection is the epoch-pin scope):

    header  <IIII  = magic "SHRD", payload length, wsum32(payload), status
    payload <I     = meta length, then meta JSON, then raw ndarray bytes

`meta["arrays"]` lists (name, dtype, shape) for the concatenated array
blobs — numpy buffers cross the boundary as raw bytes, never pickled.
status 0 = request, 1 = ok, 2 = typed error (re-raised router-side).
Failpoint sites: `shard.rpc.send`, `shard.rpc.recv`, `shard.worker.op`,
`shard.worker.serve` — all in the closed CATALOG, all reachable from
tests and the torture harness via `GRAPHDB_FAILPOINTS` (spawned workers
inherit the environment).

Failure / restart
-----------------
Workers are supervised: a dead worker (crash failpoint, OOM-kill, bug) is
respawned by the router *on the same durable directory* — recovery is the
ordinary manifest + WAL-replay open. Reads retry transparently (with
exponential backoff + jitter) after a respawn — they are idempotent
against the recovered state; writes never auto-retry (the WAL may or may
not have acknowledged the mutation — the caller must decide). Epoch pins
die with their connection: a `ShardedView` spanning a restart raises
`ShardEpochLost` rather than silently serving a different epoch.

Request lifecycle (DESIGN.md §14)
---------------------------------
Every RPC can carry a `Deadline` (explicit argument or the thread's
ambient `deadline_scope`): the remaining budget rides in frame meta, the
router derives each socket timeout from it, retry sleeps never outrun it,
and the worker re-checks it before dispatching — an op whose caller
already gave up is shed with a typed `DeadlineExceeded`, not executed.
A read retried across a worker respawn re-checks the *remaining* budget
at every stage, so a respawn that outlives the deadline surfaces as
`DeadlineExceeded`, never as a silent multi-second stall.

Slowness (the gray failure crashes don't model) is handled two ways:

  * **Hedging** — live (non-view) reads re-issue a sub-request that has
    not answered within the hedge delay (a latency-histogram quantile of
    `shard.rpc.seconds`, floored and capped) on a FRESH connection;
    first response wins. The worker serves each connection on its own
    handler thread, so a hedge genuinely overtakes a stalled request.
    Pinned `ShardedView` reads are never hedged: epoch pins are scoped
    to one connection, and a hedge on another connection would answer
    from a different epoch.
  * **Circuit breakers** — one per shard, fed by transport failures,
    deadline-derived timeouts, and histogram-classified slow calls.
    An open breaker fails calls fast with `ShardOverloadError` instead
    of queueing more work onto a sick worker; after a cool-down one
    probe (health checks always qualify) decides whether to close it.

Host copy of the reference `repro/core/shardrouter.py`: the same frames
byte for byte and the same per-shard directories. A worker runs
`repro_torch.core.shardrouter._worker_main`, so it imports the port (and
torch) but never jax or the reference, and serves host numpy slabs only:
it never initialises CUDA (the `runtime` op reports what it loaded).
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import multiprocessing as mp
import os
import random
import socket
import struct
import sys
import threading
import time
from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                TimeoutError as _FutTimeout,
                                wait as _fut_wait)
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import telemetry
from .deadline import (CircuitBreaker, Deadline, backoff_delays,
                       current_deadline, deadline_scope)
from .engine import StorageEngine
from .failpoints import failpoint, fp_clear, fp_set
from .integrity import (DeadlineExceeded, GraphDBError, OverloadError,
                        checksum32)
from .pal import IntervalMap

__all__ = [
    "ShardConfig",
    "ShardEpochLost",
    "ShardOverloadError",
    "ShardProtocolError",
    "ShardRemoteError",
    "ShardRouter",
    "ShardUnavailable",
    "ShardedEngine",
    "ShardedView",
    "shard_of",
]


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------
class ShardProtocolError(GraphDBError):
    """Bytes on a shard socket disagree with the framing contract (bad
    magic, checksum mismatch, truncated frame). The connection that saw it
    is poisoned and torn down — frames after a framing error cannot be
    trusted to be aligned."""


class ShardUnavailable(GraphDBError):
    """A shard worker could not serve the request and the router did not
    (or must not) retry: writes after a worker death, or a worker that
    stayed dead through a respawn attempt."""

    def __init__(self, shard: int, detail: str):
        super().__init__(f"shard {shard}: {detail}")
        self.shard = shard


class ShardRemoteError(GraphDBError):
    """A typed error raised inside a shard worker, carried back over the
    wire. `kind` is the worker-side exception class name."""

    def __init__(self, shard: int, kind: str, message: str):
        super().__init__(f"shard {shard}: {kind}: {message}")
        self.shard = shard
        self.kind = kind

    def to_payload(self) -> Dict[str, Any]:
        return {"kind": self.kind, "message": str(self)}


class ShardEpochLost(ShardUnavailable):
    """The worker holding a ShardedView's epoch pin restarted (or the pin's
    connection dropped): the pinned manifest is gone and the view cannot
    answer consistently. Callers open a fresh view."""

    def __init__(self, shard: int):
        super().__init__(shard, "pinned epoch lost (worker restarted)")


class ShardOverloadError(OverloadError):
    """A shard-scoped overload shed: the shard's circuit breaker is open
    (the router fails fast rather than queueing more work onto a worker
    that is failing or pathologically slow), or the worker itself shed the
    request. Subtype of `OverloadError` so front-end admission control and
    callers handle both with one except clause."""

    def __init__(self, shard: int, reason: str = "breaker_open",
                 detail: str = ""):
        super().__init__(reason, detail=f"shard {shard}"
                         + (f": {detail}" if detail else ""))
        self.shard = shard


# ---------------------------------------------------------------------------
# ownership
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """The sharding geometry every participant derives routing from. All
    shards share ONE internal id space (same IntervalMap), so internal ids,
    packed multihop keys, and engine outputs are identical across shards
    and bitwise-comparable with an unsharded store of the same config."""

    n_shards: int
    n_partitions: int
    interval_len: int
    max_id: int

    @property
    def intervals(self) -> IntervalMap:
        return IntervalMap(n_partitions=self.n_partitions,
                           interval_len=self.interval_len)

    def shard_of(self, vs) -> np.ndarray:
        return shard_of(vs, self.n_partitions, self.n_shards)


def shard_of(vs, n_partitions: int, n_shards: int) -> np.ndarray:
    """Owner shard of each ORIGINAL vertex id — `(v % P) % n_shards`,
    which equals `interval_of(to_internal(v)) % n_shards` for every id the
    store can hold (the reversible hash maps v into interval `v % P`;
    tests/test_shard.py asserts the equivalence)."""
    vs = np.asarray(vs, dtype=np.int64)
    return (vs % np.int64(n_partitions)) % np.int64(n_shards)


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------
_MAGIC = 0x53485244  # "SHRD"
_HEADER = struct.Struct("<IIII")  # magic, payload_len, wsum32, status
ST_REQUEST, ST_OK, ST_ERROR = 0, 1, 2
_MAX_FRAME = 1 << 31

_M_RPC_REQS = telemetry.counter("shard.rpc.requests")
_M_RPC_S = telemetry.histogram("shard.rpc.seconds")
_M_RPC_TX = telemetry.counter("shard.rpc.bytes_sent")
_M_RPC_RX = telemetry.counter("shard.rpc.bytes_recv")
_M_RPC_INFLIGHT = telemetry.counter("shard.rpc.inflight")
_M_RESTARTS = telemetry.counter("shard.restarts")
_M_RPC_RETRIES = telemetry.counter("shard.rpc.retries")
_M_DEADLINE = telemetry.counter("request.deadline_exceeded")
_M_HEDGES_SENT = telemetry.counter("shard.hedges.sent")
_M_HEDGES_WON = telemetry.counter("shard.hedges.won")
_M_BREAKER_TRIPS = telemetry.counter("shard.breaker.trips")
_M_BREAKER_FF = telemetry.counter("shard.breaker.fastfail")
_M_BREAKER_OPEN = telemetry.gauge("shard.breaker.open")


def encode_payload(meta: Dict[str, Any],
                   arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """meta JSON + raw C-contiguous array bytes, self-describing via
    meta["arrays"]. Arrays are never pickled: the receiver re-views the
    exact dtype/shape over the wire bytes."""
    arrays = arrays or {}
    meta = dict(meta)
    specs, blobs = [], []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        specs.append([name, arr.dtype.str, list(arr.shape)])
        blobs.append(arr.tobytes())
    meta["arrays"] = specs
    mbytes = json.dumps(meta, separators=(",", ":")).encode()
    return b"".join([struct.pack("<I", len(mbytes)), mbytes] + blobs)


def decode_payload(buf: bytes) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    (mlen,) = struct.unpack_from("<I", buf, 0)
    meta = json.loads(buf[4:4 + mlen].decode())
    arrays: Dict[str, np.ndarray] = {}
    off = 4 + mlen
    for name, dtype, shape in meta.pop("arrays", []):
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        end = off + n * dt.itemsize
        arrays[name] = np.frombuffer(buf[off:end], dtype=dt).reshape(shape)
        off = end
    return meta, arrays


def _send_all(sock: socket.socket, data: bytes) -> None:
    """Write every byte or raise — an explicit bounded loop instead of
    `sendall` so a signal landing mid-write (EINTR) resumes at the right
    offset and a closed peer surfaces as a typed ConnectionError, never a
    silent partial frame. The loop is bounded: every
    iteration either makes progress or raises."""
    view = memoryview(data)
    sent = 0
    total = len(view)
    while sent < total:
        try:
            n = sock.send(view[sent:])
        except InterruptedError:
            continue  # EINTR: nothing was written, retry the same slice
        if n <= 0:
            raise ConnectionError("shard connection closed mid-send")
        sent += n


def send_frame(sock: socket.socket, status: int, meta: Dict[str, Any],
               arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    payload = encode_payload(meta, arrays)
    failpoint("shard.rpc.send")
    _M_RPC_TX.inc(len(payload))
    _send_all(sock, _HEADER.pack(_MAGIC, len(payload), checksum32(payload),
                                 status) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise. Bounded: each iteration either
    receives at least one byte, retries a signal interruption (EINTR), or
    raises — a dribbling peer (1 byte per segment) therefore costs at most
    n iterations and can never yield a silent short read."""
    chunks = []
    while n:
        try:
            b = sock.recv(min(n, 1 << 20))
        except InterruptedError:
            continue
        if not b:
            raise ConnectionError("shard connection closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_frame(sock: socket.socket
               ) -> Tuple[int, Dict[str, Any], Dict[str, np.ndarray]]:
    head = _recv_exact(sock, _HEADER.size)
    magic, length, cksum, status = _HEADER.unpack(head)
    failpoint("shard.rpc.recv")
    if magic != _MAGIC or length > _MAX_FRAME:
        raise ShardProtocolError(
            f"bad frame header (magic {magic:#x}, length {length})")
    payload = _recv_exact(sock, length)
    _M_RPC_RX.inc(int(length))
    if checksum32(payload) != cksum:
        raise ShardProtocolError(
            f"frame checksum mismatch over {length} payload bytes")
    meta, arrays = decode_payload(payload)
    return status, meta, arrays


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------
def _predicate_from(d: Optional[Dict[str, Any]]):
    if d is None:
        return None
    from .multihop import EdgePredicate
    return EdgePredicate(**d)


class _WorkerState:
    """Per-process state of one shard worker: the shard's ServiceDB plus
    the accept loop's stop flag."""

    def __init__(self, shard_id: int, svc):
        self.shard_id = shard_id
        self.svc = svc
        self.stop = threading.Event()


class _Connection:
    """One router connection served by one worker thread. The connection
    is the epoch-pin scope: pinned views die (and are released) with it,
    which is what makes 'pin lost after restart' detectable instead of
    silently re-pinning a different epoch."""

    def __init__(self, state: _WorkerState, sock: socket.socket):
        self.state = state
        self.sock = sock
        self.views: Dict[int, Any] = {}
        self._next_view = 0

    # -- op handlers ---------------------------------------------------------
    def _store(self, kw: Dict[str, Any]):
        """The read target: a pinned epoch view when the request names one,
        the live tree otherwise (single-op reads pin their own view)."""
        token = kw.get("epoch")
        if token is None:
            return None
        view = self.views.get(int(token))
        if view is None:
            raise KeyError(f"unknown epoch token {token} (pin lost?)")
        return view

    def handle(self, meta: Dict[str, Any],
               arrays: Dict[str, np.ndarray]
               ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        op = meta["op"]
        kw = meta.get("kw", {})
        svc = self.state.svc
        if op == "ping":
            return {"shard": self.state.shard_id, **svc.health()}, {}
        if op == "insert_edges":
            cols = {n[4:]: a for n, a in arrays.items()
                    if n.startswith("col:")}
            svc.insert_edges(arrays["src"], arrays["dst"],
                             etype=arrays.get("etype"),
                             columns=cols or None)
            return {"n": int(arrays["src"].shape[0])}, {}
        if op == "delete_edge":
            return {"found": bool(svc.delete_edge(kw["src"], kw["dst"]))}, {}
        if op == "pin_epoch":
            view = svc.read_view()
            token = self._next_view
            self._next_view += 1
            self.views[token] = view
            return {"epoch": token, "version": int(view.version),
                    "n_edges": int(view.n_edges)}, {}
        if op == "release_epoch":
            view = self.views.pop(int(kw["epoch"]), None)
            if view is not None:
                view.release()
            return {"released": view is not None}, {}
        if op == "snapshot":
            view = self._store(kw)
            snap = svc.begin_snapshot(view=view)
            snap.close()  # the worker keeps no mapping; the dir is the API
            return {"dir": snap.dir}, {}
        if op == "checkpoint":
            svc.checkpoint()
            return {"ok": True}, {}
        if op == "io_stats":
            return dict(svc.db.io.snapshot()), {}
        if op == "runtime":
            # what this worker process has loaded (the isolation check):
            # is_initialized() reads a flag and creates no CUDA context
            torch = sys.modules.get("torch")
            return {"pid": os.getpid(),
                    "modules": sorted(m for m in ("jax", "repro", "torch")
                                      if sys.modules.get(m) is not None),
                    "cuda_initialized": bool(
                        torch is not None and torch.cuda.is_initialized())
                    }, {}
        if op == "telemetry":
            # worker-side observability surface: this process's metric
            # snapshot (exact-mergeable router-side) and, on request, its
            # buffered Chrome trace events — both JSON, both ride in meta
            doc: Dict[str, Any] = {"metrics": telemetry.snapshot()}
            if kw.get("trace"):
                doc["trace"] = telemetry.trace_events(
                    clear=bool(kw.get("clear")))
            return doc, {}
        if op == "failpoint":
            # per-shard fault arming: the GRAPHDB_FAILPOINTS
            # env channel is inherited by EVERY spawned worker, so a chaos
            # harness that wants exactly ONE slow shard arms it here over
            # the wire instead (seeded prob → reproducible latency faults)
            if kw.get("clear"):
                fp_clear(kw.get("site"))
                return {"ok": True}, {}
            fp_set(kw["site"], kw["action"], after=int(kw.get("after", 0)),
                   count=kw.get("count", 1), prob=kw.get("prob"),
                   seed=kw.get("seed"))
            return {"ok": True}, {}

        # -- reads: answered from the pinned epoch (or a private pin) -------
        view = self._store(kw)
        owns_pin = view is None
        if owns_pin:
            view = svc.read_view()
        try:
            eng = view.storage_engine()
            if op == "out_neighbors":
                return {}, {"nb": view.out_neighbors(int(kw["v"]))}
            if op == "in_neighbors":
                return {}, {"nb": view.in_neighbors(int(kw["v"]))}
            if op == "expand":
                owner, nb = eng.expand_frontier(
                    arrays["vs"], kw.get("direction", "out"),
                    _predicate_from(kw.get("predicate")))
                return {}, {"owner": owner, "nb": nb}
            if op == "degree_batch":
                deg = eng._degree_batch(arrays["vs"],
                                        kw.get("direction", "out"))
                return {}, {"deg": deg}
            if op == "coo":
                s, d = view.to_coo()
                return {}, {"src": np.asarray(s, np.int64),
                            "dst": np.asarray(d, np.int64)}
            if op == "n_edges":
                return {"n_edges": int(view.n_edges)}, {}
        finally:
            if owns_pin:
                view.release()
        raise ValueError(f"unknown shard op {op!r}")

    def serve(self) -> None:
        try:
            while not self.state.stop.is_set():
                try:
                    status, meta, arrays = recv_frame(self.sock)
                except (ConnectionError, OSError):
                    return
                if status != ST_REQUEST:
                    raise ShardProtocolError(
                        f"worker received non-request status {status}")
                if meta.get("op") == "shutdown":
                    send_frame(self.sock, ST_OK, {"ok": True})
                    self.state.stop.set()
                    return
                try:
                    # rebuild the budget BEFORE the failpoint so an
                    # injected stall (modeling queueing delay inside the
                    # worker) consumes it; the re-check after means an op
                    # whose caller's budget is already gone is shed typed,
                    # not executed — the router maps the kind back to a
                    # local DeadlineExceeded
                    bdl = Deadline.from_budget(meta.get("deadline"))
                    failpoint("shard.worker.op")
                    if bdl is not None and bdl.expired():
                        _M_DEADLINE.inc(label="worker")
                        raise DeadlineExceeded(
                            f"shard {self.state.shard_id} "
                            f"{meta.get('op', '?')} (shed pre-dispatch)",
                            -bdl.remaining())
                    # the router's trace context rides in meta["trace"];
                    # attaching it here is what stitches worker spans into
                    # the router-side trace (same trace id across processes)
                    with telemetry.attach(meta.get("trace")), \
                            telemetry.span("shard.op",
                                           op=meta.get("op", "?"),
                                           shard=self.state.shard_id), \
                            deadline_scope(bdl):
                        rmeta, rarrays = self.handle(meta, arrays)
                    send_frame(self.sock, ST_OK, rmeta, rarrays)
                except BrokenPipeError:
                    return
                except Exception as exc:  # typed errors cross the wire
                    try:
                        send_frame(self.sock, ST_ERROR,
                                   {"kind": type(exc).__name__,
                                    "message": str(exc)})
                    except OSError:
                        return
        finally:
            for view in self.views.values():
                try:
                    view.release()
                except Exception:
                    pass
            self.views.clear()
            try:
                self.sock.close()
            except OSError:
                pass


def _worker_main(shard_id: int, directory: str, sock_path: str,
                 db_kw: Dict[str, Any]) -> None:
    """Entry point of a spawned shard worker: open (or create) the shard's
    ServiceDB on its own durable directory, bind the shard socket, and
    serve router connections until told to shut down. Crash-restart safe:
    a respawn on the same directory is the ordinary WAL-replay open."""
    from .service import ServiceDB
    from .disk import GraphDB
    if os.path.exists(os.path.join(directory, GraphDB.MANIFEST)):
        svc = ServiceDB.open(directory)
    else:
        svc = ServiceDB.create(directory, **db_kw)
    state = _WorkerState(shard_id, svc)
    try:
        os.unlink(sock_path)  # a stale socket from a crashed predecessor
    except FileNotFoundError:
        pass
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(sock_path)
    listener.listen(16)
    listener.settimeout(0.25)
    failpoint("shard.worker.serve")
    threads: List[threading.Thread] = []
    try:
        while not state.stop.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=_Connection(state, conn).serve,
                                 name=f"shard{shard_id}-conn", daemon=True)
            t.start()
            threads.append(t)
    finally:
        listener.close()
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        for t in threads:
            t.join(timeout=2.0)
        svc.close()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
class _ShardProc:
    """Router-side handle of one worker: process, socket path, and a
    generation counter — bumped on every respawn so threads' cached
    connections (and the epoch pins living on them) detect the restart."""

    def __init__(self, shard_id: int, directory: str, sock_path: str):
        self.shard_id = shard_id
        self.dir = directory
        self.sock_path = sock_path
        self.proc: Optional[mp.process.BaseProcess] = None
        self.generation = 0
        self.lock = threading.Lock()  # serializes respawns, not requests


class ShardRouter:
    """Front end over N shard worker processes (module docstring). Thread
    safe: each router thread keeps one connection per shard (the worker
    runs one handler thread per connection), so concurrent reader threads
    fan out to genuinely parallel workers without sharing sockets."""

    CONFIG = "SHARDS.json"
    SPAWN_TIMEOUT_S = 120.0  # worker import (numpy+torch) + recovery replay

    def __init__(self, directory: str, config: ShardConfig,
                 db_kw: Dict[str, Any], start: bool = True,
                 op_timeout_s: float = 60.0,
                 read_retries: int = 2,
                 backoff_base_s: float = 0.01,
                 backoff_cap_s: float = 0.25,
                 hedge: bool = True,
                 hedge_quantile: float = 0.95,
                 hedge_floor_s: float = 0.002,
                 hedge_cap_s: float = 0.05,
                 hedge_default_s: float = 0.010,
                 hedge_min_samples: int = 64,
                 breaker_failures: int = 8,
                 breaker_open_s: float = 1.0,
                 breaker_slow_floor_s: float = 0.25,
                 breaker_slow_mult: float = 16.0,
                 rpc_pool_size: Optional[int] = None):
        self.dir = os.path.abspath(directory)
        self.config = config
        self.intervals = config.intervals
        self.db_kw = dict(db_kw)
        self._ctx = mp.get_context("spawn")
        self._tls = threading.local()
        self._closed = False
        self.restarts = 0
        # -- request-lifecycle configuration --
        self.op_timeout_s = float(op_timeout_s)   # no-deadline socket cap
        self.read_retries = int(read_retries)     # extra attempts for reads
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.hedge = bool(hedge)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_floor_s = float(hedge_floor_s)
        self.hedge_cap_s = float(hedge_cap_s)
        self.hedge_default_s = float(hedge_default_s)
        self.hedge_min_samples = int(hedge_min_samples)
        self.breaker_slow_floor_s = float(breaker_slow_floor_s)
        self.breaker_slow_mult = float(breaker_slow_mult)
        self.rpc_pool_size = rpc_pool_size
        self.breakers = [CircuitBreaker(breaker_failures, breaker_open_s)
                        for _ in range(config.n_shards)]
        self._retry_rng = random.Random()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._hedge_cache = (-1e9, float(hedge_default_s))
        self._slow_cache = (-1e9, None)
        # every live socket the router ever opened, across ALL threads —
        # close() drains this so threads that exited with cached
        # connections cannot leak fds
        self._socks: set = set()
        self._socks_lock = threading.Lock()
        self.shards = [
            _ShardProc(i, os.path.join(self.dir, f"shard_{i:02d}"),
                       os.path.join(self.dir, f"shard_{i:02d}.sock"))
            for i in range(config.n_shards)
        ]
        # a router abandoned without close() must not leave worker
        # processes behind at interpreter exit; close() unregisters
        atexit.register(self.close)
        if start:
            for sp in self.shards:
                self._spawn(sp)
            for sp in self.shards:
                self._wait_ready(sp)

    # -- lifecycle -------------------------------------------------------------
    @classmethod
    def create(cls, directory: str, max_id: int, n_shards: int,
               router_kw: Optional[Dict[str, Any]] = None,
               **db_kw) -> "ShardRouter":
        """Create a sharded store: N empty per-shard ServiceDBs under
        `directory`, all sharing one internal id space. `db_kw` forwards
        to `ServiceDB.create` in every worker (identical config per shard
        — routing and bitwise comparability depend on it); `router_kw`
        forwards to `ShardRouter.__init__` (timeouts, hedging, breaker
        tuning — router policy, never persisted)."""
        n_partitions = int(db_kw.get("n_partitions", 8))
        if n_partitions % n_shards:
            raise ValueError(
                f"n_partitions ({n_partitions}) must be a multiple of "
                f"n_shards ({n_shards}) for balanced interval ownership")
        db_kw.setdefault("n_partitions", n_partitions)
        db_kw["max_id"] = int(max_id)
        # workers on a 1-core box each default to multiple maintenance
        # threads; one per worker process keeps N shards from oversubscribing
        db_kw.setdefault("maintenance_workers", 1)
        os.makedirs(directory, exist_ok=True)
        iv = IntervalMap.for_capacity(max_id, n_partitions)
        config = ShardConfig(n_shards=n_shards, n_partitions=iv.n_partitions,
                             interval_len=iv.interval_len, max_id=int(max_id))
        doc = {"n_shards": n_shards, "n_partitions": iv.n_partitions,
               "interval_len": iv.interval_len, "max_id": int(max_id),
               "db_kw": {k: v for k, v in db_kw.items()
                         if isinstance(v, (int, float, str, bool,
                                           type(None)))}}
        with open(os.path.join(directory, cls.CONFIG), "w") as f:
            json.dump(doc, f, indent=1)
        return cls(directory, config, db_kw, **(router_kw or {}))

    @classmethod
    def open(cls, directory: str,
             **router_kw) -> "ShardRouter":
        with open(os.path.join(directory, cls.CONFIG)) as f:
            doc = json.load(f)
        config = ShardConfig(n_shards=doc["n_shards"],
                             n_partitions=doc["n_partitions"],
                             interval_len=doc["interval_len"],
                             max_id=doc["max_id"])
        return cls(directory, config, doc.get("db_kw", {}), **router_kw)

    def close(self) -> None:
        """Shut the cluster down and release EVERY router-held resource.
        Idempotent (close-twice is a no-op), atexit-registered (an
        abandoned router cannot leave worker processes behind), and safe
        to call while other threads are mid-request — their blocked recvs
        are unblocked by the socket close and surface as typed
        `ShardUnavailable("router closed")`, never a hang."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        # 1. polite shutdown, on a fresh connection per shard (best
        #    effort; a cached one may be generation-stale or mid-frame)
        for sp in self.shards:
            try:
                conn = self._connect(sp, force=True)
                conn.settimeout(5.0)
                send_frame(conn, ST_REQUEST, {"op": "shutdown"})
                recv_frame(conn)
                self._close_sock(conn)
            except (GraphDBError, OSError, ConnectionError):
                pass
        # 2. stop feeding the hedge pool (pending hedges are cancelled;
        #    in-flight ones fail typed once their sockets close below)
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        # 3. reap worker processes — no zombies survive close()
        for sp in self.shards:
            if sp.proc is not None:
                sp.proc.join(timeout=30.0)
                if sp.proc.is_alive():
                    sp.proc.terminate()
                    sp.proc.join(timeout=5.0)
                sp.proc = None
        # 4. close every socket the router ever opened, including ones
        #    cached in OTHER threads' connection maps (fd-leak guard)
        with self._socks_lock:
            socks, self._socks = list(self._socks), set()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        # 5. remove leftover socket files from terminated workers (a
        #    clean worker exit unlinks its own)
        for sp in self.shards:
            try:
                os.unlink(sp.sock_path)
            except OSError:
                pass

    def __enter__(self) -> "ShardRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- supervision -----------------------------------------------------------
    def _spawn(self, sp: _ShardProc) -> None:
        sp.proc = self._ctx.Process(
            target=_worker_main,
            args=(sp.shard_id, sp.dir, sp.sock_path, self.db_kw),
            name=f"graphdb-shard-{sp.shard_id}", daemon=True)
        sp.proc.start()

    def _wait_ready(self, sp: _ShardProc,
                    deadline: Optional[Deadline] = None) -> None:
        """Poll a spawning worker until it answers a ping. Bounded by
        SPAWN_TIMEOUT_S — and, when the caller carries a `Deadline`, by
        its REMAINING budget: a read retried across a respawn must raise
        `DeadlineExceeded` when the budget runs out mid-recovery, not
        block for the full spawn timeout."""
        give_up = time.monotonic() + self.SPAWN_TIMEOUT_S
        while True:
            if sp.proc is not None and not sp.proc.is_alive():
                raise ShardUnavailable(
                    sp.shard_id,
                    f"worker died during startup "
                    f"(exit code {sp.proc.exitcode})")
            try:
                conn = self._connect(sp)
                conn.settimeout(self.SPAWN_TIMEOUT_S)
                send_frame(conn, ST_REQUEST, {"op": "ping"})
                status, meta, _ = recv_frame(conn)
                if status == ST_OK:
                    conn.settimeout(None)
                    self._cache_conn(sp, conn)
                    return
            except (OSError, ConnectionError):
                pass
            if deadline is not None and deadline.expired():
                _M_DEADLINE.inc(label="rpc")
                raise DeadlineExceeded(
                    f"shard {sp.shard_id} respawn wait",
                    -deadline.remaining())
            if time.monotonic() > give_up:
                raise ShardUnavailable(sp.shard_id, "worker never came up")
            time.sleep(0.05)

    def restart_shard(self, shard_id: int,
                      deadline: Optional[Deadline] = None) -> None:
        """Respawn a dead worker on its durable directory (WAL-replay
        recovery) and bump the generation so every thread's cached
        connection — and the epoch pins living on them — is invalidated.
        With a `Deadline`, every wait (the respawn lock, the ready poll)
        is bounded by the remaining budget and expiry surfaces typed."""
        sp = self.shards[shard_id]
        if self._closed:
            raise ShardUnavailable(shard_id, "router closed")
        if deadline is None:
            sp.lock.acquire()
        elif not sp.lock.acquire(timeout=max(0.0, deadline.remaining())):
            _M_DEADLINE.inc(label="rpc")
            raise DeadlineExceeded(f"shard {shard_id} respawn lock wait",
                                   -deadline.remaining())
        try:
            if sp.proc is not None and sp.proc.is_alive():
                # alive: the failure was a broken connection, not a dead
                # worker — a fresh connect (new generation) is enough
                try:
                    conn = self._connect(sp)
                    self._close_sock(conn)
                    sp.generation += 1
                    return
                except (OSError, ConnectionError):
                    sp.proc.terminate()
                    sp.proc.join(timeout=10.0)
            self.restarts += 1
            _M_RESTARTS.inc()
            sp.generation += 1
            self._spawn(sp)
            self._wait_ready(sp, deadline)
        finally:
            sp.lock.release()

    def health(self) -> List[Dict[str, Any]]:
        """Ping every shard; a dead shard reports {"alive": False} instead
        of raising (supervisors poll this). Pings are breaker PROBES: they
        bypass an open breaker — a recovered worker's successful health
        ping is exactly the evidence that closes its breaker again."""
        out = []
        for sp in self.shards:
            try:
                meta, _ = self._call(sp.shard_id, "ping", {}, retry=False,
                                     probe=True)
                meta["alive"] = True
            except (GraphDBError, OSError, ConnectionError) as exc:
                meta = {"shard": sp.shard_id, "alive": False,
                        "error": str(exc)}
            out.append(meta)
        return out

    def arm_failpoint(self, shard_id: int, site: str,
                      action: Optional[str] = None, after: int = 0,
                      count: Optional[int] = 1, prob: Optional[float] = None,
                      seed: Optional[int] = None, clear: bool = False
                      ) -> None:
        """Arm (or clear) a failpoint inside ONE shard worker over the
        wire — the chaos harness's per-shard fault channel (the env var
        channel is inherited by every spawned worker and cannot single
        out a shard). A probe call: it bypasses the breaker so faults can
        be cleared even while the breaker they caused is open."""
        kw: Dict[str, Any] = {"site": site, "clear": bool(clear)}
        if not clear:
            kw.update(action=action, after=int(after), count=count,
                      prob=prob, seed=seed)
        self._call(shard_id, "failpoint", kw, retry=False, probe=True)

    # -- per-thread connections ------------------------------------------------
    def _connect(self, sp: _ShardProc, force: bool = False) -> socket.socket:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            conn.connect(sp.sock_path)
        except OSError:
            conn.close()
            raise
        with self._socks_lock:
            self._socks.add(conn)
        if self._closed and not force:
            # raced with close(): its registry drain may already have run
            self._close_sock(conn)
            raise ShardUnavailable(sp.shard_id, "router closed")
        return conn

    def _close_sock(self, conn: socket.socket) -> None:
        with self._socks_lock:
            self._socks.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def _cache_conn(self, sp: _ShardProc, conn: socket.socket) -> None:
        cache = getattr(self._tls, "conns", None)
        if cache is None:
            cache = self._tls.conns = {}
        old = cache.get(sp.shard_id)
        if old is not None:
            self._close_sock(old[0])
        cache[sp.shard_id] = (conn, sp.generation)

    def _conn(self, sp: _ShardProc) -> socket.socket:
        cache = getattr(self._tls, "conns", None)
        if cache is not None:
            entry = cache.get(sp.shard_id)
            if entry is not None and entry[1] == sp.generation:
                return entry[0]
        conn = self._connect(sp)
        self._cache_conn(sp, conn)
        return conn

    def _drop_conn(self, sp: _ShardProc) -> None:
        cache = getattr(self._tls, "conns", None)
        if cache is not None:
            entry = cache.pop(sp.shard_id, None)
            if entry is not None:
                self._close_sock(entry[0])

    # -- breaker + hedging plumbing --------------------------------------------
    def _breaker_failure(self, shard_id: int) -> None:
        if self.breakers[shard_id].record_failure():
            _M_BREAKER_TRIPS.inc(label=str(shard_id))
        self._breaker_gauge()

    def _breaker_gauge(self) -> None:
        _M_BREAKER_OPEN.set(sum(1 for b in self.breakers
                                if b.state != CircuitBreaker.CLOSED))

    def _slow_threshold(self) -> Optional[float]:
        """The latency above which a SUCCESSFUL call still counts as a
        breaker failure — fed back from the `shard.rpc.seconds` histogram
        (a multiple of its p99, floored so ordinary jitter never trips),
        None until enough samples exist. Cached briefly: quantile() merges
        every thread cell and must not run per call."""
        now = time.monotonic()
        if now - self._slow_cache[0] > 0.25:
            p = _M_RPC_S.quantile(0.99, min_count=self.hedge_min_samples)
            self._slow_cache = (
                now, None if p is None else
                max(self.breaker_slow_floor_s, self.breaker_slow_mult * p))
        return self._slow_cache[1]

    def _hedge_delay(self) -> float:
        """How long a primary sub-request may stay unanswered before a
        hedge is issued: the observed `shard.rpc.seconds` quantile
        (default p95), floored (hedging under normal jitter doubles load
        for nothing) and capped (the whole point is beating a 50ms stall),
        with a fixed default until the histogram has enough samples."""
        now = time.monotonic()
        if now - self._hedge_cache[0] > 0.25:
            p = _M_RPC_S.quantile(self.hedge_quantile,
                                  min_count=self.hedge_min_samples)
            d = self.hedge_default_s if p is None else p
            self._hedge_cache = (
                now, min(self.hedge_cap_s, max(self.hedge_floor_s, d)))
        return self._hedge_cache[1]

    def _rpc_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                n = self.rpc_pool_size or max(8, 4 * len(self.shards))
                self._pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="graphdb-rpc")
            return self._pool

    def _remote_error(self, shard_id: int, meta: Dict[str, Any]):
        """Map a worker-side ST_ERROR frame back to a LOCAL typed error
        where the lifecycle depends on the type crossing the wire; every
        other kind stays a ShardRemoteError carrying the kind string."""
        kind = meta.get("kind", "Error")
        message = meta.get("message", "")
        if kind == "DeadlineExceeded":
            _M_DEADLINE.inc(label="rpc")
            return DeadlineExceeded(f"shard {shard_id}: {message}")
        if kind in ("OverloadError", "ShardOverloadError"):
            return ShardOverloadError(shard_id, "remote", message)
        return ShardRemoteError(shard_id, kind, message)

    def _call(self, shard_id: int, op: str, kw: Dict[str, Any],
              arrays: Optional[Dict[str, np.ndarray]] = None,
              retry: bool = True,
              deadline: Optional[Deadline] = None,
              probe: bool = False
              ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """One request/response exchange with a shard, under the full
        request lifecycle (module docstring):

          * the deadline (explicit, else the thread's ambient scope) is
            checked before every attempt, rides in frame meta, and caps
            the socket timeout, the retry sleeps, and any respawn wait;
          * reads (`retry=True`) survive worker death — supervised
            respawn, then exponential-backoff-with-jitter retries (they
            are idempotent against the recovered state); writes
            (`retry=False`) raise `ShardUnavailable` because the WAL may
            or may not have acknowledged the mutation, and replaying it
            blindly could double-apply;
          * a socket timeout poisons the CONNECTION only (frame alignment
            is unknown) — the worker is presumed alive-but-slow, so no
            respawn and no generation bump (other threads' pins survive);
          * the shard's circuit breaker fails non-probe calls fast with
            `ShardOverloadError` while open, and every attempt's outcome
            (including histogram-classified slow successes) feeds it.
        """
        sp = self.shards[shard_id]
        if self._closed:
            raise ShardUnavailable(shard_id, "router closed")
        dl = deadline if deadline is not None else current_deadline()
        br = self.breakers[shard_id]
        if not probe and not br.allow():
            _M_BREAKER_FF.inc(label=str(shard_id))
            raise ShardOverloadError(shard_id, "breaker_open",
                                     f"fast-failed {op}")
        request: Dict[str, Any] = {"op": op, "kw": kw}
        if telemetry.enabled():
            # the caller's trace context (if any) crosses the process
            # boundary in frame meta — a retried read after a respawn
            # re-sends it, so the restarted worker joins the same trace
            request["trace"] = telemetry.current_context()
        t0 = time.perf_counter()
        _M_RPC_INFLIGHT.inc()
        try:
            with telemetry.span("shard.rpc", shard=shard_id, op=op):
                return self._call_attempts(sp, op, request, arrays, retry,
                                           dl)
        finally:
            _M_RPC_INFLIGHT.inc(-1)
            _M_RPC_REQS.inc(label=op)
            _M_RPC_S.observe(time.perf_counter() - t0, label=str(shard_id))

    def _call_attempts(self, sp: _ShardProc, op: str,
                       request: Dict[str, Any],
                       arrays: Optional[Dict[str, np.ndarray]],
                       retry: bool, dl: Optional[Deadline]
                       ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        shard_id = sp.shard_id
        attempts = (self.read_retries + 1) if retry else 1
        pacing = backoff_delays(self.backoff_base_s, self.backoff_cap_s,
                                attempts, self._retry_rng)
        last_exc: Optional[BaseException] = None
        for attempt in range(attempts):
            if dl is not None:
                try:
                    dl.check(f"shard {shard_id} {op}")
                except DeadlineExceeded:
                    _M_DEADLINE.inc(label="rpc")
                    raise
                request["deadline"] = dl.to_budget()
            timed_out = False
            a0 = time.perf_counter()
            try:
                conn = self._conn(sp)
                conn.settimeout(dl.timeout(cap=self.op_timeout_s)
                                if dl is not None else self.op_timeout_s)
                send_frame(conn, ST_REQUEST, request, arrays)
                status, meta, rarrays = recv_frame(conn)
            except socket.timeout as exc:
                # frame alignment on this connection is now unknown —
                # poison it; the worker is presumed alive-but-slow
                self._drop_conn(sp)
                timed_out = True
                last_exc = exc
            except ShardProtocolError:
                # a misframed stream is unrecoverable
                self._drop_conn(sp)
                raise
            except (OSError, ConnectionError) as exc:
                self._drop_conn(sp)
                last_exc = exc
            else:
                # the worker ANSWERED: transport is healthy. A response
                # slower than the histogram-derived threshold still feeds
                # the breaker as a failure (gray workers answer, late).
                slow = self._slow_threshold()
                if slow is not None and (time.perf_counter() - a0) > slow:
                    self._breaker_failure(shard_id)
                else:
                    self.breakers[shard_id].record_success()
                    self._breaker_gauge()
                if status == ST_ERROR:
                    raise self._remote_error(shard_id, meta)
                return meta, rarrays
            # -- transport failure or timeout ------------------------------
            self._breaker_failure(shard_id)
            if self._closed:
                raise ShardUnavailable(shard_id, "router closed")
            if dl is not None and dl.expired():
                # the remaining budget decides the TYPE: a retry that no
                # longer fits raises DeadlineExceeded, not ShardUnavailable
                _M_DEADLINE.inc(label="rpc")
                raise DeadlineExceeded(
                    f"shard {shard_id} {op} (after {attempt + 1} "
                    f"attempt{'s' if attempt else ''})",
                    -dl.remaining()) from last_exc
            if not retry or attempt == attempts - 1:
                raise ShardUnavailable(
                    shard_id, f"{op} failed: {last_exc}") from last_exc
            if not timed_out:
                # the worker looks dead — supervised respawn (bounded by
                # the remaining budget when a deadline is carried)
                self.restart_shard(shard_id, deadline=dl)
            _M_RPC_RETRIES.inc(label=op)
            delay = next(pacing)
            if dl is not None:
                delay = min(delay, max(0.0, dl.remaining()))
            if delay > 0.0:
                time.sleep(delay)
        raise ShardUnavailable(shard_id, f"{op}: retry exhausted")

    # -- hedged fan-out --------------------------------------------------------
    def _gather(self, calls: Sequence[Tuple[int, str, Dict[str, Any],
                                            Optional[Dict[str, np.ndarray]]]],
                deadline: Optional[Deadline] = None) -> List[Tuple]:
        """Issue `(shard_id, op, kw, arrays)` calls concurrently with
        hedging, returning results IN CALL ORDER (gather order must be
        deterministic — bitwise comparability of scatter/gather reads
        depends on it, not on completion order). Each primary that has
        not answered within the hedge delay of its submit gets ONE hedge
        on a fresh pool thread (fresh connection); first response wins.
        Live (non-view) reads only — epoch pins are connection-scoped.
        Falls back to plain sequential calls when hedging is off."""
        dl = deadline if deadline is not None else current_deadline()
        if not self.hedge or self._closed:
            return [self._call(s, op, kw, arr, deadline=dl)
                    for s, op, kw, arr in calls]
        pool = self._rpc_pool()
        ctx = telemetry.current_context() if telemetry.enabled() else None

        def attempt(c):
            s, op, kw, arr = c

            def run():
                with telemetry.attach(ctx):
                    return self._call(s, op, kw, arr, retry=True,
                                      deadline=dl)
            return run

        primaries = [pool.submit(attempt(c)) for c in calls]
        t0 = time.monotonic()
        hd = self._hedge_delay()
        out: List[Tuple] = []
        for c, prim in zip(calls, primaries):
            try:
                out.append(prim.result(
                    timeout=max(0.0, t0 + hd - time.monotonic())))
                continue
            except _FutTimeout:
                pass
            _M_HEDGES_SENT.inc(label=str(c[0]))
            hedge = pool.submit(attempt(c))
            out.append(self._first_response(c[0], prim, hedge))
        return out

    @staticmethod
    def _first_response(shard_id: int, primary, hedge):
        """First SUCCESS of {primary, hedge} wins; if both fail, surface
        the primary's error (the hedge raced the same fault)."""
        pending = {primary, hedge}
        while pending:
            done, pending = _fut_wait(pending,
                                      return_when=FIRST_COMPLETED)
            for f in done:
                if f.exception() is None:
                    if f is hedge:
                        _M_HEDGES_WON.inc(label=str(shard_id))
                    return f.result()
        return primary.result()  # re-raises the primary's exception

    # -- write surface ---------------------------------------------------------
    def insert_edges(self, src, dst, etype=None, columns=None) -> None:
        """Scatter a batch to its owner shards (by SOURCE vertex). The
        batch is atomic per shard, not across shards: a concurrent view
        may see one shard's slice before another's (DESIGN.md §12)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        owner = self.config.shard_of(src)
        for s in np.unique(owner):
            idx = np.flatnonzero(owner == s)
            arrays = {"src": src[idx], "dst": dst[idx]}
            if etype is not None:
                arrays["etype"] = np.asarray(etype)[idx]
            for name, col in (columns or {}).items():
                arrays[f"col:{name}"] = np.asarray(col)[idx]
            self._call(int(s), "insert_edges", {}, arrays, retry=False)

    def insert_edge(self, src: int, dst: int, etype: int = 0, **cols) -> None:
        self.insert_edges([src], [dst], etype=[etype],
                          columns={k: [v] for k, v in cols.items()} or None)

    def delete_edge(self, src: int, dst: int) -> bool:
        s = int(self.config.shard_of([src])[0])
        meta, _ = self._call(s, "delete_edge",
                             {"src": int(src), "dst": int(dst)}, retry=False)
        return bool(meta["found"])

    def checkpoint_all(self) -> None:
        for sp in self.shards:
            self._call(sp.shard_id, "checkpoint", {}, retry=False)

    # -- read surface ----------------------------------------------------------
    def out_neighbors(self, v: int) -> np.ndarray:
        """Single-shard routed read (the owner holds ALL of v's out-edges).
        Hedged: a stalled owner's sub-request is re-issued after the hedge
        delay, first response wins."""
        s = int(self.config.shard_of([v])[0])
        _, arrays = self._gather([(s, "out_neighbors",
                                   {"v": int(v)}, None)])[0]
        return arrays["nb"]

    def in_neighbors(self, v: int) -> np.ndarray:
        """Hedged broadcast + merge (in-edges of v are scattered across
        every shard's stores). Returned SORTED — the canonical cross-shard
        order; per-slab order would depend on each shard's private merge
        history (and, now, on which of primary/hedge answered first)."""
        calls = [(sp.shard_id, "in_neighbors", {"v": int(v)}, None)
                 for sp in self.shards]
        parts = [arrays["nb"] for _, arrays in self._gather(calls)]
        return np.sort(np.concatenate(parts)) if parts else \
            np.empty(0, np.int64)

    @property
    def n_edges(self) -> int:
        return sum(self._call(sp.shard_id, "n_edges", {})[0]["n_edges"]
                   for sp in self.shards)

    def worker_runtime(self) -> List[Dict[str, Any]]:
        """Per-shard: the worker's pid, which of jax / repro / torch it
        has imported, and whether it created a CUDA context (it must not:
        workers serve host slabs only)."""
        return [self._call(sp.shard_id, "runtime", {}, retry=False)[0]
                for sp in self.shards]

    def io_stats(self) -> List[Dict[str, Any]]:
        """Per-shard block-read accounting (bench_shard.py's evidence that
        scatter/gather actually partitions the work)."""
        return [self._call(sp.shard_id, "io_stats", {})[0]
                for sp in self.shards]

    # -- observability ---------------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """Router-process metrics plus every reachable worker's, with an
        exact cross-process aggregate (histograms merge bucket-wise,
        counters sum — telemetry.merge_snapshots). A dead shard is simply
        absent from `shards`; it still counts in `aggregate` only through
        whatever the router itself recorded about it."""
        router = telemetry.snapshot()
        shards = []
        for sp in self.shards:
            try:
                meta, _ = self._call(sp.shard_id, "telemetry", {})
                shards.append(meta["metrics"])
            except (GraphDBError, OSError, ConnectionError):
                pass
        return {"router": router, "shards": shards,
                "aggregate": telemetry.merge_snapshots([router] + shards)}

    def trace_export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """One Chrome-trace-event document stitching the router's spans
        with every worker's. Span timestamps are epoch microseconds, so
        events from different processes align on a common axis; a query's
        trace id ties its router-side span to the worker spans it caused
        (they attached the context from frame meta). Loadable in
        Perfetto / chrome://tracing."""
        events = list(telemetry.trace_events())
        for sp in self.shards:
            try:
                meta, _ = self._call(sp.shard_id, "telemetry",
                                     {"trace": True})
                events.extend(meta.get("trace", []))
            except (GraphDBError, OSError, ConnectionError):
                pass
        return telemetry.trace_export(events=events, path=path)

    def health_summary(self) -> Dict[str, Any]:
        """Cluster-level readiness folded over per-shard health(): ready
        iff every worker is alive and itself ready (WAL tail within
        budget, backlog under backpressure, nothing poisoned, writable)."""
        per = self.health()
        alive = [h for h in per if h.get("alive")]
        return {
            "n_shards": len(per),
            "alive": len(alive),
            "ready": (len(alive) == len(per)
                      and all(h.get("ready", False) for h in alive)),
            "restarts": int(self.restarts),
            "poisoned_count": sum(int(h.get("poisoned_count", 0))
                                  for h in alive),
            "backlog_edges": sum(int(h.get("backlog_edges", 0))
                                 for h in alive),
            "shards": per,
        }

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        ss, dd = [], []
        for sp in self.shards:
            _, arrays = self._call(sp.shard_id, "coo", {})
            ss.append(arrays["src"])
            dd.append(arrays["dst"])
        return np.concatenate(ss), np.concatenate(dd)

    # -- epochs ----------------------------------------------------------------
    def pin_view(self) -> "ShardedView":
        """Pin one published manifest in every shard and return the
        cross-shard view. The pins live on THIS thread's connections, so a
        view must be used and released by the thread that created it (the
        same discipline as ManifestView's pin slot)."""
        return ShardedView(self)

    def storage_engine(self) -> "ShardedEngine":
        """An engine over ad-hoc per-op pins (each scatter/gather op pins
        and releases inside every worker). For a multi-op consistent read,
        use `pin_view().storage_engine()`."""
        return ShardedEngine(self, view=None)


# ---------------------------------------------------------------------------
# sharded view + engine
# ---------------------------------------------------------------------------
class ShardedView:
    """A vector of per-shard epoch pins: shard i answers every read from
    its pinned manifest, so a multi-op query (k-hop, FoF) sees N frozen
    per-shard states. Cross-shard consistency model: per-shard prefix
    (DESIGN.md §12) — quiesced (no concurrent writer), it equals the
    unsharded store exactly."""

    def __init__(self, router: ShardRouter):
        self.router = router
        self.epochs: Dict[int, int] = {}
        self.versions: Dict[int, int] = {}
        self._released = False
        self._thread = threading.get_ident()
        try:
            # pinning is an idempotent read: it may transparently respawn a
            # dead worker (the fresh pin then covers the recovered state)
            for sp in router.shards:
                meta, _ = router._call(sp.shard_id, "pin_epoch", {})
                self.epochs[sp.shard_id] = int(meta["epoch"])
                self.versions[sp.shard_id] = int(meta["version"])
        except GraphDBError:
            self.release()
            raise

    def _epoch_kw(self, shard_id: int) -> Dict[str, Any]:
        if self._released:
            raise ShardEpochLost(shard_id)
        return {"epoch": self.epochs[shard_id]}

    def call(self, shard_id: int, op: str, kw: Dict[str, Any],
             arrays: Optional[Dict[str, np.ndarray]] = None):
        """A read against this view's pin on `shard_id`. Never auto-retries
        across a worker restart: the pin died with the worker and a silent
        re-pin would splice two different epochs into one 'view'."""
        kw = {**kw, **self._epoch_kw(shard_id)}
        try:
            return self.router._call(shard_id, op, kw, arrays, retry=False)
        except ShardRemoteError as exc:
            if "epoch token" in str(exc):
                raise ShardEpochLost(shard_id) from exc
            raise
        except ShardUnavailable as exc:
            raise ShardEpochLost(shard_id) from exc

    # -- store duck type (as_engine dispatches through this) ------------------
    @property
    def intervals(self) -> IntervalMap:
        return self.router.intervals

    @property
    def n_edges(self) -> int:
        return sum(self.call(sp.shard_id, "n_edges", {})[0]["n_edges"]
                   for sp in self.router.shards)

    def out_neighbors(self, v: int) -> np.ndarray:
        s = int(self.router.config.shard_of([v])[0])
        return self.call(s, "out_neighbors", {"v": int(v)})[1]["nb"]

    def in_neighbors(self, v: int) -> np.ndarray:
        parts = [self.call(sp.shard_id, "in_neighbors", {"v": int(v)})[1]
                 ["nb"] for sp in self.router.shards]
        return np.sort(np.concatenate(parts))

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        ss, dd = [], []
        for sp in self.router.shards:
            _, arrays = self.call(sp.shard_id, "coo", {})
            ss.append(arrays["src"])
            dd.append(arrays["dst"])
        return np.concatenate(ss), np.concatenate(dd)

    def begin_snapshot_dirs(self) -> List[str]:
        """Export every shard's pinned epoch as an on-disk session dir
        (`ServiceDB.begin_snapshot(view=...)` inside the worker): any
        process may `Snapshot.open` them and read state bitwise-equal to
        this view's pins — the hard-link machinery crossing the shard
        boundary."""
        return [self.call(sp.shard_id, "snapshot", {})[0]["dir"]
                for sp in self.router.shards]

    def storage_engine(self) -> "ShardedEngine":
        return ShardedEngine(self.router, view=self)

    # -- lifecycle -------------------------------------------------------------
    def release(self) -> None:
        if self._released:
            return
        self._released = True
        for shard_id, token in self.epochs.items():
            try:
                self.router._call(shard_id, "release_epoch",
                                  {"epoch": token}, retry=False)
            except (GraphDBError, OSError, ConnectionError):
                pass  # a dead worker already dropped the pin

    close = release

    def __enter__(self) -> "ShardedView":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ShardedEngine(StorageEngine):
    """StorageEngine whose slab probes happen inside shard workers.

    Scatter/gather: out-direction ops slice the query vertices by owner
    shard and ship only each shard's slice; in-direction ops broadcast the
    whole batch. Results come back as flat (owner, neighbor) pairs with
    owner indices mapped to the caller's positions, so the columnar
    operators in core/multihop.py consume them unchanged. Only the
    "sparse" hop mode is supported (`supported_hop_modes`): stream/kernel
    modes need the whole edge set, which must not cross the wire per hop.
    """

    supported_hop_modes = ("sparse",)

    def __init__(self, router: ShardRouter, view: Optional[ShardedView]):
        super().__init__(view if view is not None else router)
        self.router = router
        self.view = view

    # -- plumbing --------------------------------------------------------------
    @property
    def intervals(self) -> IntervalMap:
        return self.router.intervals

    @property
    def n_internal_vertices(self) -> int:
        return self.router.intervals.max_vertices

    def _slabs(self):
        raise NotImplementedError(
            "sharded engines have no local slabs: reads are scattered to "
            "shard workers (open a per-shard Snapshot for slab access)")

    def cache_token(self):
        return None  # plans are never built router-side (sparse-only)

    def _shard_call(self, shard_id: int, op: str, kw, arrays):
        if self.view is not None:
            return self.view.call(shard_id, op, kw, arrays)
        return self.router._call(shard_id, op, kw, arrays)

    def _scatter(self, vs: np.ndarray, direction: str, op: str,
                 kw: Dict[str, Any]):
        """Yield (global index array, response arrays) per shard:
        out-direction scatters owner slices, in-direction broadcasts.
        Live (view-less) reads fan out through the router's hedged gather
        — sub-requests run concurrently and a stalled shard's is re-issued
        after the hedge delay; pinned-view reads stay sequential on the
        calling thread (epoch pins are connection-scoped, and a hedge on
        another connection would answer from a different epoch). Either
        way results are yielded in deterministic shard order, so gather
        output is independent of completion order (bitwise gates)."""
        cfg = self.router.config
        if direction == "out":
            owner = cfg.shard_of(vs)
            shards = [int(s) for s in np.unique(owner)]
            idxs = [np.flatnonzero(owner == s) for s in shards]
            payloads = [{"vs": vs[i]} for i in idxs]
        else:
            shards = [sp.shard_id for sp in self.router.shards]
            idx = np.arange(vs.shape[0], dtype=np.int64)
            idxs = [idx] * len(shards)
            payloads = [{"vs": vs}] * len(shards)
        if self.view is not None:
            for s, i, p in zip(shards, idxs, payloads):
                yield i, self.view.call(s, op, kw, p)[1]
        else:
            calls = [(s, op, kw, p) for s, p in zip(shards, payloads)]
            for i, (_, arrays) in zip(idxs, self.router._gather(calls)):
                yield i, arrays

    # -- the scatter/gather read surface --------------------------------------
    def expand_frontier(self, vs, direction: str = "out", predicate=None,
                        ) -> Tuple[np.ndarray, np.ndarray]:
        vs = np.asarray(vs, dtype=np.int64).ravel()
        if vs.shape[0] == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        kw = {"direction": direction,
              "predicate": (dataclasses.asdict(predicate)
                            if predicate is not None else None)}
        owners, vals = [], []
        for idx, arrays in self._scatter(vs, direction, "expand", kw):
            if arrays["owner"].shape[0]:
                owners.append(idx[arrays["owner"]])
                vals.append(arrays["nb"])
        if not vals:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return np.concatenate(owners), np.concatenate(vals)

    def _neighbors_batch(self, vs, direction: str):
        from .multihop import _csr_offsets
        vs = np.asarray(vs, dtype=np.int64).ravel()
        owner, nb = self.expand_frontier(vs, direction)
        order = np.argsort(owner, kind="stable")
        return nb[order], _csr_offsets(owner[order], vs.shape[0])

    def _degree_batch(self, vs, direction: str) -> np.ndarray:
        vs = np.asarray(vs, dtype=np.int64).ravel()
        deg = np.zeros(vs.shape[0], np.int64)
        for idx, arrays in self._scatter(vs, direction, "degree_batch",
                                         {"direction": direction}):
            deg[idx] += arrays["deg"]
        return deg

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        g = self.graph
        return g.to_coo()
