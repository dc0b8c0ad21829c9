"""Admission-controlled serving front end.

The paper's online-graph-database claim (§5-6) is not just throughput —
it is throughput under load WITHOUT unbounded queues. `FrontDesk` is the
serving layer in front of a store (a `ServiceDB` or a `ShardRouter`)
that turns many concurrent point requests into the engine's
set-at-a-time batched reads while refusing, typed and in microseconds,
any request it predicts it cannot finish in time:

  * **Bounded queue, typed shedding.** One FIFO request queue with a
    hard cap. Admission sheds with `OverloadError` — `queue_full` when
    the cap is hit, `queue_delay` when the EWMA-estimated drain time
    already exceeds the request's remaining deadline budget, `read_only`
    / `backpressure` for writes the backing `ServiceDB` could not accept
    (its `admission_state()`), `closed` after shutdown. Shedding happens
    in the submitting thread BEFORE enqueue: the caller learns in
    microseconds, and no doomed work ever occupies a dispatcher.
  * **Coalescing.** Dispatcher threads drain the queue in same-kind
    batches: concurrent `out_neighbors`/`in_neighbors` point lookups
    become one `*_neighbors_batch` slab sweep, `fof` requests one
    `multihop.two_hop_counts` seed batch, `getrange` one
    `edge_columns_batch`, and inserts one grouped `insert_edges` — the
    set-at-a-time engine surface (DESIGN.md §10) doing for serving what
    it already did for analytics. Batch results come back in canonical
    sorted order, so answers are independent of batching, hedging, and
    shard merge history (the chaos bench's bitwise gate).
  * **Deadline discipline.** Every request carries a `Deadline`
    (explicit, ambient `deadline_scope`, or the configured default). It
    is checked at admission, re-checked when the dispatcher picks the
    request up (a request that expired while queued is answered
    `DeadlineExceeded` without touching the engine), scoped around the
    engine call (shard RPCs under it inherit the budget — timeouts,
    retry pacing, hedges), and checked once more at delivery: a result
    that arrives past its deadline is replaced by `DeadlineExceeded`,
    so NO request ever completes late without a typed error.
  * **Engine scope.** Over a `ServiceDB` each batch reads one epoch view
    (lock-free pin); over a `ShardRouter` batches use the live hedged
    scatter/gather engine — per-op pins, first-response-wins hedging
    (pinned cross-shard views are connection-scoped and must not cross
    dispatcher threads).

The dispatcher crosses the `frontdesk.dispatch` failpoint per batch, so
the chaos suite can inject dispatcher-side latency; every decision is
counted in the `frontdesk.*` telemetry catalog.

Host copy of the reference `repro/core/frontdesk.py`. `fof` batches run
`two_hop_counts` with its default `dense="never"`: sparse host probes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np

from . import telemetry
from .deadline import Deadline, current_deadline, deadline_scope
from .failpoints import failpoint
from .integrity import DeadlineExceeded, OverloadError

__all__ = ["FrontDesk", "FrontDeskStats"]

_M_REQS = telemetry.counter("frontdesk.requests")
_M_SHEDS = telemetry.counter("frontdesk.sheds")
_M_BATCHES = telemetry.counter("frontdesk.batches")
_M_BATCHED = telemetry.counter("frontdesk.batched_ops")
_M_QUEUE_S = telemetry.histogram("frontdesk.queue.seconds")
_M_DEPTH = telemetry.gauge("frontdesk.depth")
_M_DEADLINE = telemetry.counter("request.deadline_exceeded")

_READ_OPS = ("out_neighbors", "in_neighbors", "fof", "getrange")
_OPS = _READ_OPS + ("insert",)


@dataclasses.dataclass
class FrontDeskStats:
    admitted: int = 0
    shed: int = 0
    batches: int = 0
    batched_ops: int = 0
    deadline_misses: int = 0    # typed-late: queued-past or delivered-past


class _Req:
    __slots__ = ("op", "args", "deadline", "future", "t_enq")

    def __init__(self, op: str, args: Dict[str, Any],
                 deadline: Optional[Deadline]):
        self.op = op
        self.args = args
        self.deadline = deadline
        self.future: Future = Future()
        self.t_enq = time.perf_counter()


class FrontDesk:
    """The admission-controlled request front end (module docstring).

    `submit(op, deadline=..., **args)` returns a `concurrent.futures.
    Future`; the sync helpers (`out_neighbors`, `in_neighbors`,
    `friends_of_friends`, `getrange`, `insert_edges`) submit and wait.
    Admission failures raise synchronously in the submitting thread
    (`OverloadError` / `DeadlineExceeded`); failures after admission are
    delivered through the future, always typed.
    """

    def __init__(self, store, queue_cap: int = 1024, max_batch: int = 256,
                 dispatchers: int = 1,
                 default_deadline_s: Optional[float] = None,
                 drain_ewma_alpha: float = 0.2):
        self.store = store
        self.queue_cap = int(queue_cap)
        self.max_batch = int(max_batch)
        self.default_deadline_s = default_deadline_s
        self.stats = FrontDeskStats()
        self._alpha = float(drain_ewma_alpha)
        self._req_s_ewma = 0.0          # EWMA seconds per admitted request
        self._adm_cache = (-1e9, None)  # (monotonic, admission_state doc)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        self._threads = [
            threading.Thread(target=self._run, name=f"frontdesk-{i}",
                             daemon=True)
            for i in range(max(1, int(dispatchers)))
        ]
        for t in self._threads:
            t.start()

    # -- admission (submitting thread) ----------------------------------------
    def _shed(self, reason: str, detail: str = "") -> None:
        _M_SHEDS.inc(label=reason)
        self.stats.shed += 1
        raise OverloadError(reason, detail)

    def _write_admission(self) -> None:
        """Shed writes the backing service could not accept — read-only
        degradation and writer backpressure become
        front-door sheds instead of a blocked dispatcher. Polled state is
        briefly cached: admission must stay microseconds."""
        poll = getattr(self.store, "admission_state", None)
        if poll is None:
            return  # ShardRouter: each worker enforces its own bounds
        now = time.monotonic()
        if now - self._adm_cache[0] > 0.05:
            self._adm_cache = (now, poll())
        adm = self._adm_cache[1]
        if adm is None or adm.get("accepting_writes", True):
            return
        if adm.get("read_only"):
            self._shed("read_only", str(adm.get("read_only_reason") or ""))
        self._shed("backpressure",
                   f"backlog {adm.get('backlog_edges')} > bound "
                   f"{adm.get('backpressure_edges')}")

    def _estimated_queue_delay(self, depth: int) -> float:
        """Predicted time until a request admitted NOW gets dispatched:
        queue depth x the EWMA per-request service time, split across
        dispatchers. Zero until the first batch completes — the front
        desk never sheds on a cold estimate."""
        return depth * self._req_s_ewma / max(1, len(self._threads))

    def submit(self, op: str, deadline: Optional[Deadline] = None,
               **args) -> Future:
        if op not in _OPS:
            raise ValueError(f"unknown front-desk op {op!r} "
                             f"(expected one of {_OPS})")
        dl = deadline if deadline is not None else current_deadline()
        if dl is None and self.default_deadline_s is not None:
            dl = Deadline.after(self.default_deadline_s)
        if self._closed:
            self._shed("closed")
        if dl is not None and dl.expired():
            _M_DEADLINE.inc(label="frontdesk")
            self.stats.deadline_misses += 1
            raise DeadlineExceeded(f"frontdesk {op} (at admission)",
                                   -dl.remaining())
        if op == "insert":
            self._write_admission()
        req = _Req(op, args, dl)
        with self._nonempty:
            if self._closed:
                self._shed("closed")
            depth = len(self._q)
            if depth >= self.queue_cap:
                self._shed("queue_full", f"depth {depth}")
            if dl is not None:
                est = self._estimated_queue_delay(depth)
                if est > max(0.0, dl.remaining()):
                    self._shed("queue_delay",
                               f"estimated {est * 1e3:.1f}ms wait > "
                               f"{max(0.0, dl.remaining()) * 1e3:.1f}ms "
                               f"budget")
            self._q.append(req)
            _M_DEPTH.set(len(self._q))
            self._nonempty.notify()
        _M_REQS.inc(label=op)
        self.stats.admitted += 1
        return req.future

    # -- sync helpers ----------------------------------------------------------
    def out_neighbors(self, v: int, deadline: Optional[Deadline] = None
                      ) -> np.ndarray:
        return self.submit("out_neighbors", deadline, v=int(v)).result()

    def in_neighbors(self, v: int, deadline: Optional[Deadline] = None
                     ) -> np.ndarray:
        return self.submit("in_neighbors", deadline, v=int(v)).result()

    def friends_of_friends(self, v: int,
                           deadline: Optional[Deadline] = None
                           ) -> np.ndarray:
        return self.submit("fof", deadline, v=int(v)).result()

    def getrange(self, v: int, deadline: Optional[Deadline] = None
                 ) -> Dict[str, Any]:
        return self.submit("getrange", deadline, v=int(v)).result()

    def insert_edges(self, src, dst, etype=None,
                     deadline: Optional[Deadline] = None) -> int:
        return self.submit(
            "insert", deadline,
            src=np.asarray(src, np.int64), dst=np.asarray(dst, np.int64),
            etype=None if etype is None else np.asarray(etype)).result()

    # -- dispatch (worker threads) ---------------------------------------------
    def _take_batch(self) -> Optional[List[_Req]]:
        """Pop up to `max_batch` SAME-KIND requests. The batch kind is the
        queue head's (FIFO head never starves); later same-kind requests
        are pulled forward past other kinds — that cross-kind reorder is
        what makes coalescing real under a mixed op stream, and requests
        are independent (each carries its own deadline). Returns None
        only when closed AND drained."""
        with self._nonempty:
            while not self._q and not self._closed:
                self._nonempty.wait(timeout=0.1)
            if not self._q:
                return None
            kind = self._q[0].op
            batch: List[_Req] = []
            rest: List[_Req] = []
            while self._q and len(batch) < self.max_batch:
                r = self._q.popleft()
                (batch if r.op == kind else rest).append(r)
            self._q.extendleft(reversed(rest))
            _M_DEPTH.set(len(self._q))
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as exc:  # noqa: BLE001 — deliver, never die
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(exc)

    def _dispatch(self, batch: List[_Req]) -> None:
        now = time.perf_counter()
        live: List[_Req] = []
        for r in batch:
            _M_QUEUE_S.observe(now - r.t_enq, label=r.op)
            if r.deadline is not None and r.deadline.expired():
                # expired while queued: answered typed, engine untouched
                _M_DEADLINE.inc(label="frontdesk")
                self.stats.deadline_misses += 1
                r.future.set_exception(DeadlineExceeded(
                    f"frontdesk {r.op} (expired in queue)",
                    -r.deadline.remaining()))
            else:
                live.append(r)
        if not live:
            return
        failpoint("frontdesk.dispatch")
        kind = live[0].op
        # the engine call runs under the batch's LOOSEST deadline (any
        # no-deadline member => unscoped): members with tighter budgets
        # are enforced individually at delivery below
        scope = None
        if all(r.deadline is not None for r in live):
            scope = max((r.deadline for r in live), key=lambda d: d.at)
        t0 = time.perf_counter()
        try:
            with deadline_scope(scope):
                results = self._execute(kind, live)
        except Exception as exc:  # typed errors fan out to every member
            for r in live:
                r.future.set_exception(exc)
            return
        dt = time.perf_counter() - t0
        per_req = dt / len(live)
        self._req_s_ewma = (per_req if self._req_s_ewma == 0.0 else
                            (1.0 - self._alpha) * self._req_s_ewma
                            + self._alpha * per_req)
        _M_BATCHES.inc(label=kind)
        _M_BATCHED.inc(len(live), label=kind)
        self.stats.batches += 1
        self.stats.batched_ops += len(live)
        for r, res in zip(live, results):
            if r.deadline is not None and r.deadline.expired():
                # finished, but late: deliver typed — the "no request
                # completes past its deadline without a typed error" gate
                _M_DEADLINE.inc(label="frontdesk")
                self.stats.deadline_misses += 1
                r.future.set_exception(DeadlineExceeded(
                    f"frontdesk {r.op} (finished late)",
                    -r.deadline.remaining()))
            else:
                r.future.set_result(res)

    @contextmanager
    def _engine_scope(self):
        """One engine per batch. ServiceDB: a lock-free epoch view (the
        whole batch reads one frozen manifest). ShardRouter: the LIVE
        scatter/gather engine — hedged, per-op pins (a pinned cross-shard
        view is connection-scoped and cannot be shared with hedge
        threads). Anything else: as_engine passthrough."""
        store = self.store
        if hasattr(store, "pin_view"):
            yield store.storage_engine()
        elif hasattr(store, "read_view"):
            with store.read_view() as view:
                yield view.storage_engine()
        else:
            from .engine import as_engine
            yield as_engine(store)

    def _execute(self, kind: str, live: List[_Req]) -> List[Any]:
        if kind == "insert":
            srcs = [r.args["src"] for r in live]
            dsts = [r.args["dst"] for r in live]
            etypes = [r.args.get("etype") for r in live]
            src = np.concatenate([np.asarray(s, np.int64).ravel()
                                  for s in srcs])
            dst = np.concatenate([np.asarray(d, np.int64).ravel()
                                  for d in dsts])
            etype = None
            if any(e is not None for e in etypes):
                etype = np.concatenate([
                    (np.zeros(np.asarray(s).size, np.int64) if e is None
                     else np.asarray(e, np.int64).ravel())
                    for s, e in zip(srcs, etypes)])
            # ONE grouped write: per-shard scatter (router) or one WAL
            # group commit (service) instead of N tiny ones
            self.store.insert_edges(src, dst, etype=etype)
            return [int(np.asarray(s).size) for s in srcs]

        vs = np.asarray([r.args["v"] for r in live], np.int64)
        with self._engine_scope() as eng:
            if kind in ("out_neighbors", "in_neighbors"):
                direction = "out" if kind == "out_neighbors" else "in"
                vals, offs = eng._neighbors_batch(vs, direction)
                # canonical sorted order: answers independent of slab
                # order, shard merge history, and who won a hedge
                return [np.sort(vals[offs[i]:offs[i + 1]])
                        for i in range(len(live))]
            if kind == "fof":
                from .multihop import two_hop_counts
                res = two_hop_counts(eng, vs)
                return [res.ids[res.slice_of(i)] for i in range(len(live))]
            if kind == "getrange":
                eb = eng.edge_columns_batch(vs)
                offs = eb.offsets
                out = []
                for i in range(len(live)):
                    sl = slice(int(offs[i]), int(offs[i + 1]))
                    out.append({
                        "src": eb.src[sl], "dst": eb.dst[sl],
                        "etype": eb.etype[sl],
                        "columns": {k: c[sl]
                                    for k, c in eb.columns.items()},
                    })
                return out
        raise ValueError(f"unknown front-desk op {kind!r}")

    # -- lifecycle -------------------------------------------------------------
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def close(self, drain: bool = True) -> None:
        """Stop admitting, drain (or shed) the queue, join dispatchers.
        Idempotent. With `drain=False` queued requests are failed typed
        (`OverloadError("closed")`) instead of executed."""
        with self._nonempty:
            if self._closed:
                closed_already = True
            else:
                closed_already = False
                self._closed = True
                if not drain:
                    while self._q:
                        r = self._q.popleft()
                        _M_SHEDS.inc(label="closed")
                        self.stats.shed += 1
                        r.future.set_exception(OverloadError("closed"))
                    _M_DEPTH.set(0)
            self._nonempty.notify_all()
        if closed_already:
            return
        for t in self._threads:
            t.join(timeout=30.0)

    def __enter__(self) -> "FrontDesk":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
