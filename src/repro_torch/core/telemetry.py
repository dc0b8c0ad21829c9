"""Unified telemetry: metrics registry + cross-process trace spans.

One process-global registry (the Prometheus default-registry model) serves
every engine instance in the process; shard workers are separate processes
whose snapshots the router fetches over RPC and merges exactly
(`merge_snapshots`), so aggregation composes the same way the shards do.

Design constraints, in order:

  1. **The disabled path must be near-free** — `set_enabled(False)` turns
     every `inc`/`observe`/`span` into a single module-global check, the
     same discipline as `failpoints.failpoint`. The observability bench
     section gates the *enabled* path at <3% on insert and contended read.
  2. **No locks on the hot path.** Counters and histograms write to
     per-thread cells (registered once per thread under a lock); the only
     synchronization on `inc`/`observe` is the GIL. `snapshot()` sums the
     cells — aggregation cost is paid by the reader, never the writer.
  3. **Exact histogram merge.** Latency histograms are 64 power-of-two
     nanosecond buckets held as int64 numpy arrays; merging two histograms
     (across threads or across processes) is integer bucket addition, so a
     router-side aggregate is bit-identical to observing every sample in
     one process.
  4. **Closed catalog.** Every metric/span name must be declared in
     `CATALOG` (linted both ways by `scripts/check_metrics.py`, the
     `check_failpoints.py` pattern). Names starting with ``x.`` are the
     caller-owned escape hatch (tests, experiments) and bypass the
     catalog. In the port, ``x.`` also marks its own names, those the
     reference's catalog lacks: the shared lint checks all of `src/`
     against the reference's catalog and lets ``x.`` pass, so the port
     declares these in its CATALOG below and
     `tests/test_torch_telemetry.py` lints `src/repro_torch/` against it.

Spans are Chrome-trace complete events (`ph: "X"`): wall-clock `ts` in
microseconds (epoch-based, so router and worker processes align on one
Perfetto timeline), `dur` from a monotonic clock, `pid`/`tid` real OS ids,
and `args` carrying `trace`/`span`/`parent` ids plus caller tags. Context
propagates through a thread-local stack; `current_context()` exports the
ambient (trace, span) pair as a JSON-safe list that rides in shard RPC
frame metadata and into maintenance-pool submissions, and `attach()`
re-establishes it on the far side — one trace stitches a router-side query
through every shard worker it touched.

Two clocks: the registry's own events keep the epoch `ts` above, which
the shard router merges across processes. While a `torch.profiler`
profile records, each span also opens a `layer.<name>` annotation around
its body (what `record_function` opens, without its two dispatcher op
calls), so it lands in the profiler's Chrome export as a
`user_annotation` on the profiler's clock, and every device operation
launched inside it carries its correlation: a device trace can lay the
program's phases on its timeline. `profiler_recording()` is the gate and
the one place that reads torch's private profiler state; with no
profiler recording, a span pays that one check.

Legacy counter bags (`ServiceStats`, `LSMStats`, `codec.block_reads`, …)
keep their plain attributes; `register_stats` adds a read-side *collector*
(a weakref + an explicit field→metric-name map) so `snapshot()` folds them
into the same namespace without taxing their write paths at all.

Host copy of the reference `repro/core/telemetry.py`, with a CATALOG of
the port's own: the reference's names, less `multihop.hop.seconds`, plus
the ``x.`` spans inside the fof request, the live dense plan's delta and
base builds, the frontier_expand wrapper and the PSW sweep.
"""
from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "CATALOG", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTRY", "SpanHandle", "attach", "chrome_trace", "counter",
    "current_context", "enabled", "gauge", "histogram", "merge_snapshots",
    "profiler_recording", "prometheus_text", "register_stats", "reset",
    "set_enabled", "snapshot", "span", "trace_events", "trace_export",
]

# ---------------------------------------------------------------------------
# catalog
# ---------------------------------------------------------------------------
# name -> (kind, help). Kinds: counter | gauge | histogram | span.
# The registry rejects undeclared names at creation time (typos fail fast,
# exactly like failpoints.fp_set) and scripts/check_metrics.py lints that
# the catalog and the src/ call sites agree in both directions.
CATALOG: Dict[str, Tuple[str, str]] = {
    # --- WAL (core/walog.py) ---
    "wal.appends": ("counter", "records appended to the segmented WAL"),
    "wal.append.bytes": ("counter", "payload bytes appended to the WAL"),
    "wal.append.seconds": ("histogram", "WAL append latency (lock to tail)"),
    "wal.fsyncs": ("counter", "WAL fsync calls"),
    "wal.fsync.seconds": ("histogram", "WAL fsync latency"),
    # --- epoch guard / manifests (core/manifest.py) ---
    "manifest.publishes": ("counter", "LevelManifest publications"),
    "manifest.pins": ("counter", "epoch pins taken by readers"),
    "manifest.retires": ("counter", "retired manifests reclaimed by trim"),
    "manifest.epoch": ("gauge", "version of the currently published manifest"),
    "manifest.pin_lag": ("gauge",
                         "published version minus oldest pinned version"),
    # --- disk tier (core/disk.py, core/engine.py) ---
    "disk.block_reads": ("counter", "modeled block reads (IOStats)"),
    "disk.bytes_read": ("counter", "modeled bytes read (IOStats)"),
    "disk.gathers": ("counter", "gather operations accounted by IOStats"),
    "disk.interval.read_edges": ("counter",
                                 "edges gathered from disk slabs, by "
                                 "interval label lo:hi (read heat)"),
    # --- compressed index accounting (core/codec.py, core/disk.py) ---
    "codec.block_reads": ("counter",
                          "sparse/raw index block probes (RAM or disk)"),
    "codec.chunk_decodes": ("counter", "gamma chunk decodes"),
    "codec.block_decodes": ("counter", "blocked-gamma pointer block decodes"),
    # --- service tier (core/service.py) ---
    "service.flushes": ("counter", "buffer flush merges committed"),
    "service.checkpoints": ("counter", "checkpoints completed"),
    "service.snapshots": ("counter", "snapshot sessions exported"),
    "service.backpressure_waits": ("counter", "writer backpressure stalls"),
    "service.feedback_checkpoints": ("counter",
                                     "checkpoints forced by reader feedback"),
    "service.max_concurrent_flushes": ("counter",
                                       "high-water concurrent flush merges"),
    "service.job_retries": ("counter", "maintenance job retries"),
    "service.poisoned_jobs": ("counter", "maintenance jobs poisoned"),
    "service.read_only_entries": ("counter", "entries into read-only mode"),
    "service.read_only_exits": ("counter", "exits from read-only mode"),
    "service.scrubs": ("counter", "scrub passes completed"),
    "service.tail_cache.hits": ("counter", "decoded-WAL-tail cache hits"),
    "service.tail_cache.misses": ("counter", "decoded-WAL-tail cache misses"),
    "service.wal_tail_bytes": ("gauge", "WAL bytes past the last checkpoint"),
    "service.backlog_edges": ("gauge", "buffered + in-flight edges"),
    "service.job.seconds": ("histogram",
                            "maintenance job latency, by job label"),
    "service.job": ("span", "one maintenance job (flush/checkpoint/scrub)"),
    # --- LSM (core/lsm.py) ---
    "lsm.inserts": ("counter", "edges inserted into the LSM"),
    "lsm.buffer_flushes": ("counter", "buffer drains flushed into levels"),
    "lsm.pushdown_merges": ("counter", "level pushdown merges"),
    "lsm.edges_rewritten": ("counter", "edges rewritten during merges"),
    "lsm.splits": ("counter", "partition splits"),
    "lsm.deletes": ("counter", "edge deletions applied"),
    "lsm.purged_tombstones": ("counter", "tombstones purged by merges"),
    # --- multihop (core/multihop.py) ---
    "multihop.hops": ("counter", "frontier expansions, by mode label"),
    "multihop.hop": ("span", "one k-hop frontier expansion"),
    "multihop.two_hop": ("span", "one batched FoF (two_hop_counts) call"),
    "x.multihop.expand": ("span",
                          "dense 2-hop, one seed block's enqueue: indicator "
                          "scatter, both frontier expansions, the binarize"),
    "x.multihop.readback": ("span",
                            "dense 2-hop: nonzero (waits on the device), "
                            "count and friend-exclusion gathers"),
    "x.multihop.id_map": ("span",
                          "dense 2-hop: original ids and the block's key "
                          "sort, on the device (enqueue)"),
    "x.multihop.assemble": ("span",
                            "dense 2-hop after the last block: concatenate, "
                            "offsets, one copy of the answer to the host; "
                            "tag pairs"),
    "x.multihop.delta": ("span",
                         "a live view's dense-plan delta: fold the store's "
                         "mutation log up to the view, reduce it to changes "
                         "of key presence, upload the new entries; tag "
                         "delta_edges, the signed entries applied"),
    "x.multihop.base_build": ("span",
                              "a live store's base dense plan built from a "
                              "view's edge set (first use, a delta past "
                              "LIVE_DELTA_MAX, a log that no longer reaches "
                              "back)"),
    "x.multihop.base_builds": ("counter",
                               "live base dense plans built"),
    # --- frontier_expand kernel (kernels/frontier_expand/ops.py) ---
    "x.frontier_expand.counts": ("span",
                                 "one frontier_expand_counts call past its "
                                 "argument checks (kernel or plain torch); "
                                 "tag B, the panel's columns, and "
                                 "reduced_hubs, the plan's hubs of more "
                                 "than one chunk, whose chunks the "
                                 "kernel's second pass sums"),
    # --- device PSW (core/psw.py) ---
    "x.psw.pagerank": ("span", "one pagerank_device call"),
    "x.psw.window_gather": ("span",
                            "one sweep's window exchange (the send buffer "
                            "from send_idx, and over a process group the "
                            "all_to_all); the dense gather's all_gather"),
    "x.psw.segment_sum": ("span",
                          "one sweep's gather and float64 destination sum "
                          "(on the card one psw_sweep launch); with a "
                          "caller's msg_fn, the message build and the sum"),
    "x.psw.sweep_kernel": ("counter",
                           "sweeps that took the psw_sweep kernel"),
    # --- shard runtime (core/shardrouter.py) ---
    "shard.rpc.requests": ("counter", "router-side RPC calls, by op label"),
    "shard.rpc.seconds": ("histogram",
                          "router-side RPC round-trip latency, by shard"),
    "shard.rpc.bytes_sent": ("counter", "frame payload bytes sent"),
    "shard.rpc.bytes_recv": ("counter", "frame payload bytes received"),
    "shard.rpc.inflight": ("counter",
                           "RPCs currently in flight (inc/dec; the router's "
                           "queue depth)"),
    "shard.restarts": ("counter", "shard worker restarts"),
    "shard.rpc": ("span", "one router-side shard RPC"),
    "shard.op": ("span", "one worker-side op execution"),
    # --- request lifecycle (core/deadline.py wiring) ---
    "request.deadline_exceeded": ("counter",
                                  "requests whose budget ran out, by "
                                  "surface label (rpc/worker/frontdesk)"),
    "shard.rpc.retries": ("counter",
                          "idempotent-read retries after a transport "
                          "failure or deadline-derived socket timeout"),
    "shard.hedges.sent": ("counter",
                          "hedge sub-requests issued after the "
                          "histogram-derived hedge delay"),
    "shard.hedges.won": ("counter",
                         "hedges whose response beat the primary's"),
    "shard.breaker.trips": ("counter",
                            "circuit-breaker open transitions, by shard"),
    "shard.breaker.fastfail": ("counter",
                               "calls failed fast by an open breaker, "
                               "by shard"),
    "shard.breaker.open": ("gauge",
                           "shards whose circuit breaker is currently "
                           "open or probing"),
    # --- serving front end (core/frontdesk.py) ---
    "frontdesk.requests": ("counter", "admitted requests, by op label"),
    "frontdesk.sheds": ("counter",
                        "requests shed by admission control, by reason "
                        "label (queue_full/queue_delay/backpressure/"
                        "read_only)"),
    "frontdesk.batches": ("counter",
                          "engine dispatches, each coalescing >= 1 "
                          "queued requests, by op label"),
    "frontdesk.batched_ops": ("counter",
                              "requests served through coalesced "
                              "dispatches, by op label"),
    "frontdesk.queue.seconds": ("histogram",
                                "request queue delay, enqueue to batch "
                                "start"),
    "frontdesk.depth": ("gauge", "requests queued at the front desk now"),
}

_SPAN_NAMES = frozenset(n for n, (k, _) in CATALOG.items() if k == "span")

ESCAPE_PREFIX = "x."  # caller-owned namespace: bypasses the catalog

_ENABLED = True


def set_enabled(on: bool) -> None:
    """Global kill-switch: the telemetry-off arm of the overhead bench."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def _check(name: str, kind: str) -> None:
    if name.startswith(ESCAPE_PREFIX):
        return
    ent = CATALOG.get(name)
    if ent is None:
        raise KeyError(f"telemetry name not in CATALOG: {name!r}")
    if ent[0] != kind:
        raise KeyError(f"telemetry name {name!r} is a {ent[0]}, not a {kind}")


# ---------------------------------------------------------------------------
# metric primitives — per-thread cells, summed at snapshot time
# ---------------------------------------------------------------------------
class _CCell:
    __slots__ = ("v", "labels")

    def __init__(self):
        self.v = 0
        self.labels: Dict[str, int] = {}


class Counter:
    """Monotonic (or up/down, for queue depths) counter.

    `inc()` touches only a thread-local cell — no lock, no allocation after
    the first call per thread. `inc(n, label)` keeps a per-label tally in
    the same cell (read heat by interval, hops by mode, RPCs by op)."""

    __slots__ = ("name", "_tls", "_cells", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._tls = threading.local()
        self._cells: List[_CCell] = []
        self._lock = threading.Lock()

    def _cell(self) -> _CCell:
        c = getattr(self._tls, "c", None)
        if c is None:
            c = self._tls.c = _CCell()
            with self._lock:
                self._cells.append(c)
        return c

    def inc(self, n: int = 1, label: Optional[str] = None) -> None:
        if not _ENABLED:
            return
        c = self._cell()
        if label is None:
            c.v += n
        else:
            c.labels[label] = c.labels.get(label, 0) + n

    def value(self):
        """Total (int) or, if any label was ever used, {label: int} with
        the unlabeled remainder under ''. Cells of exited threads are kept:
        totals must include their contribution."""
        with self._lock:
            cells = list(self._cells)
        total = 0
        labels: Dict[str, int] = {}
        for c in cells:
            total += c.v
            for k, v in c.labels.items():
                labels[k] = labels.get(k, 0) + v
        if not labels:
            return int(total)
        if total:
            labels[""] = labels.get("", 0) + int(total)
        return {k: int(v) for k, v in labels.items()}

    def _zero(self) -> None:
        with self._lock:
            for c in self._cells:
                c.v = 0
                c.labels.clear()


class Gauge:
    """Last-write-wins scalar. A plain attribute store: CPython makes the
    write atomic, and a gauge's only contract is 'recent'."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0

    def set(self, v) -> None:
        if not _ENABLED:
            return
        self._v = v

    def value(self):
        return self._v

    def _zero(self) -> None:
        self._v = 0


N_BUCKETS = 64  # bucket b holds samples with ns.bit_length() == b (2^63 cap)


class _HCell:
    __slots__ = ("buckets", "sum")

    def __init__(self):
        self.buckets = np.zeros(N_BUCKETS, np.int64)
        self.sum = 0.0


class Histogram:
    """Power-of-two-bucket latency histogram.

    `observe(seconds)` buckets the nanosecond value by bit length into a
    per-thread int64 numpy array; merging across threads/processes is
    exact integer bucket addition. Optional `label` keeps one array per
    label (per-shard RPC latency) in the same cell."""

    __slots__ = ("name", "_tls", "_cells", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._tls = threading.local()
        self._cells: List[Dict[str, _HCell]] = []
        self._lock = threading.Lock()

    def _cell(self, label: str) -> _HCell:
        d = getattr(self._tls, "d", None)
        if d is None:
            d = self._tls.d = {}
            with self._lock:
                self._cells.append(d)
        h = d.get(label)
        if h is None:
            h = d[label] = _HCell()
        return h

    def observe(self, seconds: float, label: str = "") -> None:
        if not _ENABLED:
            return
        ns = int(seconds * 1e9)
        b = ns.bit_length() if ns > 0 else 0
        if b >= N_BUCKETS:
            b = N_BUCKETS - 1
        h = self._cell(label)
        h.buckets[b] += 1
        h.sum += seconds

    def value(self) -> Dict[str, Dict[str, Any]]:
        """{label: {count, sum, buckets{str(b): n}, p50_us, p99_us}}."""
        with self._lock:
            cells = list(self._cells)
        merged: Dict[str, Tuple[np.ndarray, float]] = {}
        for d in cells:
            for label, h in list(d.items()):
                if label in merged:
                    b, s = merged[label]
                    merged[label] = (b + h.buckets, s + h.sum)
                else:
                    merged[label] = (h.buckets.copy(), h.sum)
        return {label: _hist_dict(b, s) for label, (b, s) in merged.items()}

    def quantile(self, q: float, label: Optional[str] = None,
                 min_count: int = 1) -> Optional[float]:
        """The `q`-quantile in SECONDS (bucket upper bound — conservative),
        merged across threads and, with `label=None`, across labels. None
        until at least `min_count` samples exist. This is what feeds
        hedge-delay and breaker slow-call thresholds back from observed
        latency: a control input, not just an export."""
        with self._lock:
            cells = list(self._cells)
        buckets = np.zeros(N_BUCKETS, np.int64)
        for d in cells:
            for lb, h in list(d.items()):
                if label is None or lb == label:
                    buckets += h.buckets
        count = int(buckets.sum())
        if count < max(1, int(min_count)):
            return None
        cum = np.cumsum(buckets)
        b = int(np.searchsorted(cum, q * count))
        return float(1 << min(b, N_BUCKETS - 1)) / 1e9

    def _zero(self) -> None:
        with self._lock:
            for d in self._cells:
                for h in d.values():
                    h.buckets[:] = 0
                    h.sum = 0.0


def _hist_dict(buckets: np.ndarray, total: float) -> Dict[str, Any]:
    count = int(buckets.sum())
    nz = np.flatnonzero(buckets)
    out = {"count": count, "sum": float(total),
           "buckets": {str(int(b)): int(buckets[b]) for b in nz}}
    if count:
        cum = np.cumsum(buckets[nz])
        for q, key in ((0.5, "p50_us"), (0.99, "p99_us")):
            b = int(nz[int(np.searchsorted(cum, q * count))])
            out[key] = (1 << b) / 1000.0  # bucket upper bound, ns -> us
    return out


# ---------------------------------------------------------------------------
# trace spans — thread-local context, Chrome-trace complete events
# ---------------------------------------------------------------------------
_ctx = threading.local()
# A span makes no system call: where system calls are slow (an H100
# server's host measured `os.urandom`, `getpid` and `gettid` at 2-8 us
# each) they cost several times the rest of a span. Ids come from a
# generator seeded from `os.urandom`, the pid and each thread's native id
# are read once; a forked child reseeds and rereads.
_ids = random.Random()
_pid = os.getpid()


def _after_fork_in_child() -> None:
    global _pid
    _ids.seed()
    _pid = os.getpid()
    _ctx.__dict__.pop("tid", None)


os.register_at_fork(after_in_child=_after_fork_in_child)


def _new_id() -> str:
    return "%016x" % _ids.getrandbits(64)


def _native_id() -> int:
    tid = getattr(_ctx, "tid", None)
    if tid is None:
        tid = _ctx.tid = threading.get_native_id()
    return tid


def current_context() -> Optional[List[str]]:
    """Ambient [trace_id, span_id] or None — JSON-safe, ships in RPC meta
    and maintenance-pool submissions."""
    stack = getattr(_ctx, "stack", None)
    if not stack:
        return None
    return list(stack[-1])


class SpanHandle:
    __slots__ = ("name", "trace", "span", "parent", "tags")

    def __init__(self, name, trace, span_id, parent, tags):
        self.name = name
        self.trace = trace
        self.span = span_id
        self.parent = parent
        self.tags = tags

    def tag(self, **kw) -> None:
        self.tags.update(kw)


_NULL_SPAN = SpanHandle("", None, None, None, {})
_JSON_SCALARS = (str, int, float, bool, type(None))


def _safe_tags(tags: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v if isinstance(v, _JSON_SCALARS) else str(v))
            for k, v in tags.items()}


@contextmanager
def attach(ctx: Optional[Iterable]):
    """Re-establish a remote caller's [trace_id, span_id] as the ambient
    context (shard worker serving an RPC, maintenance job running a
    submission). `None` is a no-op, so call sites stay unconditional."""
    if ctx is None or not _ENABLED:
        yield
        return
    trace_id, span_id = ctx[0], ctx[1]
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    stack.append((trace_id, span_id))
    try:
        yield
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
class MetricsRegistry:
    def __init__(self, max_events: int = 16384):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # (weakref to stats object, {attr: metric name}) — read-side
        # collectors for legacy counter bags; dead refs pruned at snapshot
        self._collectors: List[Tuple[weakref.ref, Dict[str, str]]] = []
        self._events: deque = deque(maxlen=max_events)

    # -- metric accessors (create-or-get; catalog-checked) --
    def _get(self, name: str, kind: str, cls):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise KeyError(f"telemetry name {name!r} already registered "
                               f"as {type(m).__name__}")
            return m
        _check(name, kind)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter", Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge", Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram", Histogram)

    def register_stats(self, obj, fields: Dict[str, str]) -> None:
        """Fold a legacy stats object into snapshots: `fields` maps its
        attribute names to catalog counter names. Values from live
        instances with the same metric name are SUMMED (many LSMTree /
        Snapshot instances per process is normal)."""
        for attr, name in fields.items():
            _check(name, "counter")
            getattr(obj, attr)  # fail fast on a bad attribute name
        with self._lock:
            self._collectors.append((weakref.ref(obj), dict(fields)))

    def _collect(self) -> Dict[str, int]:
        with self._lock:
            live = [(r, f) for r, f in self._collectors if r() is not None]
            self._collectors = live
            pairs = list(live)
        out: Dict[str, int] = {}
        for ref, fields in pairs:
            obj = ref()
            if obj is None:
                continue
            for attr, name in fields.items():
                try:
                    v = int(getattr(obj, attr))
                except (AttributeError, TypeError, ValueError):
                    continue
                out[name] = out.get(name, 0) + v
        return out

    # -- spans --
    def record_event(self, ev: Dict[str, Any]) -> None:
        self._events.append(ev)  # deque.append is atomic under the GIL

    def trace_events(self, clear: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
            if clear:
                self._events.clear()
        return evs

    # -- export --
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe aggregate of every metric across all threads, plus
        the registered legacy collectors. Safe to call concurrently with
        writers: cells only grow, and reads of stale values are bounded
        by one in-flight increment."""
        with self._lock:
            metrics = dict(self._metrics)
        counters: Dict[str, Any] = {}
        gauges: Dict[str, Any] = {}
        hists: Dict[str, Any] = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, Counter):
                counters[name] = m.value()
            elif isinstance(m, Gauge):
                gauges[name] = m.value()
            else:
                hists[name] = m.value()
        for name, v in self._collect().items():
            if isinstance(counters.get(name), dict):
                d = counters[name]
                d[""] = d.get("", 0) + v
            else:
                counters[name] = counters.get(name, 0) + v
        return {"pid": os.getpid(), "counters": counters, "gauges": gauges,
                "histograms": hists}

    def prometheus_text(self) -> str:
        snap = self.snapshot()
        lines: List[str] = []

        def pname(name):
            return "graphdb_" + name.replace(".", "_").replace("-", "_")

        for name, v in snap["counters"].items():
            p = pname(name)
            lines.append(f"# TYPE {p} counter")
            if isinstance(v, dict):
                for label, n in sorted(v.items()):
                    lines.append(f'{p}{{label="{label}"}} {n}')
            else:
                lines.append(f"{p} {v}")
        for name, v in snap["gauges"].items():
            p = pname(name)
            lines.append(f"# TYPE {p} gauge")
            lines.append(f"{p} {v}")
        for name, labels in snap["histograms"].items():
            p = pname(name)
            lines.append(f"# TYPE {p} histogram")
            for label, h in sorted(labels.items()):
                sel = f'label="{label}",' if label else ""
                cum = 0
                for b in sorted(h["buckets"], key=int):
                    cum += h["buckets"][b]
                    le = (1 << int(b)) / 1e9
                    lines.append(f'{p}_bucket{{{sel}le="{le:g}"}} {cum}')
                lines.append(f'{p}_bucket{{{sel}le="+Inf"}} {h["count"]}')
                sel2 = f'{{label="{label}"}}' if label else ""
                lines.append(f'{p}_sum{sel2} {h["sum"]:g}')
                lines.append(f'{p}_count{sel2} {h["count"]}')
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every metric IN PLACE (module-level handles stay valid)
        and drop buffered trace events. Test/bench isolation only."""
        with self._lock:
            metrics = list(self._metrics.values())
            self._events.clear()
        for m in metrics:
            m._zero()


REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# module-level convenience API (what instrumented modules import)
# ---------------------------------------------------------------------------
def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def register_stats(obj, fields: Dict[str, str]) -> None:
    REGISTRY.register_stats(obj, fields)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def trace_events(clear: bool = False) -> List[Dict[str, Any]]:
    return REGISTRY.trace_events(clear=clear)


def reset() -> None:
    REGISTRY.reset()


def profiler_recording() -> bool:
    """True while a `torch.profiler` profile records in this process. The
    one read of torch's private profiler state: its Python-side flag,
    through `sys.modules`, so telemetry never imports torch (no profile
    can record before torch is imported). A torch without the flag reads
    False, so spans go on unbridged and the bridge's test fails."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


@contextmanager
def span(name: str, **tags):
    """Record a Chrome-trace complete event around the body, and, while a
    `torch.profiler` profile records, a `layer.<name>` annotation on the
    profiler's clock.

    Joins the ambient trace if one exists (same thread via the context
    stack, or a remote one re-established by `attach`); otherwise roots a
    new trace. Yields a `SpanHandle` — `handle.tag(k=v)` adds tags
    mid-span (retry counts, poison state), `handle.trace` is the trace id
    tests assert stitching on."""
    if not _ENABLED:
        yield _NULL_SPAN
        return
    if name not in _SPAN_NAMES and not name.startswith(ESCAPE_PREFIX):
        raise KeyError(f"span name not in CATALOG: {name!r}")
    annotation = None
    if profiler_recording():
        # opened first and closed last: the registry's own bookkeeping lies
        # inside the annotation, so the profiler's timeline charges it to
        # the span that pays it and leaves no gap between sibling spans
        from torch._C._autograd import _record_function_with_args_enter
        annotation = _record_function_with_args_enter("layer." + name)
    try:
        stack = getattr(_ctx, "stack", None)
        if stack is None:
            stack = _ctx.stack = []
        if stack:
            trace_id, parent = stack[-1]
        else:
            trace_id, parent = _new_id(), None
        span_id = _new_id()
        handle = SpanHandle(name, trace_id, span_id, parent, dict(tags))
        stack.append((trace_id, span_id))
        ts_us = time.time_ns() // 1000
        t0 = time.perf_counter_ns()
        try:
            yield handle
        finally:
            dur_us = (time.perf_counter_ns() - t0) // 1000
            stack.pop()
            args = _safe_tags(handle.tags)
            args["trace"] = trace_id
            args["span"] = span_id
            if parent is not None:
                args["parent"] = parent
            REGISTRY.record_event({
                "name": name, "cat": "graphdb", "ph": "X", "ts": ts_us,
                "dur": dur_us, "pid": _pid, "tid": _native_id(),
                "args": args})
    finally:
        if annotation is not None:
            from torch._C._autograd import _record_function_with_args_exit
            _record_function_with_args_exit(annotation)


def chrome_trace(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Wrap events in the Chrome trace-event JSON envelope Perfetto and
    chrome://tracing load directly."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def trace_export(events: Optional[Iterable[Dict[str, Any]]] = None,
                 path: Optional[str] = None) -> Dict[str, Any]:
    """This process's buffered spans as a Chrome trace document (pass
    `events` to wrap an externally merged list, e.g. router + workers).
    Optionally also write it to `path`."""
    doc = chrome_trace(REGISTRY.trace_events() if events is None else events)
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
    return doc


# ---------------------------------------------------------------------------
# exact cross-process aggregation
# ---------------------------------------------------------------------------
def _merge_counter(a, b):
    if isinstance(a, dict) or isinstance(b, dict):
        out = dict(a) if isinstance(a, dict) else ({"": a} if a else {})
        for k, v in (b.items() if isinstance(b, dict) else [("", b)]):
            out[k] = out.get(k, 0) + v
        return out
    return a + b


def _merge_hist(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    buckets = dict(a["buckets"])
    for k, v in b["buckets"].items():
        buckets[k] = buckets.get(k, 0) + v
    arr = np.zeros(N_BUCKETS, np.int64)
    for k, v in buckets.items():
        arr[int(k)] = v
    return _hist_dict(arr, a["sum"] + b["sum"])


def merge_snapshots(snaps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Exact aggregate of per-process snapshots: counters sum, histograms
    merge bucket-wise (identical to having observed every sample in one
    registry), gauges keep the last snapshot's value."""
    out: Dict[str, Any] = {"pids": [], "counters": {}, "gauges": {},
                           "histograms": {}}
    for s in snaps:
        if not s:
            continue
        if "pid" in s:
            out["pids"].append(s["pid"])
        for name, v in s.get("counters", {}).items():
            cur = out["counters"].get(name)
            out["counters"][name] = v if cur is None else _merge_counter(cur, v)
        out["gauges"].update(s.get("gauges", {}))
        for name, labels in s.get("histograms", {}).items():
            dst = out["histograms"].setdefault(name, {})
            for label, h in labels.items():
                dst[label] = h if label not in dst else _merge_hist(dst[label], h)
    return out
