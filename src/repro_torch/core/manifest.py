"""Epoch-published level manifests — the lock-free live read path.

The service tier made *snapshot* reads writer-free, but every live read
still serialized with the writer (and with whole merges) through the single
service lock. This module removes the lock from the read path entirely with
the standard RCU/epoch scheme over the LSM's immutable building blocks:

  * `LevelManifest` — an immutable view descriptor of the whole store at one
    instant: every partition of every level (each captured together with its
    tombstone array *as of publication*), the sealed staging view of every
    top-level edge buffer, and the staging views of drained-but-not-yet-
    merged buffers in flight through the maintenance pipeline. Publishing a
    manifest is ONE reference assignment; nothing in a published manifest is
    ever mutated afterwards (writers copy-on-write the pieces they change —
    see `EdgePartition.tombstone` and `EdgeBuffer.filter_mask`).
  * `EpochGuard` — per-reader-thread pin slots with hazard-pointer style
    validation, plus a retired-manifest list for deferred reclamation: a
    superseded manifest (and hence the partition files it references) is
    only released once no reader pins a version at or below it. The store's
    checkpoint GC asks `pinned_digests` before deleting partition files, so
    a reader that pinned a manifest minutes ago can still lazily re-mmap a
    partition that merges have long since replaced.
  * `ManifestView` — a pinned manifest wrapped in the store duck-type the
    query layer speaks (`intervals` / `all_partitions` / `buffers` /
    `to_coo` / `storage_engine`), so FoF/BFS, batched engine queries, and
    out-of-core PSW streaming all run against one frozen, consistent state
    with ZERO writer coordination.

Consistency contract (DESIGN.md §9): the edge *structure* a pinned view
exposes (src/dst/etype/tombstones) is bitwise-equal to the store after some
prefix of the mutation log — publication happens only at mutation-batch and
merge-commit boundaries, and in-place structural mutation of published
state is impossible by construction. Attribute-column writes are the one
deliberate exception: like the paper's §5.3 direct positional writes they
are non-transactional, so a pinned view may observe a newer column value
(never a torn structure).

Host copy of the reference `repro/core/manifest.py` (numpy).
`ManifestView.snapshot` returns the port's torch `DeviceGraph` (core/psw.py).
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import telemetry

_M_PUBLISHES = telemetry.counter("manifest.publishes")
_M_PINS = telemetry.counter("manifest.pins")
_M_RETIRES = telemetry.counter("manifest.retires")
_M_EPOCH = telemetry.gauge("manifest.epoch")
_M_PIN_LAG = telemetry.gauge("manifest.pin_lag")

__all__ = [
    "EpochGuard",
    "LevelManifest",
    "ManifestPartition",
    "ManifestView",
]


class ManifestPartition:
    """One partition as captured by a manifest: the (immutable) partition
    plus its tombstone array *at publication*. `tombstone()` on the live
    partition copies-on-write once it has been sealed by a publish, so the
    reference held here never changes content. Everything else is forwarded
    to the partition — its arrays, indexes, and files are immutable by the
    LSM's construction."""

    __slots__ = ("part", "dead")

    def __init__(self, part):
        self.part = part
        self.dead: Optional[np.ndarray] = part.dead

    def __getattr__(self, name):
        return getattr(self.part, name)

    @property
    def n_live_edges(self) -> int:
        if self.dead is None:
            return self.part.n_edges
        return int(self.part.n_edges - self.dead.sum())


class LevelManifest:
    """Immutable descriptor of the store's entire live read state.

    `stagings[j]` is buffer j's frozen staging view; `pending[j]` holds the
    staging views of buffer j's drained batches whose merge has not yet
    committed — a reader that includes them sees exactly the pre-merge
    logical state, and the commit publish atomically swaps them for the
    merged partitions. `wal_tail` is informational (feedback scheduling).
    `log_seq` is the tree's `MutationLog.seq` at publication: the entries
    before it are this manifest's edge set's changes. `cache` memoizes
    derived read structures (engine slab lists): a
    manifest is immutable, so they are built once and shared by every
    reader thread pinning it (idempotent benign-race fills). A slotted
    plain class, not a dataclass — one of these is constructed on EVERY
    single-edge insert, and dataclass/`replace` overhead measurably taxed
    the write path."""

    __slots__ = ("version", "levels", "stagings", "pending", "wal_tail",
                 "log_seq", "cache")

    def __init__(self, version: int,
                 levels: Tuple[Tuple[ManifestPartition, ...], ...],
                 stagings: Tuple, pending: Tuple, wal_tail: int = 0,
                 log_seq: int = 0):
        self.version = version
        self.levels = levels
        self.stagings = stagings
        self.pending = pending
        self.wal_tail = wal_tail
        self.log_seq = log_seq
        self.cache: Dict = {}

    def with_stagings(self, version: int, stagings: Tuple,
                      wal_tail: Optional[int] = None,
                      log_seq: Optional[int] = None) -> "LevelManifest":
        """The insert-path splice: same partitions/pending, new buffer
        stagings, fresh cache. `wal_tail` updates the manifest's logical
        offset (the insert path passes the post-append tail so the manifest
        is *addressable*: pinning a session at exactly `wal_tail` replays
        to exactly this manifest's logical state); `log_seq` likewise."""
        return LevelManifest(version, self.levels, stagings, self.pending,
                             self.wal_tail if wal_tail is None else wal_tail,
                             self.log_seq if log_seq is None else log_seq)

    def partitions(self) -> List[ManifestPartition]:
        return [p for lv in self.levels for p in lv]

    def derived(self, key, builder):
        """Memoized derived read structure (engine slab lists, multihop
        dense plans, edge-key sets). A manifest is immutable, so the build
        is idempotent: concurrent readers may race to fill the same key and
        one winner's value sticks — no lock, no staleness."""
        val = self.cache.get(key)
        if val is None:
            val = self.cache[key] = builder()
        return val

    def staging_slabs(self):
        """(staging, interval) for every buffer + in-flight staging, the
        interval being the fed top-level partition's."""
        out = []
        for j, mp in enumerate(self.levels[0]):
            for st in self.pending[j]:
                if st.src.shape[0]:
                    out.append((st, mp.part.interval))
            st = self.stagings[j]
            if st.src.shape[0]:
                out.append((st, mp.part.interval))
        return out

    @property
    def n_edges(self) -> int:
        n = sum(p.n_live_edges for p in self.partitions())
        for st, _ in self.staging_slabs():
            n += int(st.src.shape[0])
        return n


class _Slot:
    """One reader thread's pin slot: the manifest versions it currently
    holds (a stack — nested views are allowed), plus a weak ref to the
    owning thread so slots of exited threads can be pruned."""

    __slots__ = ("pins", "thread")

    def __init__(self):
        self.pins: List[int] = []
        self.thread = weakref.ref(threading.current_thread())


class EpochGuard:
    """Epoch-based publication + deferred reclamation over LevelManifests.

    Writers (serialized among themselves by the caller — the service lock,
    or plain single-threaded use) swap `current` via `publish`. Readers pin
    with hazard-pointer validation: write the version into the thread's
    slot, then re-check that the manifest is still current — if a publish
    raced in between, retry. Once a pin is visible, `trim` keeps every
    retired manifest at or above the minimum pinned version, which keeps
    alive (a) the Python object graph — partitions, staging arrays — by
    plain reference, and (b) the on-disk partition files, because checkpoint
    GC consults `pinned_digests` callers build from `live_manifests`."""

    def __init__(self):
        self.current: Optional[LevelManifest] = None
        self._retired: List[LevelManifest] = []
        self._tls = threading.local()
        self._slots: List[_Slot] = []
        self._slots_lock = threading.Lock()

    # -- reader side (lock-free: no writer-shared mutex) ----------------------
    def _slot(self) -> _Slot:
        slot = getattr(self._tls, "slot", None)
        if slot is None:
            slot = _Slot()
            with self._slots_lock:  # registration only, once per thread
                # prune slots of exited threads (no live pins) so a
                # thread-churning service doesn't grow the scan set —
                # amortized over registrations, which are rare
                self._slots = [s for s in self._slots
                               if s.pins or s.thread() is not None]
                self._slots.append(slot)
            self._tls.slot = slot
        return slot

    def pin(self) -> Tuple[LevelManifest, _Slot]:
        """Pin and return the current manifest. The validation loop closes
        the classic epoch race: if a publish superseded (and possibly
        reclaimed) the manifest between our read and our pin becoming
        visible, the re-check fails and we retry on the new current."""
        slot = self._slot()
        _M_PINS.inc()
        while True:
            m = self.current
            slot.pins.append(m.version)
            if self.current is m:
                return m, slot
            slot.pins.remove(m.version)

    def unpin(self, slot: _Slot, version: int) -> None:
        slot.pins.remove(version)

    # -- writer side (caller-serialized) --------------------------------------
    def publish(self, manifest: LevelManifest) -> None:
        old = self.current
        self.current = manifest  # the atomic swap: readers see old or new
        _M_PUBLISHES.inc()
        _M_EPOCH.set(manifest.version)
        if old is not None:
            if not self._slots:
                # fast path: no reader thread has EVER registered a pin
                # slot, so nothing can still hold `old` — registration
                # precedes pinning, and a pin of `old` validated before
                # this swap implies its slot was already visible here
                self._retired.clear()
                _M_RETIRES.inc()  # `old` reclaimed immediately
                _M_PIN_LAG.set(0)
            else:
                self._retired.append(old)
                self.trim()

    def pinned_versions(self) -> set:
        """The exact manifest versions readers currently pin. A pin only
        ever dereferences its own version (pin() records the version of
        the manifest it returned), so retirement can filter by exact
        membership — one long-lived reader at version V must NOT retain
        every manifest published after V."""
        out: set = set()
        with self._slots_lock:
            slots = list(self._slots)
        reclaimed = False
        for slot in slots:
            if slot.pins:
                t = slot.thread()
                if t is None or not t.is_alive():
                    # the owning thread exited without unpinning: it
                    # can never dereference the pin again,
                    # so counting it would block manifest retirement and
                    # store GC forever. Reclaim the abandoned slot — no
                    # race: only the (dead) owner ever appends to it.
                    slot.pins.clear()
                    reclaimed = True
                    continue
            out.update(slot.pins)
        if reclaimed:
            with self._slots_lock:
                live = []
                for s in self._slots:
                    t = s.thread()
                    if s.pins or (t is not None and t.is_alive()):
                        live.append(s)
                self._slots = live
        return out

    def min_pinned(self) -> Optional[int]:
        pins = self.pinned_versions()
        return min(pins) if pins else None

    def trim(self) -> int:
        """Drop retired manifests no pinned reader can still be using.
        Returns how many stayed deferred."""
        if not self._retired:
            return 0
        pins = self.pinned_versions()
        before = len(self._retired)
        if not pins:
            self._retired.clear()
        else:
            self._retired = [m for m in self._retired if m.version in pins]
        dropped = before - len(self._retired)
        if dropped:
            _M_RETIRES.inc(dropped)
        cur = self.current
        if cur is not None:
            oldest = min(pins) if pins else cur.version
            _M_PIN_LAG.set(int(cur.version - oldest))
        return len(self._retired)

    def live_manifests(self) -> List[LevelManifest]:
        """Current + every retired-but-possibly-pinned manifest — the set
        whose partition files must survive GC."""
        self.trim()
        out = list(self._retired)
        if self.current is not None:
            out.append(self.current)
        return out


class _FrozenBuffer:
    """Duck-type shim presenting a frozen BufferStaging as an EdgeBuffer to
    code that iterates `store.buffers` (PSW bucket streaming)."""

    __slots__ = ("_st",)

    def __init__(self, st):
        self._st = st

    def __len__(self) -> int:
        return int(self._st.src.shape[0])

    def staging(self):
        return self._st


class ManifestView:
    """A pinned, read-only, self-consistent view of a live store.

    Obtained from `LSMTree.read_view()` (or `GraphDB` / `ServiceDB`
    delegation); use as a context manager, or call `release()` when done —
    holding a view defers reclamation of everything it references. All
    queries on one view answer from ONE published manifest: a traversal that
    issues many batched calls against `storage_engine()` sees a single
    frozen state regardless of concurrent writers and merges."""

    def __init__(self, tree, manifest: LevelManifest, slot: _Slot):
        self.tree = tree
        self.manifest = manifest
        self._slot = slot
        self._engine = None
        self._released = False

    # -- lifecycle ------------------------------------------------------------
    def release(self) -> None:
        if not self._released:
            self._released = True
            self.tree.epochs.unpin(self._slot, self.manifest.version)

    close = release

    def __enter__(self) -> "ManifestView":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __del__(self):  # backstop: a leaked view must not pin files forever
        try:
            self.release()
        except Exception:
            pass

    # -- store duck type ------------------------------------------------------
    @property
    def intervals(self):
        return self.tree.intervals

    @property
    def column_dtypes(self) -> Dict[str, np.dtype]:
        return self.tree.column_dtypes

    @property
    def version(self) -> int:
        return self.manifest.version

    @property
    def wal_tail(self) -> int:
        """The WAL offset this view's manifest is addressable at: every
        targeted publish stamps the post-append tail, so a
        snapshot pinned at exactly this offset replays to exactly this
        view's logical state — the bridge that lets an epoch view cross a
        process boundary via `GraphDB.pin_snapshot(pinned_offset=...)`."""
        return self.manifest.wal_tail

    @property
    def n_edges(self) -> int:
        return self.manifest.n_edges

    def all_partitions(self) -> List[ManifestPartition]:
        return self.manifest.partitions()

    @property
    def levels(self):
        return self.manifest.levels

    @property
    def buffers(self) -> List[_FrozenBuffer]:
        """Frozen buffer shims (live stagings + in-flight drains) for code
        that streams `store.buffers` — e.g. `psw.stream_interval_buckets`."""
        return [_FrozenBuffer(st) for st, _ in self.manifest.staging_slabs()]

    def storage_engine(self):
        if self._engine is None:
            from .engine import ManifestEngine
            self._engine = ManifestEngine(self)
        return self._engine

    # -- queries (all answered from the pinned manifest) ----------------------
    def out_neighbors(self, v: int) -> np.ndarray:
        vals, _ = self.storage_engine().out_neighbors_batch([v])
        return vals

    def in_neighbors(self, v: int) -> np.ndarray:
        vals, _ = self.storage_engine().in_neighbors_batch([v])
        return vals

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        iv = self.tree.intervals
        ss, dd = [], []
        for mp in self.manifest.partitions():
            if mp.part.n_edges == 0:
                continue
            if mp.dead is None:
                ss.append(np.asarray(mp.part.src))
                dd.append(np.asarray(mp.part.dst))
            else:
                live = ~mp.dead
                ss.append(np.asarray(mp.part.src)[live])
                dd.append(np.asarray(mp.part.dst)[live])
        for st, _ in self.manifest.staging_slabs():
            ss.append(st.src)
            dd.append(st.dst)
        s = np.concatenate(ss) if ss else np.empty(0, np.int64)
        d = np.concatenate(dd) if dd else np.empty(0, np.int64)
        return (np.asarray(iv.to_original(s)), np.asarray(iv.to_original(d)))

    def snapshot(self, **kw):
        """Compile the pinned state into a DeviceGraph (PSW analytics);
        takes `build_device_graph`'s `with_window_plan` and `device`."""
        from .psw import build_device_graph
        return build_device_graph(self, **kw)
