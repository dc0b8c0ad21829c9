"""The on-disk storage tier: mmap-backed partition files + GraphDB (paper §4, §7.3).

This module makes the paper's headline claim real: graphs much larger than
RAM served from flat files on disk, with only the (Elias-Gamma-compressed)
pointer-array index pinned in memory (§4.2.1, §8.4).

  * `write_partition_file` / `open_partition_file`: one flat file per
    immutable `EdgePartition` — a JSON header, then 64-byte-aligned raw
    sections for the edge columns (src/dst/etype), the dst permutation and
    every attribute column, plus BOTH a raw and a blocked-Elias-Gamma copy
    of the four pointer arrays. Edge columns are accessed through
    `np.memmap` (the OS pages in only the ranges a query touches); the
    pointer arrays come back either decoded-from-gamma (resident mode) or
    as raw memmaps (the paper's Figure 8 "on disk" baseline).
  * `DiskPartition`: an `EdgePartition` whose big arrays are lazy memmaps
    and whose pointer index is decoded on demand from pinned compressed
    blobs; `evict()` drops every mapping and decoded cache (the pinned
    blobs stay), bounding resident memory.
  * `PartitionStore`: a content-addressed directory of partition files
    (`parts/part_<digest>.pal`) written via atomic rename — immutability
    makes dedup, checkpoint hard-links, and GC trivial.
  * `GraphDB`: the durable database directory — an `LSMTree` whose merged
    partitions are flushed to the store (via the tree's `partition_sink`),
    an atomically-renamed `MANIFEST.json`, and the tree's WAL. Recovery =
    open the manifest's partitions + replay the WAL tail. Close→reopen and
    crash→reopen both yield bitwise-identical query results (tested).
  * `RawDiskIndex` / `SparseDiskIndex`: explicit `os.pread`-based pointer
    lookups with REAL counted block reads, the disk baselines that
    `benchmarks/bench_disk.py` compares against the resident
    `GammaChunkedIndex` (paper Figure 8c).

Host copy of the reference `repro/core/disk.py` (numpy): the same file
formats, directory layout and recovery, so either package opens the
other's store. `GraphDB.snapshot` compiles to the port's torch
`DeviceGraph` (core/psw.py), and the dense hops over a `GraphDB` run the
port's frontier_expand kernel (core/multihop.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import mmap
import os
import shutil
import struct
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import telemetry
from .codec import (
    GAMMA_BLOCK,
    BlockedGammaPointer,
    SparseIndex,
    encode_monotonic_blocked,
)
from .failpoints import failpoint
from .integrity import (
    CKSUM_ALGO,
    CRC_ALGO,
    CorruptionError,
    RecoveryError,
    checksum32,
    crc32,
    fsync_dir,
)
from .lsm import EdgeBuffer, LSMTree
from .pal import EdgePartition, IntervalMap, build_partition
from .walog import SegmentedWAL

__all__ = [
    "IOStats",
    "DiskPartition",
    "PartitionStore",
    "GraphDB",
    "RawDiskIndex",
    "SparseDiskIndex",
    "partition_digest",
    "replay_ops",
    "write_partition_file",
    "open_partition_file",
]

_MAGIC = b"PALPART1"
_ALIGN = 64
_PTR_ARRAYS = ("src_vertices", "src_ptr", "dst_vertices", "dst_ptr")

# process-wide disk-tier accounting: IOStats instances keep their
# per-store attributes, and ALSO write through to the registry so one
# snapshot unifies every store/snapshot/shard-worker in the process
_M_DISK_BLOCKS = telemetry.counter("disk.block_reads")
_M_DISK_BYTES = telemetry.counter("disk.bytes_read")
_M_DISK_GATHERS = telemetry.counter("disk.gathers")


# ---------------------------------------------------------------------------
# Block-read accounting
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class IOStats:
    """Counts the disk blocks a query path touches. For memmapped columns
    the OS does the actual read, so we account the DISTINCT blocks covered
    by each gather — the number of page faults a cold cache would take,
    i.e. the paper's block-read cost model with real positions."""

    block_size: int = 4096
    block_reads: int = 0
    bytes_read: int = 0
    gathers: int = 0

    def account_gather(self, pos: np.ndarray, itemsize: int) -> None:
        if len(pos) == 0:
            return
        pos = np.asarray(pos, np.int64)
        blocks = np.unique(pos * itemsize // self.block_size)
        nb = int(blocks.shape[0])
        nbytes = int(pos.shape[0]) * itemsize
        self.block_reads += nb
        self.bytes_read += nbytes
        self.gathers += 1
        _M_DISK_BLOCKS.inc(nb)
        _M_DISK_BYTES.inc(nbytes)
        _M_DISK_GATHERS.inc()

    def account_range(self, a: int, b: int, itemsize: int) -> None:
        if b <= a:
            return
        lo = a * itemsize // self.block_size
        hi = (b * itemsize - 1) // self.block_size
        nb = int(hi - lo + 1)
        nbytes = (b - a) * itemsize
        self.block_reads += nb
        self.bytes_read += nbytes
        self.gathers += 1
        _M_DISK_BLOCKS.inc(nb)
        _M_DISK_BYTES.inc(nbytes)
        _M_DISK_GATHERS.inc()

    def snapshot(self) -> Dict[str, int]:
        return {"block_reads": self.block_reads, "bytes_read": self.bytes_read,
                "gathers": self.gathers, "block_size": self.block_size}


# ---------------------------------------------------------------------------
# Partition file format
# ---------------------------------------------------------------------------
def partition_digest(part: EdgePartition) -> str:
    """Content address over everything a partition file persists."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(part.src).tobytes())
    h.update(np.ascontiguousarray(part.dst).tobytes())
    h.update(np.ascontiguousarray(part.etype).tobytes())
    for k in sorted(part.columns):
        h.update(k.encode())
        h.update(np.ascontiguousarray(part.columns[k]).tobytes())
    return h.hexdigest()[:16]


def _pad(f, align: int = _ALIGN) -> int:
    off = f.tell()
    rem = off % align
    if rem:
        f.write(b"\0" * (align - rem))
        off += align - rem
    return off


def write_partition_file(path: str, part: EdgePartition,
                         fsync: bool = True, checksums: bool = True) -> None:
    """Serialize a partition to one flat file: magic, JSON header, aligned
    raw sections. Written to a per-thread-unique `<path>.tmp*` then
    atomically renamed — a crash mid-write can never leave a half-file at
    the published path, and two maintenance workers racing to persist the
    same digest each write their own temp (last rename wins, same bytes).
    With `fsync=False` durability is deferred: correct as long as the
    caller syncs before publishing a manifest that references the file (a
    torn unreferenced file is never read by recovery).

    With `checksums=True` (the default) the file is format
    version 2: the header carries a CRC-32 per 64B-aligned section (plus
    its own trailing CRC), and readers verify each section lazily on first
    touch — bit rot under the mmap becomes a typed `CorruptionError`
    instead of garbage edges. Version-1 files stay readable (unverified)."""
    sections: Dict[str, Tuple[int, str, int]] = {}
    gamma: Dict[str, Dict[str, int]] = {}
    crcs: Dict[str, int] = {}

    arrays: List[Tuple[str, np.ndarray]] = [
        ("src", np.ascontiguousarray(part.src, np.int64)),
        ("dst", np.ascontiguousarray(part.dst, np.int64)),
        ("etype", np.ascontiguousarray(part.etype, np.int8)),
        ("dst_perm", np.ascontiguousarray(part.dst_perm, np.int64)),
    ]
    for k in sorted(part.columns):
        arrays.append((f"col_{k}", np.ascontiguousarray(part.columns[k])))
    gamma_blobs: List[Tuple[str, np.ndarray, np.ndarray, int, int, int]] = []
    for name in _PTR_ARRAYS:
        arr = np.ascontiguousarray(getattr(part, name), np.int64)
        arrays.append((f"{name}_raw", arr))
        # every GAMMA_BLOCK-th raw value: the resident block directory that
        # lets lookups decode one chunk instead of the whole array
        arrays.append((f"sf_{name}", arr[::GAMMA_BLOCK].copy()))
        packed, nbits, first, offsets = encode_monotonic_blocked(arr)
        gamma_blobs.append((name, packed, offsets, nbits, first, int(arr.shape[0])))

    tmp = f"{path}.tmp{os.getpid()}_{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(b"\0" * 8)  # header-length placeholder
        # reserve generous header space by writing it twice: first pass with
        # zero offsets to learn its size, then seek back with real offsets
        header_probe = _header_json(part, sections, gamma, crcs, probe=True,
                                    arrays=arrays, blobs=gamma_blobs,
                                    checksums=checksums)
        f.write(header_probe)
        f.write(b"\0" * 4)  # header-CRC placeholder (v2)
        _pad(f)
        failpoint("part.write.body")

        def _emit(name: str, data: bytes, dtype_str: str, n: int) -> None:
            off = _pad(f)
            sections[name] = (off, dtype_str, n)
            if checksums:
                crcs[name] = checksum32(data)
            f.write(data)

        for name, arr in arrays:
            _emit(name, arr.tobytes(), arr.dtype.str, int(arr.shape[0]))
        for name, packed, offsets, nbits, first, n in gamma_blobs:
            _emit(f"g_{name}", packed.tobytes(), "|u1", int(packed.shape[0]))
            _emit(f"gd_{name}",
                  np.ascontiguousarray(offsets, np.int64).tobytes(),
                  "<i8", int(offsets.shape[0]))
            gamma[name] = {"nbits": nbits, "first": first, "n": n}
        header = _header_json(part, sections, gamma, crcs, probe=False,
                              arrays=arrays, blobs=gamma_blobs,
                              checksums=checksums)
        assert len(header) == len(header_probe), "header size drifted"
        f.seek(len(_MAGIC))
        f.write(np.uint64(len(header)).tobytes())
        f.write(header)
        f.write(struct.pack("<I", crc32(header)))
        f.flush()
        if fsync:
            failpoint("part.write.fsync")
            os.fsync(f.fileno())
    failpoint("part.write.rename")
    os.replace(tmp, path)
    # the rename is atomic but its directory entry is only durable once the
    # parent directory is synced; deferred-fsync writes
    # get their dir sync from PartitionStore.sync before publication
    if fsync:
        fsync_dir(path)


def _header_json(part, sections, gamma, crcs, probe: bool, arrays, blobs,
                 checksums: bool = True) -> bytes:
    if probe:
        # same shape/keys as the real header, with fixed-width placeholder
        # numbers so the byte length matches the final write
        sections = {name: (2 ** 52, arr.dtype.str, int(arr.shape[0]))
                    for name, arr in arrays}
        for name, packed, offsets, nbits, first, n in blobs:
            sections[f"g_{name}"] = (2 ** 52, "|u1", int(packed.shape[0]))
            sections[f"gd_{name}"] = (2 ** 52, "<i8", int(offsets.shape[0]))
        gamma = {name: {"nbits": nbits, "first": first, "n": n}
                 for name, packed, offsets, nbits, first, n in blobs}
        crcs = {k: 0 for k in sections} if checksums else {}
    else:
        sections = {k: (int(v[0]) + 2 ** 52, v[1], v[2])
                    for k, v in sections.items()}  # keep fixed width
    doc = {
        "version": 2 if checksums else 1,
        "interval": [int(part.interval[0]), int(part.interval[1])],
        "n_edges": int(part.n_edges),
        "columns": sorted(part.columns),
        "gamma_block": GAMMA_BLOCK,
        "sections": {k: list(v) for k, v in sections.items()},
        "gamma": gamma,
    }
    if checksums:
        # same fixed-width bias trick for the checksum values (u32 < 2**52)
        doc["crc_algo"] = CKSUM_ALGO
        doc["crc"] = {k: int(v) + 2 ** 52 for k, v in crcs.items()}
    return json.dumps(doc, sort_keys=True).encode()


def _read_header(path: str) -> Dict[str, Any]:
    try:
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise CorruptionError(path, "not a partition file (bad magic)")
            hlen = int(np.frombuffer(f.read(8), np.uint64)[0])
            raw = f.read(hlen)
            doc = json.loads(raw)
            if int(doc.get("version", 1)) >= 2:
                trailer = f.read(4)
                if (len(trailer) < 4
                        or struct.unpack("<I", trailer)[0] != crc32(raw)):
                    raise CorruptionError(path, "partition header failed CRC")
    except CorruptionError:
        raise
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            struct.error) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise CorruptionError(path, f"unreadable partition header: {e}")
    # undo the fixed-width offset bias
    doc["sections"] = {k: (int(v[0]) - 2 ** 52, v[1], int(v[2]))
                       for k, v in doc["sections"].items()}
    if doc.get("crc"):
        doc["crc"] = {k: int(v) - 2 ** 52 for k, v in doc["crc"].items()}
    return doc


def open_partition_file(path: str, io: Optional[IOStats] = None,
                        index_mode: str = "gamma",
                        verify: bool = True) -> "DiskPartition":
    return DiskPartition(path, _read_header(path), io=io,
                         index_mode=index_mode, verify=verify)


# ---------------------------------------------------------------------------
# DiskPartition — EdgePartition over a partition file
# ---------------------------------------------------------------------------
class DiskPartition(EdgePartition):
    """An `EdgePartition` whose edge arrays are lazy `np.memmap` views of a
    partition file and whose pointer index is decoded on demand from
    gamma blobs pinned in RAM (`index_mode="gamma"`), or memmapped raw
    (`index_mode="raw"`, the Figure-8 on-disk baseline).

    In-place mutations the LSM model allows (attribute writes, etype edits,
    tombstones) materialize the touched array into RAM (copy-on-write);
    such a partition reports `dirty` and is rewritten at the next
    `GraphDB.checkpoint()`. `evict()` drops every mapping and decoded
    cache — only `resident_nbytes()` bytes stay pinned."""

    def __init__(self, path: str, header: Dict[str, Any],
                 io: Optional[IOStats] = None, index_mode: str = "gamma",
                 verify: bool = True):
        assert index_mode in ("gamma", "raw"), index_mode
        self.path = path
        self.header = header
        self.io = io
        self.index_mode = index_mode
        # per-section CRC verification, lazy on first touch (format v2;
        # v1 files carry no CRCs and skip it). `_verified` persists across
        # evict() — re-verification of long-lived partitions is the
        # background scrub's job (GraphDB.scrub), not the query path's.
        self._crc = header.get("crc") if verify else None
        # the header names its algorithm: wsum32 files (current writer)
        # and crc32-zlib files (earlier v2 writers) both verify
        self._crc_fn = (crc32 if header.get("crc_algo") == CRC_ALGO
                        else checksum32)
        self._verified: set = set()
        # stores WITHOUT a residency budget (the service tier's default)
        # set this: queries then use the fully-decoded pointer arrays —
        # decoded ONCE per immutable partition and cached — instead of
        # re-decoding gamma blocks on every lookup. Under a budget it
        # stays False and lookups keep the chunked-decode path whose
        # resident footprint is just the compressed blobs.
        self.index_resident = False
        self.interval = (int(header["interval"][0]), int(header["interval"][1]))
        self.dead: Optional[np.ndarray] = None
        self._mm: Dict[str, np.ndarray] = {}    # section -> memmap (evictable)
        self._ram: Dict[str, np.ndarray] = {}   # copy-on-write overrides
        self._idx: Dict[str, np.ndarray] = {}   # fully-decoded ptrs (evictable)
        # pinned: compressed blobs + bit-offset directory + block firsts —
        # the ONLY per-partition state that survives eviction
        self._bp: Dict[str, BlockedGammaPointer] = {}
        if index_mode == "gamma":
            blk = int(header.get("gamma_block", GAMMA_BLOCK))
            for name in _PTR_ARRAYS:
                meta = header["gamma"][name]
                self._bp[name] = BlockedGammaPointer(
                    self._read_section(f"g_{name}"),
                    self._read_section(f"gd_{name}"),
                    meta["nbits"], meta["first"], meta["n"],
                    self._read_section(f"sf_{name}"), blk)
        self.columns = _ColumnDict(self)

    # -- raw I/O --------------------------------------------------------------
    def _section_spec(self, name: str) -> Tuple[int, np.dtype, int]:
        off, dt, n = self.header["sections"][name]
        return off, np.dtype(dt), n

    def _verify(self, name: str, data) -> None:
        """Check one section against its header CRC on FIRST touch (the
        cost is one linear pass over bytes a query is about to fault in
        anyway; later touches are free). Typed failure, never garbage."""
        if self._crc is None or name in self._verified:
            return
        want = self._crc.get(name)
        if want is not None and self._crc_fn(data) != want:
            raise CorruptionError(
                self.path, f"section {name!r} failed its checksum "
                           f"(stored {want:#010x})")
        self._verified.add(name)

    def _read_section(self, name: str) -> np.ndarray:
        """Eager read (small pinned things: gamma blobs, directories)."""
        failpoint("part.read.section")
        off, dt, n = self._section_spec(name)
        with open(self.path, "rb") as f:
            f.seek(off)
            raw = f.read(n * dt.itemsize)
        self._verify(name, raw)
        return np.frombuffer(raw, dt)

    def _mmap(self, name: str) -> np.ndarray:
        arr = self._mm.get(name)
        if arr is None:
            off, dt, n = self._section_spec(name)
            arr = np.memmap(self.path, dtype=dt, mode="r", offset=off,
                            shape=(n,))
            if n:
                self._verify(name, memoryview(arr).cast("B"))
            self._mm[name] = arr
        return arr

    def _edge_array(self, name: str) -> np.ndarray:
        override = self._ram.get(name)
        return override if override is not None else self._mmap(name)

    # -- the EdgePartition surface --------------------------------------------
    @property
    def src(self) -> np.ndarray:
        return self._edge_array("src")

    @property
    def dst(self) -> np.ndarray:
        return self._edge_array("dst")

    @property
    def etype(self) -> np.ndarray:
        return self._edge_array("etype")

    @property
    def dst_perm(self) -> np.ndarray:
        return self._edge_array("dst_perm")

    def _pointer(self, name: str) -> np.ndarray:
        """Full decoded pointer array — the compatibility path (dirty
        rewrites, direct field access). Queries never need it: they go
        through `lookup_adj_ranges`/`dst_ptr_bounds`, which decode only
        the touched blocks."""
        arr = self._idx.get(name)
        if arr is not None:
            return arr
        if self.index_mode == "gamma":
            arr = self._bp[name].decode_all()
            self._idx[name] = arr
        else:
            arr = self._mmap(f"{name}_raw")
        return arr

    # -- chunked-decode query paths (paper §4.2.1) -----------------------------
    def lookup_adj_ranges(self, vis: np.ndarray, direction: str):
        """For each queried internal vertex, its [start, end) range — into
        the edge-array for "out", into dst_perm for "in" — resolved
        against the COMPRESSED resident index: one binary search over the
        block firsts + a decode of only the touched 64-code blocks.
        Returns (hit query indices, starts, ends), or None when this
        partition has no compressed index (raw mode) or prefers its
        decoded-and-cached pointer arrays (`index_resident`)."""
        if self.index_mode != "gamma" or self.index_resident:
            return None
        names = (("src_vertices", "src_ptr") if direction == "out"
                 else ("dst_vertices", "dst_ptr"))
        V, P = self._bp[names[0]], self._bp[names[1]]
        empty = np.empty(0, np.int64)
        if V.n == 0:
            return empty, empty, empty
        vis = np.asarray(vis, np.int64)
        idx, vals = V.searchsorted_with_values(vis)  # one decode pass
        hit = np.flatnonzero((idx < V.n) & (vals == vis))
        if hit.size == 0:
            return empty, empty, empty
        ki = idx[hit]
        # one fused decode for both range endpoints
        both = P.values_at(np.concatenate([ki, ki + 1]))
        return hit, both[: ki.shape[0]], both[ki.shape[0]:]

    def dst_ptr_bounds(self, lo: int, hi: int):
        """[pa, pb) range of dst_perm whose destinations fall in [lo, hi)
        — the out-of-core PSW bucket slice — from the compressed index.
        None in raw mode (caller falls back to the decoded arrays)."""
        if self.index_mode != "gamma":
            return None
        V, P = self._bp["dst_vertices"], self._bp["dst_ptr"]
        if V.n == 0:
            return 0, 0
        ab = V.searchsorted(np.asarray([lo, hi], np.int64))
        bounds = P.values_at(np.minimum(ab, V.n))
        return int(bounds[0]), int(bounds[1])

    # scalar query overrides: a frontier of one through the chunked path
    def out_edge_range(self, v: int) -> Tuple[int, int]:
        res = self.lookup_adj_ranges(np.asarray([v], np.int64), "out")
        if res is None:
            return super().out_edge_range(v)
        hit, starts, ends = res
        if hit.size:
            return int(starts[0]), int(ends[0])
        return 0, 0

    def in_edges(self, v: int) -> np.ndarray:
        res = self.lookup_adj_ranges(np.asarray([v], np.int64), "in")
        if res is None:
            return super().in_edges(v)
        hit, starts, ends = res
        if hit.size == 0:
            return np.empty(0, np.int64)
        pos = np.asarray(self.dst_perm[int(starts[0]):int(ends[0])], np.int64)
        return self._live(pos)

    @property
    def src_vertices(self) -> np.ndarray:
        return self._pointer("src_vertices")

    @property
    def src_ptr(self) -> np.ndarray:
        return self._pointer("src_ptr")

    @property
    def dst_vertices(self) -> np.ndarray:
        return self._pointer("dst_vertices")

    @property
    def dst_ptr(self) -> np.ndarray:
        return self._pointer("dst_ptr")

    @property
    def n_edges(self) -> int:
        return int(self.header["n_edges"])

    # -- copy-on-write mutations ----------------------------------------------
    def _materialize(self, name: str) -> np.ndarray:
        arr = self._ram.get(name)
        if arr is None:
            arr = np.array(self._mmap(name))
            self._ram[name] = arr
        return arr

    def set_etype(self, pos, values) -> None:
        self._materialize("etype")[pos] = values

    def set_column(self, name: str, pos, values) -> None:
        self.columns.materialize(name)[pos] = values

    @property
    def dirty(self) -> bool:
        """The partition FILE is stale (in-place column/etype writes).
        Tombstones do NOT dirty the file — `dead` is persisted as a
        sidecar, so a tombstoned partition still hard-links/dedups by
        content."""
        return bool(self._ram) or self.columns.has_overrides()

    # -- residency ------------------------------------------------------------
    def evict(self) -> None:
        """Drop every memmap and decoded pointer cache. Pinned compressed
        blobs, RAM overrides (dirty state), and tombstones survive."""
        self._mm.clear()
        self._idx.clear()
        self.columns.evict()

    def advise_dontneed(self) -> None:
        """Tell the kernel this partition's file pages won't be re-read
        (PSW sweeps touch each bucket once per pass). Two hints, both
        advisory and platform-guarded: `madvise(DONTNEED)` drops the
        mappings' PTEs (RSS), and `posix_fadvise(POSIX_FADV_DONTNEED)`
        asks the kernel to drop the file's clean PAGE-CACHE pages — for a
        read-only shared file mapping madvise alone leaves the cache copy
        in place, so without the fadvise a streaming scan would still
        churn hotter data out."""
        advise = getattr(mmap.mmap, "madvise", None)
        flag = getattr(mmap, "MADV_DONTNEED", None)
        if advise is not None and flag is not None:
            for arr in self._mm.values():
                m = getattr(arr, "_mmap", None)
                if m is not None:
                    try:
                        m.madvise(flag)
                    except (OSError, ValueError):
                        pass  # platform refused the hint; purely advisory
        fadvise = getattr(os, "posix_fadvise", None)
        fflag = getattr(os, "POSIX_FADV_DONTNEED", None)
        if fadvise is not None and fflag is not None and self._mm:
            try:
                fd = os.open(self.path, os.O_RDONLY)
                try:
                    fadvise(fd, 0, 0, fflag)  # whole file
                finally:
                    os.close(fd)
            except OSError:
                pass

    def resident_nbytes(self) -> int:
        """Bytes pinned regardless of eviction: the compressed index
        (gamma blobs + bit-offset directories + block firsts)."""
        return sum(bp.nbytes() for bp in self._bp.values())

    def cached_nbytes(self) -> int:
        """Evictable bytes currently materialized (decoded pointers + RAM
        overrides; memmap pages are the OS's to count)."""
        n = sum(a.nbytes for a in self._idx.values())
        n += sum(a.nbytes for a in self._ram.values())
        n += self.columns.override_nbytes()
        return n

    def nbytes(self) -> int:
        return os.path.getsize(self.path)


class _ColumnDict(dict):
    """The `columns` mapping of a DiskPartition: values are memmaps until
    written, then RAM overrides. Plain-dict writes (e.g. PageRank's
    `columns["pr"] = ranks`) just shadow the file copy. Holds its partition
    weakly — the partition owns the dict, and a strong back-edge would put
    every replaced partition's mappings at the GC's mercy."""

    def __init__(self, part: DiskPartition):
        super().__init__()
        self._part = weakref.ref(part)
        self._overridden: set = set()
        for name in part.header["columns"]:
            super().__setitem__(name, None)  # placeholder, filled lazily

    def __getitem__(self, key):
        val = super().__getitem__(key)
        if val is None:
            val = self._part()._mmap(f"col_{key}")
            super().__setitem__(key, val)
        return val

    def get(self, key, default=None):
        if key not in self:
            return default
        return self[key]

    def __setitem__(self, key, value):
        self._overridden.add(key)
        super().__setitem__(key, value)

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def materialize(self, key) -> np.ndarray:
        if key not in self._overridden:
            self[key] = np.array(self[key])
        return super().__getitem__(key)

    def has_overrides(self) -> bool:
        return bool(self._overridden)

    def override_nbytes(self) -> int:
        return sum(np.asarray(super(_ColumnDict, self).__getitem__(k)).nbytes
                   for k in self._overridden)

    def evict(self) -> None:
        for k in self.keys():
            if k not in self._overridden:
                super().__setitem__(k, None)


def _link_or_copy(src: str, dst: str) -> str:
    """Hard-link (pin the inode, zero data copy); copy across filesystems."""
    if not os.path.exists(dst):
        failpoint("store.link")
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)
    return dst


# ---------------------------------------------------------------------------
# Content-addressed partition store
# ---------------------------------------------------------------------------
class PartitionStore:
    """`parts/part_<digest>.pal` under a database directory. Immutable files
    + atomic rename publishing: a digest either fully exists or doesn't,
    so dedup (same content → same file), checkpoint hard-links, and GC are
    all trivially safe."""

    def __init__(self, directory: str, io: Optional[IOStats] = None,
                 checksums: bool = True):
        self.dir = os.path.join(directory, "parts")
        os.makedirs(self.dir, exist_ok=True)
        self.io = io
        self.checksums = bool(checksums)
        self._unsynced: set = set()

    def path_of(self, digest: str) -> str:
        return os.path.join(self.dir, f"part_{digest}.pal")

    def put(self, part: EdgePartition, fsync: bool = False) -> str:
        """Write-if-absent. Merge-path writes defer fsync (hundreds of
        syncs per bulk load otherwise); `sync(digests)` settles the debt
        before a manifest references them."""
        digest = partition_digest(part)
        path = self.path_of(digest)
        if not os.path.exists(path):
            write_partition_file(path, part, fsync=fsync,
                                 checksums=self.checksums)
            if not fsync:
                self._unsynced.add(digest)
        return digest

    def sync(self, digests) -> None:
        synced = 0
        for digest in list(digests):
            if digest in self._unsynced:
                path = self.path_of(digest)
                if os.path.exists(path):
                    fd = os.open(path, os.O_RDONLY)
                    try:
                        failpoint("part.write.fsync")
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                    synced += 1
                self._unsynced.discard(digest)
        if synced:
            # one dir sync settles every deferred rename's directory entry
            fsync_dir(self.dir)

    def open(self, digest: str, index_mode: str = "gamma") -> DiskPartition:
        return open_partition_file(self.path_of(digest), io=self.io,
                                   index_mode=index_mode,
                                   verify=self.checksums)

    def gc(self, keep_digests) -> int:
        """Delete store files whose digest is not in `keep_digests`.
        Checkpoint hard-links live in other directories and keep the inode
        alive on their own."""
        keep = {f"part_{d}.pal" for d in keep_digests}
        removed = 0
        for fname in os.listdir(self.dir):
            if fname.endswith(".pal") and fname not in keep:
                failpoint("store.gc.unlink")
                os.remove(os.path.join(self.dir, fname))
                removed += 1
            elif ".pal.tmp" in fname:
                # abandoned temp from a crashed writer; an ACTIVE worker's
                # temp carries its live (pid, thread) suffix — colliding
                # with one is possible only for a recycled pid, and the
                # worker's atomic rename re-publishes identical bytes
                try:
                    os.remove(os.path.join(self.dir, fname))
                except OSError:
                    pass
        return removed

    def link_into(self, digest: str, dest_dir: str) -> str:
        """Hard-link a partition file into `dest_dir` (checkpoints,
        snapshot pins); falls back to a copy across filesystems."""
        src = self.path_of(digest)
        return _link_or_copy(src, os.path.join(dest_dir,
                                               os.path.basename(src)))


# ---------------------------------------------------------------------------
# Typed WAL replay (shared by GraphDB recovery and snapshot sessions)
# ---------------------------------------------------------------------------
def replay_ops(tree: LSMTree, ops) -> int:
    """Apply a typed WAL op stream (walog.SegmentedWAL.replay) to a tree in
    log order. Ops carry INTERNAL ids; the tree API takes original ids, so
    each op round-trips through the reversible hash. Returns ops applied.
    The caller must have suspended WAL logging on the tree."""
    iv = tree.intervals
    n = 0
    for op in ops:
        kind = op[0]
        if kind == "insert":
            _, s, d, t, cols = op
            tree.insert_edges(np.asarray(iv.to_original(s)),
                              np.asarray(iv.to_original(d)), etype=t,
                              columns=cols)
        elif kind == "delete":
            _, s, d = op
            tree.delete_edge(int(iv.to_original(s)), int(iv.to_original(d)))
        else:
            _, name, s, d, val = op
            tree.update_edge_column(int(iv.to_original(s)),
                                    int(iv.to_original(d)), name, val)
        n += 1
    return n


# ---------------------------------------------------------------------------
# GraphDB — the durable database directory
# ---------------------------------------------------------------------------
class GraphDB:
    """An LSM graph store that lives in a directory:

        dbdir/MANIFEST.json   atomically-renamed recovery root
        dbdir/wal/            segmented typed WAL (walog.SegmentedWAL)
        dbdir/parts/          content-addressed immutable partition files

    Merged partitions above `persist_min_edges` are flushed to disk as they
    are produced (the LSM's `partition_sink`) and replaced in the tree by
    mmap-backed `DiskPartition`s; smaller/hot top partitions stay in RAM
    and are covered by the WAL. `checkpoint()` persists everything, writes
    the manifest (recording the WAL offset it covers), and GCs unreferenced
    store files. Recovery (`GraphDB.open`) = manifest partitions + WAL
    replay from the recorded offset. Single writer per directory."""

    MANIFEST = "MANIFEST.json"

    def __init__(self, directory: str, tree: LSMTree, config: Dict[str, Any],
                 io: Optional[IOStats] = None):
        self.dir = directory
        self.io = io or IOStats()
        self.store = PartitionStore(directory, io=self.io,
                                    checksums=config.get("checksums", True))
        self.tree = tree
        self.config = config
        self.persist_min_edges = int(config.get("persist_min_edges", 4096))
        self.resident_budget_bytes = config.get("resident_budget_bytes")
        # integrity accounting: every detected corruption /
        # quarantine / rebuild is appended here — `integrity_report()`
        # surfaces what was lost vs recovered instead of serving garbage
        self.integrity_log: List[Dict[str, Any]] = []
        # per-partition touch recency (monotone clock) for LRU-first
        # eviction; partitions never touched sort oldest
        self._touch_clock = itertools.count(1)
        tree.partition_sink = self._sink
        # the engine calls this after it is done with a slab inside one
        # batched query, letting a budgeted store release decoded indexes
        # mid-batch instead of accumulating one per slab
        tree.release_slab = self._release_slab

    # -- lifecycle -------------------------------------------------------------
    @classmethod
    def create(
        cls,
        directory: str,
        max_id: int,
        n_partitions: int = 8,
        n_levels: int = 2,
        branching: int = 8,
        buffer_cap: int = 100_000,
        max_partition_edges: int = 2_000_000,
        column_dtypes: Optional[Dict[str, np.dtype]] = None,
        durable: bool = True,
        wal_sync: str = "commit",
        persist_min_edges: int = 4096,
        resident_budget_bytes: Optional[int] = None,
        wal_segment_bytes: int = 4 << 20,
        checksums: bool = True,
        wal_keep_history: bool = False,
    ) -> "GraphDB":
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(os.path.join(directory, cls.MANIFEST)):
            raise FileExistsError(
                f"{directory} already holds a GraphDB — use GraphDB.open")
        iv = IntervalMap.for_capacity(max_id, n_partitions)
        column_dtypes = {k: np.dtype(v) for k, v in (column_dtypes or {}).items()}
        wal = (SegmentedWAL(os.path.join(directory, "wal"),
                            column_dtypes=column_dtypes, sync=wal_sync,
                            segment_bytes=wal_segment_bytes, crc=checksums)
               if durable else None)
        tree = LSMTree(
            iv, n_levels=n_levels, branching=branching, buffer_cap=buffer_cap,
            max_partition_edges=max_partition_edges,
            column_dtypes=column_dtypes, durable=durable,
            wal=wal, wal_sync=wal_sync)
        config = {
            "n_partitions": iv.n_partitions,
            "interval_len": iv.interval_len,
            "n_levels": n_levels,
            "branching": branching,
            "buffer_cap": buffer_cap,
            "max_partition_edges": max_partition_edges,
            "column_dtypes": {k: dt.str for k, dt in column_dtypes.items()},
            "durable": durable,
            "wal_sync": wal_sync,
            "persist_min_edges": persist_min_edges,
            "resident_budget_bytes": resident_budget_bytes,
            "wal_segment_bytes": wal_segment_bytes,
            "checksums": bool(checksums),
            "wal_keep_history": bool(wal_keep_history),
        }
        db = cls(directory, tree, config)
        db._write_manifest(wal_offset=db._wal_offset())
        return db

    @classmethod
    def bulk_load(cls, directory: str, src, dst, max_id: int, etype=None,
                  columns: Optional[Dict[str, np.ndarray]] = None,
                  **create_kw) -> "GraphDB":
        """Create a GraphDB whose leaf level holds the edges `src -> dst`
        (original ids, host int64 arrays) with their `etype` and edge
        `columns` (one array for each of `column_dtypes`), written straight
        to partition files. `insert_edges` of the same arrays would give
        the same edge multiset through buffers and merges; here each leaf
        is built once by `build_partition`, as `GraphPAL.from_edges` builds
        its partitions, put through the partition store, and covered by a
        manifest at the WAL's tail, so `GraphDB.open` recovers it bitwise.
        Leaves are built and written side by side, a thread a core (numpy's
        sorts, the checksums and the writes release the GIL). `create_kw`
        are `create`'s."""
        db = cls.create(directory, max_id, **create_kw)
        tree = db.tree
        iv = tree.intervals
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        n = src.shape[0]
        columns = dict(columns or {})
        if set(columns) != set(tree.column_dtypes):
            raise ValueError(f"columns {sorted(columns)} are not the store's "
                             f"{sorted(tree.column_dtypes)}")
        if dst.shape[0] != n or any(np.shape(v) != (n,)
                                    for v in columns.values()):
            raise ValueError("src, dst and every column need one entry an "
                             "edge")
        if n and (min(src.min(), dst.min()) < 0
                  or max(src.max(), dst.max()) > max_id):
            raise ValueError(f"vertex ids outside 0 .. {max_id}")
        etype = (np.zeros(n, np.int8) if etype is None
                 else np.asarray(etype, np.int8))
        isrc, idst = iv.to_internal(src), iv.to_internal(dst)
        leaves = tree.levels[-1]
        leaf_of = idst // (iv.max_vertices // len(leaves))

        def load(j):
            m = leaf_of == j
            if not m.any():
                return None
            return db.store.put(build_partition(
                leaves[j].interval, isrc[m], idst[m], etype[m],
                {k: np.asarray(v)[m].astype(tree.column_dtypes[k])
                 for k, v in columns.items()}))

        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            digests = list(pool.map(load, range(len(leaves))))
        for j, digest in enumerate(digests):
            if digest is not None:
                leaves[j] = db._open_part(digest)
        db.store.sync([d for d in digests if d is not None])
        tree.publish()
        db._write_manifest(wal_offset=db._wal_offset())
        return db

    @classmethod
    def open(cls, directory: str) -> "GraphDB":
        """Recover a GraphDB: manifest partitions + WAL tail replay."""
        mpath = os.path.join(directory, cls.MANIFEST)
        with open(mpath) as f:
            manifest = json.load(f)
        config = manifest["config"]
        iv = IntervalMap(n_partitions=config["n_partitions"],
                         interval_len=config["interval_len"])
        column_dtypes = {k: np.dtype(s)
                         for k, s in config["column_dtypes"].items()}
        wal = (SegmentedWAL(
                   os.path.join(directory, "wal"),
                   column_dtypes=column_dtypes, sync=config["wal_sync"],
                   segment_bytes=int(config.get("wal_segment_bytes", 4 << 20)),
                   crc=config.get("checksums", True))
               if config["durable"] else None)
        tree = LSMTree(
            iv, n_levels=config["n_levels"], branching=config["branching"],
            buffer_cap=config["buffer_cap"],
            max_partition_edges=config["max_partition_edges"],
            column_dtypes=column_dtypes, durable=config["durable"],
            wal=wal, wal_sync=config["wal_sync"])
        db = cls(directory, tree, config)
        lost = []
        for li, level in enumerate(manifest["levels"]):
            for pi, entry in enumerate(level):
                if entry is None:
                    continue
                try:
                    part = db._open_part(entry["digest"])
                except (CorruptionError, FileNotFoundError) as exc:
                    # a manifest-referenced partition is unreadable: move
                    # it out of the store (if it exists at all) and leave
                    # the slot's default empty partition — the WAL decides
                    # below whether the data is recoverable
                    db._quarantine_files(entry["digest"])
                    db.integrity_log.append({
                        "event": "quarantine", "digest": entry["digest"],
                        "interval": list(entry["interval"]),
                        "level": li, "slot": pi, "detail": str(exc),
                    })
                    lost.append(entry)
                    continue
                dead_path = os.path.join(db.store.dir,
                                         f"part_{entry['digest']}.dead.npy")
                if entry.get("dead") and os.path.exists(dead_path):
                    part.dead = np.load(dead_path)
                tree.levels[li][pi] = part
        legacy = os.path.join(directory, "wal.log")
        if wal is not None and os.path.exists(legacy):
            # pre-segmented-WAL database: its manifest's wal_offset indexes
            # wal.log. Replay the legacy tail WITH logging on (the records
            # re-enter the segmented WAL), retire the file, and checkpoint
            # so the manifest's offset re-anchors on the new log.
            s, d, ty = LSMTree.replay_wal(
                legacy, offset=int(manifest.get("wal_offset", 0)))
            if s.shape[0]:
                iv = tree.intervals
                tree.insert_edges(np.asarray(iv.to_original(s)),
                                  np.asarray(iv.to_original(d)), etype=ty)
            os.replace(legacy, legacy + ".migrated")
            db.checkpoint()
        elif lost and db._full_history_available():
            # quarantined partitions, but the WAL still reaches back to
            # offset 0: rebuild the WHOLE store from the log (surviving
            # partitions hold state the pre-compaction log also carries,
            # so they are dropped and re-derived — correctness over speed)
            db._rebuild_from_wal()
            db.integrity_log.append({
                "event": "rebuild", "recovered": [e["digest"] for e in lost],
            })
        else:
            db._replay_wal_tail(int(manifest.get("wal_offset", 0)))
            for e in lost:
                # compaction already dropped the log below the manifest
                # offset: the quarantined interval's pre-offset state is
                # gone. Report the unrecoverable range — never serve
                # silently-wrong (empty) data as if it were complete.
                db.integrity_log.append({
                    "event": "unrecoverable", "digest": e["digest"],
                    "interval": list(e["interval"]),
                    "n_edges_lost": int(e["n_edges"]),
                })
        # recovery installed partitions by direct slot assignment; publish
        # so epoch readers see the recovered store even with an empty tail
        tree.publish()
        return db

    def _wal_offset(self) -> int:
        if self.tree.wal is None:
            return 0
        self.tree.wal_flush(fsync=False)
        return self.tree.wal.tail_offset()

    def _replay_wal_tail(self, offset: int,
                         end: Optional[int] = None) -> None:
        """Apply the typed WAL tail in log order — inserts (with their
        attribute columns), tombstones, and column writes all replay, so
        recovery restores EVERY mutation since the covered offset, not just
        the edge triples (buffered columns survive)."""
        if self.tree.wal is None:
            return
        # the tail records are already in the WAL — re-applying must not
        # append them again, so logging is suspended for the replay
        wal, self.tree.wal = self.tree.wal, None
        try:
            replay_ops(self.tree, wal.replay(offset=offset, end=end))
        finally:
            self.tree.wal = wal

    # -- integrity: quarantine / rebuild / scrub ---------------------------------
    def _quarantine_files(self, digest: str) -> List[str]:
        """Move a corrupt partition file (and its tombstone sidecar) out of
        the store into `dbdir/quarantine/` so nothing can re-open it. The
        bytes are preserved for forensics, not deleted."""
        qdir = os.path.join(self.dir, "quarantine")
        moved = []
        for fname in (f"part_{digest}.pal", f"part_{digest}.dead.npy"):
            src = os.path.join(self.store.dir, fname)
            if os.path.exists(src):
                os.makedirs(qdir, exist_ok=True)
                os.replace(src, os.path.join(qdir, fname))
                moved.append(fname)
        if moved:
            fsync_dir(self.store.dir)
        self.store._unsynced.discard(digest)
        return moved

    def _empty_slot(self, interval) -> EdgePartition:
        return build_partition(
            (int(interval[0]), int(interval[1])),
            np.empty(0, np.int64), np.empty(0, np.int64),
            columns={k: np.empty(0, dt)
                     for k, dt in self.tree.column_dtypes.items()})

    def quarantine(self, digest: str, detail: str = "corruption") -> bool:
        """Drop a live corrupt partition: quarantine its file, replace its
        tree slot with an empty partition, and publish — reads keep flowing
        from every surviving level (plus buffered/WAL-covered state) while
        the quarantined interval's persisted edges are reported, not served
        as garbage. The manifest is NOT rewritten here: the next checkpoint
        re-derives it, and a crash-before-then reopen re-detects the missing
        file and re-quarantines (or rebuilds from a full-history WAL)."""
        hit = False
        for li, level in enumerate(self.tree.levels):
            for pi, part in enumerate(level):
                if (isinstance(part, DiskPartition)
                        and os.path.basename(part.path)[5:-4] == digest):
                    entry = {
                        "event": "quarantine", "digest": digest,
                        "interval": [int(part.interval[0]),
                                     int(part.interval[1])],
                        "level": li, "slot": pi, "detail": detail,
                        "n_edges_lost": int(part.n_edges),
                    }
                    part.evict()
                    self.tree.levels[li][pi] = self._empty_slot(part.interval)
                    self.integrity_log.append(entry)
                    hit = True
        self._quarantine_files(digest)
        if hit:
            self.tree.oplog.cut()   # the edge set changed outside the log
            self.tree.publish()
        return hit

    def _full_history_available(self) -> bool:
        """True when the WAL still starts at offset 0 (never compacted past
        the first record) — the whole store is re-derivable from the log."""
        if self.tree.wal is None:
            return False
        segs = self.tree.wal.segments()
        return bool(segs) and int(segs[0][0]) == 0

    def _rebuild_from_wal(self) -> int:
        """Full-store rebuild: reset every level slot and buffer to empty,
        then replay the ENTIRE log from offset 0 (logging suspended).
        Only sound when `_full_history_available()`."""
        tree = self.tree
        for li, level in enumerate(tree.levels):
            for pi, part in enumerate(level):
                if isinstance(part, DiskPartition):
                    part.evict()
                tree.levels[li][pi] = self._empty_slot(part.interval)
        tree.buffers = [EdgeBuffer(tree.column_dtypes)
                        for _ in tree.levels[0]]
        tree._buffered = 0
        tree._pending = [[] for _ in tree.buffers]
        tree._inflight_edges = 0
        tree.oplog.cut()
        wal, tree.wal = tree.wal, None
        try:
            n = replay_ops(tree, wal.replay(offset=0))
        finally:
            tree.wal = wal
        tree.publish()
        return n

    def scrub(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """Background integrity scrub: re-verify every section CRC of up to
        `limit` live partition files AND re-hash their content digests
        against the content address. Corrupt partitions are quarantined
        (reads keep flowing from survivors). Returns a report dict."""
        checked, quarantined = 0, []
        for part in list(self._disk_partitions()):
            if limit is not None and checked >= limit:
                break
            digest = os.path.basename(part.path)[5:-4]
            checked += 1
            try:
                # a fresh verifying open: touches every section (CRC check
                # on first touch) without disturbing the live partition's
                # caches, then re-derives the content address
                probe = open_partition_file(part.path, verify=True)
                try:
                    found = partition_digest(probe)
                finally:
                    probe.evict()
                if found != digest:
                    raise CorruptionError(
                        part.path,
                        f"content digest {found} != address {digest}")
            except CorruptionError as exc:
                quarantined.append(digest)
                self.quarantine(digest, detail=str(exc))
            except FileNotFoundError:
                quarantined.append(digest)
                self.quarantine(digest, detail="file missing")
        return {"checked": checked, "quarantined": quarantined}

    def integrity_report(self) -> Dict[str, Any]:
        """What corruption was seen, what was recovered, what was lost."""
        return {
            "events": list(self.integrity_log),
            "quarantined": [e["digest"] for e in self.integrity_log
                            if e["event"] == "quarantine"],
            "unrecoverable": [
                {"interval": e["interval"],
                 "n_edges_lost": e["n_edges_lost"]}
                for e in self.integrity_log
                if e["event"] == "unrecoverable"],
        }

    # -- the LSM partition sink -----------------------------------------------
    def _open_part(self, digest: str) -> DiskPartition:
        """Open a store partition with the db's residency policy: without a
        budget, pointer lookups decode once and stay cached (service-tier
        repeat queries); with one, they stay chunked-decode."""
        dp = self.store.open(digest)
        dp.index_resident = self.resident_budget_bytes is None
        return dp

    def _sink(self, level: int, j: int, part: EdgePartition) -> EdgePartition:
        """Called by the tree whenever a merge produces a new partition.
        Large partitions go to disk immediately (and come back mmapped);
        small hot ones stay in RAM, covered by the WAL until checkpoint."""
        if isinstance(part, DiskPartition) or part.n_edges < self.persist_min_edges:
            return part
        digest = self.store.put(part)
        dp = self._open_part(digest)
        self._touch(dp)
        self.maybe_evict()
        return dp

    # -- residency -------------------------------------------------------------
    def _disk_partitions(self) -> List[DiskPartition]:
        return [p for lv in self.tree.levels for p in lv
                if isinstance(p, DiskPartition)]

    def evict(self) -> None:
        for p in self._disk_partitions():
            p.evict()

    def _touch(self, part: EdgePartition) -> None:
        part._touch = next(self._touch_clock)

    def maybe_evict(self) -> None:
        """Evict LRU-first until the decoded/override cache fits the budget
        — partitions a recent query touched keep their caches; cold ones
        (oldest touch stamp, or never touched) give theirs up first. The
        old behavior dropped EVERY partition's cache the moment the total
        crossed the budget, churning the hot set on every merge."""
        budget = self.resident_budget_bytes
        if budget is None:
            return
        parts = self._disk_partitions()
        total = sum(p.cached_nbytes() for p in parts)
        if total <= budget:
            return
        for p in sorted(parts, key=lambda p: getattr(p, "_touch", 0)):
            if total <= budget:
                break
            c = p.cached_nbytes()
            if c:
                p.evict()
                # credit only what eviction actually reclaimed — RAM
                # overrides (dirty column/etype state) survive evict()
                total -= c - p.cached_nbytes()

    def _release_slab(self, part: EdgePartition) -> None:
        """With a residency budget, a batched query releases each slab's
        mappings (and any decoded cache) as soon as it is done with it —
        the pages a gather faulted in leave RSS before the next slab
        faults its own, so a whole-store batch peaks at ONE slab's
        footprint. Remapping is a cheap syscall and the kernel page cache
        stays warm. Every release also stamps touch recency, feeding the
        LRU order `maybe_evict` uses on the insert path."""
        if isinstance(part, DiskPartition):
            self._touch(part)
            if self.resident_budget_bytes is not None:
                part.evict()

    def resident_nbytes(self) -> Dict[str, int]:
        parts = self._disk_partitions()
        return {
            "pinned_index": sum(p.resident_nbytes() for p in parts),
            "cached": sum(p.cached_nbytes() for p in parts),
            "ram_partitions": sum(
                p.nbytes() for lv in self.tree.levels for p in lv
                if not isinstance(p, DiskPartition)),
            "buffers": sum(
                len(b) * 17 for b in self.tree.buffers),
            "on_disk": sum(p.nbytes() for p in parts),
        }

    # -- durability ------------------------------------------------------------
    def checkpoint(self) -> Dict[str, Any]:
        """Flush buffers, persist every non-empty partition, publish the
        manifest (atomic rename), GC unreferenced store files."""
        self.tree.flush_all()
        for li, level in enumerate(self.tree.levels):
            for pi, part in enumerate(level):
                if part.n_edges == 0:
                    continue
                if not isinstance(part, DiskPartition) or part.dirty:
                    digest = self.store.put(part)
                    dp = self._open_part(digest)
                    dp.dead = (None if part.dead is None
                               else np.asarray(part.dead))
                    self.tree.levels[li][pi] = dp
                    part = dp
                if part.dead is not None and part.dead.any():
                    self._write_dead_sidecar(
                        os.path.basename(part.path)[5:-4], part.dead)
        # the checkpoint swapped RAM/dirty partitions for fresh mmap-backed
        # ones; publish so new epoch readers pin the persisted state (and
        # the fresh `dead` refs get sealed before any further tombstone)
        self.tree.publish()
        # settle deferred fsyncs for every file the manifest will reference
        keep = {os.path.basename(p.path)[5:-4]
                for p in self._disk_partitions()}
        self.store.sync(keep)
        manifest = self._write_manifest(wal_offset=self._wal_offset())
        # deferred reclamation: files referenced by manifests that epoch
        # readers may still pin survive this GC round and fall out of the
        # keep-set once the last pin releases (core/manifest.py)
        self.store.gc({e["digest"] for lv in manifest["levels"]
                       for e in lv if e} | self.tree.pinned_digests())
        self._gc_dead_files(manifest)
        # WAL compaction: segments wholly below the covered offset carry
        # only state the manifest already persists. Snapshot sessions that
        # still need those bytes hold hard links — deleting here only drops
        # the store's name for the inode, never the session's.
        # `wal_keep_history` retains the full log instead: with checksums
        # on, the whole store is then re-derivable from offset 0, so a
        # corrupt partition can be REBUILT rather than reported lost
        # (recoverability traded against log space).
        if (self.tree.wal is not None
                and not self.config.get("wal_keep_history")):
            self.tree.wal.compact(int(manifest["wal_offset"]))
        return manifest

    SNAPSHOT = "SNAPSHOT.json"

    def pin_snapshot(self, dest_dir: str,
                     pinned_offset: Optional[int] = None) -> Dict[str, Any]:
        """Pin the database's CURRENT logical state into `dest_dir` without
        copying data: hard-link the last published manifest's partition
        files (+ dead sidecars) and every WAL segment carrying records in
        [manifest.wal_offset, tail), then write SNAPSHOT.json recording the
        pinned tail offset. The linked inodes survive store GC and WAL
        compaction, so the session stays readable — and bitwise stable up
        to its pinned offset — no matter what the writer does next.
        Single-writer callers may call this directly; under concurrency the
        service tier (core/service.py) serializes it with mutations.

        `pinned_offset` pins at a PAST logical offset instead of the tail —
        the epoch-view bridge: passing a `ManifestView.wal_tail`
        yields a session whose replayed state equals that pinned view, so
        an in-process epoch becomes addressable from another process. The
        offset must be at or past the offset the on-disk manifest covers
        (an older one would need WAL bytes a later checkpoint may already
        have compacted away, and un-replaying a manifest is impossible)."""
        if self.tree.wal is None:
            raise ValueError("snapshots need a durable GraphDB (the WAL "
                             "covers RAM partitions and live buffers)")
        manifest = self._read_manifest()
        self.tree.wal_flush(fsync=False)
        if pinned_offset is None:
            pinned = self.tree.wal.tail_offset()
        else:
            pinned = int(pinned_offset)
            covered = int(manifest["wal_offset"])
            if pinned < covered:
                raise ValueError(
                    f"pinned_offset {pinned} predates the checkpointed "
                    f"manifest (covers WAL up to {covered}); a view that "
                    f"old cannot be reconstructed from the current store")
        os.makedirs(dest_dir)
        for lv in manifest["levels"]:
            for e in lv:
                if e is None:
                    continue
                self.store.link_into(e["digest"], dest_dir)
                if e.get("dead"):
                    _link_or_copy(
                        os.path.join(self.store.dir,
                                     f"part_{e['digest']}.dead.npy"),
                        os.path.join(dest_dir,
                                     f"part_{e['digest']}.dead.npy"))
        wal_dir = os.path.join(dest_dir, "wal")
        os.makedirs(wal_dir)
        covered = int(manifest["wal_offset"])
        for base, end, path in self.tree.wal.segments():
            if end > covered and base < pinned:
                _link_or_copy(path,
                              os.path.join(wal_dir, os.path.basename(path)))
        doc = dict(manifest)
        doc["pinned_offset"] = int(pinned)
        tmp = os.path.join(dest_dir, self.SNAPSHOT + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        failpoint("snapshot.json.rename")
        os.replace(tmp, os.path.join(dest_dir, self.SNAPSHOT))
        fsync_dir(dest_dir)
        return doc

    def _write_dead_sidecar(self, digest: str, dead: np.ndarray) -> None:
        """Tombstones persist OUTSIDE the (content-addressed, immutable)
        partition file. Synced like the manifest: deletes are only durable
        at checkpoint, so the sidecar must actually be on disk before the
        manifest declares the WAL offset covered."""
        tmp = os.path.join(self.store.dir, f"part_{digest}.dead.npy.tmp")
        failpoint("dead.write")
        with open(tmp, "wb") as df:
            np.save(df, np.asarray(dead))
            df.flush()
            os.fsync(df.fileno())
        failpoint("dead.rename")
        os.replace(tmp, os.path.join(self.store.dir,
                                     f"part_{digest}.dead.npy"))
        fsync_dir(self.store.dir)

    def _gc_dead_files(self, manifest: Dict[str, Any]) -> None:
        live = {f"part_{e['digest']}.dead.npy"
                for lv in manifest["levels"] for e in lv
                if e and e.get("dead")}
        for fname in os.listdir(self.store.dir):
            if fname.endswith(".dead.npy") and fname not in live:
                os.remove(os.path.join(self.store.dir, fname))

    def _read_manifest(self) -> Dict[str, Any]:
        with open(os.path.join(self.dir, self.MANIFEST)) as f:
            return json.load(f)

    def _write_manifest(self, wal_offset: int) -> Dict[str, Any]:
        levels = []
        for level in self.tree.levels:
            entries = []
            for part in level:
                if isinstance(part, DiskPartition):
                    digest = os.path.basename(part.path)[5:-4]
                    entries.append({
                        "digest": digest,
                        "interval": [int(part.interval[0]), int(part.interval[1])],
                        "n_edges": part.n_edges,
                        "dead": bool(part.dead is not None and part.dead.any()),
                    })
                else:
                    entries.append(None)  # empty or RAM-only: WAL covers it
            levels.append(entries)
        manifest = {"config": self.config, "levels": levels,
                    "wal_offset": int(wal_offset)}
        tmp = os.path.join(self.dir, self.MANIFEST + ".tmp")
        failpoint("manifest.write")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        failpoint("manifest.rename")
        os.replace(tmp, os.path.join(self.dir, self.MANIFEST))
        fsync_dir(self.dir)
        return manifest

    def close(self) -> None:
        self.checkpoint()
        self.tree.close()
        self.evict()

    # -- delegation (GraphDB quacks like its tree) ------------------------------
    @property
    def intervals(self) -> IntervalMap:
        return self.tree.intervals

    @property
    def buffers(self):
        return self.tree.buffers

    @property
    def levels(self):
        return self.tree.levels

    @property
    def n_edges(self) -> int:
        return self.tree.n_edges

    def insert_edge(self, *a, **kw):
        return self.tree.insert_edge(*a, **kw)

    def insert_edges(self, *a, **kw):
        return self.tree.insert_edges(*a, **kw)

    def delete_edge(self, *a, **kw):
        return self.tree.delete_edge(*a, **kw)

    def update_edge_column(self, *a, **kw):
        return self.tree.update_edge_column(*a, **kw)

    def out_neighbors(self, v: int) -> np.ndarray:
        return self.tree.out_neighbors(v)

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.tree.in_neighbors(v)

    def storage_engine(self):
        return self.tree.storage_engine()

    def read_view(self):
        """Pinned lock-free read view (core/manifest.py)."""
        return self.tree.read_view()

    def snapshot(self, **kw):
        return self.tree.snapshot(**kw)

    def all_partitions(self):
        return self.tree.all_partitions()

    def flush_all(self) -> None:
        self.tree.flush_all()

    def to_coo(self):
        return self.tree.to_coo()


# ---------------------------------------------------------------------------
# Figure-8 index readers: REAL counted block reads via os.pread
# ---------------------------------------------------------------------------
class RawDiskIndex:
    """Binary search over an on-disk sorted int64 array with block-granular
    `os.pread`s — the paper's "pointer array on disk" baseline. Every probe
    reads one real `block_size` block and counts it; RAM footprint is one
    block."""

    def __init__(self, path: str, offset: int, n: int, block_size: int = 4096):
        self.path = path
        self.offset = offset
        self.n = n
        self.block_size = block_size
        self.keys_per_block = block_size // 8
        self.n_blocks = -(-n // self.keys_per_block) if n else 0
        self.block_reads = 0
        self._fd = os.open(path, os.O_RDONLY)

    def _read_block(self, b: int) -> np.ndarray:
        self.block_reads += 1
        telemetry.counter("codec.block_reads").inc()
        lo = b * self.keys_per_block
        hi = min(lo + self.keys_per_block, self.n)
        raw = os.pread(self._fd, (hi - lo) * 8, self.offset + lo * 8)
        return np.frombuffer(raw, np.int64)

    def lookup(self, k: int) -> int:
        """Index of k, or -1 — a block-granular binary search, log₂(#blocks)
        real reads plus one for the final block."""
        lo_b, hi_b = 0, self.n_blocks - 1
        if self.n_blocks == 0:
            return -1
        while lo_b < hi_b:
            mid = (lo_b + hi_b + 1) // 2
            first = self._read_block(mid)[0]
            if first <= k:
                lo_b = mid
            else:
                hi_b = mid - 1
        blk = self._read_block(lo_b)
        i = int(np.searchsorted(blk, k))
        if i < blk.shape[0] and blk[i] == k:
            return lo_b * self.keys_per_block + i
        return -1

    def nbytes(self) -> int:
        return self.block_size  # one block buffer

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class SparseDiskIndex:
    """The paper's sparse option with real I/O: every `stride`-th key is
    resident; a lookup is one RAM binary search + ONE real block read."""

    def __init__(self, path: str, offset: int, n: int, stride: int = 512,
                 block_size: int = 4096):
        self.raw = RawDiskIndex(path, offset, n, block_size=max(block_size,
                                                                stride * 8))
        self.stride = stride
        keys = np.memmap(path, np.int64, mode="r", offset=offset, shape=(n,))
        self.sparse = np.array(keys[::stride])
        del keys

    @property
    def block_reads(self) -> int:
        return self.raw.block_reads

    def lookup(self, k: int) -> int:
        j = int(np.searchsorted(self.sparse, k, side="right")) - 1
        j = max(j, 0)
        lo = j * self.stride
        hi = min(lo + self.stride, self.raw.n)
        self.raw.block_reads += 1
        telemetry.counter("codec.block_reads").inc()
        raw = os.pread(self.raw._fd, (hi - lo) * 8, self.raw.offset + lo * 8)
        blk = np.frombuffer(raw, np.int64)
        i = int(np.searchsorted(blk, k))
        if i < blk.shape[0] and blk[i] == k:
            return lo + i
        return -1

    def nbytes(self) -> int:
        return self.sparse.nbytes

    def close(self) -> None:
        self.raw.close()
