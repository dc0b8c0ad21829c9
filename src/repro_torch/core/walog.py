"""Segmented durable write-ahead log.

A single append-only `wal.log` (`LSMTree`'s own log) has three gaps: it
only grows (a manifest records covered offsets but bytes are never
reclaimed), it only records `(src, dst, etype)` (buffered attribute
columns and all deletes / column writes are lost between checkpoints), and
a reader cannot pin a stable prefix while a writer keeps appending.
`SegmentedWAL` closes all three:

  * **Segments.** The log is a directory of `seg_<base>.wal` files, rotated
    once a segment's record bytes exceed `segment_bytes`. Offsets handed to
    callers are *global logical* offsets over the concatenated record
    stream (headers excluded), so they survive rotation; `<base>` in the
    file name is the segment's first record's global offset. Segments
    wholly below a checkpoint's covered offset are deleted by
    `compact(covered)` — on-disk WAL bytes shrink instead of growing
    forever. Rotation fsyncs the sealed segment.
  * **Typed records with a declared column schema.** Each segment header
    carries the schema (sorted column name → dtype); insert records store
    the columns positionally after the edge triples, so crash recovery
    restores attribute values buffered since the last checkpoint. Deletes
    (tombstones) and in-place column writes are record types of their own —
    *every* mutation is durable between checkpoints, not just inserts.
  * **Pinnable prefixes.** Segment files are append-only and never
    rewritten, so hard-linking them into a session directory pins the
    bytes; `replay(offset, end)` caps at `end`, giving a snapshot a
    bitwise-stable view of the record stream even while the writer keeps
    appending to the shared inode (core/service.py).

Record stream grammar (little-endian):

    INSERT  = 0x01  u32 n  n×(i64 src, i64 dst, i8 etype)
                    then, per schema column in schema order, n×itemsize
    DELETE  = 0x02  i64 src, i64 dst                (internal IDs)
    COLUMN  = 0x03  u16 schema_index, i64 src, i64 dst, itemsize value

Segments whose header declares `"crc": 1` (every segment the current
writer makes) append a u32 CRC-32 over the record bytes after EVERY record;
older segments parse exactly as before. The CRC turns silent bit rot into
a typed failure (`WALCorruptionError`) instead of garbage edges:

  * a bad record in a SEALED segment — or followed by further valid bytes
    — is corruption of acknowledged history and raises, carrying the
    global offset of the durable prefix before it;
  * a bad or length-torn record at the very tail of the LAST segment is a
    torn write (crash mid-append, possibly spanning a filesystem-section
    boundary): it was never acknowledged-and-synced, so replay drops it
    and opening for append truncates back to the last whole record.

Replay also verifies the segment CHAIN: each segment must begin exactly
where its predecessor ended (`WALGapError` otherwise), so a missing or
header-torn middle segment — e.g. a snapshot dir that lost a hard link —
fails typed instead of silently skipping acknowledged mutations.

Host copy of the reference `repro/core/walog.py` (numpy): the same record
stream and segment files, byte for byte, so either package replays the
other's log.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import telemetry
from .failpoints import failpoint
from .integrity import (
    CKSUM_ALGO,
    CRC_ALGO,
    WALCorruptionError,
    WALGapError,
    crc32,
    fsync_dir,
    record_checksum,
)

__all__ = ["SegmentedWAL", "REC_INSERT", "REC_DELETE", "REC_COLUMN"]

_MAGIC = b"GCDBWAL1"
REC_INSERT = 1
REC_DELETE = 2
REC_COLUMN = 3

_M_APPENDS = telemetry.counter("wal.appends")
_M_APPEND_BYTES = telemetry.counter("wal.append.bytes")
_M_APPEND_S = telemetry.histogram("wal.append.seconds")
_M_FSYNCS = telemetry.counter("wal.fsyncs")
_M_FSYNC_S = telemetry.histogram("wal.fsync.seconds")

_EDGE_DT = np.dtype([("s", "<i8"), ("d", "<i8"), ("t", "i1")])
_INSERT_HDR = struct.Struct("<BI")
_DELETE_REC = struct.Struct("<Bqq")
_COLUMN_HDR = struct.Struct("<BHqq")


class SegmentedWAL:
    """Rotating segmented WAL over a directory. One writer; any number of
    readers via `replay` (including read-only instances over a directory of
    hard-linked segments). All appends are thread-safe behind one lock."""

    def __init__(self, directory: str,
                 column_dtypes: Optional[Dict[str, Any]] = None,
                 sync: str = "commit", segment_bytes: int = 4 << 20,
                 readonly: bool = False, crc: bool = True):
        assert sync in ("always", "commit", "close"), sync
        self.dir = directory
        self.sync = sync
        self.segment_bytes = int(segment_bytes)
        self.readonly = readonly
        # new segments carry per-record checksums; the int is the
        # record-checksum VERSION (2 = record_checksum: crc32 small /
        # wsum32 bulk; 1 = plain crc32, still replayable)
        self.crc = 2 if crc else 0
        self._lock = threading.Lock()
        self._f = None
        os.makedirs(directory, exist_ok=True)
        segs = self._scan()
        # quarantine a torn-HEADER tail segment (crash during rotation,
        # before the header's fsync): it was created but never held an
        # acknowledged record — appends only start after the header is on
        # disk — so dropping it loses nothing. Only the newest segment can
        # be in this state; an unreadable earlier segment is corruption.
        # A writer deletes the file; a readonly session just ignores it.
        while segs and _try_header(segs[-1][1]) is None:
            base, path = segs.pop()
            if not readonly:
                os.remove(path)
        if segs:
            # schema is immutable per WAL: read it back from any header
            hdr = _read_header(segs[-1][1])
            self.schema: List[Tuple[str, np.dtype]] = [
                (name, np.dtype(s)) for name, s in hdr["schema"]]
            if column_dtypes is not None:
                declared = sorted((k, np.dtype(v).str)
                                  for k, v in column_dtypes.items())
                assert declared == [(n, dt.str) for n, dt in self.schema], (
                    "WAL column schema mismatch: "
                    f"{declared} vs {hdr['schema']}")
        else:
            self.schema = sorted(
                (k, np.dtype(v)) for k, v in (column_dtypes or {}).items())
        self._names = [n for n, _ in self.schema]
        if readonly:
            self._base = self._tail = self._end_of(segs)
            return
        if segs:
            base, path = segs[-1]
            self._base = base
            # truncate a torn tail so appends resume at a record boundary;
            # in a CRC segment a fully-written record whose bytes were only
            # partially persisted (torn page across a section boundary)
            # also fails here and is truncated with it
            self._seg_crc = int(_read_header(path).get("crc", 0))
            body_len = os.path.getsize(path) - _header_len(path)
            good = _parse_len(_read_body(path), self.schema, self._seg_crc)
            if good < body_len:
                with open(path, "r+b") as f:
                    f.truncate(_header_len(path) + good)
            self._tail = base + good
            self._seg_bytes = good
            self._f = open(path, "ab", buffering=1 << 20)
        else:
            self._base = self._tail = 0
            self._open_segment(0)

    # -- segment bookkeeping ---------------------------------------------------
    def _scan(self) -> List[Tuple[int, str]]:
        segs = []
        for fname in os.listdir(self.dir):
            if fname.startswith("seg_") and fname.endswith(".wal"):
                segs.append((int(fname[4:-4]),
                             os.path.join(self.dir, fname)))
        return sorted(segs)

    def _end_of(self, segs) -> int:
        for base, path in reversed(segs):
            if _try_header(path) is not None:
                return base + os.path.getsize(path) - _header_len(path)
        return 0

    def _open_segment(self, base: int) -> None:
        path = os.path.join(self.dir, f"seg_{base:020d}.wal")
        doc = {"base": base,
               "schema": [[n, dt.str] for n, dt in self.schema]}
        if self.crc:
            doc["crc"] = self.crc
            doc["crc_algo"] = (CRC_ALGO if self.crc == 1 else
                               f"{CRC_ALGO}<1KiB/{CKSUM_ALGO}")
        header = json.dumps(doc, sort_keys=True).encode()
        failpoint("wal.segment.create")
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            f.flush()
            os.fsync(f.fileno())
        # the segment's directory entry must be durable before any record
        # in it is acknowledged (rename-without-dir-fsync loses the file)
        fsync_dir(self.dir)
        self._f = open(path, "ab", buffering=1 << 20)
        self._base = base
        self._seg_bytes = 0
        self._seg_crc = self.crc

    def _rotate(self) -> None:
        failpoint("wal.segment.rotate")
        self._f.flush()
        os.fsync(self._f.fileno())  # seal: a sealed segment is fully durable
        self._f.close()
        self._open_segment(self._tail)

    # -- appends ---------------------------------------------------------------
    def _append(self, payload: bytes) -> None:
        assert not self.readonly, "read-only WAL"
        t0 = time.perf_counter()
        with self._lock:
            if self._seg_crc:
                ck = (crc32 if self._seg_crc == 1
                      else record_checksum)(payload)
                payload += struct.pack("<I", ck)
            failpoint("wal.append.write")
            self._f.write(payload)
            self._tail += len(payload)
            self._seg_bytes += len(payload)
            if self.sync == "commit":
                self._f.flush()
            elif self.sync == "always":
                self._f.flush()
                failpoint("wal.append.fsync")
                ts = time.perf_counter()
                os.fsync(self._f.fileno())
                _M_FSYNCS.inc()
                _M_FSYNC_S.observe(time.perf_counter() - ts)
            if self._seg_bytes >= self.segment_bytes:
                self._rotate()
        _M_APPENDS.inc()
        _M_APPEND_BYTES.inc(len(payload))
        _M_APPEND_S.observe(time.perf_counter() - t0)

    def append_inserts(self, isrc, idst, etype,
                       columns: Optional[Dict[str, Any]] = None) -> None:
        """ONE group-commit record for a whole insert batch, columns
        included (internal IDs)."""
        isrc = np.ascontiguousarray(isrc, np.int64).ravel()
        n = int(isrc.shape[0])
        if n == 0:
            return
        rec = np.empty(n, _EDGE_DT)
        rec["s"] = isrc
        rec["d"] = np.asarray(idst, np.int64).ravel()
        rec["t"] = np.asarray(etype, np.int8).ravel()
        parts = [_INSERT_HDR.pack(REC_INSERT, n), rec.tobytes()]
        columns = columns or {}
        for name, dt in self.schema:
            v = columns.get(name)
            if v is None:
                arr = np.zeros(n, dt)
            else:
                arr = np.broadcast_to(np.asarray(v, dt), (n,))
            parts.append(np.ascontiguousarray(arr).tobytes())
        self._append(b"".join(parts))

    def append_delete(self, isrc: int, idst: int) -> None:
        self._append(_DELETE_REC.pack(REC_DELETE, int(isrc), int(idst)))

    def append_column(self, name: str, isrc: int, idst: int, value) -> None:
        ci = self._names.index(name)
        dt = self.schema[ci][1]
        self._append(_COLUMN_HDR.pack(REC_COLUMN, ci, int(isrc), int(idst))
                     + np.asarray(value, dt).tobytes())

    # -- durability ------------------------------------------------------------
    def flush(self, fsync: bool = False) -> None:
        if self.readonly or self._f is None:
            return
        with self._lock:
            self._f.flush()
            if fsync:
                failpoint("wal.append.fsync")
                ts = time.perf_counter()
                os.fsync(self._f.fileno())
                _M_FSYNCS.inc()
                _M_FSYNC_S.observe(time.perf_counter() - ts)

    def tail_offset(self) -> int:
        with self._lock:
            return self._tail

    def close(self) -> None:
        if self._f is not None:
            self.flush(fsync=True)
            self._f.close()
            self._f = None

    # -- segment lifecycle -----------------------------------------------------
    def segments(self) -> List[Tuple[int, int, str]]:
        """(base_offset, end_offset, path) per readable segment, ascending
        (a torn-header tail segment holds no acked records and is skipped)."""
        out = []
        for base, path in self._scan():
            if _try_header(path) is not None:
                out.append((base, base + os.path.getsize(path)
                            - _header_len(path), path))
        return out

    def compact(self, covered_offset: int) -> int:
        """Delete segments wholly below the covered offset (checkpointed
        state supersedes them). The active segment is never deleted — it is
        rotated first if it too is fully covered, so the next segment
        starts exactly at the covered boundary."""
        if self.readonly:
            return 0  # a pinned session dir never reclaims its links
        removed = 0
        with self._lock:
            if (self._f is not None
                    and self._tail <= covered_offset and self._seg_bytes > 0):
                self._rotate()
        for base, end, path in self.segments():
            if end <= covered_offset and base != self._base:
                failpoint("wal.compact.unlink")
                os.remove(path)
                removed += 1
        return removed

    def on_disk_bytes(self) -> int:
        return sum(os.path.getsize(p) for _, _, p in self.segments())

    def segment_identity(self, offset: int, end: int) -> Tuple:
        """Hashable identity of the record window [offset, end): the
        (st_dev, st_ino, base) of every segment overlapping it, plus the
        window itself. Hard-linked copies of the segments (snapshot session
        dirs pinning the same offset) share inodes and therefore the same
        identity — the key of the shared replayed-tail cache
        (the service tier, core/service.py)."""
        parts = []
        for base, seg_end, path in self.segments():
            if seg_end > offset and base < end:
                st = os.stat(path)
                parts.append((st.st_dev, st.st_ino, base))
        return (tuple(parts), int(offset), int(end))

    # -- replay ----------------------------------------------------------------
    def replay(self, offset: int = 0, end: Optional[int] = None,
               strict_head: bool = False) -> Iterator[Tuple]:
        """Decode records whose global offsets lie in [offset, end). Yields
        ("insert", src, dst, etype, columns) | ("delete", s, d) |
        ("column", name, s, d, value), in log order. `offset`/`end` must be
        record boundaries the WAL handed out (tail offsets); a torn
        trailing record is dropped. Failure is TYPED, never silent: a hole
        BETWEEN available segments raises `WALGapError` (acknowledged
        mutations would silently vanish); a CRC-failed record that is not
        the torn tail raises `WALCorruptionError` carrying the offset of
        the durable prefix before it. A hole before the FIRST available
        segment is compaction (only whole leading segments are ever
        deleted) and is skipped — unless `strict_head` is set, for readers
        of a pinned session dir where the first segment must cover
        `offset` and a missing link is loss, not compaction."""
        self.flush()
        segs = [(base, path, _try_header(path)) for base, path in self._scan()]
        # a crash during rotation leaves torn-header files only at the TAIL
        # (possibly several from a crash loop): they hold no acked records
        # and are skipped. An unreadable segment with a readable one after
        # it is a hole in acked history — typed failure below.
        while segs and segs[-1][2] is None:
            segs.pop()
        if strict_head and end is not None and end > offset and not segs:
            # a pinned dir whose [offset, end) window is non-empty must
            # hold at least the segment covering `offset`
            raise WALGapError(self.dir, int(offset), int(end))
        pos: Optional[int] = None  # None until the first readable segment
        for i, (base, path, hdr) in enumerate(segs):
            if end is not None and base >= end:
                break
            if hdr is None:
                raise WALGapError(self.dir,
                                  base if pos is None else pos,
                                  segs[i + 1][0])
            body = _read_body(path)
            seg_end = base + len(body)
            if seg_end <= offset:
                pos = max(pos or 0, seg_end)
                continue
            if pos is None:
                if strict_head and base > offset:
                    raise WALGapError(self.dir, int(offset), base)
            elif base > pos:
                raise WALGapError(self.dir, pos, base)
            lo = max(0, offset - base)
            hi = len(body) if end is None else min(len(body), end - base)
            schema = [(n, np.dtype(s)) for n, s in hdr["schema"]]
            crc = int(hdr.get("crc", 0))
            window = body[lo:hi]
            good = _parse_len(window, schema, crc)
            if good < len(window):
                # bytes past the last whole valid record: a torn tail is
                # droppable, anything else is corruption of acked history
                tail_of_log = (i == len(segs) - 1 and hi == len(body))
                if not tail_of_log:
                    raise WALCorruptionError(
                        path, base + lo + good,
                        "WAL record failed CRC / framing mid-stream")
            yield from _parse(window[:good], schema, crc)
            pos = seg_end


# ---------------------------------------------------------------------------
# Segment parsing (shared by replay, torn-tail recovery)
# ---------------------------------------------------------------------------
def _read_header(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a WAL segment")
        (hlen,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(hlen))


def _try_header(path: str) -> Optional[Dict[str, Any]]:
    """Header, or None for an empty/torn-header segment file."""
    try:
        return _read_header(path)
    except (ValueError, struct.error, json.JSONDecodeError, KeyError):
        return None


def _header_len(path: str) -> int:
    with open(path, "rb") as f:
        f.seek(8)
        (hlen,) = struct.unpack("<I", f.read(4))
    return 12 + hlen


def _read_body(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    hlen = struct.unpack("<I", data[8:12])[0]
    return data[12 + hlen:]


def _record_span(buf: bytes, p: int, schema) -> int:
    """Byte length of the record starting at p, or -1 if torn/unknown."""
    kind = buf[p]
    if kind == REC_INSERT:
        if p + _INSERT_HDR.size > len(buf):
            return -1
        (_, n) = _INSERT_HDR.unpack_from(buf, p)
        span = _INSERT_HDR.size + n * _EDGE_DT.itemsize
        for _, dt in schema:
            span += n * dt.itemsize
        return span
    if kind == REC_DELETE:
        return _DELETE_REC.size
    if kind == REC_COLUMN:
        if p + _COLUMN_HDR.size > len(buf):
            return -1
        (_, ci, _, _) = _COLUMN_HDR.unpack_from(buf, p)
        if ci >= len(schema):
            return -1
        return _COLUMN_HDR.size + schema[ci][1].itemsize
    return -1  # unknown kind: treat as torn


def _rec_at(buf: bytes, p: int, schema, crc: int) -> int:
    """Total stream span of the record at p (CRC trailer included), after
    verifying the trailer when the segment carries one. -1 = torn/bad."""
    span = _record_span(buf, p, schema)
    if span < 0:
        return -1
    total = span + 4 if crc else span
    if p + total > len(buf):
        return -1
    if crc:
        (want,) = struct.unpack_from("<I", buf, p + span)
        body = memoryview(buf)[p:p + span]
        got = crc32(body) if crc == 1 else record_checksum(body)
        if got != want:
            return -1
    return total


def _parse_len(buf: bytes, schema, crc: int = 0) -> int:
    """Length of the longest valid whole-record prefix of buf (in a CRC
    segment, "valid" includes the checksum)."""
    p = 0
    while p < len(buf):
        total = _rec_at(buf, p, schema, crc)
        if total < 0:
            break
        p += total
    return p


def _parse(buf: bytes, schema, crc: int = 0) -> Iterator[Tuple]:
    p = 0
    while p < len(buf):
        total = _rec_at(buf, p, schema, crc)
        if total < 0:
            break  # torn trailing record
        kind = buf[p]
        if kind == REC_INSERT:
            (_, n) = _INSERT_HDR.unpack_from(buf, p)
            q = p + _INSERT_HDR.size
            rec = np.frombuffer(buf, _EDGE_DT, count=n, offset=q)
            q += n * _EDGE_DT.itemsize
            cols = {}
            for name, dt in schema:
                cols[name] = np.frombuffer(buf, dt, count=n, offset=q)
                q += n * dt.itemsize
            yield ("insert", rec["s"], rec["d"], rec["t"], cols)
        elif kind == REC_DELETE:
            (_, s, d) = _DELETE_REC.unpack_from(buf, p)
            yield ("delete", s, d)
        else:
            (_, ci, s, d) = _COLUMN_HDR.unpack_from(buf, p)
            name, dt = schema[ci]
            val = np.frombuffer(buf, dt, count=1,
                                offset=p + _COLUMN_HDR.size)[0]
            yield ("column", name, s, d, val)
        p += total
