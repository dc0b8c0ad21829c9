"""End-to-end integrity primitives: checksums, typed failure
errors, and directory-fsync durability helpers.

Checksum algorithms — always recorded *by name* in the header that
carries the values, so files are self-describing and old files stay
readable after an algorithm switch:

  * `crc32` (`"crc32-zlib"`): CRC-32 via `zlib.crc32`. Used for tiny
    fixed inputs (partition header trailers, small WAL records) where
    its per-call overhead is nil.
  * `checksum32` (`"wsum32"`): the bulk-data checksum — 4 KiB block sums
    combined with position-dependent odd weights and folded to 32 bits,
    all in vectorized numpy. On machines whose zlib lacks a hardware CRC
    path this runs at memory bandwidth (~10-15x `zlib.crc32`), which is
    what keeps full-coverage checksumming under the <5% overhead gate
    (`bench_service.py --section checksum`). It detects bit flips,
    torn/stale/zeroed ranges, and block reorders; it is NOT
    cryptographic — content *addresses* use sha1 digests.
  * `record_checksum`: the WAL record checksum — `crc32` under 1 KiB,
    `checksum32` above (deterministic by length, so readers agree).

Coverage map (DESIGN.md §11):

  * every WAL record carries a trailing u32 checksum over its record
    bytes (core/walog.py; segment header `"crc": 2` = record_checksum,
    `"crc": 1` = plain crc32, absent = unchecksummed (older writers) —
    all three parse),
  * every 64B-aligned section of a partition file carries a checksum in
    the (versioned) header, verified lazily on first touch
    (core/disk.py, format version 2; version-1 files stay readable).

The error taxonomy is the contract "fail typed, never garbage":

    GraphDBError
    ├── CorruptionError     bytes on disk disagree with their checksum /
    │                       digest / format (path + detail attached)
    │   └── WALCorruptionError   a WAL record body failed its CRC
    ├── RecoveryError       recovery inputs are structurally impossible
    │   └── WALGapError     the segment chain has a hole (missing segment)
    ├── ReadOnlyError       the service shed to read-only mode; writes are
    │                       rejected until the condition clears
    ├── DeadlineExceeded    the request's time budget ran out before the
    │                       work completed (also a TimeoutError)
    └── OverloadError       admission control shed the request — the
                            system chose not to start work it could not
                            finish in time (queue full, breaker open, …)

`fsync_dir` closes the classic rename-durability hole: `os.replace` makes
a publish atomic, but the *directory entry* itself is only durable once
the parent directory is fsynced — without it, a power failure after the
rename can forget the file (or resurrect the old name). Every atomic
publish in the storage tier (MANIFEST.json, SNAPSHOT.json, partition
files, tombstone sidecars, WAL segment creation) now syncs its parent
directory, each crossing the `dir.fsync` failpoint.

Host copy of the reference `repro/core/integrity.py` (numpy): the same
algorithms, so either package verifies the other's files.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from .failpoints import failpoint

__all__ = [
    "CRC_ALGO",
    "CKSUM_ALGO",
    "crc32",
    "checksum32",
    "record_checksum",
    "fsync_dir",
    "GraphDBError",
    "CorruptionError",
    "WALCorruptionError",
    "RecoveryError",
    "WALGapError",
    "ReadOnlyError",
    "DeadlineExceeded",
    "OverloadError",
]

CRC_ALGO = "crc32-zlib"
CKSUM_ALGO = "wsum32"


def crc32(data, value: int = 0) -> int:
    """CRC-32 of a bytes-like (memoryview-friendly: numpy arrays pass
    through `memoryview` without a copy)."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


_CK_BLOCK = 512                             # uint64 words / block = 4 KiB
_CK_STEP = np.uint64(0x9E3779B97F4A7C15)    # odd (golden-ratio) multiplier
_CK_MASK = (1 << 64) - 1
_ck_weights_cache = np.empty(0, np.uint64)


def _ck_weights(n: int) -> np.ndarray:
    global _ck_weights_cache
    if _ck_weights_cache.shape[0] < n:
        idx = np.arange(1, n + 1, dtype=np.uint64)
        _ck_weights_cache = (idx * _CK_STEP) | np.uint64(1)
    return _ck_weights_cache[:n]


def checksum32(data) -> int:
    """Bulk-data checksum (`CKSUM_ALGO`) at memory bandwidth: 4 KiB block
    sums x position-dependent odd weights, folded to 32 bits. Accepts any
    C-contiguous bytes-like (bytes, numpy array, memmap) without copying.
    All arithmetic wraps mod 2**64 (numpy array ops wrap silently; the
    scalar accumulation stays in Python ints to avoid overflow warnings).
    """
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    n = len(mv)
    total = n
    head = n - (n & 7)
    if head:
        v = np.frombuffer(mv[:head], dtype="<u8")
        whole = (v.shape[0] // _CK_BLOCK) * _CK_BLOCK
        if whole:
            bs = v[:whole].reshape(-1, _CK_BLOCK).sum(axis=1,
                                                      dtype=np.uint64)
            total += int(np.add.reduce(bs * _ck_weights(bs.shape[0])))
        tail = v[whole:]
        if tail.shape[0]:
            # the partial block: weighted per-word under a shifted phase
            # so bytes cannot migrate between regions unnoticed
            total += int(np.add.reduce(
                (tail * _ck_weights(tail.shape[0])) * _CK_STEP))
    rem = n & 7
    if rem:
        total += (int.from_bytes(mv[head:], "little") * int(_CK_STEP)
                  + rem)
    total &= _CK_MASK
    return ((total >> 32) ^ total) & 0xFFFFFFFF


_RECORD_SMALL = 1024


def record_checksum(data) -> int:
    """WAL record checksum (segment header `"crc": 2`): plain CRC-32 for
    small records (crc32's per-call overhead is nil and numpy's isn't),
    `checksum32` for bulk group-commit records. Deterministic by record
    length, so writer and replayer always agree."""
    if len(data) < _RECORD_SMALL:
        return crc32(data)
    return checksum32(data)


class GraphDBError(Exception):
    """Base of every typed storage/service failure."""


class CorruptionError(GraphDBError, ValueError):
    """On-disk bytes disagree with their checksum, digest, or format.
    Also a `ValueError`: earlier callers caught bad-magic/format
    failures as ValueError and still can."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"{path}: {detail}")
        self.path = path
        self.detail = detail


class WALCorruptionError(CorruptionError):
    """A WAL record inside the acknowledged stream failed its CRC. Carries
    the global offset of the first bad record: everything before it is a
    valid durable prefix the caller may keep."""

    def __init__(self, path: str, offset: int, detail: str):
        super().__init__(path, f"{detail} (first bad offset {offset})")
        self.offset = offset


class RecoveryError(GraphDBError):
    """Recovery inputs are structurally impossible (not mere bit rot):
    missing segment files, a manifest referencing absent partitions, …"""


class WALGapError(RecoveryError):
    """The WAL segment chain has a hole: a segment's base offset is past
    the end of its predecessor. Replaying across the gap would silently
    drop acknowledged mutations, so recovery must fail typed instead."""

    def __init__(self, directory: str, expected: int, found: int):
        super().__init__(
            f"{directory}: WAL segment chain gap — expected a segment "
            f"covering offset {expected}, next segment starts at {found}")
        self.expected = expected
        self.found = found


class ReadOnlyError(GraphDBError, RuntimeError):
    """The service shed to read-only mode (ENOSPC / repeated persist
    failure). Epoch reads and snapshot sessions stay live; writes are
    rejected with this error until the condition clears. Also a
    `RuntimeError`: callers that treated any writer-path failure as
    RuntimeError keep working."""

    def __init__(self, reason: str):
        super().__init__(f"service is read-only: {reason}")
        self.reason = reason


class DeadlineExceeded(GraphDBError, TimeoutError):
    """The request's time budget ran out. Raised by whichever
    lifecycle stage first notices — admission, a queue drain, a socket
    timeout the router derived from the deadline, or a shard worker
    checking the budget before executing an op. Also a `TimeoutError`, so
    callers treating any timeout generically keep working. `late_by` is
    how far past the deadline the check ran (seconds, >= 0)."""

    def __init__(self, what: str = "request", late_by: float = 0.0):
        super().__init__(f"deadline exceeded: {what} "
                         f"(late by {max(0.0, late_by) * 1e3:.1f}ms)")
        self.what = what
        self.late_by = max(0.0, float(late_by))


class OverloadError(GraphDBError):
    """Admission control shed the request: the system refused
    to START work it predicted it could not finish within the request's
    deadline — a bounded queue was full, estimated queue delay exceeded
    the budget, writer backpressure was at its bound, or a circuit
    breaker was open. Shedding is the fast path: the caller learns in
    microseconds instead of waiting out a doomed request. `reason` is a
    stable machine-readable tag (`queue_full`, `queue_delay`,
    `backpressure`, `breaker_open`, …)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"overloaded ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


def fsync_dir(path: str) -> None:
    """fsync the DIRECTORY containing `path` (or `path` itself if it is
    one) so a just-renamed entry survives power failure. Advisory on
    platforms whose directories refuse O_RDONLY open/fsync (Windows)."""
    d = path if os.path.isdir(path) else os.path.dirname(path) or "."
    failpoint("dir.fsync")
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
