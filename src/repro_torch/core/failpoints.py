"""Deterministic fault-injection failpoints.

Every I/O boundary in the storage and service tiers carries a *named
injection site* — a `failpoint("site.name")` call that is a near-free dict
probe when nothing is armed, and fires a configured fault when it is. The
torture suite (tests/test_torture.py, benchmarks/bench_torture.py)
enumerates crash points along the ingest→merge→checkpoint→GC schedule by
arming one site at a time in a subprocess; unit tests arm errno faults to
drive the quarantine / read-only / recovery paths deterministically.

Sites and policies:

  * The **catalog** (`CATALOG`) is the closed set of legal site names with
    a one-line description each. `failpoint()` on an uncataloged name is a
    programming error (raises immediately), so the catalog can't drift
    from the code — and `scripts/check_failpoints.py` lints that every
    cataloged site is exercised by at least one test.
  * **Trigger policies** — a site fires its action when its hit counter
    satisfies the armed spec:
      - fire-once (the default: `count=1`),
      - fire-after-N (`after=N` skips the first N hits),
      - fire-K-times (`count=K`, or `count=None` for every hit),
      - seeded probability (`prob=p, seed=s`: an armed site carries its own
        `random.Random(seed)` so a run is reproducible from the seed).
  * **Actions**:
      - `"crash"`  — `os._exit(CRASH_EXIT_CODE)`: the process dies at the
        injection point with no cleanup, `atexit`, or buffer flushing —
        the closest a test can get to pulling the power,
      - `"errno:ENOSPC"` (any errno name) — raise `OSError(errno, ...)`
        exactly as the syscall under the site would,
      - `"raise"` — raise `FailpointError` (a typed, catchable fault),
      - `"delay:50"` / `"stall:50"` — sleep that many MILLISECONDS at the
        site, then continue: the gray-failure injector. A
        crash or errno models a dead component; a delay models the far
        more common *slow* one — the latency-chaos harness
        (benchmarks/bench_chaos.py) arms `shard.worker.op=delay:50` with
        a seeded probability to make one shard's tail heavy while every
        byte stays correct. `stall` is an alias of `delay` (reads better
        when the injected latency exceeds the caller's timeout),
      - any callable — invoked with the site name (custom behaviors).

Arming:

  * In-process: `fp_set("wal.append.fsync", "errno:ENOSPC", count=None)`,
    then `fp_clear()` (every test must clear; `fp_clear` is idempotent).
  * Across a process boundary (the torture harness): the environment
    variable `GRAPHDB_FAILPOINTS` is parsed at import time. Grammar, sites
    separated by `;`:

        site=action[@after][xcount]

    e.g. `GRAPHDB_FAILPOINTS="part.write.rename=crash@2"` crashes the
    process the 3rd time a partition-file rename is attempted, and
    `wal.append.write=errno:ENOSPC@0x0` arms ENOSPC on every WAL write
    (`x0` = unlimited count).

Hit counters (`fp_hits`) count every evaluation of an armed OR unarmed
site, letting regression tests assert that a code path actually crossed
an injection site (e.g. "the manifest publish fsynced its directory").
Counting only starts after `fp_trace(True)`/arming to keep the fast path
free for production use.

Host copy of the reference `repro/core/failpoints.py`: the same CATALOG,
so one lint (`scripts/check_failpoints.py`) covers both packages. The
port keeps its own armed state, parsed from `GRAPHDB_FAILPOINTS` at
import like the reference's.
"""
from __future__ import annotations

import errno as _errno
import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Union

__all__ = [
    "CATALOG",
    "CRASH_EXIT_CODE",
    "FailpointError",
    "failpoint",
    "fp_set",
    "fp_clear",
    "fp_hits",
    "fp_trace",
    "fp_armed",
]

# The exit code a "crash" action dies with — the torture harness asserts it
# to distinguish an injected crash from an ordinary failure.
CRASH_EXIT_CODE = 41

ENV_VAR = "GRAPHDB_FAILPOINTS"


class FailpointError(RuntimeError):
    """The typed fault the `"raise"` action injects."""

    def __init__(self, site: str):
        super().__init__(f"injected failpoint: {site}")
        self.site = site


# ---------------------------------------------------------------------------
# The catalog: every legal injection site, with where it lives
# ---------------------------------------------------------------------------
CATALOG: Dict[str, str] = {
    # --- segmented WAL (core/walog.py) ---
    "wal.append.write":    "record bytes written to the active segment",
    "wal.append.fsync":    "fsync of the active segment (sync=always/flush)",
    "wal.segment.create":  "new segment file created + header fsynced",
    "wal.segment.rotate":  "sealing fsync of a full segment before rotation",
    "wal.compact.unlink":  "deletion of a fully-covered segment",
    # --- partition files (core/disk.py) ---
    "part.write.body":     "partition-file section bytes written to the tmp",
    "part.write.fsync":    "partition-file fsync before publication",
    "part.write.rename":   "atomic rename publishing a partition file",
    "part.read.section":   "eager pread of a pinned section (gamma blobs)",
    "store.gc.unlink":     "deletion of an unreferenced store file",
    "store.link":          "hard-link of a store file (checkpoint/snapshot)",
    # --- manifest + sidecars (core/disk.py) ---
    "manifest.write":      "MANIFEST.json tmp written + fsynced",
    "manifest.rename":     "atomic rename publishing MANIFEST.json",
    "dead.write":          "tombstone sidecar tmp written + fsynced",
    "dead.rename":         "atomic rename publishing a tombstone sidecar",
    "dir.fsync":           "fsync of a parent directory after a rename",
    # --- snapshot pins (core/disk.py) ---
    "snapshot.json.rename": "atomic rename publishing SNAPSHOT.json",
    # --- maintenance pipeline (core/service.py) ---
    "service.flush.merge":  "a pipelined flush job's merge+persist stage",
    "service.ckpt.phaseA":  "checkpoint phase A per-partition persist",
    "service.ckpt.phaseB":  "checkpoint phase B exclusive commit",
    "service.scrub":        "background scrub of one partition file",
    # --- shard router / worker IPC (core/shardrouter.py) ---
    "shard.rpc.send":       "a frame about to be written to a shard socket",
    "shard.rpc.recv":       "a received frame's header+checksum verification",
    "shard.worker.op":      "a shard worker dispatching one decoded request",
    "shard.worker.serve":   "a spawned shard worker entering its accept loop",
    # --- serving front end (core/frontdesk.py) ---
    "frontdesk.dispatch":   "a front-desk dispatcher executing one batch",
}


# ---------------------------------------------------------------------------
# Armed-spec state
# ---------------------------------------------------------------------------
class _Spec:
    __slots__ = ("action", "after", "count", "prob", "rng", "fired")

    def __init__(self, action, after: int, count: Optional[int],
                 prob: Optional[float], seed: Optional[int]):
        self.action = action
        self.after = int(after)
        self.count = count  # None = unlimited
        self.prob = prob
        self.rng = random.Random(seed) if prob is not None else None
        self.fired = 0


_LOCK = threading.Lock()
_ARMED: Dict[str, _Spec] = {}
_HITS: Dict[str, int] = {}
_TRACING = False


def fp_trace(on: bool = True) -> None:
    """Enable hit counting for UNARMED sites too (tests asserting a code
    path crossed a site without injecting any fault)."""
    global _TRACING
    with _LOCK:
        _TRACING = bool(on)
        if not on:
            _HITS.clear()


def fp_armed(name: str) -> bool:
    return name in _ARMED


def fp_set(name: str, action: Union[str, Callable], after: int = 0,
           count: Optional[int] = 1, prob: Optional[float] = None,
           seed: Optional[int] = None) -> None:
    """Arm a site. `after` hits are skipped, then the action fires on up to
    `count` subsequent hits (None = every hit), each gated by `prob` when
    given (seeded — reproducible)."""
    if name not in CATALOG:
        raise KeyError(f"unknown failpoint {name!r} — add it to "
                       f"failpoints.CATALOG")
    with _LOCK:
        _ARMED[name] = _Spec(action, after, count, prob, seed)


def fp_clear(name: Optional[str] = None) -> None:
    with _LOCK:
        if name is None:
            _ARMED.clear()
            _HITS.clear()
        else:
            _ARMED.pop(name, None)
            _HITS.pop(name, None)


def fp_hits(name: str) -> int:
    with _LOCK:
        return _HITS.get(name, 0)


def _run_action(action, name: str):
    if callable(action):
        return action(name)
    if action == "crash":
        # no cleanup, no atexit, no flushing — the power-pull analogue
        os._exit(CRASH_EXIT_CODE)
    if action == "raise":
        raise FailpointError(name)
    if isinstance(action, str) and action.startswith("errno:"):
        code = getattr(_errno, action[6:])
        raise OSError(code, f"injected {action[6:]} at failpoint {name}")
    if isinstance(action, str) and (action.startswith("delay:")
                                    or action.startswith("stall:")):
        # injected latency, in milliseconds — the site then proceeds
        # normally (the work completes, just late: a gray failure)
        time.sleep(float(action.partition(":")[2]) / 1e3)
        return
    raise ValueError(f"unknown failpoint action {action!r} at {name}")


def failpoint(name: str) -> None:
    """The injection site. Near-free when nothing is armed (one dict probe
    on an empty dict); evaluates the armed spec otherwise."""
    if not _ARMED and not _TRACING:
        if __debug__ and name not in CATALOG:
            raise KeyError(f"uncataloged failpoint site {name!r}")
        return
    with _LOCK:
        if __debug__ and name not in CATALOG:
            raise KeyError(f"uncataloged failpoint site {name!r}")
        if _TRACING or name in _ARMED:
            _HITS[name] = _HITS.get(name, 0) + 1
        spec = _ARMED.get(name)
        if spec is None:
            return
        hit = _HITS[name]
        if hit <= spec.after:
            return
        if spec.count is not None and spec.fired >= spec.count:
            return
        if spec.rng is not None and spec.rng.random() >= spec.prob:
            return
        spec.fired += 1
        action = spec.action
    # run the action OUTSIDE the lock: a crash holds nothing, and a raised
    # fault must not leave the registry lock held for other threads
    _run_action(action, name)


# ---------------------------------------------------------------------------
# Environment arming (the torture harness's cross-process channel)
# ---------------------------------------------------------------------------
def _parse_env(value: str) -> None:
    """`site=action[@after][xcount]` separated by `;`. `x0` = unlimited."""
    for entry in value.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, rhs = entry.partition("=")
        after, count = 0, 1
        if "x" in rhs.rpartition("@")[2] or ("@" not in rhs and
                                             rhs.rpartition("x")[2].isdigit()):
            rhs, _, c = rhs.rpartition("x")
            count = None if c == "0" else int(c)
        if "@" in rhs:
            rhs, _, a = rhs.rpartition("@")
            after = int(a)
        fp_set(name.strip(), rhs.strip(), after=after, count=count)


if os.environ.get(ENV_VAR):
    _parse_env(os.environ[ENV_VAR])
