"""Request-lifecycle primitives: deadlines, jittered backoff,
and per-shard circuit breakers.

The paper's online-database claim (§5–6) assumes the store stays
responsive when parts of it are slow. These are the building blocks the
router (core/shardrouter.py) and the serving front end (core/frontdesk.py)
compose into that behavior:

  * `Deadline` — a monotonic-clock budget every request carries. It rides
    across the shard RPC boundary as *remaining seconds* in frame meta
    (`to_budget`/`from_budget`): AF_UNIX peers share CLOCK_MONOTONIC, but
    shipping the remainder rather than an absolute instant keeps the wire
    format clock-agnostic. The router derives per-call socket timeouts
    from it; the worker re-checks it before executing an op so work whose
    caller already gave up is shed, not performed.
  * `deadline_scope` / `current_deadline` — a thread-local ambient stack
    (the telemetry-context pattern): the front desk scopes a batch, and
    every shard RPC under it inherits the budget without threading a
    parameter through the engine/operator layers.
  * `backoff_delays` — exponential backoff with equal jitter
    (d/2 + U(0, d/2)), the retry pacing for idempotent reads. Jitter is
    what keeps N clients that failed together from retrying together;
    pass a seeded `random.Random` for reproducible tests.
  * `CircuitBreaker` — the classic closed → open → half-open machine.
    CLOSED counts consecutive failures (transport errors, timeouts,
    latency-over-threshold "slow" outcomes fed from the telemetry
    histograms); at `failure_threshold` it OPENs and calls fail fast
    (`ShardOverloadError` router-side) instead of queueing onto a sick
    worker. After `open_s` one probe is admitted (HALF_OPEN): success
    closes the breaker, failure re-opens it with the clock reset.

`DeadlineExceeded` and `OverloadError` live in core/integrity.py with the
rest of the typed error taxonomy.

Host copy of the reference `repro/core/deadline.py`: the same budgets,
jitter stream and breaker transitions.
"""
from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from .integrity import DeadlineExceeded

__all__ = [
    "CircuitBreaker",
    "Deadline",
    "backoff_delays",
    "current_deadline",
    "deadline_scope",
]


class Deadline:
    """An absolute give-up instant on the monotonic clock.

    Every accessor is cheap (one `time.monotonic()` call); a Deadline is
    immutable and may be shared across threads (a broadcast's sub-requests
    all race the same instant)."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + float(seconds))

    def remaining(self) -> float:
        """Seconds left; negative once expired (callers clamp as needed)."""
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def check(self, what: str = "request") -> None:
        """Raise `DeadlineExceeded` if the budget is gone — the typed
        shed every lifecycle stage calls before starting work it could
        not finish in time."""
        rem = self.remaining()
        if rem <= 0.0:
            raise DeadlineExceeded(what, -rem)

    def timeout(self, cap: Optional[float] = None,
                floor: float = 1e-3) -> float:
        """A socket/wait timeout derived from the remaining budget: never
        below `floor` (a zero timeout means non-blocking, which is not
        what a deadline wants) and never above `cap` when given."""
        t = self.remaining()
        if cap is not None and t > cap:
            t = cap
        return max(float(floor), t)

    # -- wire format (shard RPC frame meta) --------------------------------
    def to_budget(self) -> float:
        """The remaining budget in seconds — what crosses the process
        boundary (clock-agnostic; the peer rebuilds its own instant)."""
        return self.remaining()

    @classmethod
    def from_budget(cls, budget) -> Optional["Deadline"]:
        if budget is None:
            return None
        return cls.after(float(budget))

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.4f}s)"


# ---------------------------------------------------------------------------
# ambient deadline (thread-local, the telemetry-context pattern)
# ---------------------------------------------------------------------------
_ctx = threading.local()


def current_deadline() -> Optional[Deadline]:
    stack = getattr(_ctx, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Make `deadline` the ambient budget for this thread: shard RPCs
    issued anywhere under the scope (engine slabs, multihop operators)
    inherit it without parameter plumbing. `None` is a no-op so call
    sites stay unconditional."""
    if deadline is None:
        yield
        return
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    stack.append(deadline)
    try:
        yield
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# retry pacing
# ---------------------------------------------------------------------------
def backoff_delays(base_s: float, cap_s: float, attempts: int,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Exponential backoff with equal jitter: attempt k sleeps
    `d/2 + U(0, d/2)` where `d = min(cap, base * 2**k)`. Equal jitter
    keeps the expected pacing of plain exponential backoff while
    decorrelating clients that failed at the same instant. Pass a seeded
    `random.Random` for deterministic tests."""
    r = rng.random if rng is not None else random.random
    for k in range(attempts):
        d = min(float(cap_s), float(base_s) * (2.0 ** k))
        yield d * 0.5 + r() * d * 0.5


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------
class CircuitBreaker:
    """Closed → open → half-open breaker over one dependency (one shard).

    CLOSED: `allow()` always True; `failure_threshold` CONSECUTIVE
    failures trip it OPEN (any success resets the streak). OPEN: `allow()`
    False — the caller fails fast with a typed overload error instead of
    adding load to a sick worker — until `open_s` has passed, when exactly
    one caller wins the HALF_OPEN probe slot. The probe's outcome decides:
    success closes the breaker (streak cleared), failure re-opens it with
    the clock reset. Thread-safe; every transition is O(1) under one lock.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, open_s: float = 1.0):
        self.failure_threshold = int(failure_threshold)
        self.open_s = float(open_s)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0          # consecutive, in CLOSED
        self._opened_at = 0.0
        self._probing = False       # the single HALF_OPEN slot
        self.trips = 0              # open transitions (telemetry feed)

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        """Caller holds the lock. OPEN lazily becomes HALF_OPEN once the
        cool-down has passed (no timer thread: state advances when
        observed)."""
        if (self._state == self.OPEN
                and time.monotonic() - self._opened_at >= self.open_s):
            self._state = self.HALF_OPEN
            self._probing = False
        return self._state

    def allow(self) -> bool:
        """May a call proceed? OPEN rejects; HALF_OPEN admits exactly one
        probe (the rest keep failing fast until its outcome is recorded)."""
        with self._lock:
            st = self._effective_state()
            if st == self.CLOSED:
                return True
            if st == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            self._state = self.CLOSED

    def record_failure(self) -> bool:
        """Record a failure (transport error, timeout, or a slow call the
        caller classified as a failure). Returns True when THIS record
        tripped the breaker open — the caller increments the trip metric
        exactly once per open transition."""
        with self._lock:
            st = self._effective_state()
            if st == self.HALF_OPEN:
                # the probe failed: straight back to OPEN, clock reset
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self._probing = False
                self.trips += 1
                return True
            self._failures += 1
            if st == self.CLOSED and self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self.trips += 1
                return True
            return False

    def reset(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False
