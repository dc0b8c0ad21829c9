"""The device trace of a window: `torch.profiler` over the window, read from
its Chrome trace export.

Host spans are `torch.profiler.record_function` annotations that the
benchmark puts around its own calls (`graphbench.window`,
`graphbench.request`, `graphbench.job`) and around calls into the program's
layers (`layer.<name>`, see `kinds/`). A device operation belongs to every
annotation that was open on the host when it was launched: the launch's
runtime call and the operation share a correlation id.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import types
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation")
_NAME_CHARS = 200   # a C++ kernel's name, cut for the breakdown


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float          # us, the trace's clock
    dur: float            # us
    spans: Tuple[str, ...]  # annotations open at its launch


@dataclasses.dataclass
class Span:
    name: str
    start: float
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class DeviceTrace:
    ops: List[DeviceOp]
    spans: List[Span]          # the benchmark's annotations
    host_ops: List[Span]       # every host op and annotation, for naming gaps
    window: Optional[Span]

    @property
    def window_s(self) -> float:
        return self.window.dur / 1e6 if self.window else 0.0

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations inside the window, merged."""
        if self.window is None:
            return []
        lo, hi = self.window.start, self.window.end
        iv = sorted((max(o.start, lo), min(o.start + o.dur, hi))
                    for o in self.ops)
        merged: List[List[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def busy_within(self, spans: List[Span]) -> float:
        """Seconds of device activity inside each of `spans`, summed."""
        merged = self.busy_intervals()
        starts = [a for a, _ in merged]
        total = 0.0
        for s in spans:
            i = max(bisect.bisect_right(starts, s.start) - 1, 0)
            while i < len(merged) and merged[i][0] < s.end:
                a, b = merged[i]
                total += max(0.0, min(b, s.end) - max(a, s.start))
                i += 1
        return total / 1e6

    def op_seconds(self, inside: Optional[str] = None,
                   outside: Optional[str] = None) -> float:
        """Summed device time of the window's operations launched inside the
        annotation `inside` (any when None) and not inside `outside`."""
        lo, hi = (self.window.start, self.window.end) if self.window \
            else (float("-inf"), float("inf"))
        return sum(o.dur for o in self.ops
                   if lo <= o.start < hi
                   and (inside is None or inside in o.spans)
                   and (outside is None or outside not in o.spans)) / 1e6

    def has_span(self, name: str) -> bool:
        return any(name in o.spans for o in self.ops)

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for o in self.ops:
            if self.window and not (self.window.start <= o.start
                                    < self.window.end):
                continue
            by[o.name] = by.get(o.name, 0.0) + o.dur / 1e6
        return [[n[:_NAME_CHARS], s]
                for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle device time inside the window, summed by what the host was
        in at each gap's middle: the innermost host op, under the innermost
        benchmark annotation."""
        if self.window is None:
            return []
        edges = [self.window.start]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.window.end)
        host = sorted((s for s in self.host_ops
                       if not s.name.startswith(("graphbench.", "layer."))),
                      key=lambda s: s.start)
        starts = [s.start for s in host]
        index = _SpanIndex(self.spans)
        by: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)
            inner = "host python"
            # the innermost host op holding `mid`: the latest-starting one
            for s in reversed(host[max(0, i - 256):i]):
                if s.end > mid:
                    inner = s.name
                    break
            outer = index.innermost(mid) or "graphbench.window"
            name = f"{outer} > {inner}"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


class _SpanIndex:
    """Annotations by name, each name's spans disjoint and sorted, so the
    ones open at a time are found by bisection."""

    def __init__(self, spans: List[Span]):
        self.by_name: Dict[str, Tuple[list, list]] = {}
        for s in sorted(spans, key=lambda s: s.start):
            starts, ends = self.by_name.setdefault(s.name, ([], []))
            starts.append(s.start)
            ends.append(s.end)

    def _open(self, t: float):
        for name, (starts, ends) in self.by_name.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                yield name, starts[i]

    def open_at(self, t: float) -> Tuple[str, ...]:
        return tuple(name for name, _ in self._open(t))

    def innermost(self, t: float) -> Optional[str]:
        best = max(self._open(t), key=lambda x: x[1], default=None)
        return best[0] if best else None


def read_chrome_trace(path: Path) -> DeviceTrace:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    spans, host_ops, launches, raw_ops = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = e.get("name", "")
        if cat in _DEVICE_CATS:
            raw_ops.append((name, ts, dur,
                            (e.get("args") or {}).get("correlation")))
        elif cat in _LAUNCH_CATS:
            launches.append(((e.get("args") or {}).get("correlation"), ts))
        elif cat in _HOST_CATS:
            host_ops.append(Span(name, ts, dur))
            if cat == "user_annotation" and name.startswith(
                    ("graphbench.", "layer.")):
                spans.append(Span(name, ts, dur))
    spans.sort(key=lambda s: s.start)
    launch_ts = {c: ts for c, ts in launches if c is not None}

    index = _SpanIndex(spans)
    ops = []
    for name, ts, dur, corr in raw_ops:
        t = launch_ts.get(corr)
        ops.append(DeviceOp(name, ts, dur, index.open_at(t) if t is not None
                            else ()))
    windows = [s for s in spans if s.name == "graphbench.window"]
    return DeviceTrace(ops, [s for s in spans
                             if s.name != "graphbench.window"],
                       host_ops, windows[0] if windows else None)


@contextlib.contextmanager
def profiled(enabled: bool, out_path: Path):
    """Profile the body (CPU and CUDA activities) when `enabled`, export the
    Chrome trace to `out_path`, and yield a holder whose `.trace` is the
    parsed `DeviceTrace` after the body (None when not enabled)."""
    holder = types.SimpleNamespace(trace=None)
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    del prof
    holder.trace = read_chrome_trace(out_path)
