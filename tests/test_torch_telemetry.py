"""The port's telemetry (repro_torch/core/telemetry.py) on its own: its
catalog, the bridge that lays a span on the `torch.profiler` clock as a
`layer.<name>` annotation, the spans inside the dense fof request and the
PSW sweep, and the lint of `src/repro_torch/` against the port's catalog
(`scripts/check_metrics.py` checks all of `src/` against the reference's,
and lets the port's own `x.` names pass).

The registry is process-global: each test clears the buffered events it
reads, and leaves telemetry enabled."""
import json
import os
import re
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
from repro_torch.core import telemetry
from repro_torch.core.telemetry import MetricsRegistry

ROOT = Path(__file__).resolve().parent.parent
N, E = 400, 3000

NEW_SPANS = ("x.multihop.expand", "x.multihop.readback", "x.multihop.id_map",
             "x.multihop.assemble", "x.frontier_expand.counts",
             "x.psw.pagerank", "x.psw.window_gather", "x.psw.segment_sum")


@pytest.fixture
def events():
    """Clears the registry's buffered spans; yields a reader that takes
    them; re-enables telemetry afterwards."""
    telemetry.trace_events(clear=True)
    try:
        yield lambda: telemetry.trace_events(clear=True)
    finally:
        telemetry.set_enabled(True)


def store(seed: int = 0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    hot = ((rng.zipf(1.8, E) - 1) * 2654435761) % N
    dst = np.where(rng.random(E) < 0.5, hot, rng.integers(0, N, E))
    return T.GraphPAL.from_edges(src, dst, n_partitions=8, max_id=N - 1)


def _ancestors(ev, by_id):
    out = []
    while "parent" in ev["args"]:
        ev = by_id[ev["args"]["parent"]]
        out.append(ev["name"])
    return out


# ---------------------------------------------------------------------------
# catalog
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,name", [
    ("counter", "no.such.metric"),
    ("histogram", "multihop.hop.seconds"),   # the reference's, not the port's
    ("span", "multihop.expand"),             # the port's name is x.-only
    ("span", "no.such.span"),
    ("span", "multihop.hops"),               # declared, as a counter
])
def test_catalog_rejects_undeclared_names(kind, name, events):
    with pytest.raises(KeyError):
        if kind == "span":
            with telemetry.span(name):
                pass
        else:
            getattr(MetricsRegistry(), kind)(name)


@pytest.mark.parametrize("name", NEW_SPANS)
def test_port_spans_are_declared(name, events):
    assert telemetry.CATALOG[name][0] == "span"
    with telemetry.span(name):
        pass
    assert [e["name"] for e in events()] == [name]


# ---------------------------------------------------------------------------
# a span's ids, pid and thread id
# ---------------------------------------------------------------------------
def test_span_makes_no_system_call(monkeypatch, events):
    with telemetry.span("x.psw.pagerank"):     # this thread's id, read once
        pass

    def refuse(*a):
        raise AssertionError("a span made a system call")
    for mod, name in ((os, "urandom"), (os, "getpid"),
                      (threading, "get_native_id")):
        monkeypatch.setattr(mod, name, refuse)
    with telemetry.span("x.psw.pagerank"):
        with telemetry.span("x.psw.segment_sum"):
            pass
    assert len(events()) == 3


def test_span_ids_pid_and_tid_in_threads_and_forked_children(events):
    with telemetry.span("x.psw.pagerank"):
        pass
    seen = []

    def worker():
        with telemetry.span("x.psw.pagerank"):
            pass
        seen.append(threading.get_native_id())
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    a, b = events()
    assert (a["pid"], a["tid"]) == (os.getpid(), threading.get_native_id())
    assert (b["pid"], b["tid"]) == (os.getpid(), seen[0])
    assert a["args"]["trace"] != b["args"]["trace"]
    assert all(len(e["args"][k]) == 16 for e in (a, b)
               for k in ("trace", "span"))
    r, w = os.pipe()
    child = os.fork()
    if child == 0:
        try:
            with telemetry.span("x.psw.pagerank"):
                pass
            e = telemetry.trace_events(clear=True)[-1]
            os.write(w, json.dumps([e["pid"], e["tid"],
                                    e["args"]["span"]]).encode())
        finally:
            os._exit(0)
    os.close(w)
    os.waitpid(child, 0)
    with os.fdopen(r) as f:
        pid, tid, span_id = json.loads(f.read())
    # the child's main thread has the child's pid as its id, and its ids
    # come from a generator reseeded at the fork, not the parent's
    assert pid == tid == child
    assert span_id != telemetry._new_id()


# ---------------------------------------------------------------------------
# the bridge onto the profiler's clock
# ---------------------------------------------------------------------------
def test_span_is_a_nested_annotation_on_the_profiler_clock(tmp_path,
                                                           events):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("multihop.two_hop"):
            with telemetry.span("x.multihop.expand"):
                torch.ones(64).cumsum(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in trace if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"}
    outer = ann["layer.multihop.two_hop"]
    inner = ann["layer.x.multihop.expand"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    op = next(e for e in trace if e.get("name") == "aten::cumsum")
    assert inner["ts"] <= op["ts"] <= inner["ts"] + inner["dur"]
    # the registry's own events stay on the epoch clock
    regs = events()
    assert [e["name"] for e in regs] == ["x.multihop.expand",
                                         "multihop.two_hop"]
    assert regs[0]["args"]["parent"] == regs[1]["args"]["span"]


@pytest.mark.parametrize("profiled,enabled,want", [
    (True, True, ["layer.multihop.two_hop", "layer.x.multihop.expand"]),
    (False, True, []),
    (True, False, []),
    (False, False, []),
])
def test_annotation_opens_only_while_the_profiler_records(
        profiled, enabled, want, monkeypatch, events):
    ag = torch._C._autograd
    real = ag._record_function_with_args_enter
    opened = []

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)
    monkeypatch.setattr(ag, "_record_function_with_args_enter", counting)
    telemetry.set_enabled(enabled)
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    if prof is not None:
        prof.__enter__()
    try:
        with telemetry.span("multihop.two_hop"):
            with telemetry.span("x.multihop.expand"):
                pass
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    assert opened == want
    assert len(events()) == (2 if enabled else 0)


@pytest.mark.parametrize("state", ["idle", "recording", "stopped",
                                   "no flag"])
def test_profiler_recording_reads_the_profilers_flag(state, monkeypatch):
    """The one accessor of torch's private profiler flag: False with no
    profile, True while one records, False after it, and False, not an
    error, in a torch that has no such flag."""
    if state == "no flag":
        monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    prof = profile(activities=[ProfilerActivity.CPU])
    if state in ("recording", "stopped"):
        prof.__enter__()
        assert telemetry.profiler_recording() is True
    if state == "stopped":
        prof.__exit__(None, None, None)
    try:
        assert telemetry.profiler_recording() is (state == "recording")
    finally:
        if state == "recording":
            prof.__exit__(None, None, None)


# ---------------------------------------------------------------------------
# spans of the dense fof request and of the PSW sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exclude", [True, False])
def test_fof_request_phases(exclude, events):
    g = store(1)
    seeds = np.random.default_rng(2).choice(N, 300, replace=False)
    blocks = 3                                    # 128 + 128 + 44 seeds
    events()
    got = T.two_hop_counts(g, seeds, dense="kernel", device="cpu",
                           exclude=exclude)
    evs = events()
    names = Counter(e["name"] for e in evs)
    per = 2 if exclude else 1
    assert names == {"multihop.two_hop": 1, "x.multihop.expand": blocks,
                     "x.frontier_expand.counts": 2 * blocks,
                     "x.multihop.readback": per * blocks,
                     "x.multihop.id_map": per * blocks,
                     "x.multihop.assemble": 1}
    assert len({e["args"]["trace"] for e in evs}) == 1
    by_id = {e["args"]["span"]: e for e in evs}
    for e in evs:
        if e["name"] == "multihop.two_hop":
            continue
        up = _ancestors(e, by_id)
        assert up[-1] == "multihop.two_hop"
        if e["name"] == "x.frontier_expand.counts":
            assert up[0] == "x.multihop.expand"
            assert e["args"]["B"] in (128, 44)
    want = T.two_hop_counts(g, seeds, dense="never", exclude=exclude)
    for f in ("seeds", "offsets", "ids", "counts"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["psw_windows", "dense_gather"])
def test_pagerank_sweep_phases(mode, events):
    dg = T.build_device_graph(store(3), device="cpu")
    events()
    got = T.pagerank_device(dg, n_iters=5, mode=mode)
    evs = events()
    assert Counter(e["name"] for e in evs) == {
        "x.psw.pagerank": 1, "x.psw.window_gather": 5,
        "x.psw.segment_sum": 5}
    root = next(e for e in evs if e["name"] == "x.psw.pagerank")
    for e in evs:
        if e is not root:
            assert e["args"]["parent"] == root["args"]["span"]
    telemetry.set_enabled(False)
    want = T.pagerank_device(dg, n_iters=5, mode=mode)
    assert events() == []
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the lint of the port against its own catalog
# ---------------------------------------------------------------------------
# an instrument call site, and any quoted dotted literal (the wiring of a
# catalog name, as in a collector's name map)
API_RE = re.compile(r"\b(counter|gauge|histogram|span)\(\s*[\"']([^\"']+)[\"']")
LITERAL_RE = re.compile(r"[\"']([A-Za-z_0-9]+(?:\.[A-Za-z_0-9]+)+)[\"']")


def port_lint(catalog) -> list:
    """`scripts/check_metrics.py`'s four invariants for the port, against
    `catalog`: every name handed to a telemetry API in `src/repro_torch/`
    is declared there (its `x.` names too: in the port's code they are the
    port's own, not a test's), with the declared kind; every declared name
    is wired by a literal in `src/repro_torch/` outside telemetry.py; and
    the port's tests name no undeclared metric outside the `x.` escape."""
    sites, literals = {}, set()
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        if path.name == "telemetry.py":
            continue
        text = path.read_text(encoding="utf-8")
        for m in API_RE.finditer(text):
            sites.setdefault((m.group(1), m.group(2)), path.name)
        literals.update(LITERAL_RE.findall(text))
    misses = [f"UNCATALOGED {kind}({name!r}) in {where}"
              for (kind, name), where in sorted(sites.items())
              if name not in catalog]
    misses += [f"KIND MISMATCH {kind}({name!r}) in {where}: declared "
               f"{catalog[name][0]}"
               for (kind, name), where in sorted(sites.items())
               if name in catalog and catalog[name][0] != kind]
    misses += [f"ORPHANED {name}" for name in sorted(catalog)
               if name not in literals]
    tests = sorted([*(ROOT / "tests").glob("test_torch_*.py"),
                    *(ROOT / "graphbench").glob("test_*.py")])
    for path in tests:
        for line in path.read_text(encoding="utf-8").splitlines():
            if "# lint: phantom-ok" in line:
                continue
            for m in API_RE.finditer(line):
                name = m.group(2)
                if (name not in catalog
                        and not name.startswith(telemetry.ESCAPE_PREFIX)):
                    misses.append(f"PHANTOM {name} in {path.name}")
    return misses


@pytest.mark.parametrize("change,want", [
    (None, None),
    ("drop x.multihop.expand", "UNCATALOGED"),
    ("add multihop.hop.seconds", "ORPHANED"),
    ("retype x.psw.segment_sum", "KIND MISMATCH"),
    ("drop multihop.two_hop", "PHANTOM"),
])
def test_port_is_linted_against_its_own_catalog(change, want):
    catalog = dict(telemetry.CATALOG)
    if change is not None:
        verb, name = change.split()
        if verb == "drop":
            del catalog[name]
        elif verb == "add":
            catalog[name] = ("histogram", "not wired in the port")
        else:
            catalog[name] = ("counter", catalog[name][1])
    misses = port_lint(catalog)
    if want is None:
        assert misses == []
    else:
        assert any(line.startswith(want) and name in line
                   for line in misses), misses
