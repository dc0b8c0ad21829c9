"""Whole runs of tiny cells on the CPU, the harness's look for a chip
skipped: the last line's keys and types, a throwaway configuration, mix
and metric found by name in a temporary directory, and the check failing
when the timed path is broken underneath."""
import json

import numpy as np
import pytest

from graphbench import run
from graphbench.conftest import last_json
from graphbench.registry import Registry

RUN = ["--seed", str(2 ** 31 + 3), "--seconds", "0.3"]


def drive(bench, reg, cell, trace, capsys, device="cpu"):
    rc = run.main(["--workload", cell, *RUN, "--trace", str(trace)],
                  device=device, registry=reg, bench=bench,
                  loaded=lambda: [])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return last_json(out.out), out.err


@pytest.mark.parametrize("cell", ["t.fof", "t.pagerank"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny, cell, trace, capsys):
    bench, reg = tiny
    res, err = drive(bench, reg, cell, trace, capsys)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], (int, float))
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[section]}
    assert set(res["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "setup.store_build_s" in res["metrics"]
    else:
        assert "setup_s" in res["metrics"]
    last = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(last, res["checks"].items()):
        assert c["value"] <= c["limit"]
        assert line.startswith(f"check {name}: ")


def test_throwaway_config_mix_and_metric(tiny, tmp_path, capsys):
    """A new configuration, mix of a known kind and per-layer metric need
    new files only: here all three live in a temporary directory."""
    bench, _ = tiny
    extra = tmp_path / "more"
    for sub in ("configs", "traffic", "metrics"):
        (extra / sub).mkdir(parents=True)
    cfg = json.loads((tmp_path / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny2", vertices=2000, edges=20000)
    (extra / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    mix = Registry().mix("fof128")
    mix.update(seeds_per_request=32, checked_requests=4)
    (extra / "traffic" / "fof32.json").write_text(json.dumps(mix))
    (extra / "metrics" / "x.requests.py").write_text(
        'LAYER = "multi-hop operators"\nUNIT = "requests"\n'
        'MOVES = "fof_seeds_per_s"\n\n\ndef read(r):\n    return r.units\n')
    bench["workloads"].append({"name": "x.fof", "config": "tiny2",
                               "traffic": "fof32", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "x.requests", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "multi-hop operators",
                               "moves": "fof_seeds_per_s",
                               "workloads": ["x.fof"]})
    for m in bench["end_to_end"]:
        if "fof_p95_ms" == m["name"]:
            m["workloads"].append("x.fof")
    reg = Registry([tmp_path, extra])
    res, _ = drive(bench, reg, "x.fof", 1, capsys)
    assert res["correct"] is True
    assert res["metrics"]["x.requests"]["value"] == res["attempted"]
    res, _ = drive(bench, reg, "x.fof", 0, capsys)
    assert "fof_p95_ms" in res["metrics"]


def test_registry_finds_by_name():
    reg = Registry()
    assert reg.config("twitter-2010")["vertices"] == 2_000_000
    assert reg.mix("fof128")["kind"] == "fof"
    assert reg.metric("psw_sweep_roofline").UNIT == "%"
    assert callable(reg.kind("pagerank").window)
    with pytest.raises(KeyError):
        reg.config("no-such-config")


# faults planted in the timed path: each has to turn `correct` false
def _alter_one_count(core, monkeypatch):
    inner = core.two_hop_counts

    def faulty(*a, **kw):
        res = inner(*a, **kw)
        if res.counts.shape[0]:
            res.counts[res.counts.shape[0] // 2] += 1
        return res
    monkeypatch.setattr(core, "two_hop_counts", faulty)


def _drop_half_the_batch(core, monkeypatch):
    inner = core.two_hop_counts

    def faulty(g, seeds, *a, **kw):
        seeds = np.asarray(seeds)
        half = inner(g, seeds[: seeds.shape[0] // 2], *a, **kw)
        off = np.concatenate([half.offsets, np.full(
            seeds.shape[0] - half.offsets.shape[0] + 1, half.offsets[-1])])
        return type(half)(seeds, off, half.ids, half.counts)
    monkeypatch.setattr(core, "two_hop_counts", faulty)


def _state_unchanged(core, monkeypatch):
    inner = core.pagerank_device

    def faulty(dg, n_iters=5, *a, **kw):
        return inner(dg, 0, *a, **kw)
    monkeypatch.setattr(core, "pagerank_device", faulty)


def _alter_one_rank(core, monkeypatch):
    inner = core.pagerank_device

    def faulty(*a, **kw):
        r = inner(*a, **kw).clone()
        r.view(-1)[7] *= 1.001
        return r
    monkeypatch.setattr(core, "pagerank_device", faulty)


@pytest.mark.parametrize("cell,fault", [
    ("t.fof", _alter_one_count), ("t.fof", _drop_half_the_batch),
    ("t.pagerank", _state_unchanged), ("t.pagerank", _alter_one_rank)])
def test_fault_in_timed_path_is_not_correct(tiny, cell, fault, monkeypatch,
                                            capsys):
    import repro_torch.core as core
    fault(core, monkeypatch)
    bench, reg = tiny
    res, _ = drive(bench, reg, cell, 0, capsys)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_launches_the_trace_does_not_see_are_not_correct(tiny, monkeypatch,
                                                          capsys):
    """A traced fof run that counts kernel launches while its trace holds
    no device operation under `layer.frontier_expand` is not correct. On
    the CPU no operation runs on a device, so a counted launch stands for
    one that the annotation no longer reaches."""
    import repro_torch.kernels.frontier_expand as fe
    from repro_torch.kernels.frontier_expand import ops
    inner = fe.frontier_expand_counts

    def counted(*a, **kw):
        ops.launches += 1
        return inner(*a, **kw)
    monkeypatch.setattr(fe, "frontier_expand_counts", counted)
    bench, reg = tiny
    res, _ = drive(bench, reg, "t.fof", 1, capsys)
    assert res["correct"] is False
    assert res["checks"]["launches_unseen"]["value"] > 0
    res, _ = drive(bench, reg, "t.fof", 0, capsys)
    assert "launches_unseen" not in res["checks"]


@pytest.mark.parametrize("inside,launches,want", [
    (True, 2, 0), (False, 2, 2), (None, 2, 2), (None, 0, 0)])
def test_launches_unseen_reads_the_annotation(inside, launches, want):
    from graphbench.devtrace import DeviceOp, DeviceTrace, Span
    from graphbench.kinds.common import Readings
    from graphbench.kinds.fof import launches_unseen
    trace = None
    if inside is not None:
        spans = ("graphbench.request",) + (
            ("layer.frontier_expand",) if inside else ())
        trace = DeviceTrace([DeviceOp("k", 10.0, 5.0, spans)], [], [],
                            Span("graphbench.window", 0.0, 100.0))
    r = Readings("c", "fof", {}, 1.0, 1, trace=trace,
                 counters={"frontier_expand.launches": launches})
    assert launches_unseen(r) == want


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["t.fof", "t.pagerank"])
def test_tiny_cells_on_the_card(tiny, cell, cuda_device, capsys):
    """The kernel path and the trace's attribution on the card: the
    per-layer metrics that need a device trace are read."""
    bench, reg = tiny
    res, _ = drive(bench, reg, cell, 1, capsys, device=cuda_device)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    want = ("frontier_expand_roofline" if cell == "t.fof"
            else "psw_sweep_roofline")
    assert 0 < res["metrics"][want]["value"] <= 100
