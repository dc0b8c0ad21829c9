"""The readers of the per-layer metrics that read the program's own spans
(`multihop.readback_ms`, `multihop.id_map_ms`, `multihop.assemble_ms`,
`psw.window_gather_ms`, `psw.segment_sum_ms`): each against hand-built
traces, a traced tiny fof run on the CPU, and on the card the program's
`x.frontier_expand.counts` span against the benchmark's own wrapper."""
import pytest

from graphbench import run
from graphbench.conftest import last_json
from graphbench.devtrace import DeviceOp, DeviceTrace, Span, \
    read_chrome_trace
from graphbench.kinds.common import Readings
from graphbench.registry import Registry

RUN = ["--seed", str(2 ** 31 + 11), "--seconds", "0.3", "--trace", "1"]
HOST = ["multihop.readback_ms", "multihop.id_map_ms",
        "multihop.assemble_ms"]
DEVICE = ["psw.window_gather_ms", "psw.segment_sum_ms"]
WINDOW = Span("graphbench.window", 0.0, 1000.0)


def host_trace(span: str, requests: int = 2) -> DeviceTrace:
    """`requests` requests of 400 us in the window, each holding two of
    `span` (30 and 50 us) and one span of another name; one more request
    after the window."""
    spans = []
    for k in range(requests):
        t0 = 10.0 + 450.0 * k
        spans += [Span("graphbench.request", t0, 400.0),
                  Span("layer.multihop.two_hop", t0 + 1, 398.0),
                  Span(span, t0 + 10, 30.0), Span(span, t0 + 100, 50.0),
                  Span("layer.multihop.other", t0 + 200, 90.0)]
    spans += [Span("layer.multihop.two_hop", 2000.0, 500.0),
              Span(span, 2010.0, 400.0)]
    return DeviceTrace([], spans, list(spans), WINDOW)


def device_trace(span: str, jobs: int = 2) -> DeviceTrace:
    """`jobs` jobs in the window, with device operations of 100 and 200
    us launched inside `span`, one of 300 us outside it, and one inside it
    after the window."""
    spans = [Span("layer.x.psw.pagerank", 10.0 + 450.0 * k, 400.0)
             for k in range(jobs)]
    inside = ("graphbench.job", "layer.x.psw.pagerank", span)
    ops = [DeviceOp("a", 20.0, 100.0, inside),
           DeviceOp("b", 500.0, 200.0, inside),
           DeviceOp("c", 600.0, 300.0, inside[:2]),
           DeviceOp("d", 5000.0, 700.0, inside)]
    return DeviceTrace(ops, spans, list(spans), WINDOW)


def readings(trace, units: int) -> Readings:
    return Readings("c", "k", {}, 1.0, units, trace=trace)


@pytest.mark.parametrize("case", ["per_unit", "no_trace", "count",
                                  "no_span"])
@pytest.mark.parametrize("name", HOST + DEVICE)
def test_reader(name, case):
    read = Registry().metric(name).read
    span = "layer.x." + name[:-3]
    make = host_trace if name in HOST else device_trace
    # (30 + 50) us of host time in each request; (100 + 200) us of device
    # time over the two jobs
    want = 0.08 if name in HOST else 0.15
    if case == "per_unit":
        assert read(readings(make(span), 2)) == pytest.approx(want)
    elif case == "no_trace":
        assert read(readings(None, 2)) is None
    elif case == "count":
        assert read(readings(make(span), 3)) is None
        assert read(readings(make(span), 1)) is None
    else:
        assert read(readings(make("layer.multihop.elsewhere"), 2)) is None


def drive(tiny, cell, capsys, device="cpu"):
    bench, reg = tiny
    rc = run.main(["--workload", cell, *RUN], device=device, registry=reg,
                  bench=bench, loaded=lambda: [])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = last_json(out.out)
    assert res["correct"] is True
    return res


def test_traced_fof_on_the_cpu_reads_the_host_phases(tiny, capsys):
    metrics = drive(tiny, "t.fof", capsys)["metrics"]
    for name in HOST:
        assert metrics[name]["value"] > 0
    # nothing runs on a device here, so nothing is read from one
    assert "multihop.panel_ms" not in metrics


@pytest.fixture
def on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return "cuda"


@pytest.mark.cuda
def test_pagerank_phases_on_the_card(tiny, capsys, on_card):
    metrics = drive(tiny, "t.pagerank", capsys, on_card)["metrics"]
    for name in DEVICE:
        assert metrics[name]["value"] > 0


@pytest.mark.cuda
def test_program_span_sees_what_the_wrapper_sees(tiny, capsys, on_card):
    """The device operations launched inside the program's
    `x.frontier_expand.counts` span are those launched inside the
    benchmark's `layer.frontier_expand` wrapper, one for one."""
    drive(tiny, "t.fof", capsys, on_card)
    t = read_chrome_trace(run.BUILD / "graphbench" / "trace.t.fof.json")
    wrap = [(o.name, o.start) for o in t.ops
            if "layer.frontier_expand" in o.spans]
    mine = [(o.name, o.start) for o in t.ops
            if "layer.x.frontier_expand.counts" in o.spans]
    assert wrap and mine == wrap
    assert t.op_seconds(inside="layer.x.frontier_expand.counts") == \
        t.op_seconds(inside="layer.frontier_expand")
