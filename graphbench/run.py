"""One run of one cell of the benchmark, on the machine it is started on.

    python3 graphbench/run.py --workload lj.fof --seed 7 --seconds 20 --trace 0

Reads BENCHMARK.json at the checkout's root, finds the cell's configuration,
traffic mix and metrics by name (registry.py), makes the graph from the
seed, builds what the cell needs, warms it up, measures for `--seconds`,
checks the window's answers against the plain reference, and prints one
JSON object as the last line of standard output. With `--trace 0` its
metrics are the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from a `torch.profiler` trace of the window. Set-up lines,
counts and the numbers compared go to standard error; the numbers compared,
each with its limit, are its last lines.

Exits with 2, printing no result, when no CUDA device is present or fewer
than the cell asks for, and with 3 when JAX or the JAX package is loaded.
The program builds its kernels under build/kernels/ in the checkout; the
trace of a traced run goes under build/graphbench/.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# a traced run profiles this many seconds of its window at most, which keeps
# the trace to some tens of MB; its metrics are per request or job, or
# shares of the traced window
TRACE_SECONDS = 5.0


def _environment() -> None:
    """The package and the program importable without PYTHONPATH."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"graphbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, *, device=None, registry=None, bench=None,
         loaded=None) -> int:
    """Run one cell. `device` None looks for the CUDA devices the cell
    asks for; a test passes a device to skip that look. `loaded` returns
    the module names to check for JAX (default: sys.modules)."""
    args = parse(argv)
    import torch

    from graphbench import devtrace, isolation
    from graphbench.kinds.common import Context, Readings, log
    from graphbench.registry import (Registry, cell_of, load_benchmark,
                                     metrics_of)

    loaded = loaded or (lambda: list(sys.modules))
    bench = bench or load_benchmark()
    reg = registry or Registry()
    cell = cell_of(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA device", 2)
        if torch.cuda.device_count() < int(cell["chips"]):
            return _fail(f"{cell['name']} needs {cell['chips']} CUDA "
                         f"devices, {torch.cuda.device_count()} present", 2)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    on_gpu = dev.type == "cuda"
    traced = bool(args.trace)

    mix = reg.mix(cell["traffic"])
    kind = reg.kind(mix["kind"])
    ctx = Context(cell["name"], reg.config(cell["config"]), mix, args.seed,
                  dev, traced)
    log(f"cell {cell['name']}: config {cell['config']}, traffic "
        f"{cell['traffic']}, seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}, device "
        f"{torch.cuda.get_device_name(dev) if on_gpu else dev}")
    log(f"set-up imports and device: {time.perf_counter() - T0:.3f} s")
    st = kind.setup(ctx)
    log(f"set-up in all: {time.perf_counter() - T0:.3f} s")
    bad = isolation.forbidden_loaded(loaded())
    if bad:
        return _fail(f"loaded after set-up: {', '.join(bad)}", 3)

    seconds = min(args.seconds, TRACE_SECONDS) if traced else args.seconds
    trace_path = BUILD / "graphbench" / f"trace.{cell['name']}.json"
    with devtrace.profiled(traced, trace_path) as prof:
        out = kind.window(st, seconds, traced)
    values = dict(out["values"])
    values["setup_s"] = out["t_start"] - T0
    peak = torch.cuda.max_memory_allocated(dev) if on_gpu else None
    if peak is not None:
        values["device_peak_gib"] = peak / 2 ** 30
    kind.release(st)

    readings = Readings(cell["name"], mix["kind"], dict(ctx.spans),
                        trace=prof.trace, **out["readings"])
    checks = kind.check(st, readings)
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    if not traced:
        for m in metrics_of(bench, "end_to_end", cell["name"]):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in metrics_of(bench, "per_layer", cell["name"]):
            v = reg.metric(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_gpu else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if on_gpu
                         else dev.type,
                         "count": 1, "memory_peak_bytes": peak or 0}}
    if traced and prof.trace is not None:
        result["device"]["busy_s"] = prof.trace.busy_s()
        result["device"]["window_s"] = prof.trace.window_s
        result["breakdown"] = {"device_ops": prof.trace.top_ops(10),
                               "idle_gaps": prof.trace.idle_gaps(10)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}

    bad = isolation.forbidden_loaded(loaded())
    if bad:
        return _fail(f"loaded by the end of the run: {', '.join(bad)}", 3)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _environment()
    sys.exit(main())
