"""PageRank jobs back to back: each job one `pagerank_device` call over the
store's `DeviceGraph`, ending in a device synchronize.

The mix file gives `iterations`, `damping`, `mode` and `warmup_jobs`, and
under `limits` the largest relative error of a rank that a correct run
may show (`rank_rel_err`).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from .. import work
from ..reference import pagerank as ref
from .common import Context, Readings, log, synchronize


@dataclasses.dataclass
class State:
    ctx: Context
    core: object
    g: object
    dg: object
    ranks: list = dataclasses.field(default_factory=list)  # host float64


def setup(ctx: Context) -> State:
    import repro_torch.core as core
    src, dst = ctx.host_edges()
    g = ctx.bulk_store(core, src, dst)
    del src, dst
    dg = ctx.timed("device_graph", core.build_device_graph, g,
                   device=ctx.dev, sync=True)
    st = State(ctx, core, g, dg)
    for _ in range(int(ctx.mix["warmup_jobs"])):
        _job(st)
    return st


def _job(st: State) -> torch.Tensor:
    mix = st.ctx.mix
    r = st.core.pagerank_device(st.dg, int(mix["iterations"]),
                                float(mix["damping"]), mode=mix["mode"])
    synchronize(st.ctx.dev)
    return r


def _original_order(st: State, r: torch.Tensor) -> np.ndarray:
    """The ranks of vertices 0 .. n - 1, through the store's id map."""
    n = st.ctx.shape.vertices
    internal = st.g.intervals.to_internal(np.arange(n, dtype=np.int64))
    return r.reshape(-1).cpu().numpy()[internal].astype(np.float64)


def window(st: State, seconds: float, traced: bool) -> dict:
    rf = torch.profiler.record_function
    jobs = 0
    first = last = None
    with rf("graphbench.window"):
        t_start = time.perf_counter()
        while True:
            with rf("graphbench.job"):
                last = _job(st)
            if first is None:
                first = last
            jobs += 1
            t1 = time.perf_counter()
            if t1 - t_start >= seconds:
                break
    window_s = t1 - t_start
    st.ranks = [_original_order(st, first), _original_order(st, last)]
    iters = jobs * int(st.ctx.mix["iterations"])
    log(f"window: {jobs} jobs ({iters} iterations) in {window_s:.3f} s")
    return {
        "t_start": t_start,
        "values": {"pagerank_job_ms": window_s * 1e3 / jobs},
        "readings": dict(window_s=window_s, units=jobs, iterations=iters),
        "attempted": jobs,
    }


def release(st: State) -> None:
    st.dg = None
    st.g = None
    gc.collect()
    if st.ctx.dev.type == "cuda":
        torch.cuda.empty_cache()


def check(st: State, readings: Readings) -> dict:
    """The window's first and last job against a float64 reference."""
    ctx, mix = st.ctx, st.ctx.mix
    src, dst = ctx.edges()
    n = ctx.shape.vertices
    want = ref.pagerank(src, dst, n, int(mix["iterations"]),
                        float(mix["damping"]))
    err = max(ref.max_relative_error(
        torch.from_numpy(r).to(want.device), want) for r in st.ranks)
    if ctx.traced:
        readings.bounds_s["psw_sweep"] = readings.iterations * \
            work.pagerank_iteration_bound_s(int(src.shape[0]), n)
    return {"rank_rel_err": (err, float(mix["limits"]["rank_rel_err"]))}
