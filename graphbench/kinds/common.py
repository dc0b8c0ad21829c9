"""What every kind of traffic shares: the run's context, the graph made
from the seed, the bulk store, the benchmark's spans around set-up steps,
and the readings handed to the per-layer metrics."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..gen.powerlaw import GraphShape, degree_summary, generate, relabelling


def log(msg: str) -> None:
    """Progress and set-up lines: standard error, so that the result stays
    the last line of standard output."""
    print(msg, file=sys.stderr, flush=True)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence([int(seed) % (2 ** 64), stream])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


# streams of the run's seed
GRAPH, TRAFFIC, ORDER = 1, 2, 3


@dataclasses.dataclass
class Context:
    cell: str
    config: dict
    mix: dict
    seed: int
    dev: torch.device
    traced: bool
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> GraphShape:
        return GraphShape.from_config(self.config)

    def timed(self, name: str, fn, *args, sync: bool = False, **kw):
        """Run `fn` and keep its host-clock seconds as the set-up span
        `name`; `sync` ends the span in a device synchronize."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if sync:
            synchronize(self.dev)
        self.spans[name] = time.perf_counter() - t0
        log(f"set-up {name}: {self.spans[name]:.3f} s")
        return out

    @property
    def fixed_work(self) -> Optional[int]:
        """The mix's `fixed_work_seed`, or None. Where it is given, the
        graph's wiring and the requests come from it, the same in every
        run, and the run's seed relabels the vertices and orders the edges
        and the requests: every run does the same work under other ids and
        in another order."""
        fixed = self.mix.get("fixed_work_seed")
        return None if fixed is None else int(fixed)

    def labels(self) -> torch.Tensor:
        """The run's relabelling of the vertices, on the device: a
        permutation that keeps every id's class modulo `id_classes`."""
        shape = self.shape
        return relabelling(shape.vertices, shape.id_classes,
                           sub_seed(self.seed, GRAPH), self.dev)

    def edges(self):
        """The raw edge list made from the seed, on the device."""
        if self.fixed_work is None:
            return generate(self.shape, sub_seed(self.seed, GRAPH),
                            self.dev)
        src, dst = generate(self.shape, self.fixed_work, self.dev)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(sub_seed(self.seed, ORDER))
        order = torch.randperm(src.shape[0], generator=gen, device=self.dev)
        labels = self.labels()
        return labels[src[order]], labels[dst[order]]

    def host_edges(self):
        """The raw edges as host int64 arrays, as a caller of the program
        passes them; the device copies are freed, and the device's peak is
        reset so that it reads the program's own."""
        src, dst = self.timed("generate", self.edges, sync=True)
        shape = self.shape
        summary = degree_summary(src, dst, shape.vertices, shape.id_classes)
        log(f"graph: {summary}")
        src_np, dst_np = src.cpu().numpy(), dst.cpu().numpy()
        del src, dst
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        return src_np, dst_np

    def bulk_store(self, core, src, dst):
        """The configuration's store, bulk-loaded from the host arrays."""
        store = self.config["store"]
        if store["build"] != "GraphPAL.from_edges":
            raise ValueError(f"no store build {store['build']!r}")
        return self.timed("store_build", core.GraphPAL.from_edges, src, dst,
                          n_partitions=int(store["n_partitions"]),
                          max_id=self.shape.vertices - 1)


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader may read."""

    cell: str
    kind: str
    setup_spans: Dict[str, float]
    window_s: float
    units: int                     # requests or jobs completed
    iterations: int = 0            # sweeps completed (PageRank)
    program_spans: List[dict] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace: Any = None              # devtrace.DeviceTrace in traced runs
    bounds_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # each request's latency, send to answer, host clock (fof)
    latencies_ms: List[float] = dataclasses.field(default_factory=list)

    def per_unit(self, value: Optional[float]) -> Optional[float]:
        return None if value is None or not self.units \
            else value / self.units
