"""The control of a cell's check: the plain reference put in the program's
place, one step below the exactness or precision that the configuration
states, read against the reference on the seeds given.

    python3 graphbench/control.py --workload lj.fof --seeds 11 12 13

  * fof: the reference counting every copy of a repeated edge (paths, not
    distinct middles), on the requests a run would check first; the
    reading is the number of seeds whose answers differ (the check's
    `seeds_wrong`, limit 0).
  * pagerank: the reference with ranks in bfloat16 (float32 sums); the
    reading is the largest relative error of a rank (`rank_rel_err`).

A control that the check does not fail is no control: the limit has to lie
below every reading printed here. Prints one JSON line a seed. Imports
nothing of the program under test.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fof_control(ctx) -> dict:
    import numpy as np
    import torch

    from graphbench.kinds.common import TRAFFIC, sub_seed
    from graphbench.kinds.fof import draw_requests
    from graphbench.reference import fof as ref
    mix = ctx.mix
    src, dst = ctx.edges()
    n = ctx.shape.vertices
    exact = ref.EdgeIndex.build(src, dst, n)
    paths = ref.EdgeIndex.build(src, dst, n, distinct=False)
    rng = np.random.default_rng(sub_seed(ctx.seed, TRAFFIC))
    pool = draw_requests(n, int(mix["checked_requests"]),
                         int(mix["seeds_per_request"]), rng)
    wrong = pairs = 0
    for seeds in pool:
        s = torch.from_numpy(seeds).to(ctx.dev)
        want = ref.two_hop(exact, s)
        wrong += ref.seeds_differing(ref.two_hop(paths, s), want)
        pairs += int(want.ids.shape[0])
    return {"seeds_wrong": wrong, "seeds": int(pool.size),
            "answer_pairs": pairs}


def pagerank_control(ctx) -> dict:
    import torch

    from graphbench.reference import pagerank as ref
    mix = ctx.mix
    src, dst = ctx.edges()
    n = ctx.shape.vertices
    args = (src, dst, n, int(mix["iterations"]), float(mix["damping"]))
    want = ref.pagerank(*args)
    low = ref.pagerank(*args, dtype=torch.bfloat16)
    return {"rank_rel_err": ref.max_relative_error(low, want)}


CONTROLS = {"fof": fof_control, "pagerank": pagerank_control}


def main(argv=None, *, device=None, registry=None, bench=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from graphbench.kinds.common import Context
    from graphbench.registry import Registry, cell_of, load_benchmark
    bench = bench or load_benchmark()
    reg = registry or Registry()
    cell = cell_of(bench, args.workload)
    if device is None and not torch.cuda.is_available():
        raise SystemExit("graphbench control: no CUDA device")
    dev = torch.device(device or "cuda")
    mix = reg.mix(cell["traffic"])
    out = []
    for seed in args.seeds:
        ctx = Context(cell["name"], reg.config(cell["config"]), mix, seed,
                      dev, False)
        reading = {"workload": cell["name"], "seed": seed,
                   **CONTROLS[mix["kind"]](ctx)}
        print(json.dumps(reading), flush=True)
        out.append(reading)
    return out


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT)]
    main()
