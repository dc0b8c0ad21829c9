"""Profile the dense frontier plan's build (`core.dense_plan`) on a
power-law store of chip_smoke.py phase 1's shape, with cProfile.

  PYTHONPATH=src python scripts/profile_dense_plan.py \
      [--vertices 4000000] [--edges 56000000] [--device cuda]

Prints the generation and `GraphPAL.from_edges` seconds, the plan's build
seconds (the edge keys' sort on the host, then the plan's dedup, sort and
CSR on --device) and the profile's top entries by cumulative and by own
time. The defaults are phase 1's
full size (~10 GB of host memory); `--vertices 1000000 --edges 14000000
--device cpu` is a quarter of it."""
import argparse
import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=4_000_000)
    ap.add_argument("--edges", type=int, default=56_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    import repro_torch.core as core

    t = time.perf_counter()
    src, dst = chip_smoke.power_law_graph(args.vertices, args.edges,
                                          seed=args.seed)
    print(f"generate {time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter()
    g = core.GraphPAL.from_edges(src, dst, n_partitions=16,
                                 max_id=args.vertices - 1)
    print(f"GraphPAL.from_edges {time.perf_counter() - t:.3f} s", flush=True)
    del src, dst
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    core.dense_plan(g, "out", device=args.device)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    print(f"dense_plan {time.perf_counter() - t:.3f} s", flush=True)
    for key in ("cumulative", "tottime"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(15)
        print(out.getvalue())


if __name__ == "__main__":
    main()
