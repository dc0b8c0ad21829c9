"""Streaming ingestion + incremental analytics on the PyTorch port (paper
§6.1.2, Fig 7a's 'insert + Pagerank' run): edges arrive continuously;
PageRank sweeps run between batches so the authority scores track the
growing graph on the host (PSW, Algorithm 2), and a PageRank from scratch
runs on --device over a snapshot of the live store.

  PYTHONPATH=src python examples/torch/incremental_pagerank.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import (IntervalMap, LSMTree, pagerank_device,
                              pagerank_host)
from repro_torch.data import GraphStream

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--rounds", type=int, default=10)
args = ap.parse_args()

N = 50_000
iv = IntervalMap.for_capacity(N - 1, 16)
db = LSMTree(iv, n_levels=3, branching=4, buffer_cap=25_000,
             max_partition_edges=100_000)
stream = GraphStream(N, alpha=1.8, seed=0)

t0 = time.time()
total = 0
for round_ in range(args.rounds):
    src, dst = stream.next_edges(50_000)
    db.insert_edges(src, dst)
    total += 50_000
    # one incremental PSW sweep on the host: the ranks persist between
    # calls, so a single sweep refreshes them instead of starting over
    ranks = pagerank_host(db, n_iters=1)
    top = np.argsort(ranks)[-3:][::-1]
    # a from-scratch PageRank on the device over a snapshot of the live
    # store (5 sweeps, window exchange)
    dev = pagerank_device(db.snapshot(device=args.device), n_iters=5,
                          mode="psw_windows").reshape(-1)
    dev_top = np.argsort(dev.cpu().numpy())[-3:][::-1]
    rate = total / (time.time() - t0)
    print(f"round {round_}: {total:,} edges @ {rate:,.0f} edges/s | "
          f"top vertices {top.tolist()} ranks {ranks[top].round(2)} | "
          f"device top {dev_top.tolist()}")

print(f"\nLSM stats: {db.stats}")
