"""Quickstart on the PyTorch port: build, insert, query, compute.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The store and its queries run on the host; `snapshot()` compiles the live
store into a DeviceGraph on --device (default: the GPU) for PSW PageRank.
"""
import argparse

import numpy as np

from repro_torch.core import (IntervalMap, LSMTree, friends_of_friends,
                              pagerank_device, pagerank_host, shortest_path)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# 1. an online graph database over PAL + LSM
iv = IntervalMap.for_capacity(max_id=99_999, n_partitions=16)
db = LSMTree(iv, n_levels=3, branching=4, buffer_cap=50_000,
             column_dtypes={"weight": np.float32})

# 2. stream edges in ONLINE (no batch mode — paper §5)
rng = np.random.default_rng(0)
src = rng.integers(0, 100_000, 500_000)
dst = rng.integers(0, 100_000, 500_000)
db.insert_edges(src, dst, columns={"weight": rng.random(500_000,
                                                        dtype=np.float32)})
print(f"inserted {db.n_edges:,} edges "
      f"(buffer flushes: {db.stats.buffer_flushes}, "
      f"push-down merges: {db.stats.pushdown_merges})")

# 3. point queries: both directions, each edge stored once (paper §4)
v = int(src[0])
print(f"out-neighbors of {v}: {len(db.out_neighbors(v))}")
print(f"in-neighbors  of {v}: {len(db.in_neighbors(v))}")

# 4. graph queries — and the batched set-at-a-time engine
fof = friends_of_friends(db, v)
print(f"friends-of-friends of {v}: {fof.size}")
d = shortest_path(db, int(src[1]), int(dst[2]), max_depth=5)
print(f"shortest path: {d}")
frontier = np.unique(src[:64])
vals, offsets = db.storage_engine().out_neighbors_batch(frontier)
print(f"one batched hop from {frontier.size} vertices: {vals.size} edges")

# 5. updates and deletes (tombstones, purged at merges — paper §5.3)
db.update_edge_column(int(src[0]), int(dst[0]), "weight", 9.9)
db.delete_edge(int(src[1]), int(dst[1]))

# 6. analytical computation IN PLACE (PSW, paper §6)
ranks = pagerank_host(db, n_iters=5)
top = np.argsort(ranks)[-3:]
print(f"top-3 pagerank (internal ids): {top}, scores {ranks[top].round(3)}")

# 7. device analytics on the LIVE store: snapshot() compiles all levels and
#    the in-memory buffers into a DeviceGraph (no flush, read-only)
db.insert_edges(rng.integers(0, 100_000, 2_000),      # fresh arrivals: these
                rng.integers(0, 100_000, 2_000),      # stay buffered
                columns={"weight": rng.random(2_000, dtype=np.float32)})
dg = db.snapshot(device=args.device)
r = pagerank_device(dg, n_iters=3, mode="dense_gather")
print(f"device pagerank on {r.device} over {dg.n_edges:,} live edges "
      f"(incl. {db.total_buffered():,} buffered): shape {tuple(r.shape)}")
print("done.")
