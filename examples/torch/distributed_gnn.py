"""Distributed PSW on the PyTorch port: a PAL-sharded graph over ranks of
`torch.distributed`, the PSW sweep across ranks and ring-window message
passing, each against the one-device computation.

  PYTHONPATH=src python examples/torch/distributed_gnn.py [--device cpu]

--device cpu spawns --ranks (default 4) CPU processes on gloo; the default,
cuda, one process a GPU on NCCL (--ranks defaults to the GPU count). Each
rank owns P / ranks vertex intervals (`DeviceGraph.shard`): PageRank's
sweep exchanges window rows with one `all_to_all_single` (psw_windows) or
gathers the vertex state (dense_gather); one message-passing step brings
remote source rows around the ring (`graph/psw_ops.py`) and sums into the
rank's own destinations (the PAL property).
"""
import argparse
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import GraphPAL, build_device_graph, pagerank_device
from repro_torch.graph.psw_ops import (local_scatter_sum, ring_gather,
                                       ring_mesh)

P = 8                                   # vertex intervals


def graph():
    rng = np.random.default_rng(0)
    n, e = 4096, 32768
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    return GraphPAL.from_edges(src, dst, n_partitions=P, max_id=n - 1)


def rank_main(rank, world, port, device):
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        g = graph()
        dg = build_device_graph(g, device=dev)
        mine = dg.shard(rank, world)
        pl, L = P // world, dg.interval_len
        # 1. PageRank over the ranks, both modes, bitwise the one-device one
        for mode in ("dense_gather", "psw_windows"):
            r = pagerank_device(mine, n_iters=5, mode=mode,
                                group=dist.group.WORLD)
            one = pagerank_device(dg, n_iters=5, mode=mode)
            same = torch.equal(r, one[rank * pl:(rank + 1) * pl])
            if rank == 0:
                print(f"{mode}: {world} ranks, bitwise one-device: {same}")
        # 2. one message-passing step: this rank's partitions' edges, their
        #    remote sources around the ring, summed into its own rows
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.normal(size=(P * L, 16)).astype(
            np.float32)).to(dev)
        rows = slice(rank * pl * L, (rank + 1) * pl * L)
        src = mine.src.reshape(-1).long()
        dst = (mine.dst_local + (rank * pl + torch.arange(
            pl, device=dev))[:, None] * L).reshape(-1).long()
        mask = mine.mask.reshape(-1).to(x.dtype)
        ring = ring_mesh(pl * L)
        msgs = ring_gather(x[rows], src, ring) * mask[:, None]
        agg = local_scatter_sum(msgs, dst, P * L, ring)
        want = torch.zeros_like(x).index_add_(0, dst, x[src] * mask[:, None])
        err = torch.tensor(float((agg - want[rows]).abs().max()), device=dev)
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        if rank == 0:
            print(f"ring message passing vs one device max diff: "
                  f"{float(err):.2e}")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=None)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    world = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 4)
    if P % world:
        raise SystemExit(f"{P} intervals do not split over {world} ranks")
    with socket.socket() as s:                  # a free local port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    g = graph()
    print(f"graph: {g.intervals.max_vertices} vertex slots, {g.n_edges} "
          f"edges, {P} intervals over {world} ranks on {args.device}")
    mp.spawn(rank_main, args=(world, port, args.device), nprocs=world)
    print("done.")


if __name__ == "__main__":
    main()
