#!/usr/bin/env python
"""Time variants of the frontier_expand CUDA kernel's tuning constants on
one GPU.

    python3 scripts/frontier_expand_variants.py [--reps 20] [VARIANT ...]

A VARIANT is comma-separated `name=value` pairs over the kernel's constants
(kWarpsPerBlock, kInFlight, kFlagRows in
src/repro_torch/kernels/frontier_expand/csrc/frontier_expand.cu) and the
layout's split (LIGHT_EDGES, CHUNK_EDGES in ops.py), e.g. `kInFlight=8`
or `LIGHT_EDGES=16,CHUNK_EDGES=512`; `base` is the source as it stands.
The graph is chip_smoke.py phase 1's (4M vertices, 56M power-law edges,
`--vertices` / `--edges` to cut it), deduplicated and laid out as the
kernel's compact CSR directly on the card (original ids, so it differs
from the store's plan only by the interval relabelling). Panels: B = 1
(half the vertices), two_hop's hop-2 panels of 64 and 128 random seeds,
and a dense 30% 0/1 panel at B = 128. Each variant's result is checked
bitwise against `torch.sparse.mm` of the same CSR, which is timed beside
them (CUDA events, the best of 3 means over --reps launches). Run from the
repository root; prints one line per (panel, variant).
"""
import argparse
import dataclasses
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT,
                                                              "scripts")]

CUDA_NAMES = ("kWarpsPerBlock", "kInFlight", "kFlagRows")
PY_NAMES = ("LIGHT_EDGES", "CHUNK_EDGES")


@dataclasses.dataclass
class Layout:
    """The fields of a FrontierPlan that the kernel reads."""
    col: object
    edge_ptr: object
    chunks: object
    chunk_row: object
    reduce_dst: object
    reduce_ptr: object
    light_edges: int
    chunk_edges: int
    reduced_hubs: int
    scratch_rows: int
    n_src: int
    n_dst: int


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=["base"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--vertices", type=int, default=4_000_000)
    ap.add_argument("--edges", type=int, default=56_000_000)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    import kernel_variants
    from repro_torch.kernels.frontier_expand import kernel as fk
    from repro_torch.kernels.frontier_expand import ops

    libs = kernel_variants.build(fk.SOURCE, args.variants, CUDA_NAMES,
                                 PY_NAMES, "frontier_expand_variants",
                                 fk._bind)
    dev = torch.device("cuda:0")
    n = args.vertices
    src, dst = cs.power_law_graph(n, args.edges, seed=0)
    keys = torch.unique(torch.from_numpy(dst * n + src).to(dev))
    del src, dst
    d, col = keys // n, (keys % n).to(torch.int32)
    del keys
    edge_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(d, minlength=n), 0, out=edge_ptr[1:])
    del d
    print(f"{col.shape[0]} distinct edges on {n} vertices", flush=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "sparse CSR is in beta"
        adj = torch.sparse_csr_tensor(edge_ptr, col.long(),
                                      torch.ones(col.shape[0], device=dev),
                                      size=(n, n))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    seeds = torch.randperm(n, generator=gen, device=dev)[:128]
    x = torch.zeros((n, 128), device=dev)
    x[seeds, torch.arange(128, device=dev)] = 1.0
    panels = (("B=1 half the vertices",
               (torch.rand((n, 1), generator=gen, device=dev) < 0.5).float()),
              ("B=64 hop-2 panel",
               (torch.sparse.mm(adj, x[:, :64].contiguous()) > 0).float()),
              ("B=128 hop-2 panel", (torch.sparse.mm(adj, x) > 0).float()),
              ("B=128 dense 30%",
               (torch.rand((n, 128), generator=gen, device=dev) < 0.3)
               .float()))
    del x
    for name, x in panels:
        B = x.shape[1]
        want = torch.sparse.mm(adj, x)
        print(f"{name}: {int((x != 0).any(1).sum())} non-zero rows",
              flush=True)
        for variant, consts, lib in libs:
            lay = Layout(col, edge_ptr, n_src=n, n_dst=n, **ops.hub_chunks(
                edge_ptr, consts.get("LIGHT_EDGES", ops.LIGHT_EDGES),
                consts.get("CHUNK_EDGES", ops.CHUNK_EDGES)))
            out = torch.empty_like(want)
            scratch = torch.empty((lay.scratch_rows, B), device=dev)
            flags = torch.empty((n, -(-B // fk.TILE) if B >= 32 else 0),
                                dtype=torch.uint8, device=dev)

            def run():
                fk.launch(lay, x, out, scratch, flags, lib)

            run()
            ok = torch.equal(out, want)
            ms = min(cs.cuda_ms(torch, run, args.reps) for _ in range(3))
            print(f"{name} {variant}: {ms:.4f} ms, {lay.chunks.shape[0]} "
                  f"chunks, {lay.reduced_hubs} hubs summed by pass 2, "
                  f"equal to torch.sparse.mm: {ok}", flush=True)
        ms = min(cs.cuda_ms(torch, lambda: torch.sparse.mm(adj, x), args.reps)
                 for _ in range(3))
        print(f"{name} torch.sparse.mm: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
