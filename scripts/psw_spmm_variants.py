#!/usr/bin/env python
"""Time variants of the psw_spmm CUDA kernel's tuning constants on one GPU.

    python3 scripts/psw_spmm_variants.py [--reps 50] [VARIANT ...]

A VARIANT is comma-separated `name=value` pairs over the kernel's
constants (kUnroll, kMinBlocks, kWarpsPerBlock, kHubLoads, kRowsPerWarp in
src/repro_torch/kernels/psw_spmm/csrc/psw_spmm.cu) and the wrapper's hub
cut CHUNK (ops.py), e.g. `kUnroll=8` or `kRowsPerWarp=1,CHUNK=64`; the
empty variant `base` is the source as it stands. Each variant's source is
compiled (all at once, one nvcc each) into build/psw_variants/, and timed
with CUDA events (the best of 3 means over --reps launches) on
chip_smoke.py phase 6's two graphs: the live tree (32,768 vertices,
458,752 power-law edges, F = 128) and the Cora shape (2,708 vertices,
10,556 edges, F = 1,433), each result checked against a float64 edge
oracle. `torch.sparse.mm` on the same CSR is timed beside them. Run from
the repository root; prints one line per (graph, variant).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT,
                                                              "scripts")]

CONSTANTS = ("kUnroll", "kMinBlocks", "kWarpsPerBlock", "kHubLoads",
             "kRowsPerWarp")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=["base"])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    import kernel_variants
    import repro_torch.core as core
    from repro_torch.kernels import psw_spmm as ps
    from repro_torch.kernels.psw_spmm import kernel as ps_kernel

    libs = kernel_variants.build(ps_kernel.SOURCE, args.variants, CONSTANTS,
                                 ("CHUNK",), "psw_variants", ps_kernel._bind)
    dev = torch.device("cuda:0")
    tree = cs.live_tree(core, 32_768, 458_752, 11)
    s2, d2 = tree.to_coo()
    s3, d3 = cs.power_law_graph(2_708, 10_556, seed=13)
    graphs = (("live tree F=128", s2, d2, cs.randn(torch, (32_768, 128), dev,
                                                    12)),
              ("Cora F=1433", s3, d3, cs.randn(torch, (2_708, 1_433), dev,
                                               14)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    chunk = ps.ops.CHUNK
    for name, s, d, x in graphs:
        n, F = x.shape
        want = ps.spmm_dense_torch(torch.from_numpy(s).to(dev),
                                   torch.from_numpy(d).to(dev), x.double(), n)
        for variant, consts, lib in libs:
            ps.ops.CHUNK = consts.get("CHUNK", chunk)
            lay = ps.prepare_rows(s, d, n, 128, device=dev)
            out = torch.empty_like(x)
            scratch = torch.empty((lay.chunks.shape[0], F), device=dev)

            def run():
                err = lib.psw_spmm_launch(
                    lay.row_ptr.data_ptr(), lay.col.data_ptr(),
                    lay.val.data_ptr(), lay.hub_rows.data_ptr(),
                    lay.hub_ptr.data_ptr(), lay.chunks.data_ptr(),
                    x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                    lay.chunks.shape[0], lay.hub_rows.shape[0], F,
                    lay.block, lay.max_row, dev.index, stream)
                if err:
                    raise SystemExit(f"{variant}: launch failed ({err})")

            ms = min(cs.cuda_ms(torch, run, args.reps) for _ in range(3))
            ok = cs.row_tolerance(out, want, 1e-4, 1e-4)[0]
            print(f"{name} {variant}: {ms:.4f} ms, within 1e-4 of float64: "
                  f"{ok}", flush=True)
        ps.ops.CHUNK = chunk
        lay = ps.prepare_rows(s, d, n, 128, device=dev)
        adj = torch.sparse_csr_tensor(lay.row_ptr, lay.col.long(), lay.val,
                                      size=(n, n))
        ms = min(cs.cuda_ms(torch, lambda: torch.sparse.mm(adj, x), args.reps)
                 for _ in range(3))
        print(f"{name} torch.sparse.mm: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
