#!/usr/bin/env python
"""Time variants of the segment_ell CUDA kernel's tuning constants on one
GPU.

    python3 scripts/segment_ell_variants.py [VARIANT ...] [--reps 20]
        [--compare PATH] [--features F ...]

A VARIANT is comma-separated `name=value` pairs over the kernel's constants
(kInFlight, kWarpsPerBlock, kMinBlocks in
src/repro_torch/kernels/segment_ell/csrc/segment_ell.cu), e.g.
`kInFlight=2` or `kWarpsPerBlock=4,kMinBlocks=8`; `base` is the source as
it stands. `--compare PATH` adds another source with the same C interface
(an earlier commit's `segment_ell.cu`, say) as it stands. The input is
chip_smoke.py phase 6's: `pad_to_ell` (K = 15) of the phase-1 graph's 56M
power-law edges on 4M vertices (`--vertices` / `--edges` to cut it) and a
random x of F = 100 columns; `--features 100 96 128` repeats the timings
for each width. Each result is checked bitwise against the plain version;
times are CUDA events, the best of 3 means over --reps launches, taken in
the order given and then again in reverse (so two builds compare as A B B
A), with `F.embedding_bag` beside them. Run from the repository root;
prints one line per (width, build, pass).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT,
                                                              "scripts")]

CUDA_NAMES = ("kInFlight", "kWarpsPerBlock", "kMinBlocks")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=["base"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--vertices", type=int, default=4_000_000)
    ap.add_argument("--edges", type=int, default=56_000_000)
    ap.add_argument("--features", type=int, nargs="+", default=[100])
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    import kernel_variants
    from repro_torch.graph import pad_to_ell
    from repro_torch.kernels import segment_ell as se
    from repro_torch.kernels.segment_ell import kernel as sk

    libs = kernel_variants.build(sk.SOURCE, args.variants, CUDA_NAMES, (),
                                 "segment_ell_variants", sk._bind)
    if args.compare:
        libs += [(f"compare {args.compare}", {}, lib) for _, _, lib in
                 kernel_variants.build(args.compare, ["base"], (), (),
                                       "segment_ell_compare", sk._bind)]
    dev = torch.device("cuda:0")
    n = args.vertices
    src, dst = cs.power_law_graph(n, args.edges, seed=0)
    idx, mask = (torch.from_numpy(a).to(dev)
                 for a in pad_to_ell(src, dst, n, 15))
    del src, dst
    ii, w = idx.long(), mask.float()
    for F in args.features:
        x = cs.randn(torch, (n, F), dev, 10)
        want = se.segment_ell_torch(idx, mask, x)
        fetched = cs.fetched_row_bytes(idx, mask, x)
        bound = (n * 15 * 5 + fetched + n * F * 4) / cs.HBM_BYTES_PER_S * 1e3
        print(f"N = {n}, K = 15, F = {F}, {int(mask.sum())} kept slots, "
              f"{fetched} bytes of rows fetched in 64-byte pieces, gather "
              f"bound {bound:.4f} ms", flush=True)
        for rnd, order in enumerate((libs, libs[::-1])):
            for variant, _, lib in order:
                out = torch.empty_like(want)

                def run():
                    sk.launch(idx, mask, x, out, lib)

                run()
                ok = torch.equal(out, want)
                ms = min(cs.cuda_ms(torch, run, args.reps) for _ in range(3))
                print(f"F={F} pass {rnd + 1} {variant}: {ms:.4f} ms, bitwise "
                      f"equal to the plain version: {ok}", flush=True)
        ms = min(cs.cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
            ii, x, per_sample_weights=w, mode="sum"), args.reps)
            for _ in range(3))
        print(f"F={F} F.embedding_bag: {ms:.4f} ms", flush=True)
        del x, want


if __name__ == "__main__":
    main()
