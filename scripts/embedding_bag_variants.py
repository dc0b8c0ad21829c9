#!/usr/bin/env python
"""Time variants of the embedding_bag CUDA kernel's tuning constants on one
GPU.

    python3 scripts/embedding_bag_variants.py [VARIANT ...] [--reps 20]
        [--compare PATH ...] [--bags B]

A VARIANT is comma-separated `name=value` pairs over the kernel's constants
(kDeep, kShallow, kDeepWarpsPerSm, kWarpsPerBlock in
src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu), e.g.
`kShallow=16` or `kWarpsPerBlock=2,kDeep=16`; `base` is the source as it
stands.
`--compare PATH ...` adds other sources as they stand: each with today's C
interface, or an earlier one whose launch takes no row count and no error
word (an earlier commit's source, from `git show <commit>:<path>`). The input is chip_smoke.py phase
8's: bert4rec's 1,000,192 x 64 fp32 item table and --bags left-padded
histories of 200 slots, timed at B = --bags and B = 512 (sum). Each result
is checked bitwise against the plain version; times are CUDA events over
--reps launches, replayed from a CUDA graph (device time, the best of 3
replays) and launched from Python one by one (eager: the best of 3 means,
the host's launch path included), taken in the order given and then again
in reverse (so two builds compare as A B B A), with `F.embedding_bag`
beside them, a breakdown of the wrapper's eager time (the launch, the
error word's read and other ways to read it; each the best of 6 rounds
taken in rotated order), and, when a compared source has the earlier
interface, the wrapper with the id check against that source's wrapper
without it, A B B A. Run from the repository root; prints one line per
(B, build, pass).
"""
import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT,
                                                              "scripts")]

CUDA_NAMES = ("kDeep", "kShallow", "kDeepWarpsPerSm", "kWarpsPerBlock")


def bind_without_check(lib) -> None:
    """The launch of a source that takes no row count and no error word:
    (idx int32, w, table, out, B, K, D, device, stream)."""
    fn = lib.embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def wrapper_without_check(torch, lib, idx, weights, table):
    """The sum wrapper of a source with no error word, as it stood: the
    same argument checks, ids cast to int32, the launch, and no read-back
    (so no sync)."""
    from repro_torch.kernels import common
    for name, t in (("idx", idx), ("weights", weights), ("table", table)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if idx.device != table.device or weights.device != table.device:
        raise ValueError("expected one device")
    if (idx.dim() != 2 or weights.shape != idx.shape or table.dim() != 2
            or idx.dtype not in (torch.int32, torch.int64)
            or not weights.is_floating_point()):
        raise ValueError("expected int idx and float weights (B, K)")
    if table.dtype != torch.float32:
        raise TypeError("table must be float32")
    dev = table.device
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32,
                      device=dev)
    idx, w = idx.to(torch.int32).contiguous(), weights.to(
        torch.float32).contiguous()
    table = table.contiguous()
    (B, K), (V, D) = idx.shape, table.shape
    for t, name, dtype, shape in ((idx, "idx", torch.int32, (B, K)),
                                  (w, "w", torch.float32, (B, K)),
                                  (table, "table", torch.float32, (V, D)),
                                  (out, "out", torch.float32, (B, D))):
        common.check_tensor(t, name, dtype, shape, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common.raise_on_error(lib, "embedding_bag", lib.embedding_bag_launch(
        idx.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(), B,
        K, D, dev.index, stream))
    return out


def compare_wrappers(torch, cs, eb, lib, i, ww, table, reps: int,
                     B: int) -> None:
    """The wrapper with the id check against the one without it (on the
    unchecked source `lib`), A B B A: a lookup's latency (the call, then
    torch.cuda.synchronize, on the host's clock: the result is ready) and
    back-to-back calls (CUDA events; the wrapper without the check then
    overlaps its launches, the checked one cannot)."""
    import time
    fns = {"without the check": lambda: wrapper_without_check(
               torch, lib, i, ww, table),
           "with the check": lambda: eb.embedding_bag(i, ww, table)}
    want = eb.embedding_bag_torch(i, ww, table)
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            raise SystemExit(f"wrapper {name} != plain version at B={B}")

    def latency(fn) -> float:
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / reps * 1e3)
        return best

    for rnd, names in enumerate((list(fns), list(fns)[::-1])):
        for name in names:
            back = min(cs.cuda_ms(torch, fns[name], reps) for _ in range(3))
            print(f"B={B} wrapper {name}, pass {rnd + 1}: latency "
                  f"{latency(fns[name]):.4f} ms, back to back {back:.4f} ms",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=["base"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bags", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", nargs="*", default=[])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    import kernel_variants
    from repro_torch.kernels import common
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import kernel as ek

    libs = [(v, c, lib, True) for v, c, lib in kernel_variants.build(
        ek.SOURCE, args.variants, CUDA_NAMES, (), "embedding_bag_variants",
        ek._bind)]
    for n, path in enumerate(args.compare):
        checked = "n_rows" in open(path).read()
        libs += [(f"compare {path}", {}, lib, checked)
                 for _, _, lib in kernel_variants.build(
                     path, ["base"], (), (), f"embedding_bag_compare{n}",
                     ek._bind if checked else bind_without_check)]
    dev = torch.device("cuda:0")
    table, idx_np, w_np = cs.bag_inputs(torch, dev, args)
    idx, w = torch.from_numpy(idx_np).to(dev), torch.from_numpy(w_np).to(dev)
    V, D = table.shape
    for B in (args.bags, 512):
        i, ww = idx[:B].contiguous(), w[:B].contiguous()
        K = i.shape[1]
        want = eb.embedding_bag_torch(i, ww, table)
        distinct = int(torch.unique(i).numel())
        bound = (distinct * D * 4 + B * K * 8 + B * D * 4) \
            / cs.HBM_BYTES_PER_S * 1e3
        print(f"B = {B}, K = {K}, D = {D}: {distinct} distinct rows, "
              f"{cs.bags_rows_read(ww)} rows read, read-once bound "
              f"{bound:.4f} ms", flush=True)
        for rnd, order in enumerate((libs, libs[::-1])):
            for variant, _, lib, checked in order:
                out = torch.empty_like(want)
                err = torch.zeros(1, dtype=torch.int32, device=dev)

                def run():
                    if checked:
                        ek.launch(i, ww, table, out, err, lib)
                        return
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    common.raise_on_error(lib, ek.NAME,
                                          lib.embedding_bag_launch(
                                              i.data_ptr(), ww.data_ptr(),
                                              table.data_ptr(),
                                              out.data_ptr(), B, K, D,
                                              dev.index, stream))

                run()
                ok = torch.equal(out, want) and err.tolist() == [0]
                ms = cs.graph_ms(torch, run, args.reps)
                eager = min(cs.cuda_ms(torch, run, args.reps)
                            for _ in range(3))
                ok = ok and torch.equal(out, want) and err.tolist() == [0]
                print(f"B={B} pass {rnd + 1} {variant}: {ms:.4f} ms (eager "
                      f"{eager:.4f}), bitwise equal to the plain version: "
                      f"{ok}", flush=True)
        ii = i.long()

        def library():
            torch.nn.functional.embedding_bag(ii, table,
                                              per_sample_weights=ww,
                                              mode="sum")

        ms = cs.graph_ms(torch, library, args.reps)
        eager = min(cs.cuda_ms(torch, library, args.reps) for _ in range(3))
        print(f"B={B} F.embedding_bag: {ms:.4f} ms (eager {eager:.4f})",
              flush=True)
        # where the wrapper's time goes (the source as it stands, eager),
        # and other ways to read the error word: the wrapper's (pinned host
        # memory the kernel writes, then a stream synchronize), a device
        # word read with .item() (a copy and a sync), a device word copied
        # into pinned memory; the synchronize alone is the floor of each
        stream = torch.cuda.current_stream(dev)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        host = torch.zeros(1, dtype=torch.int32, pin_memory=True)

        def launch_and_sync():
            ek.launch(i, ww, table, out, err)
            stream.synchronize()

        def launch_to_host_word():
            ek.launch(i, ww, table, out, host)
            stream.synchronize()
            host.item()

        def launch_and_item():
            ek.launch(i, ww, table, out, err)
            err.item()

        def launch_and_pinned_copy():
            ek.launch(i, ww, table, out, err)
            host.copy_(err, non_blocking=True)
            stream.synchronize()
            host.item()

        parts = {
            "embedding_bag (the wrapper, sum)":
                lambda: eb.embedding_bag(i, ww, table),
            "kernel.launch": lambda: ek.launch(i, ww, table, out, err),
            "kernel.launch + stream sync": launch_and_sync,
            "kernel.launch writing a pinned host word + stream sync":
                launch_to_host_word,
            "kernel.launch + device word .item()": launch_and_item,
            "kernel.launch + device word copied to pinned + stream sync":
                launch_and_pinned_copy,
            "torch.zeros(1) (a device word allocated a call)":
                lambda: torch.zeros(1, dtype=torch.int32, device=dev)}
        times = dict.fromkeys(parts, float("inf"))
        names = list(parts)
        for rnd in range(6):   # host noise comes in bursts: rotate the order
            for name in names[rnd % len(names):] + names[:rnd % len(names)]:
                times[name] = min(times[name],
                                  cs.cuda_ms(torch, parts[name], args.reps))
        print(f"B={B} wrapper breakdown, eager ms: " + ", ".join(
            f"{name} {t:.4f}" for name, t in times.items()), flush=True)
        unchecked = [lib for _, _, lib, checked in libs if not checked]
        if unchecked:
            compare_wrappers(torch, cs, eb, unchecked[0], i, ww, table,
                             args.reps, B)


if __name__ == "__main__":
    main()
