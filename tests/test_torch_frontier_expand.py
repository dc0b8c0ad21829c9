"""The port's frontier_expand plan and wrapper (repro_torch/kernels/
frontier_expand) against the reference's, on the CPU: plan arrays equal
array for array, and counts bitwise equal to the reference jnp path
(`use_kernel=False`; the Pallas interpret path no longer traces under
jax 0.9), the numpy oracle and a dense A @ x. Exact tolerance: the inputs
are small integers, so every sum is exact in float32."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.kernels.frontier_expand import build_frontier_plan as ref_build
from repro.kernels.frontier_expand import frontier_expand_counts as ref_counts
from repro.kernels.frontier_expand import frontier_expand_np
from repro_torch import convert
from repro_torch.kernels.frontier_expand import (build_frontier_plan,
                                                 frontier_expand_counts,
                                                 frontier_expand_torch,
                                                 plan_to_device)
from repro_torch.kernels.frontier_expand import ops

REF_FIELDS = ("idx", "mask", "row_dst", "n_src", "n_dst", "n_edges",
              "k_slots")


def graph(kind: str, seed: int = 0):
    """(src, dst, n): random multigraph, one hub of in-degree 5000, or no
    edges at all."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n, e = 300, 3000
        return rng.integers(0, n, e), rng.integers(0, n, e), n
    if kind == "hub":
        n = 6000
        src = np.concatenate([np.arange(5000), rng.integers(0, n, 2000)])
        dst = np.concatenate([np.full(5000, 17), rng.integers(0, n, 2000)])
        return src, dst, n
    assert kind == "empty"
    return np.empty(0, np.int64), np.empty(0, np.int64), 50


def panel(n: int, b: int, seed: int) -> np.ndarray:
    """Small-integer float32 panel (0/1 indicators plus a few 2s and 3s)."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, b)) < 0.3).astype(np.float32)
    x[rng.random((n, b)) < 0.02] = 3.0
    return x


@pytest.mark.parametrize("kind", ["random", "hub", "empty"])
@pytest.mark.parametrize("k_slots", [32, 7])
def test_plan_arrays_match_reference(kind, k_slots):
    src, dst, n = graph(kind)
    ref = ref_build(src, dst, n, n, k_slots=k_slots)
    got = build_frontier_plan(src, dst, n, n, k_slots=k_slots)
    for name in REF_FIELDS:
        a, b = getattr(ref, name), getattr(got, name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
        assert np.asarray(a).dtype == np.asarray(b).dtype, name


@pytest.mark.parametrize("kind", ["random", "hub", "empty"])
@pytest.mark.parametrize("b", [1, 5, 128, 130])
def test_counts_bitwise_equal_reference(kind, b):
    src, dst, n = graph(kind, seed=b)
    x = panel(n, b, seed=b + 1)
    ref_plan = ref_build(src, dst, n, n)
    plan = plan_to_device(build_frontier_plan(src, dst, n, n), "cpu")
    got = frontier_expand_counts(plan, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, b)
    got = got.numpy()
    # the reference jnp path (K-loop ref + sorted segment_sum)
    assert np.array_equal(got, ref_counts(ref_plan, x, use_kernel=False))
    # the numpy oracle, reduced by row_dst
    rows = frontier_expand_np(ref_plan.idx, ref_plan.mask, x)
    want = np.zeros((n + 1, b), np.float32)
    np.add.at(want, ref_plan.row_dst, rows)
    assert np.array_equal(got, want[:n])
    # a dense deduplicated adjacency product
    a = np.zeros((n, n), np.float64)
    a[dst, src] = 1.0
    assert np.array_equal(got, (a @ x).astype(np.float32))


def emulate_kernel(plan, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's walk in torch: each light destination sums its CSR
    range col[edge_ptr[d]:edge_ptr[d + 1]] in edge order, a heavy one the
    partials of its chunks; for B >= 32 an edge whose source's 128-column
    tile holds only +-0 is skipped (never read), as the kernel's flags do."""
    n, b = plan.n_dst, x.shape[1]
    col = plan.col.long()
    keep = torch.ones((x.shape[0], b), dtype=torch.bool)
    if b >= 32:
        for t0 in range(0, b, 128):
            nz = (x[:, t0:t0 + 128] != 0).any(1, keepdim=True)   # NaN: True
            keep[:, t0:t0 + 128] = nz

    def walk(e0: int, e1: int) -> torch.Tensor:
        acc = torch.zeros(b)
        for s in col[e0:e1].tolist():
            acc = torch.where(keep[s], acc + x[s], acc)
        return acc

    counts = plan.edge_ptr[1:] - plan.edge_ptr[:-1]
    out = torch.full((n, b), float("nan"))
    for d in torch.nonzero(counts <= plan.light_edges).squeeze(1).tolist():
        out[d] = walk(*plan.edge_ptr[d:d + 2].tolist())
    parts = [walk(e0, e1) for e0, e1 in plan.chunks.tolist()]
    for h, d in enumerate(plan.heavy_dst.tolist()):
        lo, hi = plan.heavy_ptr[h:h + 2].tolist()
        out[d] = torch.stack(parts[lo:hi]).sum(0)
    return out


def check_compact_layout(plan, ref) -> None:
    """The kernel layout against the reference plan's idx/mask/row_dst:
    every destination's edges in slot order, and hub chunks that cover each
    heavy destination's edges once, in order, at most chunk_edges each."""
    n = ref.n_dst
    col, ptr = plan.col.numpy(), plan.edge_ptr.numpy()
    assert col.dtype == np.int32 and ptr.dtype == np.int64
    assert ptr[0] == 0 and ptr[-1] == ref.n_edges == col.shape[0]
    idx, mask, row_dst = (np.asarray(a) for a in (ref.idx, ref.mask,
                                                  ref.row_dst))
    for d in range(n):
        rows = np.flatnonzero(row_dst == d)
        want = idx[rows][mask[rows]]          # row by row, slot order
        assert np.array_equal(col[ptr[d]:ptr[d + 1]], want), d
    counts = np.diff(ptr)
    heavy = np.flatnonzero(counts > plan.light_edges)
    assert np.array_equal(plan.heavy_dst.numpy(), heavy)
    hp, ch = plan.heavy_ptr.numpy(), plan.chunks.numpy()
    assert hp[0] == 0 and hp[-1] == ch.shape[0]
    for h, d in enumerate(heavy):
        c = ch[hp[h]:hp[h + 1]]
        assert c[0, 0] == ptr[d] and c[-1, 1] == ptr[d + 1]
        assert np.array_equal(c[1:, 0], c[:-1, 1])
        assert ((c[:, 1] - c[:, 0]) <= plan.chunk_edges).all()
        assert ((c[:, 1] - c[:, 0]) > 0).all()


@pytest.mark.parametrize("kind", ["random", "hub", "empty"])
def test_kernel_layout_covers_every_row(kind):
    src, dst, n = graph(kind)
    ref = ref_build(src, dst, n, n)
    plan = plan_to_device(build_frontier_plan(src, dst, n, n), "cpu")
    check_compact_layout(plan, ref)
    if kind == "hub":
        assert 17 in plan.heavy_dst.tolist()   # the 5000-source hub is split
        h = plan.heavy_dst.tolist().index(17)
        count = int(plan.edge_ptr[18] - plan.edge_ptr[17])
        assert count >= 5000
        assert int(plan.heavy_ptr[h + 1] - plan.heavy_ptr[h]) == \
            -(-count // plan.chunk_edges)


@pytest.mark.parametrize("kind", ["random", "hub", "empty"])
@pytest.mark.parametrize("k_slots", [32, 7])
@pytest.mark.parametrize("split", [None, (3, 5)])
def test_compact_layout_matches_reference(kind, k_slots, split):
    """Built by plan_to_device and by convert.plan_from_arrays, at the
    default split and at a small one (more heavy destinations and
    chunks)."""
    src, dst, n = graph(kind, seed=k_slots)
    ref = ref_build(src, dst, n, n, k_slots=k_slots)
    for plan in (plan_to_device(build_frontier_plan(src, dst, n, n,
                                                    k_slots=k_slots), "cpu"),
                 convert.plan_from_arrays(convert.plan_to_arrays(ref),
                                          "cpu")):
        if split:
            plan = dataclasses.replace(plan, **ops.kernel_layout(
                plan.idx, plan.mask, plan.row_dst, plan.n_dst, *split))
        check_compact_layout(plan, ref)
        for name in REF_FIELDS[:3]:
            assert np.array_equal(getattr(plan, name).numpy(),
                                  np.asarray(getattr(ref, name)))


def walk_panel(n: int, b: int, kind: str, seed: int) -> torch.Tensor:
    """Panels for the emulated walk: all zero, one-hot columns, mostly zero
    rows, and mostly zero rows holding NaN, inf and -0.0."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, b), np.float32)
    if kind == "one_hot":
        x[rng.choice(n, min(b, n), replace=False), np.arange(min(b, n))] = 1
    elif kind in ("sparse_rows", "non_finite"):
        rows = rng.random(n) < 0.1
        x[rows] = rng.random((int(rows.sum()), b)) < 0.3
    if kind == "non_finite":
        for v in (np.nan, np.inf, -np.inf):
            x[rng.choice(n, 5, replace=False), rng.integers(0, b, 5)] = v
        x[rng.choice(n, 30, replace=False)] = -0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["zero", "one_hot", "sparse_rows",
                                  "non_finite"])
@pytest.mark.parametrize("b", [1, 5, 64, 130])
def test_emulated_walk_matches_counts(kind, b):
    """The new walk (CSR ranges, hub chunks at a small split, skipped zero
    rows) bitwise against frontier_expand_counts, NaN where it has NaN."""
    src, dst, n = graph("hub", seed=b)
    src, dst = src[::4], dst[::4]           # 1,750 edges, hub of 1,250
    plan = plan_to_device(build_frontier_plan(src, dst, n, n), "cpu")
    plan = dataclasses.replace(plan, **ops.kernel_layout(
        plan.idx, plan.mask, plan.row_dst, n, 2, 64))
    assert plan.chunks.shape[0] >= 20
    x = walk_panel(n, b, kind, seed=b + 2)
    got = emulate_kernel(plan, x)
    want = frontier_expand_counts(plan, x)
    fin = ~want.isnan()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(got[fin].signbit(), want[fin].signbit())


@pytest.mark.parametrize("kind", ["random", "hub"])
@pytest.mark.parametrize("b", [1, 130])
def test_kernel_work_split_matches_plain(kind, b):
    src, dst, n = graph(kind, seed=3)
    plan = plan_to_device(build_frontier_plan(src, dst, n, n), "cpu")
    x = torch.from_numpy(panel(n, b, seed=4))
    assert torch.equal(emulate_kernel(plan, x),
                       frontier_expand_counts(plan, x))


def test_plan_from_reference_arrays():
    src, dst, n = graph("hub", seed=5)
    ref = ref_build(src, dst, n, n)
    plan = convert.plan_from_arrays(convert.plan_to_arrays(ref), "cpu")
    own = plan_to_device(build_frontier_plan(src, dst, n, n), "cpu")
    for name in ("col", "edge_ptr", "heavy_dst", "heavy_ptr", "chunks"):
        assert torch.equal(getattr(plan, name), getattr(own, name))
    x = panel(n, 5, seed=6)
    assert np.array_equal(
        frontier_expand_counts(plan, torch.from_numpy(x)).numpy(),
        ref_counts(ref, x, use_kernel=False))
    # arrays from outside are checked before the kernel would gather them
    for name, bad in (("idx", n), ("row_dst", n + 1)):
        d = convert.plan_to_arrays(ref)
        d[name] = d[name].copy()
        d[name][0] = bad
        with pytest.raises(ValueError):
            convert.plan_from_arrays(d, "cpu")
    d = convert.plan_to_arrays(ref)
    d["row_dst"] = d["row_dst"][::-1].copy()
    with pytest.raises(ValueError):
        convert.plan_from_arrays(d, "cpu")


def test_cpu_path_counts_no_launch_and_checks_inputs():
    src, dst, n = graph("random")
    host = build_frontier_plan(src, dst, n, n)
    plan = plan_to_device(host, "cpu")
    before = ops.launches
    frontier_expand_counts(plan, torch.ones((n, 2)))
    assert ops.launches == before          # the plain version is no launch
    with pytest.raises(TypeError):
        frontier_expand_counts(host, torch.ones((n, 2)))
    with pytest.raises(TypeError):
        frontier_expand_counts(plan, np.ones((n, 2), np.float32))
    with pytest.raises(ValueError):
        frontier_expand_counts(plan, torch.ones((n, 2), dtype=torch.float64))
    with pytest.raises(ValueError):
        frontier_expand_counts(plan, torch.ones((n + 1, 2)))


@pytest.mark.parametrize("kernel", ["frontier_expand", "psw_spmm",
                                    "segment_ell", "embedding_bag",
                                    "flash_attention"])
def test_launch_counts_are_exact_from_threads(kernel, monkeypatch):
    """Reader threads of a service launch frontier_expand at once: every
    wrapper counts through `common.count_launch`, whose lock keeps the
    module count exact (a bare `launches += 1` can lose one between the
    read and the write). The thread switch interval is cut to provoke
    interleaving; the zero-then-read protocol is the callers'."""
    import importlib
    import inspect
    import sys
    import threading
    from repro_torch.kernels.common import count_launch
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    src = inspect.getsource(mod)
    assert "count_launch(globals())" in src and "launches += 1" not in src
    monkeypatch.setattr(mod, "launches", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(8)

        def hammer():
            start.wait()
            for _ in range(5_000):
                count_launch(vars(mod))

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert mod.launches == 40_000
