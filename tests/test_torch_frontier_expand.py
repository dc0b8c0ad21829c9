"""The port's frontier_expand plan and wrapper (repro_torch/kernels/
frontier_expand) against the reference's, on the CPU: plan arrays equal
array for array, and counts bitwise equal to the reference jnp path
(`use_kernel=False`; the Pallas interpret path no longer traces under
jax 0.9), the numpy oracle and a dense A @ x. Exact tolerance: the inputs
are small integers, so every sum is exact in float32."""
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
    """The CUDA kernel's work split in torch: light destinations summed
    whole, heavy destinations as the sum of their chunks' partials."""
    n, b = plan.n_dst, x.shape[1]
    rows = plan.dst_ptr[1:] - plan.dst_ptr[:-1]
    full = frontier_expand_torch(plan.idx, plan.mask, x, plan.row_dst, n)
    out = torch.full((n, b), float("nan"))
    light = rows <= plan.split_rows
    out[light] = full[light]
    parts = []
    for r0, r1 in plan.chunks.tolist():
        parts.append(frontier_expand_torch(
            plan.idx[r0:r1], plan.mask[r0:r1], x,
            torch.zeros(r1 - r0, dtype=torch.int32), 1)[0])
    for h, d in enumerate(plan.heavy_dst.tolist()):
        lo, hi = plan.heavy_ptr[h:h + 2].tolist()
        out[d] = torch.stack(parts[lo:hi]).sum(0)
    return out


@pytest.mark.parametrize("kind", ["random", "hub", "empty"])
def test_kernel_layout_covers_every_row(kind):
    src, dst, n = graph(kind)
    plan = build_frontier_plan(src, dst, n, n)
    R = int((plan.row_dst < n).sum())
    rows = np.diff(plan.dst_ptr)
    assert plan.dst_ptr[0] == 0 and plan.dst_ptr[-1] == R
    assert np.array_equal(np.repeat(np.arange(n), rows), plan.row_dst[:R])
    heavy = np.flatnonzero(rows > plan.split_rows)
    assert np.array_equal(plan.heavy_dst, heavy)
    if kind == "hub":
        assert 17 in heavy                 # the 5000-source hub is split
    for h, d in enumerate(heavy):
        ch = plan.chunks[plan.heavy_ptr[h]:plan.heavy_ptr[h + 1]]
        assert ch[0, 0] == plan.dst_ptr[d] and ch[-1, 1] == plan.dst_ptr[d + 1]
        assert np.array_equal(ch[1:, 0], ch[:-1, 1])
        assert ((ch[:, 1] - ch[:, 0]) <= plan.split_rows).all()
        assert ((ch[:, 1] - ch[:, 0]) > 0).all()
    assert plan.heavy_ptr[-1] == plan.chunks.shape[0]


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
    own = build_frontier_plan(src, dst, n, n)
    for name in ("dst_ptr", "heavy_dst", "heavy_ptr", "chunks"):
        assert np.array_equal(getattr(plan, name).numpy(), getattr(own, name))
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
