"""The frontier_expand CUDA kernel against its plain torch version on the
card (marked `cuda`; skipped where torch sees no GPU). Imports neither jax
nor the reference package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py

Exact tolerance: the panels hold small integers, so every float32 sum is
exact whatever the order."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.frontier_expand import (build_frontier_plan,
                                                 frontier_expand_counts,
                                                 frontier_expand_torch,
                                                 ops, plan_to_device)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def plan_and_panel(n, e, b, hub, k_slots, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub:
        src = np.concatenate([src, rng.integers(0, n, hub)])
        dst = np.concatenate([dst, np.full(hub, 3)])
    plan = build_frontier_plan(src, dst, n, n, k_slots=k_slots)
    x = (rng.random((n, b)) < 0.3).astype(np.float32)
    x[rng.random((n, b)) < 0.02] = 3.0
    return plan, torch.from_numpy(x)


@pytest.mark.parametrize("b", [1, 5, 31, 32, 128, 130])
@pytest.mark.parametrize("hub,k_slots", [(0, 32), (20000, 32), (5000, 7),
                                         (5000, 40)])
def test_kernel_bitwise_equals_plain(cuda, b, hub, k_slots):
    plan, x = plan_and_panel(3000, 30000, b, hub, k_slots, seed=b + hub)
    dplan = plan_to_device(plan, cuda)
    before = ops.launches
    got = frontier_expand_counts(dplan, x.to(cuda))
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = frontier_expand_torch(dplan.idx, dplan.mask, x.to(cuda),
                                 dplan.row_dst, dplan.n_dst)
    assert torch.equal(got, want)
    cpu = frontier_expand_counts(plan_to_device(plan, "cpu"), x)
    assert torch.equal(got.cpu(), cpu)


def test_empty_plan_and_bad_inputs(cuda):
    plan = plan_to_device(build_frontier_plan(
        np.empty(0, np.int64), np.empty(0, np.int64), 10, 12), cuda)
    out = frontier_expand_counts(plan, torch.ones((10, 3), device=cuda))
    assert tuple(out.shape) == (12, 3) and not out.any()
    with pytest.raises(ValueError):
        frontier_expand_counts(plan, torch.ones((10, 3)))        # on the CPU
    with pytest.raises(ValueError):
        frontier_expand_counts(plan, torch.ones((10, 6), device=cuda)[:, ::2])
