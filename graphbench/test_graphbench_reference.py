"""The plain references against the port, on the CPU at a tiny size: the
port's dense 2-hop (its plain frontier-expansion path) and its device
PageRank on `device="cpu"`."""
import numpy as np
import pytest
import torch

from graphbench.gen.powerlaw import GraphShape, generate
from graphbench.reference import fof as fof_ref
from graphbench.reference import pagerank as pr_ref

SHAPE = GraphShape(2000, 30000, 2.4, 2.4, 60, 45, 0.5, 0.01, 0.001, 16)


@pytest.fixture(scope="module")
def graph():
    import repro_torch.core as core
    src, dst = generate(SHAPE, 2 ** 31 + 17, "cpu")
    g = core.GraphPAL.from_edges(src.numpy(), dst.numpy(), n_partitions=16,
                                 max_id=SHAPE.vertices - 1)
    return core, g, src, dst


@pytest.mark.parametrize("dense", ["kernel", "never"])
def test_fof_reference_matches_port(graph, dense):
    core, g, src, dst = graph
    index = fof_ref.EdgeIndex.build(src, dst, SHAPE.vertices)
    rng = np.random.default_rng(3)
    for _ in range(3):
        seeds = rng.choice(SHAPE.vertices, 128, replace=False)
        got = core.two_hop_counts(g, seeds, dense=dense, device="cpu")
        want = fof_ref.two_hop(index, torch.from_numpy(seeds))
        assert fof_ref.seeds_differing(got, want) == 0
        assert np.array_equal(got.offsets, want.offsets)
        assert np.array_equal(got.ids, want.ids)
        assert np.array_equal(got.counts, want.counts)
        assert want.ids.shape[0] > 0


def test_fof_reference_semantics():
    """A repeated edge is one friendship, a self-loop makes the seed its
    own friend, friends and the seed are left out."""
    src = torch.tensor([0, 0, 0, 1, 1, 2, 2, 3, 0])
    dst = torch.tensor([1, 1, 2, 3, 3, 3, 0, 4, 0])
    ans = fof_ref.two_hop(fof_ref.EdgeIndex.build(src, dst, 5),
                          torch.tensor([0, 1]))
    # seed 0: friends {0, 1, 2}; through 1 -> 3, through 2 -> 3 and 0
    assert ans.offsets.tolist() == [0, 1, 2]
    assert ans.ids.tolist() == [3, 4]
    assert ans.counts.tolist() == [2, 1]
    paths = fof_ref.two_hop(fof_ref.EdgeIndex.build(src, dst, 5,
                                                    distinct=False),
                            torch.tensor([0, 1]))
    assert fof_ref.seeds_differing(paths, ans) == 2


def test_pagerank_reference_matches_port(graph):
    core, g, src, dst = graph
    dg = core.build_device_graph(g, device="cpu")
    r = core.pagerank_device(dg, 5, 0.85, mode="psw_windows")
    internal = g.intervals.to_internal(np.arange(SHAPE.vertices))
    got = torch.from_numpy(r.reshape(-1).numpy()[internal])
    want = pr_ref.pagerank(src, dst, SHAPE.vertices, 5, 0.85)
    assert pr_ref.max_relative_error(got, want) < 1e-5
    low = pr_ref.pagerank(src, dst, SHAPE.vertices, 5, 0.85,
                          dtype=torch.bfloat16)
    assert pr_ref.max_relative_error(low, want) > 1e-3


def test_pagerank_reference_counts_every_copy():
    src = torch.tensor([0, 0, 1, 2, 2])
    dst = torch.tensor([1, 1, 2, 2, 0])
    r = pr_ref.pagerank(src, dst, 3, 1, 0.85)
    # vertex 1 gets both of 0's copies (1/2 each), 2 its own loop's half
    assert torch.allclose(r, torch.tensor([0.15 + 0.85 * 0.5, 0.15 + 0.85,
                                           0.15 + 0.85 * 1.5],
                                          dtype=torch.float64))
