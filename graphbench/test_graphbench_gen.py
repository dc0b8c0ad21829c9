"""The generator's sizes, degree shapes and seeding, at a tiny scale."""
import numpy as np
import pytest
import torch

from graphbench.gen.powerlaw import (GraphShape, degree_sequence, generate,
                                     relabelling)
from graphbench.registry import Registry

SHAPE = GraphShape(5000, 80000, 2.4, 2.276, 150, 250, 0.3, 0.01, 0.001, 16)


def test_degree_sequence_sum_and_cap():
    d = degree_sequence(100_000, 1_423_000, 2.4, 4000).numpy()
    assert d.sum() == 1_423_000
    assert abs(int(d[0]) - 4000) <= 1
    assert np.all(np.diff(d) <= 0) and d[-1] >= 1
    # a power law: the top 1% of vertices hold far more than 1% of edges
    assert d[:1000].sum() > 0.1 * d.sum()


def test_sizes_and_shares():
    src, dst = generate(SHAPE, 5, "cpu")
    n = SHAPE.vertices
    assert src.shape == dst.shape == (SHAPE.edges,)
    assert src.dtype == dst.dtype == torch.int64
    assert int(src.min()) >= 0 and int(max(src.max(), dst.max())) < n
    keys = src * n + dst
    assert int((src == dst).sum()) >= SHAPE.n_self_loops
    repeated = SHAPE.edges - torch.unique(keys).shape[0]
    assert repeated >= SHAPE.n_duplicates * 0.9
    out_deg = torch.bincount(src, minlength=n)
    in_deg = torch.bincount(dst, minlength=n)
    assert 0.6 * 150 < int(out_deg.max()) < 1.3 * 150
    assert 0.6 * 250 < int(in_deg.max()) < 1.3 * 250
    assert float(in_deg.float().median()) < SHAPE.edges / n


def test_seeded():
    a = generate(SHAPE, 2 ** 31 + 99, "cpu")
    b = generate(SHAPE, 2 ** 31 + 99, "cpu")
    c = generate(SHAPE, 2 ** 31 + 100, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    # the degree sequence is the configuration's, not the seed's
    da = np.sort(torch.bincount(a[0], minlength=5000).numpy())
    dc = np.sort(torch.bincount(c[0], minlength=5000).numpy())
    assert abs(int(da.sum()) - int(dc.sum())) == 0
    # every class of destination ids modulo 16 holds as many edges
    pa = torch.bincount(a[1] % 16, minlength=16)
    assert torch.equal(pa, torch.bincount(c[1] % 16, minlength=16))
    assert int(pa.max() - pa.min()) <= 3


def test_relabelling_keeps_every_class():
    a = relabelling(5000, 16, 2 ** 31 + 7, "cpu")
    assert torch.equal(torch.sort(a).values, torch.arange(5000))
    assert torch.equal(a % 16, torch.arange(5000) % 16)
    assert torch.equal(a, relabelling(5000, 16, 2 ** 31 + 7, "cpu"))
    assert not torch.equal(a, relabelling(5000, 16, 2 ** 31 + 8, "cpu"))


@pytest.mark.parametrize("name", ["soc-livejournal1", "twitter-2010"])
def test_configs_keep_the_source_density(name):
    cfg = Registry().config(name)
    shape = GraphShape.from_config(cfg)
    src_ratio = cfg["source_edges"] / cfg["source_vertices"]
    assert abs(shape.edges / shape.vertices - src_ratio) < 0.01
    assert set(cfg["reduced"]) == {"vertices", "edges"}
    assert shape.max_in_degree < shape.vertices
