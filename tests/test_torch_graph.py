"""The port's graph ops (repro_torch/graph: segment ops, edge-chunked
aggregation, the neighbour sampler) against the reference's (repro/graph),
on the same numpy inputs made from a seed.

Segment ops and the chunked moments are float32 sums and are held at
rtol/atol 1e-6 (integer max/min bitwise); the sampler is host numpy and is
held bitwise, array by array and dtype by dtype, on a `GraphPAL` and on a
live `LSMTree` fed the same batches in each package."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as R
from repro.graph import chunked as rch
from repro.graph import segment_ops as rso
from repro.graph.sampler import NeighborSampler as RefSampler
import repro_torch.core as T
from repro_torch.graph import NeighborSampler
from repro_torch.graph import chunked as tch
from repro_torch.graph import segment_ops as tso
from test_torch_multihop import N, bulk, live

TOL = dict(rtol=1e-6, atol=1e-6)


def close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def messages(n, e, d, seed, empty=True):
    """(msgs, dst) with destinations in [0, n // 2) when `empty` (so half
    the segments get no message) else [0, n)."""
    rng = np.random.default_rng(seed)
    shape = (e,) if d is None else (e, d)
    msgs = rng.standard_normal(shape).astype(np.float32)
    dst = rng.integers(0, n // 2 if empty else n, e)
    return msgs, dst


@pytest.mark.parametrize("name", ["scatter_sum", "scatter_mean",
                                  "scatter_max", "scatter_min",
                                  "scatter_std"])
@pytest.mark.parametrize("d", [None, 1, 7])
def test_segment_ops_match_reference(name, d):
    msgs, dst = messages(50, 400, d, seed=len(name) * 10 + (d or 0))
    want = getattr(rso, name)(jnp.asarray(msgs), jnp.asarray(dst), 50)
    got = getattr(tso, name)(torch.from_numpy(msgs), torch.from_numpy(dst),
                             50)
    assert got.dtype == torch.float32
    if name in ("scatter_max", "scatter_min"):    # empty segments: ±inf
        assert np.array_equal(got.numpy(), np.asarray(want))
    else:
        close(got, want)


@pytest.mark.parametrize("name", ["scatter_max", "scatter_min"])
def test_integer_max_min_keep_the_identity_bitwise(name):
    rng = np.random.default_rng(3)
    msgs = rng.integers(-1000, 1000, (300, 4)).astype(np.int32)
    dst = rng.integers(0, 20, 300)
    want = getattr(rso, name)(jnp.asarray(msgs), jnp.asarray(dst), 40)
    got = getattr(tso, name)(torch.from_numpy(msgs), torch.from_numpy(dst),
                             40)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_gather_degree_and_edge_softmax_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((30, 5)).astype(np.float32)
    src = rng.integers(0, 30, 200)
    dst = rng.integers(0, 15, 200)
    assert np.array_equal(
        tso.gather_src(torch.from_numpy(x), torch.from_numpy(src)).numpy(),
        np.asarray(rso.gather_src(jnp.asarray(x), jnp.asarray(src))))
    deg = tso.degree(torch.from_numpy(dst), 30)
    assert deg.dtype == torch.float32
    assert np.array_equal(deg.numpy(),
                          np.asarray(rso.degree(jnp.asarray(dst), 30)))
    for shape in ((200,), (200, 3)):
        scores = (rng.standard_normal(shape) * 30).astype(np.float32)
        close(tso.edge_softmax(torch.from_numpy(scores),
                               torch.from_numpy(dst), 30),
              rso.edge_softmax(jnp.asarray(scores), jnp.asarray(dst), 30))


@pytest.mark.parametrize("aggs", [("mean", "max", "min", "std"),
                                  ("sum", "max", "std", "min", "mean")])
def test_aggregate_multi_maps_empty_segments_to_zero(aggs):
    msgs, dst = messages(64, 500, 6, seed=5)
    msgs[::7] = 1e30                  # huge but finite: kept, not zeroed
    want = rso.aggregate_multi(jnp.asarray(msgs), jnp.asarray(dst), 64, aggs)
    got = tso.aggregate_multi(torch.from_numpy(msgs), torch.from_numpy(dst),
                              64, aggs)
    close(got, want, dict(rtol=1e-6, atol=1e-6))
    empty = np.setdiff1d(np.arange(64), dst)
    blocks = got.reshape(64, len(aggs), 6)
    for a in ("max", "min"):          # the ±inf identities become 0
        assert empty.size and not blocks[empty, aggs.index(a)].any()
    with pytest.raises(ValueError):
        tso.aggregate_multi(torch.from_numpy(msgs), torch.from_numpy(dst),
                            64, ("median",))


def chunk_inputs(n=40, e=256, d=6, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 8, e)   # the last 8 nodes get no edge
    mask = rng.random(e) < 0.8
    dst[~mask & (rng.random(e) < 0.5)] = n - 1   # masked edges only there
    return x, src, dst, mask


AGGS = ("mean", "max", "min", "std", "sum")


def port_chunked(x, src, dst, mask, chunks, aggs=AGGS):
    tx = torch.from_numpy(x)
    acc = tch.multi_aggregate_chunked(
        lambda src, _x=tx: _x[src],
        {"dst": torch.from_numpy(dst), "mask": torch.from_numpy(mask),
         "src": torch.from_numpy(src)},
        x.shape[0], x.shape[1], aggs, chunks=chunks)
    return acc, tch.fold_aggregate(acc, aggs)


@pytest.mark.parametrize("chunks", [1, 4])
def test_chunked_aggregation_matches_reference(chunks):
    x, src, dst, mask = chunk_inputs()
    jx = jnp.asarray(x)
    want_acc = rch.multi_aggregate_chunked(
        lambda src, _x=jx: _x[src],
        {"dst": jnp.asarray(dst), "mask": jnp.asarray(mask),
         "src": jnp.asarray(src)}, x.shape[0], x.shape[1], AGGS,
        chunks=chunks)
    acc, folded = port_chunked(x, src, dst, mask, chunks)
    assert set(acc) == set(want_acc)
    for k in acc:
        assert acc[k].dtype == torch.float32
        close(acc[k], want_acc[k])
    close(folded, rch.fold_aggregate(want_acc, AGGS))
    # the node that only masked edges reach: no count, max and min 0
    assert acc["count"][-1] == 0
    blocks = folded[-1].reshape(len(AGGS), x.shape[1])
    assert not blocks[[AGGS.index("max"), AGGS.index("min")]].any()


def test_chunk_counts_agree_and_must_divide_the_edges():
    x, src, dst, mask = chunk_inputs(seed=7)
    _, one = port_chunked(x, src, dst, mask, 1)
    _, four = port_chunked(x, src, dst, mask, 4)
    np.testing.assert_allclose(four.numpy(), one.numpy(), **TOL)
    with pytest.raises(ValueError, match="chunks"):
        port_chunked(x, src, dst, mask, 3)
    # only the moments the aggregators need
    acc, _ = port_chunked(x, src, dst, mask, 2, ("sum",))
    assert set(acc) == {"sum", "count"}


def same_subgraph(a, b):
    for name in ("nodes", "node_mask", "src", "dst", "edge_mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.n_seeds == b.n_seeds


def batches(seed):
    """Seed lists (a repeated seed, a vertex without in-edges among
    them), fanouts and paddings, drawn once per store seed."""
    rng = np.random.default_rng(seed)
    out = []
    for fanouts in ((15, 10), (3, 2), (4,)):
        for pad in ((None, None), (N + 128, 40 * 128)):
            seeds = rng.choice(N, 16, replace=False)
            out.append((seeds, fanouts, pad))
    out.append((np.array([5, 9, 5, 17]), (15, 10), (None, None)))
    return out


@pytest.mark.parametrize("store", ["bulk", "live"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_is_bitwise_the_reference(store, seed):
    make = {"bulk": bulk, "live": live}[store]
    ref, port = RefSampler(make(R, seed), seed=seed), \
        NeighborSampler(make(T, seed), seed=seed)
    for seeds, fanouts, (pn, pe) in batches(seed + 10):
        want = ref.sample(seeds, fanouts, pad_nodes=pn, pad_edges=pe)
        got = port.sample(seeds, fanouts, pad_nodes=pn, pad_edges=pe)
        same_subgraph(got, want)
        n = int(got.node_mask.sum())
        assert np.array_equal(got.nodes[:len(seeds)], seeds)
        assert (got.src[got.edge_mask] < n).all()
        assert (got.dst[got.edge_mask] < n).all()
    # both generators were drawn from equally: the next batch agrees too
    seeds = np.arange(0, N, 7)
    same_subgraph(port.sample(seeds, (15, 10)), ref.sample(seeds, (15, 10)))


def test_sampler_padding_too_small_raises_in_both():
    ref, port = RefSampler(bulk(R, 3), seed=3), \
        NeighborSampler(bulk(T, 3), seed=3)
    seeds = np.arange(0, N, 5)
    for kw in ({"pad_nodes": 8}, {"pad_edges": 8}):
        with pytest.raises(ValueError, match="padding too small"):
            ref.sample(seeds, (15, 10), **kw)
        with pytest.raises(ValueError, match="padding too small"):
            port.sample(seeds, (15, 10), **kw)
    # the failed calls drew from both generators alike
    same_subgraph(port.sample(seeds, (15, 10)), ref.sample(seeds, (15, 10)))


def test_sampler_on_an_empty_store():
    for pkg, cls in ((R, RefSampler), (T, NeighborSampler)):
        g = pkg.GraphPAL.from_edges(np.empty(0, np.int64),
                                    np.empty(0, np.int64), n_partitions=2,
                                    max_id=9)
        sub = cls(g).sample([1, 2], (3, 2))
        assert sub.nodes.shape == (128,) and sub.edge_mask.shape == (128,)
        assert int(sub.node_mask.sum()) == 2 and not sub.edge_mask.any()
