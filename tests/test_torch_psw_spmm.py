"""The port's PSW block-sparse SpMM (repro_torch/kernels/psw_spmm and
repro_torch/graph/padding.py::bucket_edges_by_block) against the
reference's, on the CPU, where the wrapper takes the plain torch version.

Tile layouts are held bitwise. Products are held at TestPswSpmm's own
tolerances: rtol 1e-5, atol 1e-5 against the reference's Pallas kernel
(interpret mode) and its jnp oracle, both of which sum in another order;
rtol 1e-4, atol 1e-4 on the live store, as tests/test_engine.py holds it."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as R
from repro.graph.padding import bucket_edges_by_block as ref_bucket
from repro.kernels.psw_spmm import prepare_blocks as ref_prepare
from repro.kernels.psw_spmm import psw_spmm_edges as ref_psw_spmm_edges
from repro.kernels.psw_spmm import psw_spmm_ref, spmm_dense_ref
import repro_torch.core as T
from repro_torch.graph import bucket_edges_by_block
from repro_torch.kernels.psw_spmm import (ops, prepare_blocks, psw_spmm,
                                          psw_spmm_edges, psw_spmm_torch,
                                          spmm_dense_torch, tile_ptr)


def edge_list(n, e, seed, hub=False):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub:         # one destination block only: the others are empty
        dst = rng.integers(0, min(n, 100), e)
    return src, dst


@pytest.mark.parametrize("n,e,block,hub", [(100, 500, 128, False),
                                           (513, 4000, 128, False),
                                           (513, 4000, 128, True),
                                           (300, 3000, 32, False),
                                           (5, 0, 128, False)])
def test_tile_layouts_match_reference_bitwise(n, e, block, hub):
    src, dst = edge_list(n, e, n + e, hub)
    for got, want in ((bucket_edges_by_block(src, dst, n, block),
                       ref_bucket(src, dst, n, block)),
                      (prepare_blocks(src, dst, n, block),
                       ref_prepare(src, dst, n, block))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,e,f", [(100, 500, 16), (300, 3000, 64),
                                   (513, 4000, 130), (64, 64, 256)])
def test_plain_version_matches_reference(n, e, f):
    rng = np.random.default_rng(n + e)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    before = ops.launches
    got = psw_spmm_edges(src, dst, torch.from_numpy(x), n, block=128)
    assert ops.launches == before          # the CPU takes the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, f)
    want = np.asarray(ref_psw_spmm_edges(src, dst, jnp.asarray(x), n,
                                         block=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    edge = np.asarray(spmm_dense_ref(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(x), n))
    np.testing.assert_allclose(got.numpy(), edge, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        spmm_dense_torch(torch.from_numpy(src), torch.from_numpy(dst),
                         torch.from_numpy(x), n).numpy(),
        edge, rtol=1e-5, atol=1e-5)
    # the tile-level entry against the reference's jnp oracle
    coords, tiles, nb = prepare_blocks(src, dst, n, 128)
    xp = np.pad(x, ((0, nb * 128 - n), (0, 0)))
    want_t = np.asarray(psw_spmm_ref(jnp.asarray(coords), jnp.asarray(tiles),
                                     jnp.asarray(xp), nb, 128))
    got_t = psw_spmm_torch(torch.from_numpy(coords), torch.from_numpy(tiles),
                           torch.from_numpy(xp), nb, 128)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-5, atol=1e-5)


def test_empty_dst_blocks_zeroed():
    # all edges target node 0 — other blocks must still be written
    src = np.arange(50)
    dst = np.zeros(50, np.int64)
    out = psw_spmm_edges(src, dst, torch.ones((300, 8)), 300, block=128)
    assert float(out[1:].abs().max()) == 0.0
    assert torch.equal(out[0], torch.full((8,), 50.0))
    # the tile-level entry with no filler tiles at all
    coords = torch.tensor([[2, 0]], dtype=torch.int32)
    tiles = torch.ones((1, 4, 4))
    out = psw_spmm(coords, tiles, torch.ones((4, 3)), 3, 4)
    assert not out[:8].any() and torch.equal(out[8:], torch.full((4, 3), 4.))
    assert torch.equal(tile_ptr(coords, 3), torch.tensor([0, 0, 0, 1]))


def test_live_store_path():
    """Neighbour aggregation straight off an online LSMTree, edges still in
    its buffers (the path of tests/test_engine.py::test_snapshot_spmm_on_
    live_store), the same batches into both packages."""
    rng = np.random.default_rng(10)
    n, e = 512, 3000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    outs = []
    for pkg in (R, T):
        t = pkg.LSMTree(pkg.IntervalMap.for_capacity(n - 1, 16), n_levels=2,
                        branching=4, buffer_cap=500, max_partition_edges=1200)
        t.insert_edges(src[:2700], dst[:2700])
        t.insert_edges(src[2700:], dst[2700:])  # < cap: stays buffered
        assert t.total_buffered() > 0
        outs.append(t.to_coo())
    (rs, rd), (s, d) = outs
    assert np.array_equal(rs, s) and np.array_equal(rd, d)
    got = psw_spmm_edges(s, d, torch.from_numpy(x), n, block=128)
    want = np.asarray(spmm_dense_ref(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(x), n))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bad_inputs_raise():
    coords = torch.tensor([[0, 0]], dtype=torch.int32)
    tiles = torch.ones((1, 4, 4))
    with pytest.raises(ValueError):
        psw_spmm(coords.long(), tiles, torch.ones((4, 3)), 1, 4)
    with pytest.raises(ValueError):
        psw_spmm(coords, tiles, torch.ones((5, 3)), 1, 4)   # not n*block rows
    with pytest.raises(TypeError):
        psw_spmm(coords.numpy(), tiles, torch.ones((4, 3)), 1, 4)
    with pytest.raises(ValueError):
        psw_spmm_edges([0, 9], [1, 2], torch.ones((5, 3)), 5)
