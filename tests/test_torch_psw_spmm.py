"""The port's PSW block-sparse SpMM (repro_torch/kernels/psw_spmm and
repro_torch/graph/padding.py::bucket_edges_by_block) against the
reference's, on the CPU, where the wrapper takes the plain torch version.

Tile and row layouts are held bitwise. Products are held at TestPswSpmm's own
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
from repro_torch.kernels.psw_spmm import (compact_tiles, ops, prepare_blocks,
                                          prepare_rows, psw_spmm,
                                          psw_spmm_edges, psw_spmm_rows,
                                          psw_spmm_rows_torch, psw_spmm_torch,
                                          spmm_dense_torch)


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


def assert_rows_close(got, want, tol=1e-5):
    """|got - want| <= tol + tol * (the largest |want| of the row): a hub
    row sums thousands of float32 terms, and where they cancel to near 0 in
    one column no two summation orders meet an elementwise rtol there."""
    bound = tol + tol * np.abs(want).max(1, keepdims=True, initial=0.0)
    assert np.all(np.abs(got - want) <= bound), float(
        (np.abs(got - want) / bound).max())


def hub_edges(n, e, seed, hub_sources=0, dup=0):
    """Uniform edges, plus one hub destination (3) with `hub_sources`
    distinct sources and `dup` repeated edges (multiplicities > 1)."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub_sources:
        src = np.concatenate([src, rng.choice(n, hub_sources, replace=False)])
        dst = np.concatenate([dst, np.full(hub_sources, 3)])
    if dup:
        src = np.concatenate([src, np.repeat(src[:dup], 3)])
        dst = np.concatenate([dst, np.repeat(dst[:dup], 3)])
    return src, dst


def as_np(layout):
    return {f: getattr(layout, f).numpy() for f in
            ("row_ptr", "col", "val", "hub_rows", "hub_ptr", "chunks")}


ROW_CASES = [(100, 500, 128, 0, 0, False),       # empty dst blocks
             (513, 4000, 128, 0, 50, False),     # multi-edges
             (3000, 20000, 128, 2000, 30, False),  # a hub of 2,000 sources
             (3000, 20000, 32, 1500, 0, False),
             (513, 4000, 128, 0, 0, True),       # one dst block only
             (5, 0, 128, 0, 0, False)]


@pytest.mark.parametrize("n,e,block,hub,dup,one_block", ROW_CASES)
def test_prepare_rows_scatters_to_reference_tiles(n, e, block, hub, dup,
                                                  one_block):
    if one_block:
        src, dst = edge_list(n, e, n + e, hub=True)
    else:
        src, dst = hub_edges(n, e, n + e, hub, dup)
    lay = as_np(prepare_rows(src, dst, n, block, device="cpu"))
    coords, tiles, nb = ref_prepare(src, dst, n, block)
    coords, tiles = np.asarray(coords), np.asarray(tiles)
    rows = np.repeat(np.arange(n), np.diff(lay["row_ptr"]))
    cols = lay["col"].astype(np.int64)
    assert lay["col"].dtype == np.int32 and lay["val"].dtype == np.float32
    # each row's entries strictly ascending by source (distinct, sorted)
    assert np.all((rows[1:] > rows[:-1]) | (cols[1:] > cols[:-1]))
    where = {(int(a), int(b)): t for t, (a, b) in enumerate(coords)}
    back = np.zeros_like(tiles)
    t = np.array([where[(r // block, c // block)] for r, c in
                  zip(rows.tolist(), cols.tolist())], np.int64)
    back[t, rows % block, cols % block] = lay["val"]
    assert np.array_equal(back, tiles)


@pytest.mark.parametrize("n,e,block,hub,dup,one_block", ROW_CASES)
def test_tile_compaction_equals_prepare_rows(n, e, block, hub, dup,
                                             one_block):
    if one_block:
        src, dst = edge_list(n, e, n + e, hub=True)
    else:
        src, dst = hub_edges(n, e, n + e, hub, dup)
    want = prepare_rows(src, dst, n, block, device="cpu")
    coords, tiles, nb = prepare_blocks(src, dst, n, block)
    got = compact_tiles(torch.from_numpy(coords), torch.from_numpy(tiles),
                        nb, block, nb)
    assert (got.n_rows, got.n_src) == (nb * block, nb * block)
    g, w = as_np(got), as_np(want)
    assert np.array_equal(g["row_ptr"][:n + 1], w["row_ptr"])
    assert np.all(g["row_ptr"][n:] == w["row_ptr"][-1])
    for f in ("col", "val", "hub_rows", "hub_ptr", "chunks"):
        assert g[f].dtype == w[f].dtype and np.array_equal(g[f], w[f]), f


@pytest.mark.parametrize("n,e,block,hub,dup,one_block", ROW_CASES)
@pytest.mark.parametrize("f", [1, 70, 128])
def test_plain_row_version_matches_reference(n, e, block, hub, dup,
                                             one_block, f):
    if one_block:
        src, dst = edge_list(n, e, n + e, hub=True)
    else:
        src, dst = hub_edges(n, e, n + e, hub, dup)
    x = np.random.default_rng(f).normal(size=(n, f)).astype(np.float32)
    lay = prepare_rows(src, dst, n, block, device="cpu")
    got = psw_spmm_rows_torch(lay.row_ptr, lay.col, lay.val,
                              torch.from_numpy(x), block).numpy()
    edge = np.asarray(spmm_dense_ref(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(x), n))
    assert_rows_close(got, edge)
    coords, tiles, nb = ref_prepare(src, dst, n, block)
    xp = np.pad(x, ((0, nb * block - n), (0, 0)))
    want = np.asarray(psw_spmm_ref(jnp.asarray(coords), jnp.asarray(tiles),
                                   jnp.asarray(xp), nb, block))[:n]
    assert_rows_close(got, want)
    before = ops.launches
    assert torch.equal(psw_spmm_rows(lay, torch.from_numpy(x)),
                       torch.from_numpy(got))
    assert ops.launches == before          # the CPU takes the plain version


@pytest.mark.parametrize("hub,block", [(300, 128), (2000, 128), (2999, 32),
                                       (1500, 4)])
def test_chunk_plan_covers_each_hub_row_once(hub, block):
    """Every row of more than CHUNK entries, and no other, is cut into
    chunks that tile its entries in order, each starting at a source
    block boundary and holding at most CHUNK + block - 1 entries."""
    n = 3000
    src, dst = hub_edges(n, 20000, hub + block, hub, 40)
    lay = prepare_rows(src, dst, n, block, device="cpu")
    w = as_np(lay)
    lens = np.diff(w["row_ptr"])
    assert np.array_equal(w["hub_rows"], np.nonzero(lens > lay.max_row)[0])
    assert lay.max_row == ops.CHUNK and 3 in w["hub_rows"].tolist()
    blk = w["col"].astype(np.int64) // block
    assert w["hub_ptr"][0] == 0 and w["hub_ptr"][-1] == w["chunks"].shape[0]
    for h, r in enumerate(w["hub_rows"].tolist()):
        ch = w["chunks"][w["hub_ptr"][h]:w["hub_ptr"][h + 1]]
        assert ch.shape[0] >= 2
        assert ch[0, 0] == w["row_ptr"][r] and ch[-1, 1] == w["row_ptr"][r + 1]
        assert np.array_equal(ch[1:, 0], ch[:-1, 1])
        assert np.all(ch[:, 1] - ch[:, 0] <= lay.max_row + block - 1)
        inner = ch[1:, 0]
        assert np.all(blk[inner] != blk[inner - 1])


def kernel_order(lay, x):
    """The CUDA kernel's order in numpy float32: per-source-block partials
    in each row or chunk, then a hub's chunk totals in chunk order."""
    def run(lo, hi):
        tot = np.zeros(x.shape[1], np.float32)
        part = np.zeros_like(tot)
        cur = -1
        for e in range(lo, hi):
            b = int(lay["col"][e]) // block
            if b != cur:
                tot, part, cur = tot + part, np.zeros_like(tot), b
            part = part + lay["val"][e] * x[lay["col"][e]]
        return tot + part
    block = lay["block"]
    out = np.zeros((len(lay["row_ptr"]) - 1, x.shape[1]), np.float32)
    for r in range(out.shape[0]):
        if lay["row_ptr"][r + 1] - lay["row_ptr"][r] <= lay["max_row"]:
            out[r] = run(lay["row_ptr"][r], lay["row_ptr"][r + 1])
    for h, r in enumerate(lay["hub_rows"].tolist()):
        tot = np.zeros(x.shape[1], np.float32)
        for lo, hi in lay["chunks"][lay["hub_ptr"][h]:lay["hub_ptr"][h + 1]]:
            tot = tot + run(lo, hi)
        out[r] = tot
    return out


def test_kernel_order_with_chunks_matches_edge_oracle():
    n = 3000
    src, dst = hub_edges(n, 6000, 5, 2500, 40)
    x = np.random.default_rng(5).normal(size=(n, 8)).astype(np.float32)
    lay = prepare_rows(src, dst, n, 32, device="cpu")
    w = {**as_np(lay), "block": lay.block, "max_row": lay.max_row}
    assert w["chunks"].shape[0] >= 10
    edge = np.asarray(spmm_dense_ref(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(x), n))
    assert_rows_close(kernel_order(w, x), edge)


def test_non_finite_x_reaches_only_rows_with_an_edge_from_it():
    """The documented difference (ROADMAP queue 3): the dense tile product
    gives 0 * inf = NaN in every row of a tile whose source block holds an
    inf; the row layout, like the edge oracle, only where an edge reads
    it."""
    n = 256
    src = np.array([5, 5, 7, 200])
    dst = np.array([1, 2, 3, 130])
    x = np.ones((n, 2), np.float32)
    x[5, 0] = np.inf                      # source block 0, read by rows 1, 2
    lay = prepare_rows(src, dst, n, 128, device="cpu")
    got = psw_spmm_rows(lay, torch.from_numpy(x)).numpy()
    assert np.isinf(got[[1, 2], 0]).all() and np.isfinite(got[3]).all()
    assert np.array_equal(got[3], [1.0, 1.0]) and not got[4:128].any()
    edge = np.asarray(spmm_dense_ref(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(x), n))
    assert np.array_equal(got, edge)
    coords, tiles, nb = ref_prepare(src, dst, n, 128)
    ref = np.asarray(psw_spmm_ref(jnp.asarray(coords), jnp.asarray(tiles),
                                  jnp.asarray(x), nb, 128))
    assert np.isnan(ref[3, 0]) and np.isnan(ref[0, 0])   # no edge from 5
    assert np.isfinite(ref[130]).all()    # another tile, no inf source
    tile_api = psw_spmm(torch.from_numpy(coords), torch.from_numpy(tiles),
                        torch.from_numpy(x), nb, 128).numpy()
    assert np.array_equal(tile_api, got)


def test_prepare_rows_device_and_bad_inputs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_rows([0], [1], 4)                     # None means the GPU
    with pytest.raises(ValueError):
        prepare_rows([0, 1], [1], 4, device="cpu")
    with pytest.raises(ValueError):
        prepare_rows([0, -1], [1, 2], 4, device="cpu")
    lay = prepare_rows([0], [1], 4, device="cpu")
    with pytest.raises(ValueError):
        psw_spmm_rows(lay, torch.ones((5, 3)))        # not n_src rows
    with pytest.raises(ValueError):
        psw_spmm_rows(lay, torch.ones((4, 3), dtype=torch.float64))


def same_layout(a, b):
    for name in ("row_ptr", "col", "val", "hub_rows", "hub_ptr", "chunks"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert (a.n_src, a.block, a.max_row) == (b.n_src, b.block, b.max_row)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_prepare_rows_takes_tensors_as_they_are(dtype):
    """Ids given as tensors (as a GNN batch holds them) build the layout
    the same ids give as numpy arrays, memmaps or lists; a tensor is read
    in place, and the caller's ids are never written."""
    src, dst = edge_list(300, 5000, seed=21)
    dst[:600] = 7                                     # a hub row, chunked
    want = prepare_rows(src, dst, 300, 128, device="cpu")
    s, d = (torch.from_numpy(a).to(dtype) for a in (src, dst))
    s0, d0 = s.clone(), d.clone()
    same_layout(prepare_rows(s, d, 300, 128, device="cpu"), want)
    assert torch.equal(s, s0) and torch.equal(d, d0)
    same_layout(prepare_rows(list(src), list(dst), 300, 128, device="cpu"),
                want)
    live = torch.rand(5000, generator=torch.Generator().manual_seed(0)) < 0.7
    same_layout(prepare_rows(s[live], d[live], 300, 128, device="cpu"),
                prepare_rows(src[live.numpy()], dst[live.numpy()], 300, 128,
                             device="cpu"))
    with pytest.raises(ValueError):
        prepare_rows(s, d + 300, 300, device="cpu")


# (n_rows, n_src, edges, block, hub rows of A, hub rows of A^T, duplicates)
TRANSPOSE_CASES = [(300, 300, 3000, 128, True, False, 40),
                   (3000, 500, 9000, 128, True, True, 0),   # rectangular
                   (50, 4000, 3000, 32, False, True, 25),   # wide, hub in A^T
                   (7, 3, 0, 128, False, False, 0)]         # no entries


def rect_edges(n_rows, n_src, e, seed, hub, t_hub, dup):
    """Edges from [0, n_src) to [0, n_rows): a destination hub (row 3, 400
    sources), a source hub (source 5, 400 destinations), repeats."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n_src, e), rng.integers(0, n_rows, e)
    if hub:
        src = np.concatenate([src, rng.integers(0, n_src, 400)])
        dst = np.concatenate([dst, np.full(400, 3)])
    if t_hub:
        src = np.concatenate([src, np.full(400, 5)])
        dst = np.concatenate([dst, rng.integers(0, n_rows, 400)])
    if dup:
        src = np.concatenate([src, np.repeat(src[:dup], 2)])
        dst = np.concatenate([dst, np.repeat(dst[:dup], 2)])
    return src, dst


@pytest.mark.parametrize("n_rows,n_src,e,block,hub,t_hub,dup",
                         TRANSPOSE_CASES)
def test_transpose_rows_is_prepare_rows_of_the_swapped_edges(
        n_rows, n_src, e, block, hub, t_hub, dup):
    """Bitwise, chunk plan and multiplicities included; built once and
    cached on the layout."""
    src, dst = rect_edges(n_rows, n_src, e, 31, hub, t_hub, dup)
    lay = prepare_rows(src, dst, n_rows, block, device="cpu", n_src=n_src)
    t = ops.transpose_rows(lay)
    same_layout(t, prepare_rows(dst, src, n_src, block, device="cpu",
                                n_src=n_rows))
    assert t.n_rows == n_src and t.n_src == n_rows
    assert ops.transpose_rows(lay) is t
    if t_hub:
        assert 5 in t.hub_rows.tolist()
    if dup:
        assert float(t.val.max()) >= 3
    same_layout(ops.transpose_rows(t), lay)


@pytest.mark.parametrize("n_rows,n_src,e,block,hub,t_hub,dup",
                         TRANSPOSE_CASES)
def test_backward_matches_autograd_through_the_dense_product(
        n_rows, n_src, e, block, hub, t_hub, dup):
    """dx = A^T g through the Function (the plain version both ways on the
    CPU) against autograd through the dense A @ x in float64; the values
    get no gradient, and the transpose the backward used is the cached
    one."""
    src, dst = rect_edges(n_rows, n_src, e, 32, hub, t_hub, dup)
    lay = prepare_rows(src, dst, n_rows, block, device="cpu", n_src=n_src)
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((n_src, 24)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n_rows, 24)).astype(np.float32))
    x.requires_grad_()
    out = psw_spmm_rows(lay, x)
    assert out.requires_grad and not lay.val.requires_grad
    dx, = torch.autograd.grad(out, x, g)
    dense = torch.zeros((n_rows, n_src), dtype=torch.float64)
    dense.index_put_((torch.from_numpy(dst), torch.from_numpy(src)),
                     torch.ones(len(src), dtype=torch.float64),
                     accumulate=True)
    x64 = x.detach().double().requires_grad_()
    want, = torch.autograd.grad(dense @ x64, x64, g.double())
    assert_rows_close(dx.numpy(), want.numpy())
    assert "transpose" in lay.cache
    # a second backward reuses the transpose
    t = lay.cache["transpose"]
    torch.autograd.grad(psw_spmm_rows(lay, x).sum(), x)
    assert lay.cache["transpose"] is t


def test_gradcheck_in_float64_of_the_plain_path():
    """The Function's backward is the adjoint of its forward
    (torch.autograd.gradcheck, which the plain version runs in float64
    where the wrapper takes float32 only)."""
    src, dst = rect_edges(20, 30, 80, 34, False, False, 5)
    lay = prepare_rows(src, dst, 20, 8, device="cpu", n_src=30)
    x = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (30, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: ops._Rows.apply(x, lay), (x,))
