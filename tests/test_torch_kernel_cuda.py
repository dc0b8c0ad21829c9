"""The CUDA kernels against their plain torch versions on the card (marked
`cuda`; skipped where torch sees no GPU). Imports neither jax nor the
reference package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py

Tolerances: frontier_expand is exact (the panels hold small integers, so
every float32 sum is exact whatever the order); segment_ell is bitwise (the
kernel and the plain version add the same values in the same slot order);
psw_spmm is rtol 1e-5, atol 1e-5 against the plain version (TestPswSpmm's
tolerance: index_add_ sums in another order) and 1e-4 against the edge
oracle, taken against the row's largest |value| on a 3,000-term hub row
whose terms cancel, and bitwise equal across runs; the PSW sweep's gather-and-sum (psw_sweep) is bitwise equal
across runs and within 1e-6 of a float64 sum, and bitwise the CPU's float64
`index_add_` where the float64 sums are exact (values on a 1/64 grid); flash_attention is rtol/atol 2e-5 against its
plain version in float32 (TestFlashAttention's tolerance: the fp32 SIMT
kernel and cuBLAS sum in another order) and 2e-2 in bfloat16 (test_bf16's:
the kernel rounds P to bf16 for P·V, on wgmma + TMA); embedding_bag is bitwise (both add
w·row in slot order, rounded twice in fp32; where a row holds inf or NaN, the NaN
columns are compared as a mask, since NaN != NaN). A small reopened on-disk
`GraphDB`'s dense hops and snapshot on the card, and a 256-seed dense
two-hop answer assembled on the card, are bitwise equal to `device="cpu"`. A MoE smoke-width prefill (through the flash_attention
kernel) and bert4rec's scores on the card are within 1e-4 of the CPU's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import psw
from repro_torch.graph import pad_to_ell
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import psw_spmm as ps
from repro_torch.kernels import psw_sweep
from repro_torch.kernels import segment_ell as se
from repro_torch.kernels.frontier_expand import (build_frontier_plan,
                                                 frontier_expand_counts,
                                                 frontier_expand_torch, ops)
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.psw_spmm import kernel as ps_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def plans_and_panel(n, e, b, hub, seed, device):
    """The plan of a random multigraph (a hub at destination 3) on `device`
    and on the CPU, and a small-integer panel."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub:
        src = np.concatenate([src, rng.integers(0, n, hub)])
        dst = np.concatenate([dst, np.full(hub, 3)])
    x = (rng.random((n, b)) < 0.3).astype(np.float32)
    x[rng.random((n, b)) < 0.02] = 3.0
    return (build_frontier_plan(src, dst, n, n, device),
            build_frontier_plan(src, dst, n, n, "cpu"), torch.from_numpy(x))


def same_plan(a, b) -> None:
    """Every field equal, tensors bitwise (on any devices)."""
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(u):
            assert u.dtype == v.dtype and torch.equal(u.cpu(), v.cpu()), f.name
        else:
            assert u == v, f.name


@pytest.mark.parametrize("b", [1, 5, 31, 32, 64, 128, 130])
@pytest.mark.parametrize("hub,graph_seed", [(0, 32), (20000, 32), (5000, 7),
                                            (5000, 40)])
def test_kernel_bitwise_equals_plain(cuda, b, hub, graph_seed):
    """The plan built on the card is the CPU's, and the kernel's counts on
    it are bitwise the plain version's on either device."""
    dplan, plan, x = plans_and_panel(3000, 30000, b, hub,
                                     (b + hub, graph_seed), cuda)
    same_plan(dplan, plan)
    before = ops.launches
    got = frontier_expand_counts(dplan, x.to(cuda))
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = frontier_expand_torch(dplan.col, dplan.edge_ptr, x.to(cuda),
                                 dplan.n_dst)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), frontier_expand_counts(plan, x))


def sparse_panel(n, b, kind, seed):
    """Panels the wide path skips rows of: all zero, one-hot columns,
    mostly zero rows, and mostly zero rows holding NaN, inf and -0.0."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, b), np.float32)
    if kind == "one_hot":
        x[rng.choice(n, b, replace=False), np.arange(b)] = 1.0
    elif kind in ("sparse_rows", "non_finite"):
        rows = rng.random(n) < 0.05
        x[rows] = (rng.random((int(rows.sum()), b)) < 0.3)
        x[rng.random((n, b)) < 0.002] = 2.0
    if kind == "non_finite":
        x[rng.choice(n, 20, replace=False), rng.integers(0, b, 20)] = np.nan
        x[rng.choice(n, 20, replace=False), rng.integers(0, b, 20)] = np.inf
        x[rng.choice(n, 20, replace=False), rng.integers(0, b, 20)] = -np.inf
        x[rng.choice(n, 200, replace=False)] = -0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("b", [1, 5, 31, 32, 64, 128, 130])
@pytest.mark.parametrize("kind", ["zero", "one_hot", "sparse_rows",
                                  "non_finite"])
def test_frontier_sparse_and_non_finite_panels(cuda, b, kind):
    """Rows of only +-0 are skipped on the wide path and change no bit: the
    kernel equals the plain version (NaN where it has NaN), and a
    destination of -0.0 rows only sums to +0.0 in both."""
    dplan, _, _ = plans_and_panel(3000, 30000, 1, 8000, b, cuda)
    x = sparse_panel(3000, b, kind, seed=b + 1)
    got = frontier_expand_counts(dplan, x.to(cuda))
    want = frontier_expand_torch(dplan.col, dplan.edge_ptr, x.to(cuda),
                                 dplan.n_dst)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~got.isnan()
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(got[fin].signbit(), want[fin].signbit())
    if kind == "zero":
        assert not got.any() and not got.signbit().any()


@pytest.mark.parametrize("b", [1, 64, 128])
def test_frontier_hub_above_the_edge_split(cuda, b):
    """A hub of 12,000 distinct sources: many chunks of chunk_edges, summed
    by pass 2; a second run gives the same bits."""
    rng = np.random.default_rng(b)
    n = 20000
    src = np.concatenate([rng.integers(0, n, 60000),
                          rng.choice(n, 12000, replace=False)])
    dst = np.concatenate([rng.integers(0, n, 60000), np.full(12000, 11)])
    plan = build_frontier_plan(src, dst, n, n, cuda)
    assert 11 in plan.reduce_dst.tolist()
    h = plan.reduce_dst.tolist().index(11)
    assert int(plan.reduce_ptr[h + 1] - plan.reduce_ptr[h]) >= \
        12000 // plan.chunk_edges
    x = (torch.rand((n, b), device=cuda) < 0.5).to(torch.float32)
    got = frontier_expand_counts(plan, x)
    want = frontier_expand_torch(plan.col, plan.edge_ptr, x, n)
    assert torch.equal(got, want)
    assert torch.equal(frontier_expand_counts(plan, x), got)
    assert int(got[11].max()) > 4000


@pytest.mark.parametrize("b", [1, 64, 128, 130])
def test_frontier_lone_and_reduced_hub_chunks(cuda, b):
    """Hubs of one chunk (light_edges + 1 and chunk_edges sources), which
    write their own rows, beside hubs of several (chunk_edges + 1 and
    12,000 sources), whose chunk sums pass 2 adds: bitwise the CPU's, and
    bitwise across two launches. Scratch has a row for each chunk of the
    hubs of several chunks and no other, and the launch writes each."""
    from repro_torch.kernels.frontier_expand import kernel as fk
    rng = np.random.default_rng(b)
    n, c = 20000, ops.CHUNK_EDGES
    hubs = {11: 12000, 12: c + 1, 13: c, 14: ops.LIGHT_EDGES + 1}
    dst = rng.integers(0, n, 60000)
    dst = np.where(np.isin(dst, list(hubs)), dst + 10, dst)
    src = np.concatenate([rng.integers(0, n, 60000)]
                         + [rng.choice(n, m, replace=False)
                            for m in hubs.values()])
    dst = np.concatenate([dst] + [np.full(m, d) for d, m in hubs.items()])
    plan = build_frontier_plan(src, dst, n, n, cuda)
    assert plan.reduce_dst.tolist() == [11, 12]
    assert plan.scratch_rows == -(-12000 // c) + 2 < plan.chunks.shape[0]
    lone = plan.chunk_row[plan.scratch_rows:].tolist()
    assert 13 in lone and 14 in lone
    x = (rng.random((n, b)) < 0.3).astype(np.float32)
    x[rng.random((n, b)) < 0.02] = 3.0
    x = torch.from_numpy(x)
    got = frontier_expand_counts(plan, x.to(cuda))
    assert torch.equal(frontier_expand_counts(plan, x.to(cuda)), got)
    assert torch.equal(got.cpu(), frontier_expand_counts(
        build_frontier_plan(src, dst, n, n, "cpu"), x))
    out = torch.empty_like(got)
    scratch = torch.full((plan.scratch_rows, b), float("nan"), device=cuda)
    flags = torch.empty((n, -(-b // fk.TILE) if b >= 32 else 0),
                        dtype=torch.uint8, device=cuda)
    fk.launch(plan, x.to(cuda), out, scratch, flags)
    torch.cuda.synchronize()
    assert torch.equal(out, got) and not scratch.isnan().any()
    for h, d in enumerate(plan.reduce_dst.tolist()):
        lo, hi = plan.reduce_ptr[h:h + 2].tolist()
        assert torch.equal(scratch[lo:hi].sum(0), got[d])


@pytest.mark.parametrize("b", [32, 128])
def test_frontier_unaligned_panel_takes_the_scalar_path(cuda, b):
    """x whose data_ptr is 4 mod 16 (contiguous, B % 4 == 0)."""
    dplan, _, x = plans_and_panel(3000, 30000, b, 5000, 7, cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x.to(cuda))
    assert xs.data_ptr() % 16 == 4
    got = frontier_expand_counts(dplan, xs)
    assert torch.equal(got, frontier_expand_torch(
        dplan.col, dplan.edge_ptr, xs, dplan.n_dst))


def test_empty_plan_and_bad_inputs(cuda):
    plan = build_frontier_plan(np.empty(0, np.int64), np.empty(0, np.int64),
                               10, 12, cuda)
    out = frontier_expand_counts(plan, torch.ones((10, 3), device=cuda))
    assert tuple(out.shape) == (12, 3) and not out.any()
    with pytest.raises(ValueError):
        frontier_expand_counts(plan, torch.ones((10, 3)))        # on the CPU
    with pytest.raises(ValueError):
        frontier_expand_counts(plan, torch.ones((10, 6), device=cuda)[:, ::2])


@pytest.mark.parametrize("f", [1, 3, 4, 100, 102, 128, 1433])
@pytest.mark.parametrize("k", [1, 15, 32])
def test_segment_ell_bitwise_equals_plain(cuda, k, f):
    """From edges with a hub destination (far more in-edges than K, so its
    row is full and the rest dropped), random values."""
    rng = np.random.default_rng(k * 1000 + f)
    n, e = 3000, 30000
    src = np.concatenate([rng.integers(0, n, e), rng.integers(0, n, 5000)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(5000, 7)])
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    before = se.ops.launches
    got = se.segment_ell_from_edges(src, dst, x.to(cuda), n, k)
    torch.cuda.synchronize()
    assert se.ops.launches == before + 1
    cpu = se.segment_ell_from_edges(src, dst, x, n, k)
    assert torch.equal(got.cpu(), cpu)
    idx, mask = (torch.from_numpy(a).to(cuda)
                 for a in pad_to_ell(src, dst, n, k))
    assert bool(mask[7].all())
    assert torch.equal(got, se.segment_ell_torch(idx, mask, x.to(cuda)))


@pytest.mark.parametrize("f", [4, 100])
def test_segment_ell_unaligned_x_takes_the_scalar_path(cuda, f):
    """x whose data_ptr is 4 mod 16 with F % 4 == 0: no 16-byte loads, and
    still bitwise equal to the plain version."""
    rng = np.random.default_rng(f)
    n, k = 2000, 15
    idx = torch.from_numpy(rng.integers(0, n, (n, k)).astype(np.int32))
    mask = torch.from_numpy(rng.random((n, k)) < 0.7)
    buf = torch.from_numpy(rng.normal(size=n * f + 1).astype(np.float32))
    x = buf.to(cuda)[1:].view(n, f)
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    got = se.segment_ell(idx.to(cuda), mask.to(cuda), x)
    assert torch.equal(got, se.segment_ell_torch(idx.to(cuda),
                                                 mask.to(cuda), x))


def test_segment_ell_never_reads_masked_slots(cuda):
    idx = torch.tensor([[1, -7, 2**30], [2**30, 2, -1]], dtype=torch.int32)
    mask = torch.tensor([[True, False, False], [False, True, False]])
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = se.segment_ell(idx.to(cuda), mask.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), x[[1, 2]])
    empty = se.segment_ell(idx[:0].to(cuda), mask[:0].to(cuda), x.to(cuda))
    assert tuple(empty.shape) == (0, 3)


def assert_rows_close(got, want, tol):
    """|got - want| <= tol + tol * (the largest |want| of the row), in
    float64: a hub row's float32 terms cancel to near 0 in some columns,
    where no two summation orders meet an elementwise rtol."""
    got, want = got.double(), want.double()
    bound = tol + tol * want.abs().amax(1, keepdim=True)
    ratio = float(((got - want).abs() / bound).max()) if got.numel() else 0.
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("f", [1, 100, 128, 1433])
@pytest.mark.parametrize("hub", [False, True])
def test_psw_spmm_matches_plain_and_edges(cuda, f, hub):
    """hub=True puts every edge into the first 100 destinations (the other
    rows are empty) and gives destination 3 a row of 3,000 distinct
    sources, many chunks of ps.CHUNK entries. Repeat runs are bitwise
    equal."""
    rng = np.random.default_rng(f + hub)
    n, e = 4000, 12000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, 100 if hub else n, e)
    if hub:
        src = np.concatenate([src, rng.choice(n, 3000, replace=False)])
        dst = np.concatenate([dst, np.full(3000, 3)])
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    before = ps.ops.launches
    got = ps.psw_spmm_edges(src, dst, x.to(cuda), n)
    torch.cuda.synchronize()
    assert ps.ops.launches == before + 1
    for _ in range(3):
        assert torch.equal(got, ps.psw_spmm_edges(src, dst, x.to(cuda), n))
    lay = ps.prepare_rows(src, dst, n, device=cuda)
    assert lay.row_ptr.device.type == "cuda"
    if hub:
        assert lay.chunks.shape[0] >= 3000 // (ps.CHUNK + 127)
        assert 3 in lay.hub_rows.tolist()
    plain = ps.psw_spmm_rows_torch(lay.row_ptr, lay.col, lay.val, x.to(cuda),
                                   lay.block)
    edge = ps.spmm_dense_torch(torch.from_numpy(src).to(cuda),
                               torch.from_numpy(dst).to(cuda),
                               x.to(cuda).double(), n)
    rest = torch.ones(n, dtype=torch.bool, device=cuda)
    if hub:                 # the 3,000-term row: rowwise, the rest as before
        rest[3] = False
        assert_rows_close(got[3:4], plain[3:4], 1e-5)
        assert_rows_close(got[3:4], edge[3:4], 1e-4)
    torch.testing.assert_close(got[rest], plain[rest], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[rest], edge[rest].float(), rtol=1e-4,
                               atol=1e-4)
    if hub:
        assert not got[100:].any()
    cpu = ps.prepare_rows(src, dst, n, device="cpu")
    for name in ("row_ptr", "col", "val", "hub_rows", "hub_ptr", "chunks"):
        assert torch.equal(getattr(lay, name).cpu(), getattr(cpu, name))


@pytest.mark.parametrize("P,E,hub", [(1, 1 << 24, 1 << 24),
                                     (1, 100_000, 70_000),
                                     (16, 1 << 20, 600_000)])
def test_segment_sum_sorted_is_deterministic(cuda, P, E, hub):
    """The PSW sweep's kernel sum gives the same bits on every run, for a
    single partition and for a hub segment of up to 2**24 edges (spread
    over thousands of blocks and summed by the fix-up pass in block order),
    and sums to float64 accuracy."""
    L = 64
    gen = torch.Generator(device=cuda)
    gen.manual_seed(P + E)
    msgs = torch.rand((P, E, 1), generator=gen, device=cuda)
    # destination 5 of every partition takes `hub` edges, the rest spread
    # over the other destinations in order
    dst = torch.cat([torch.full((hub,), 5, device=cuda),
                     torch.randint(0, L, (E - hub,), generator=gen,
                                   device=cuda)]).sort().values
    mask = torch.ones((P, E), dtype=torch.bool, device=cuda)
    seg_ptr = psw.segment_ptr(dst.expand(P, E).to(torch.int32), mask, L)
    n0 = psw_sweep.ops.launches
    first = psw_sweep.segment_sum(msgs, seg_ptr)
    assert psw_sweep.ops.launches == n0 + 1
    for _ in range(3):
        assert torch.equal(psw_sweep.segment_sum(msgs, seg_ptr), first)
    want = torch.zeros((P, L, 1), dtype=torch.float64, device=cuda)
    want.index_add_(1, dst, msgs.double())
    torch.testing.assert_close(first, want.float(), rtol=1e-6, atol=1e-6)


def grid_values(gen, shape, device):
    """float32 values on a 1/64 grid in [-8, 8): float64 sums of up to
    2**40 of them are exact, so every summation order gives their bits."""
    return (torch.randint(-512, 512, shape, generator=gen, device=device)
            .float() / 64)


def segments(counts, E, device):
    """(P, L + 1) destination CSRs of per-partition in-degree lists, each
    partition's edges a prefix of E slots."""
    ptr = [np.concatenate([[0], np.cumsum(c)]) for c in counts]
    assert all(p[-1] <= E for p in ptr)
    return torch.tensor(np.stack(ptr), dtype=torch.int64, device=device)


def padded(msgs, seg_ptr):
    """msgs with every slot past its partition's last edge set to NaN: the
    kernel must never read one."""
    pos = torch.arange(msgs.shape[1], device=msgs.device)
    pad = pos[None, :] >= seg_ptr[:, -1:]
    return msgs.masked_fill(pad[..., None], float("nan"))


@pytest.mark.parametrize("d", [1, 3])
def test_psw_sweep_empty_segments_and_padding(cuda, d):
    """Runs of empty destinations, a partition of padding only and one with
    no padding: the kernel's sums are bitwise the CPU's float64
    `index_add_`, empty destinations read 0, and padding is never read."""
    rng = np.random.default_rng(5)
    L, E = 3000, 9000
    sparse = np.zeros(L, np.int64)
    sparse[rng.choice(L, 40, replace=False)] = rng.integers(1, 200, 40)
    full = rng.multinomial(E, np.ones(L) / L)
    counts = [sparse, np.zeros(L, np.int64), full]
    seg_ptr = segments(counts, E, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d)
    msgs = padded(grid_values(gen, (3, E, d), cuda), seg_ptr)
    got = psw_sweep.segment_sum(msgs, seg_ptr)
    want = psw_sweep.segment_sum_torch(msgs.cpu(), seg_ptr.cpu())
    assert torch.equal(got.cpu(), want)
    assert not got[1].any() and not got[0][torch.from_numpy(sparse) == 0].any()
    assert torch.equal(psw_sweep.segment_sum(msgs, seg_ptr), got)


@pytest.mark.parametrize("d", [1, 2])
def test_psw_sweep_segments_around_one_tile(cuda, d):
    """Segments just under, at and over one block's merge items (TILE),
    twice and many times over, between short ones, at several offsets: the
    sums of segments split over blocks are bitwise the CPU's."""
    from repro_torch.kernels.psw_sweep.kernel import TILE
    rng = np.random.default_rng(d)
    counts = []
    for shift in (0, 1, 700, TILE - 3):
        c = rng.integers(0, 30, 4000)
        long_ = [TILE - 1, TILE, TILE + 1, 2 * TILE, 2 * TILE + 1,
                 9 * TILE + 17]
        c[rng.choice(np.arange(50, 4000), len(long_), replace=False)] = long_
        c[0] = shift
        counts.append(c)
    E = max(int(c.sum()) for c in counts) + 300
    seg_ptr = segments(counts, E, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    msgs = padded(grid_values(gen, (len(counts), E, d), cuda), seg_ptr)
    got = psw_sweep.segment_sum(msgs, seg_ptr)
    assert torch.equal(got.cpu(), psw_sweep.segment_sum_torch(msgs.cpu(),
                                                              seg_ptr.cpu()))
    # rounding: not on the grid, against a float64 sum
    x = torch.rand((len(counts), E, d), generator=gen, device=cuda)
    got = psw_sweep.segment_sum(x, seg_ptr)
    want = psw_sweep.segment_sum_torch(x.double(), seg_ptr)
    torch.testing.assert_close(got, want.float(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["dense_gather", "psw_windows"])
def test_psw_sweep_message_function_on_the_card(cuda, mode):
    """A DeviceGraph with hubs of TILE - 1, TILE and TILE + 1 in-edges and
    a state of width 2 on the grid: the sweep under a caller's msg_fn (2 in,
    3 out: built by plain torch, summed by the kernel) and the fused
    identity sweep are bitwise the CPU's; the identity through msg_fn is
    bitwise the fused one; both modes agree."""
    from repro_torch.core import GraphPAL
    from repro_torch.kernels.psw_sweep.kernel import TILE
    rng = np.random.default_rng(23)
    n = 30_000
    src = [rng.integers(0, n, 150_000)]
    dst = [rng.integers(0, n, 150_000)]
    for hub, deg in ((7, TILE - 1), (4_000, TILE), (29_999, TILE + 1)):
        src.append(rng.choice(n, deg, replace=False))
        dst.append(np.full(deg, hub))
    g = GraphPAL.from_edges(np.concatenate(src), np.concatenate(dst),
                            n_partitions=8, max_id=n - 1)
    dg, dh = (psw.build_device_graph(g, device=dev) for dev in (cuda, "cpu"))
    x = (torch.from_numpy(rng.integers(-256, 256, (8, dh.interval_len, 2)))
         .float() / 64)

    def msg(s):
        return torch.stack([s[..., 0] - s[..., 1], 2 * s[..., 1],
                            s[..., 0]], -1)

    got = psw.edge_centric_sweep(dg, x.to(cuda), msg, mode)
    assert got.shape == (8, dh.interval_len, 3)
    assert torch.equal(got.cpu(), psw.edge_centric_sweep(dh, x, msg, mode))
    fused = psw.edge_centric_sweep(dg, x.to(cuda), None, mode)
    assert torch.equal(fused.cpu(), psw.edge_centric_sweep(dh, x, None, mode))
    assert torch.equal(psw.edge_centric_sweep(dg, x.to(cuda), lambda s: s,
                                              mode), fused)
    other = "psw_windows" if mode == "dense_gather" else "dense_gather"
    assert torch.equal(psw.edge_centric_sweep(dg, x.to(cuda), None, other),
                       fused)


def test_pagerank_device_counts_a_kernel_sweep_an_iteration(cuda):
    """Each of a 5-iteration `pagerank_device`'s sweeps on the card takes
    the kernel: `x.psw.sweep_kernel` rises by 5, and the kernels launch
    twice a sweep in psw_windows mode (exchange, sum) and once in
    dense_gather mode."""
    from repro_torch.core import GraphPAL, telemetry
    rng = np.random.default_rng(29)
    g = GraphPAL.from_edges(rng.integers(0, 5000, 40_000),
                            rng.integers(0, 5000, 40_000), n_partitions=4,
                            max_id=4999)
    dg = psw.build_device_graph(g, device=cuda)

    def swept() -> int:
        return int(telemetry.snapshot()["counters"].get(
            "x.psw.sweep_kernel", 0))

    was = telemetry.enabled()
    telemetry.set_enabled(True)
    try:
        for mode, per_sweep in (("psw_windows", 2), ("dense_gather", 1)):
            k0, n0 = swept(), psw_sweep.ops.launches
            psw.pagerank_device(dg, 5, mode=mode)
            assert swept() == k0 + 5, mode
            assert psw_sweep.ops.launches == n0 + 5 * per_sweep, mode
    finally:
        telemetry.set_enabled(was)


def test_psw_sweep_allocates_no_edge_sized_buffer(cuda):
    """One psw_windows sweep on a DeviceGraph allocates the window buffer
    and a few (P, L) float buffers, and no (P, E) index or float64 array:
    the peak over the sweep stays below recv's bytes plus four (P, L)
    float32 buffers, while one (P, E) int64 array alone is over 5x that
    margin."""
    from repro_torch.core import GraphPAL
    rng = np.random.default_rng(31)
    n = 200_000
    g = GraphPAL.from_edges(rng.integers(0, n, 4_000_000),
                            rng.integers(0, n, 4_000_000), n_partitions=16,
                            max_id=n - 1)
    dg = psw.build_device_graph(g, device=cuda)
    P, L, E = dg.n_partitions, dg.interval_len, dg.src.shape[1]
    x = torch.rand((P, L, 1), device=cuda)
    psw.edge_centric_sweep(dg, x)            # the library is loaded
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = psw.edge_centric_sweep(dg, x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    recv = P * P * dg.window_width * 4
    margin = 4 * P * L * 4
    assert P * E * 8 > 5 * margin
    assert extra <= recv + margin, (extra, recv, margin)
    assert out.shape == (P, L, 1)


def test_psw_spmm_empty_blocks_without_filler_tiles(cuda):
    """The tile API on the card: its tiles are compacted into a row layout
    on the device (equal to the CPU's), the kernel writes zeros for a dst
    block with no tiles at all, and unsorted coords raise."""
    rng = np.random.default_rng(3)
    coords = torch.tensor([[1, 0], [1, 2], [3, 1]], dtype=torch.int32)
    tiles = torch.from_numpy(
        (rng.random((3, 128, 128)) < 0.01).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3 * 128, 70)).astype(np.float32))
    before = ps.ops.launches
    got = ps.psw_spmm(coords.to(cuda), tiles.to(cuda), x.to(cuda), 5, 128)
    torch.cuda.synchronize()
    assert ps.ops.launches == before + 1
    want = ps.psw_spmm_torch(coords, tiles, x, 5, 128)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for b in (0, 2, 4):
        assert not got[b * 128:(b + 1) * 128].any()
    dev_lay = ps.compact_tiles(coords.to(cuda), tiles.to(cuda), 5, 128, 3)
    cpu_lay = ps.compact_tiles(coords, tiles, 5, 128, 3)
    for name in ("row_ptr", "col", "val"):
        assert torch.equal(getattr(dev_lay, name).cpu(),
                           getattr(cpu_lay, name))
    with pytest.raises(ValueError):      # not sorted by dst block
        ps.psw_spmm(coords.flip(0).to(cuda), tiles.to(cuda), x.to(cuda), 5,
                    128)


def test_psw_spmm_refused_launch_raises(cuda):
    """A launch the card refuses (grid.y > 65535 column slabs) raises, and
    a row layout on another device than x does too."""
    lay = ps.prepare_rows([0, 1], [1, 0], 2, device=cuda)
    F = 128 * 65536
    x = torch.zeros((2, F), device=cuda)
    out = torch.empty((2, F), device=cuda)
    scratch = torch.empty((0, F), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ps_kernel.launch(lay, x, out, scratch)
    with pytest.raises(ValueError):
        ps.psw_spmm_rows(lay, torch.zeros((2, 3)))


def randn(shape, dev, seed, dtype=torch.float32):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


FA_SHAPES = [(2, 256, 256, 4, 2),      # S == T, GQA
             (1, 1000, 1000, 8, 1),    # ragged S == T, MQA
             (2, 128, 512, 4, 4),      # S < T
             (1, 300, 77, 2, 1),       # S > T, both ragged
             (1, 200, 700, 4, 2)]      # S < T, S not a multiple of 128


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,t,h,hkv", FA_SHAPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, dtype, d, b, s, t, h, hkv,
                                       causal):
    q = randn((b, s, h, d), cuda, s + d, dtype)
    k = randn((b, t, hkv, d), cuda, t + d + 1, dtype)
    v = randn((b, t, hkv, d), cuda, t + d + 2, dtype)
    before = fa.ops.launches
    got = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.ops.launches == before + 1 and got.dtype == dtype
    want = fa.flash_attention_torch(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [16, 48, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_narrow_heads_and_strided_inputs(cuda, dtype, d):
    """D below the kernel's 64/128 build widths, and q, k, v read through
    the strides of one packed projection (B, S, H + 2 Hkv, D), plus a view
    whose base is off the 16-byte grid and k, v broadcast over the batch
    (both copied by the wrapper)."""
    B, S, H, Hkv = 2, 200, 4, 2
    packed = randn((B, S, H + 2 * Hkv, d), cuda, d, dtype)
    q, k, v = packed[:, :, :H], packed[:, :, H:H + Hkv], packed[:, :, H + Hkv:]
    assert not q.is_contiguous() and fa_kernel.vector_ready(q)
    got = fa.flash_attention(q, k, v, True)
    want = fa.flash_attention_torch(q, k, v, True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    flat = randn((B * S * H * d + 1,), cuda, 7, dtype)
    q_off = flat[1:].reshape(B, S, H, d)
    assert not fa_kernel.vector_ready(q_off)
    got = fa.flash_attention(q_off, k, v, False)
    want = fa.flash_attention_torch(q_off, k, v, False)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # k and v broadcast over the batch (stride 0): no tensor map takes a
    # zero stride, so the wrapper copies them
    kb, vb = (t[:1].expand(B, -1, -1, -1) for t in (k, v))
    assert not fa_kernel.vector_ready(kb)
    got = fa.flash_attention(q, kb, vb, True)
    want = fa.flash_attention_torch(q, kb, vb, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_refused_launch_raises(cuda):
    q = torch.zeros((65536, 1, 1, 16), device=cuda)     # grid.z > 65535
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa_kernel.launch(q, q, q, out, True)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                      # D = 8
        fa.flash_attention(*(torch.zeros((1, 4, 2, 8), device=cuda),) * 3)
    with pytest.raises(ValueError):                      # one device
        fa.flash_attention(q, q.cpu(), q)


def bags(B, K, V, rng, interior=0.0):
    """Left-padded histories (item 0, weight 0) of lengths 1..K, plus a
    share `interior` of the real slots with weight 0 on a random row."""
    lens = rng.integers(1, K + 1, B)
    real = np.arange(K)[None, :] >= (K - lens)[:, None]
    idx = np.where(real, rng.integers(1, V, (B, K)), 0)
    w = real * rng.random((B, K))
    w[rng.random((B, K)) < interior] = 0.0
    return idx, w.astype(np.float32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [1, 63, 64, 100, 300])
def test_embedding_bag_bitwise_equals_plain(cuda, d, mode):
    """B in {1, 511, 512, 513, 16,384} x K in {1, 37, 200}: left-padded
    histories with interior zero weights, int32 and int64 ids."""
    rng = np.random.default_rng(d)
    V = 20_000
    table_cpu = torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32))
    table = table_cpu.to(cuda)
    for B in (1, 511, 512, 513, 16_384):
        for K in (1, 37, 200):
            idx, w = bags(B, K, V, rng, interior=0.1)
            w_t = torch.from_numpy(w).to(cuda)
            want = eb.embedding_bag_torch(torch.from_numpy(idx).to(cuda),
                                          w_t, table)
            if mode == "mean":
                want = want / torch.clamp_min(w_t.sum(1, keepdim=True), 1e-9)
            for dtype in (torch.int32, torch.int64):
                idx_t = torch.from_numpy(idx).to(dtype).to(cuda)
                before = eb.ops.launches
                got = eb.embedding_bag(idx_t, w_t, table, mode=mode)
                torch.cuda.synchronize()
                assert eb.ops.launches == before + 1
                assert torch.equal(got, want), (B, K, dtype)
            if B <= 513:
                cpu = eb.embedding_bag(idx_t.cpu(), w_t.cpu(), table_cpu,
                                       mode=mode)
                torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("poison", [float("inf"), float("-inf"),
                                    float("nan")])
@pytest.mark.parametrize("d", [1, 64, 100])
def test_embedding_bag_non_finite_padding_row(cuda, poison, d):
    """Weight-0 slots on a row holding inf or NaN give the plain version's
    NaN columns: the kernel's skip of repeated weight-0 rows is exact, at
    600 bags (few warps: many loads in flight each) and 4,096 (more warps
    than 16 a SM: fewer loads in flight each)."""
    rng = np.random.default_rng(7)
    V = 1000
    table = torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32))
    table[0, ::2] = poison                   # the padding row
    table[5, 1::3] = poison                  # an interior weight-0 row
    table = table.to(cuda)
    for B in (600, 4096):
        idx, w = bags(B, 200, V, rng)
        idx[:, 150::7] = 5
        w[:, 150::7] = 0.0
        idx_t = torch.from_numpy(idx).to(cuda)
        w_t = torch.from_numpy(w).to(cuda)
        got = eb.embedding_bag(idx_t, w_t, table)
        want = eb.embedding_bag_torch(idx_t, w_t, table)
        assert want.isnan().any()
        assert torch.equal(got.isnan(), want.isnan()), B
        assert torch.equal(got[~want.isnan()], want[~want.isnan()]), B


@pytest.mark.parametrize("bad_id", [20_000, -1, 2**32 + 1])
def test_embedding_bag_out_of_range_ids_raise(cuda, bad_id):
    """The kernel reads no row outside [0, V): the slot adds nothing and the
    error word is set; the wrapper raises, and later calls are bitwise."""
    rng = np.random.default_rng(3)
    V, D = 20_000, 64
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)
                             ).to(cuda)
    idx, w = bags(512, 200, V, rng)
    idx_t = torch.from_numpy(idx).to(cuda)
    w_t = torch.from_numpy(w).to(cuda)
    bad = idx_t.clone()
    bad[100, 199] = bad_id
    if bad_id < 2**31:
        bad32 = bad.int()
        w_off = w_t.clone()
        w_off[100, 199] = 0.0
        # the error word on the card, or pinned on the host (the wrapper's)
        for err in (torch.zeros(1, dtype=torch.int32, device=cuda),
                    torch.zeros(1, dtype=torch.int32, pin_memory=True)):
            out = torch.empty((512, D), device=cuda)
            eb_kernel.launch(bad32, w_t, table, out, err)
            torch.cuda.synchronize()
            assert err.tolist() == [1]
            assert torch.equal(out, eb.embedding_bag_torch(idx_t, w_off,
                                                           table))
    for dtype in (torch.int32, torch.int64):
        if bad_id >= 2**31 and dtype == torch.int32:
            continue
        with pytest.raises(ValueError, match="ids must lie"):
            eb.embedding_bag(bad.to(dtype), w_t, table)
        assert all(word.tolist() == [0]
                   for word in eb.ops._error_words.values())
        got = eb.embedding_bag(idx_t.to(dtype), w_t, table)
        assert torch.equal(got, eb.embedding_bag_torch(idx_t, w_t, table))


def test_embedding_bag_refused_launch_raises(cuda):
    idx = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    w = torch.ones((1, 1), device=cuda)
    table = torch.zeros((1, 128 * 65536), device=cuda)   # grid.y > 65535
    out = torch.empty((1, 128 * 65536), device=cuda)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        eb_kernel.launch(idx, w, table, out, err)
    with pytest.raises(ValueError, match="pinned"):
        eb_kernel.launch(idx, w, table[:, :8], out[:, :8],
                         torch.zeros(1, dtype=torch.int32))
    empty = eb.embedding_bag(idx[:0], w[:0], table[:, :8])
    assert tuple(empty.shape) == (0, 8)
    with pytest.raises(TypeError):
        eb.embedding_bag(idx, w, table[:, :8].bfloat16())


def test_reopened_graphdb_dense_hops_and_snapshot_on_the_card(cuda,
                                                              tmp_path):
    """A small GraphDB built on disk, closed and reopened: its dense
    two_hop and khop on the card (frontier_expand) are bitwise equal to
    `device="cpu"` (the plain version), and its snapshot's arrays and
    PageRank on the card equal the CPU snapshot's."""
    from repro_torch.core import GraphDB, khop, two_hop_counts
    rng = np.random.default_rng(17)
    path = str(tmp_path / "db")
    db = GraphDB.create(path, max_id=4999, n_partitions=16, n_levels=3,
                        branching=4, buffer_cap=2000, max_partition_edges=8000,
                        persist_min_edges=512)
    for _ in range(5):
        db.insert_edges(rng.integers(0, 5000, 6000),
                        rng.integers(0, 5000, 6000))
    db.close()
    db = GraphDB.open(path)
    db.insert_edges(rng.integers(0, 5000, 500), rng.integers(0, 5000, 500))
    assert db._disk_partitions()
    seeds = rng.choice(5000, 96, replace=False)
    n0 = ops.launches
    on_card = two_hop_counts(db, seeds, dense="kernel", device=cuda)
    assert ops.launches > n0
    plain = two_hop_counts(db, seeds, dense="kernel", device="cpu")
    for f in ("offsets", "ids", "counts"):
        assert np.array_equal(getattr(on_card, f), getattr(plain, f)), f
    kc = khop(db, seeds[:8], 3, dense="kernel", device=cuda)
    kp = khop(db, seeds[:8], 3, dense="kernel", device="cpu")
    assert len(kc.levels) == len(kp.levels)
    assert all(np.array_equal(a, b) for a, b in zip(kc.levels, kp.levels))
    dg, dh = db.snapshot(device=cuda), db.snapshot(device="cpu")
    for f in ("src", "dst_local", "mask", "outdeg", "send_idx", "edge_owner",
              "edge_slot", "seg_ptr"):
        assert torch.equal(getattr(dg, f).cpu(), getattr(dh, f)), f
    for mode in ("dense_gather", "psw_windows"):
        assert torch.equal(psw.pagerank_device(dg, 5, mode=mode).cpu(),
                           psw.pagerank_device(dh, 5, mode=mode))


@pytest.mark.parametrize("exclude", [True, False])
def test_dense_two_hop_assembled_on_the_card_equals_cpu(cuda, exclude):
    """A 256-seed dense two_hop (two seed blocks, with a hub and repeated
    seeds): the answer assembled on the card (friend exclusion by a gather
    from the hop-1 panel, the id map and the sort there, one copy back) is
    bitwise the `device="cpu"` one, as int64 numpy arrays."""
    from repro_torch.core import GraphPAL, two_hop_counts
    rng = np.random.default_rng(41)
    n = 20_000
    src, dst = rng.integers(0, n, 300_000), rng.integers(0, n, 300_000)
    src = np.concatenate([src, np.full(5000, 11), rng.integers(0, n, 5000)])
    dst = np.concatenate([dst, rng.integers(0, n, 5000), np.full(5000, 11)])
    g = GraphPAL.from_edges(src, dst, n_partitions=16, max_id=n - 1)
    seeds = rng.choice(n, 256, replace=False)
    seeds[[3, 200]] = 11                              # the hub, twice
    n0 = ops.launches
    on_card = two_hop_counts(g, seeds, dense="kernel", device=cuda,
                             exclude=exclude)
    assert ops.launches - n0 == 4
    plain = two_hop_counts(g, seeds, dense="kernel", device="cpu",
                           exclude=exclude)
    assert on_card.ids.shape[0] > 0
    for f in ("offsets", "ids", "counts"):
        a = getattr(on_card, f)
        assert isinstance(a, np.ndarray) and a.dtype == np.int64, f
        assert np.array_equal(a, getattr(plain, f)), f


def test_service_read_views_dense_under_a_writer_on_the_card(cuda,
                                                             tmp_path):
    """A live ServiceDB with a writer thread and its maintenance pipeline
    running: two reader threads each pin a `read_view()` and run dense
    `two_hop_counts` and `khop` through frontier_expand on the card, each
    bitwise equal to the sparse host path on the same view, on a first
    view and on a second one pinned after the writer published again.
    The module's launch count is exactly the launches the two threads
    made, counted apart in each thread."""
    import threading
    import time
    from repro_torch.core import ServiceDB, khop, two_hop_counts
    from repro_torch.kernels import frontier_expand as fe
    rng = np.random.default_rng(23)
    svc = ServiceDB.create(str(tmp_path / "svc"), max_id=19_999,
                           n_partitions=8, n_levels=2, branching=4,
                           buffer_cap=4000, max_partition_edges=50_000,
                           persist_min_edges=512)
    counts = fe.frontier_expand_counts
    per_thread = threading.local()

    def counted(plan, x):
        if x.device.type == "cuda" and plan.n_dst * x.shape[1]:
            per_thread.n = getattr(per_thread, "n", 0) + 1
        return counts(plan, x)

    try:
        svc.insert_edges(rng.integers(0, 20_000, 60_000),
                         rng.integers(0, 20_000, 60_000))
        stop, published = threading.Event(), [0]
        made, errors, versions = [0, 0], [], [[], []]

        def writer():
            w = np.random.default_rng(24)
            try:
                while not stop.is_set():
                    svc.insert_edges(w.integers(0, 20_000, 1000),
                                     w.integers(0, 20_000, 1000))
                    published[0] += 1
            except Exception as exc:                   # surfaced below
                errors.append(exc)

        def reader(i):
            try:
                seeds = np.random.default_rng(30 + i).choice(20_000, 150,
                                                             replace=False)
                for _ in range(2):
                    at = published[0]
                    with svc.read_view() as view:
                        versions[i].append(view.version)
                        d2 = two_hop_counts(view, seeds, dense="kernel",
                                            device=cuda)
                        s2 = two_hop_counts(view, seeds)
                        dk = khop(view, seeds[:8], 3, dense="kernel",
                                  device=cuda)
                        sk = khop(view, seeds[:8], 3)
                    for name in ("offsets", "ids", "counts"):
                        assert np.array_equal(getattr(d2, name),
                                              getattr(s2, name)), name
                    assert len(dk.levels) == len(sk.levels)
                    assert all(np.array_equal(a, b)
                               for a, b in zip(dk.levels, sk.levels))
                    give_up = time.monotonic() + 60    # a new publication
                    while published[0] == at and time.monotonic() < give_up:
                        time.sleep(0.01)
                made[i] = getattr(per_thread, "n", 0)
            except Exception as exc:                   # surfaced below
                errors.append(exc)

        fe.frontier_expand_counts = counted
        ops.launches = 0
        w = threading.Thread(target=writer)
        readers = [threading.Thread(target=reader, args=(i,))
                   for i in range(2)]
        w.start()
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=300)
        stop.set()
        w.join(timeout=60)
        assert not any(t.is_alive() for t in readers + [w])
        assert not errors, errors
        assert ops.launches == sum(made) and min(made) > 0
        for vs in versions:
            assert vs[1] > vs[0]
    finally:
        fe.frontier_expand_counts = counts
        svc.close()


def test_prepare_rows_takes_device_tensors_as_they_are(cuda):
    """Ids already on the card (a GNN batch's) build the layout that the
    same ids give as numpy arrays, with no host round trip."""
    rng = np.random.default_rng(25)
    src, dst = rng.integers(0, 5000, 40_000), rng.integers(0, 5000, 40_000)
    dst[:3000] = 11                                    # a chunked hub row
    want = ps.prepare_rows(src, dst, 5000, device=cuda)
    for dtype in (torch.int64, torch.int32):
        s = torch.from_numpy(src).to(cuda, dtype)
        d = torch.from_numpy(dst).to(cuda, dtype)
        got = ps.prepare_rows(s, d, 5000)              # None: x's card
        for name in ("row_ptr", "col", "val", "hub_rows", "hub_ptr",
                     "chunks"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b), name


def test_gin_sampled_batch_on_the_card_matches_plain(cuda, monkeypatch):
    """GIN at its full width (5 layers, d 64) on a sampled minibatch: the
    neighbour sum through the psw_spmm kernel (one layout, one launch a
    layer) against the same forward through its plain version on the card
    and on the CPU. The kernel's rowwise 1e-5 is held at the logits as
    1e-4."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.core import GraphPAL
    from repro_torch.graph import NeighborSampler
    from repro_torch.models.gnn import gin
    rng = np.random.default_rng(26)
    n, e = 20_000, 300_000
    src = rng.integers(0, n, e)
    hot = ((rng.zipf(1.8, e) - 1) * 2654435761) % n
    dst = np.where(rng.random(e) < 0.5, hot, rng.integers(0, n, e))
    g = GraphPAL.from_edges(src, dst, n_partitions=8, max_id=n - 1)
    sub = NeighborSampler(g, seed=26).sample(
        rng.choice(n, 128, replace=False), (15, 10))
    feats = torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32))
    cfg = dataclasses.replace(gin.GINConfig(), d_in=32, n_classes=7,
                              readout="node")
    params = gin.init_params(torch.Generator().manual_seed(26), cfg, "cpu")

    def batch(dev):
        nodes = torch.from_numpy(sub.nodes).to(dev)
        return {"x": feats.to(dev)[nodes], "src": torch.from_numpy(
                    sub.src).to(dev), "dst": torch.from_numpy(sub.dst).to(dev),
                "edge_mask": torch.from_numpy(sub.edge_mask).to(dev),
                "node_mask": torch.from_numpy(sub.node_mask).to(dev)}

    on_card = convert.gnn_params_from_arrays(
        convert.gnn_params_to_arrays(params), params, cuda)
    before = ps.ops.launches
    got = gin.forward(on_card, batch(cuda), cfg)
    torch.cuda.synchronize()
    assert ps.ops.launches == before + cfg.n_layers
    monkeypatch.setattr(gin, "psw_spmm_rows", lambda lay, x:
                        ps.psw_spmm_rows_torch(lay.row_ptr, lay.col, lay.val,
                                               x, lay.block))
    plain = gin.forward(on_card, batch(cuda), cfg)
    torch.cuda.synchronize()
    assert ps.ops.launches == before + cfg.n_layers
    cpu = gin.forward(params, batch("cpu"), cfg)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_rows,n_src,f", [(3000, 3000, 64),
                                             (3000, 4000, 6272)])
def test_psw_spmm_rows_refuses_a_gradient_on_the_card(cuda, n_rows, n_src,
                                                      f):
    """The backward on the card: dx = A^T g launches the same kernel over
    `transpose_rows(layout)`, built on the card (equal to `prepare_rows`
    of the swapped edges, hub chunks included, and cached), within
    rowwise 1e-5 of the plain version over that transpose and 1e-4 of
    the edge oracle, at GIN's width and at EquiformerV2's scatter width
    (F = 6,272, sources the edge ids: a rectangular layout); a source hub
    of 300 destinations is a hub row of the transpose."""
    rng = np.random.default_rng(n_src + f)
    e = 12000
    src, dst = rng.integers(0, n_src, e), rng.integers(0, n_rows, e)
    src[:300], dst[:100] = 5, 7              # hubs of A^T and of A
    lay = ps.prepare_rows(src, dst, n_rows, device=cuda, n_src=n_src)
    x = torch.from_numpy(rng.standard_normal((n_src, f)).astype(
        np.float32)).to(cuda).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((n_rows, f)).astype(
        np.float32)).to(cuda)
    before = ps.ops.launches
    dx, = torch.autograd.grad(ps.psw_spmm_rows(lay, x), x, g)
    torch.cuda.synchronize()
    assert ps.ops.launches == before + 2
    t = ps.transpose_rows(lay)
    assert lay.cache["transpose"] is t and 5 in t.hub_rows.tolist()
    want_t = ps.prepare_rows(dst, src, n_src, device=cuda, n_src=n_rows)
    for name in ("row_ptr", "col", "val", "hub_rows", "hub_ptr", "chunks"):
        assert torch.equal(getattr(t, name), getattr(want_t, name)), name
    plain = ps.psw_spmm_rows_torch(t.row_ptr, t.col, t.val, g, t.block)
    assert_rows_close(dx, plain, 1e-5)
    oracle = ps.spmm_dense_torch(torch.from_numpy(dst).to(cuda),
                                 torch.from_numpy(src).to(cuda), g, n_src)
    assert_rows_close(dx, oracle, 1e-4)


def train_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: train_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [train_tree(v, fn) for v in tree]
    return fn(tree)


def leaf_grads(loss_fn, params):
    """(loss, gradients in tree order) with every leaf of `params` a leaf
    that needs a gradient."""
    leaves = torch.utils._pytree.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss = loss_fn(params)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_loss_fn_gradient_on_the_card_matches_cpu(cuda):
    """granite-3-2b's smoke config (fp32, 2 layers, D 16) at 2 x 600
    tokens, remat "full": the loss and every gradient on the card (the
    kernel forward in each layer and its recompute, the backward by
    query chunks of 512) within 1e-4 of the CPU's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(configs.get_arch("granite-3-2b").smoke_config,
                              remat="full")
    params = tf.init_params(cfg, torch.Generator().manual_seed(29), "cpu")
    rng = np.random.default_rng(29)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 600)))
             for k in ("tokens", "labels")}
    before = fa.ops.launches
    loss, grads = leaf_grads(lambda p: tf.loss_fn(
        p, {k: v.to(cuda) for k, v in batch.items()}, cfg),
        train_tree(params, lambda t: t.to(cuda)))
    torch.cuda.synchronize()
    assert fa.ops.launches == before + 2 * cfg.n_layers
    want, want_g = leaf_grads(lambda p: tf.loss_fn(p, batch, cfg), params)
    assert torch.isfinite(loss)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-4, atol=1e-4)
    for got, w in zip(grads, want_g):
        torch.testing.assert_close(got.cpu(), w, rtol=1e-4, atol=1e-4)


def test_bert4rec_gradient_on_the_card_matches_cpu(cuda):
    """bert4rec at its full width over a 50,000-item table: the masked-item
    loss of 64 histories (40 masked slots, vocab chunks of 8,192) and
    every parameter's gradient on the card within 1e-4 of the CPU's."""
    from repro_torch.models import bert4rec
    cfg = bert4rec.Bert4RecConfig(n_items=50_000)
    params = bert4rec.init_params(torch.Generator().manual_seed(30), cfg,
                                  "cpu")
    rng = np.random.default_rng(30)
    seq = rng.integers(1, cfg.n_items + 1, (64, cfg.seq_len))
    mpos = np.stack([rng.choice(cfg.seq_len, 40, replace=False)
                     for _ in range(64)])
    labels = np.take_along_axis(seq, mpos, 1)
    labels[:, 35:] = 0
    np.put_along_axis(seq, mpos, cfg.vocab - 1, 1)
    batch = {"item_seq": torch.from_numpy(seq),
             "masked_positions": torch.from_numpy(mpos),
             "labels": torch.from_numpy(labels)}
    loss, grads = leaf_grads(lambda p: bert4rec.masked_lm_loss(
        p, {k: v.to(cuda) for k, v in batch.items()}, cfg, 8192),
        train_tree(params, lambda t: t.to(cuda)))
    want, want_g = leaf_grads(lambda p: bert4rec.masked_lm_loss(
        p, batch, cfg, 8192), params)
    assert torch.isfinite(loss)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-4, atol=1e-4)
    for got, w in zip(grads, want_g):
        torch.testing.assert_close(got.cpu(), w, rtol=1e-4, atol=1e-4)
    assert float(grads[0].abs().sum()) > 0          # item_embed


def test_psw_spmm_at_equiformer_width_with_a_hub(cuda):
    """EquiformerV2's message scatter shape: F = 6,272 (49 irreps x 128
    channels, 49 of the kernel's 128-column slabs), sources the edge ids
    (n_src = E, not n, some edges left out as masked), and destination 5
    given 300 edges: a hub row, so its chunks go through the (n_chunks, F)
    scratch and pass 2."""
    rng = np.random.default_rng(27)
    n, E, F = 3000, 4000, 6272
    dst = rng.integers(0, n, E)
    dst[:300] = 5
    live = np.flatnonzero(rng.random(E) < 0.9)
    msg = torch.from_numpy(rng.standard_normal((E, F)).astype(np.float32)
                           ).to(cuda)
    lay = ps.prepare_rows(live, dst[live], n, device=cuda, n_src=E)
    assert lay.n_src == E and 5 in lay.hub_rows.tolist()
    before = ps.ops.launches
    got = ps.psw_spmm_rows(lay, msg)
    torch.cuda.synchronize()
    assert ps.ops.launches == before + 1
    assert torch.equal(got, ps.psw_spmm_rows(lay, msg))
    plain = ps.psw_spmm_rows_torch(lay.row_ptr, lay.col, lay.val, msg,
                                   lay.block)
    assert_rows_close(got, plain, 1e-5)
    # where index_add_ adds in index order (deterministic algorithms), the
    # plain version adds a row's block partials as the kernel does:
    # bitwise equal off the hub
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ordered = ps.psw_spmm_rows_torch(lay.row_ptr, lay.col, lay.val, msg,
                                         lay.block)
    finally:
        torch.use_deterministic_algorithms(was)
    rest = torch.ones(n, dtype=torch.bool, device=cuda)
    rest[lay.hub_rows] = False
    assert torch.equal(got[rest], ordered[rest])
    d = torch.from_numpy(dst[live]).to(cuda)
    edge = torch.zeros((n, F), dtype=torch.float64, device=cuda).index_add_(
        0, d, msg[torch.from_numpy(live).to(cuda)].double())
    assert_rows_close(got, edge, 1e-4)


def test_equiformer_sampled_batch_on_the_card_matches_plain(cuda,
                                                            monkeypatch):
    """EquiformerV2 at a narrow width (2 layers, d 16, the published l_max
    6, m_max 2; 4 heads) on a sampled minibatch, psw_ring on one rank in
    2 edge chunks: the message scatter through the psw_spmm kernel (one
    layout a chunk, one launch a chunk and layer) against the same
    forward through its plain version on the card, bitwise under
    deterministic algorithms; and the take-mode forward on the card
    against the CPU's at 1e-4. Positions are unit-ball draws a vertex,
    species a hash of its id, as chip_smoke.py's phase 12 makes them."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.core import GraphPAL
    from repro_torch.graph import NeighborSampler
    from repro_torch.models.gnn import equiformer_v2 as eq
    rng = np.random.default_rng(28)
    n, e = 20_000, 300_000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    g = GraphPAL.from_edges(src, dst, n_partitions=8, max_id=n - 1)
    sub = NeighborSampler(g, seed=28).sample(
        rng.choice(n, 64, replace=False), (15, 10))
    u = rng.standard_normal((n, 3))
    pos = (u / np.linalg.norm(u, axis=1, keepdims=True)
           * rng.random((n, 1)) ** (1 / 3)).astype(np.float32)
    species = (np.arange(n) * 2654435761 % 2**32 % 128).astype(np.int64)
    cfg = eq.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=6, m_max=2,
                                n_heads=4, n_species=128, d_out=41,
                                edge_chunks=2, gather_mode="psw_ring")
    params = eq.init_params(torch.Generator().manual_seed(28), cfg, "cpu")

    def batch(dev):
        nodes = sub.nodes
        return {"species": torch.from_numpy(species[nodes]).to(dev),
                "pos": torch.from_numpy(pos[nodes]).to(dev),
                "src": torch.from_numpy(sub.src).to(dev),
                "dst": torch.from_numpy(sub.dst).to(dev),
                "edge_mask": torch.from_numpy(sub.edge_mask).to(dev),
                "node_mask": torch.from_numpy(sub.node_mask).to(dev)}

    on_card = convert.gnn_params_from_arrays(
        convert.gnn_params_to_arrays(params), params, cuda)
    # card against CPU in take mode: float32 throughout, so another order
    # of addition on the card moves logits by float32 ulps only
    take = dataclasses.replace(cfg, gather_mode="take")
    with torch.no_grad():
        card = eq.forward(on_card, batch(cuda), take)
        cpu = eq.forward(params, batch("cpu"), take)
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-4, atol=1e-4)
    # kernel against plain in psw_ring mode, x in bf16 through the ring:
    # under deterministic algorithms index_add_ adds in index order, so
    # the plain scatter adds as the kernel does and no bf16 rounding of x
    # can flip between the two forwards
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        before = ps.ops.launches
        with torch.no_grad():
            got = eq.forward(on_card, batch(cuda), cfg)
            torch.cuda.synchronize()
            assert (ps.ops.launches
                    == before + cfg.n_layers * cfg.edge_chunks)
            monkeypatch.setattr(eq, "psw_spmm_rows", lambda lay, x:
                                ps.psw_spmm_rows_torch(lay.row_ptr, lay.col,
                                                       lay.val, x, lay.block))
            plain = eq.forward(on_card, batch(cuda), cfg)
            torch.cuda.synchronize()
            assert (ps.ops.launches
                    == before + cfg.n_layers * cfg.edge_chunks)
    finally:
        torch.use_deterministic_algorithms(was)
    assert tuple(got.shape) == (sub.nodes.shape[0], 41)
    assert torch.isfinite(got).all()
    assert torch.equal(got, plain)


def test_moe_prefill_on_the_card_matches_cpu(cuda):
    """qwen3-moe's smoke config (fp32, 8 experts, top-2) prefilled on the
    card, its attention through the flash_attention kernel (one launch a
    layer) and its MoE dispatch on the card, against the same prefill on
    the CPU: last-token logits and the caches within 1e-4."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.get_arch("qwen3-moe-235b-a22b").smoke_config
    params = tf.init_params(cfg, torch.Generator().manual_seed(27), "cpu")
    on_card = tf._map(params, lambda t: t.to(cuda))
    toks = torch.from_numpy(np.random.default_rng(27).integers(
        0, cfg.vocab_size, (2, 256)))
    before = fa.ops.launches
    with torch.no_grad():
        got, cache = tf.prefill(on_card, toks.to(cuda), cfg, 264,
                                cache_dtype=torch.float32)
        torch.cuda.synchronize()
        assert fa.ops.launches == before + cfg.n_layers
        want, cache_cpu = tf.prefill(params, toks, cfg, 264,
                                     cache_dtype=torch.float32)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name].cpu(), cache_cpu[name],
                                   rtol=1e-4, atol=1e-4)


def test_bert4rec_scores_on_the_card_match_cpu(cuda):
    """bert4rec at its full width (d 64, 2 blocks, 2 heads, 200 slots) over
    a 50,000-item table: `score_all_items` and `score_candidates` of 16
    left-padded histories on the card within 1e-4 of the CPU's."""
    from repro_torch.models import bert4rec
    cfg = bert4rec.Bert4RecConfig(n_items=50_000)
    params = bert4rec.init_params(torch.Generator().manual_seed(28), cfg,
                                  "cpu")
    on_card = {k: [{n: t.to(cuda) for n, t in b.items()} for b in v]
               if k == "blocks" else v.to(cuda) for k, v in params.items()}
    rng = np.random.default_rng(28)
    lens = rng.integers(1, cfg.seq_len + 1, 16)
    seq = rng.integers(1, cfg.n_items + 1, (16, cfg.seq_len))
    seq[np.arange(cfg.seq_len)[None, :] < (cfg.seq_len - lens)[:, None]] = 0
    seq = torch.from_numpy(seq)
    cand = torch.from_numpy(rng.choice(cfg.n_items, 1000, replace=False) + 1)
    with torch.no_grad():
        got = bert4rec.score_all_items(on_card, seq.to(cuda), cfg)
        got_c = bert4rec.score_candidates(on_card, seq.to(cuda),
                                          cand.to(cuda), cfg)
        want = bert4rec.score_all_items(params, seq, cfg)
    assert got.shape == (16, cfg.padded_vocab) and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_c.cpu(), want[:, cand], rtol=1e-4,
                               atol=1e-4)
