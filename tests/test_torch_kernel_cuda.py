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
whose terms cancel, and bitwise equal across runs; the PSW sweep's segment-sum is bitwise equal across runs and
within 1e-6 of a float64 sum; flash_attention is rtol/atol 2e-5 against its
plain version in float32 (TestFlashAttention's tolerance: the fp32 SIMT
kernel and cuBLAS sum in another order) and 2e-2 in bfloat16 (test_bf16's:
the kernel rounds P to bf16 for P·V, on wgmma + TMA); embedding_bag is bitwise (both add
w·row in slot order, rounded twice in fp32; where a row holds inf or NaN, the NaN
columns are compared as a mask, since NaN != NaN). A small reopened on-disk
`GraphDB`'s dense hops and snapshot on the card are bitwise equal to
`device="cpu"`."""
import numpy as np
import pytest
import torch

from repro_torch.core import psw
from repro_torch.graph import pad_to_ell
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import psw_spmm as ps
from repro_torch.kernels import segment_ell as se
from repro_torch.kernels.frontier_expand import (build_frontier_plan,
                                                 frontier_expand_counts,
                                                 frontier_expand_torch,
                                                 ops, plan_to_device)
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.psw_spmm import kernel as ps_kernel

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


@pytest.mark.parametrize("b", [1, 5, 31, 32, 64, 128, 130])
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
    plan, _ = plan_and_panel(3000, 30000, 1, 8000, 32, seed=b)
    x = sparse_panel(3000, b, kind, seed=b + 1)
    dplan = plan_to_device(plan, cuda)
    got = frontier_expand_counts(dplan, x.to(cuda))
    want = frontier_expand_torch(dplan.idx, dplan.mask, x.to(cuda),
                                 dplan.row_dst, dplan.n_dst)
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
    plan = plan_to_device(build_frontier_plan(src, dst, n, n), cuda)
    assert 11 in plan.heavy_dst.tolist()
    h = plan.heavy_dst.tolist().index(11)
    assert int(plan.heavy_ptr[h + 1] - plan.heavy_ptr[h]) >= \
        12000 // plan.chunk_edges
    x = (torch.rand((n, b), device=cuda) < 0.5).to(torch.float32)
    got = frontier_expand_counts(plan, x)
    want = frontier_expand_torch(plan.idx, plan.mask, x, plan.row_dst, n)
    assert torch.equal(got, want)
    assert torch.equal(frontier_expand_counts(plan, x), got)
    assert int(got[11].max()) > 4000


@pytest.mark.parametrize("b", [32, 128])
def test_frontier_unaligned_panel_takes_the_scalar_path(cuda, b):
    """x whose data_ptr is 4 mod 16 (contiguous, B % 4 == 0)."""
    plan, x = plan_and_panel(3000, 30000, b, 5000, 32, seed=7)
    dplan = plan_to_device(plan, cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x.to(cuda))
    assert xs.data_ptr() % 16 == 4
    got = frontier_expand_counts(dplan, xs)
    assert torch.equal(got, frontier_expand_torch(
        dplan.idx, dplan.mask, xs, dplan.row_dst, dplan.n_dst))


def test_empty_plan_and_bad_inputs(cuda):
    plan = plan_to_device(build_frontier_plan(
        np.empty(0, np.int64), np.empty(0, np.int64), 10, 12), cuda)
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
    """The PSW sweep's float64 scan gives the same bits on every run, for a
    single partition (one scan row per block total) and for a hub segment
    of up to 2**24 edges, and sums to float64 accuracy."""
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
    first = psw.segment_sum_sorted(msgs, seg_ptr)
    for _ in range(3):
        assert torch.equal(psw.segment_sum_sorted(msgs, seg_ptr), first)
    want = torch.zeros((P, L, 1), dtype=torch.float64, device=cuda)
    want.index_add_(1, dst, msgs.double())
    torch.testing.assert_close(first, want.float(), rtol=1e-6, atol=1e-6)


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
