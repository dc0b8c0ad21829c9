"""The port's PSW analytics (repro_torch/core/psw.py) against the reference's
(repro/core/psw.py), on the CPU, on the same edges: a bulk `GraphPAL`, a
live `LSMTree` fed the same insert and delete batches (flushed levels,
tombstones, a buffered tail) and its pinned `read_view()`.

Tolerances: `DeviceGraph` arrays, host PSW results and the port's own
store-vs-store and mode-vs-mode comparisons are exact (the same integer
arrays, or the same float operations in the same order). Device PageRank
against the reference's is rtol 1e-5, atol 1e-6: the reference sums each
destination in float32 with `segment_sum`, the port in float64 rounded once
to float32, so the two differ by float32 rounding only. The sweep over
four gloo ranks (`DeviceGraph.shard`, `group=`) is bitwise the one-device
sweep in both modes, and within the message test's 1e-5 of the
reference's `shard_map` over four host devices. The CPU segment sum is a
float64 `index_add_` in edge order, bitwise, whatever the padding."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as R
from repro.core import psw as rpsw
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import psw as tpsw
from repro_torch.core import telemetry
from repro_torch.kernels import psw_sweep
from test_torch_multihop import N, bulk, live

FIELDS = ("src", "dst_local", "mask", "outdeg", "send_idx", "edge_owner",
          "edge_slot")
MODES = ("dense_gather", "psw_windows")


def same_device_graph(ref, port, fields=FIELDS):
    assert (ref.n_partitions, ref.interval_len, ref.n_edges) == (
        port.n_partitions, port.interval_len, port.n_edges)
    for name in fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(port, name).cpu().numpy()
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def same_tensors(a, b, fields=FIELDS + ("seg_ptr",)):
    for name in fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("store", ["pal", "lsm", "view"])
@pytest.mark.parametrize("window", [True, False])
def test_device_graph_arrays_match_reference(store, window):
    kw = {"with_window_plan": window}
    fields = FIELDS if window else FIELDS[:4]
    if store == "pal":
        same_device_graph(rpsw.build_device_graph(bulk(R, 0), **kw),
                          T.build_device_graph(bulk(T, 0), device="cpu", **kw),
                          fields)
        return
    rt, tt = live(R, 1), live(T, 1)
    if store == "lsm":
        same_device_graph(rt.snapshot(**kw),
                          tt.snapshot(device="cpu", **kw), fields)
        return
    with rt.read_view() as rv, tt.read_view() as tv:
        same_device_graph(rv.snapshot(**kw), tv.snapshot(device="cpu", **kw),
                          fields)
        if not window:
            assert tv.snapshot(device="cpu", **kw).send_idx is None


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("store", ["pal", "lsm"])
def test_pagerank_device_matches_reference(store, mode):
    if store == "pal":
        rdg = rpsw.build_device_graph(bulk(R, 2))
        tdg = T.build_device_graph(bulk(T, 2), device="cpu")
    else:
        rdg, tdg = live(R, 3).snapshot(), live(T, 3).snapshot(device="cpu")
    want = np.asarray(rpsw.pagerank_device(rdg, n_iters=5, mode=mode))
    got = T.pagerank_device(tdg, n_iters=5, mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # both modes gather the same values and reduce them the same way
    other = MODES[1 - MODES.index(mode)]
    assert torch.equal(got, T.pagerank_device(tdg, n_iters=5, mode=other))


def test_lsm_snapshot_is_bit_identical_to_pal():
    t = live(T, 4)
    s, d = t.to_coo()
    g = T.GraphPAL.from_edges(s, d, n_partitions=16, max_id=N - 1)
    dg_pal = T.build_device_graph(g, device="cpu")
    dg_lsm = t.snapshot(device="cpu")
    same_tensors(dg_lsm, dg_pal)
    with t.read_view() as view:
        dg_view = view.snapshot(device="cpu")
    same_tensors(dg_view, dg_pal)
    for mode in MODES:
        r = T.pagerank_device(dg_pal, mode=mode)
        assert torch.equal(T.pagerank_device(dg_lsm, mode=mode), r)
        assert torch.equal(T.pagerank_device(dg_view, mode=mode), r)
    # a snapshot is read-only: the buffered tail is still buffered
    assert t.total_buffered() > 0 and dg_lsm.n_edges == t.n_edges


@pytest.mark.parametrize("store", ["pal", "lsm", "view"])
def test_host_psw_matches_reference_bitwise(store):
    if store == "pal":
        r, p = bulk(R, 5), bulk(T, 5)
    else:
        r, p = live(R, 5), live(T, 5)
    if store == "view":
        with r.read_view() as rv, p.read_view() as pv:
            check_host_psw(rv, pv, pagerank=False)
        return
    check_host_psw(r, p, pagerank=True)


def check_host_psw(r, p, pagerank: bool):
    rb = list(rpsw.stream_interval_buckets(r))
    pb = list(tpsw.stream_interval_buckets(p))
    assert len(rb) == len(pb)
    for (i, s, d), (j, s2, d2) in zip(rb, pb):
        assert i == j and np.array_equal(s, s2) and np.array_equal(d, d2)
    assert np.array_equal(rpsw.pagerank_out_of_core(r, n_iters=4),
                          tpsw.pagerank_out_of_core(p, n_iters=4))
    if not pagerank:
        return
    # pagerank_host flushes an LSM store's buffers first: both trees alike
    assert np.array_equal(rpsw.pagerank_host(r, n_iters=4),
                          tpsw.pagerank_host(p, n_iters=4))
    seen_r, seen_p = [], []
    seeks_r = rpsw.psw_sweep_host(r, lambda i, o, w: seen_r.append(
        (i, [(a, b) for _, a, b in w])))
    seeks_p = tpsw.psw_sweep_host(p, lambda i, o, w: seen_p.append(
        (i, [(a, b) for _, a, b in w])))
    assert seeks_r == seeks_p and seen_r == seen_p


@pytest.mark.parametrize("mode", MODES)
def test_edge_centric_sweep_with_message_function(mode):
    """A message that changes the state width: (P, L, 2) in, (P, L, 1) out
    (the same lambda runs on jnp and on torch)."""
    rdg = rpsw.build_device_graph(bulk(R, 6))
    tdg = T.build_device_graph(bulk(T, 6), device="cpu")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(tdg.n_partitions, tdg.interval_len, 2)).astype(
        np.float32)

    def msg(s):
        return s[..., :1] * s[..., 1:] + 0.5

    want = np.asarray(rpsw.edge_centric_sweep(rdg, jnp.asarray(x), msg, mode))
    got = T.edge_centric_sweep(tdg, torch.from_numpy(x), msg, mode)
    assert tuple(got.shape) == want.shape == (tdg.n_partitions,
                                              tdg.interval_len, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the arrays-level entry, destination CSR derived on the fly
    got2 = tpsw.edge_centric_sweep_arrays(
        tdg.src, tdg.dst_local, tdg.mask, tdg.interval_len,
        torch.from_numpy(x), msg, mode=mode, send_idx=tdg.send_idx,
        edge_owner=tdg.edge_owner, edge_slot=tdg.edge_slot)
    assert torch.equal(got, got2)


def test_reference_device_graph_carried_across():
    rdg = rpsw.build_device_graph(bulk(R, 7))
    arrays = convert.device_graph_to_arrays(rdg)
    tdg = convert.device_graph_from_arrays(arrays, "cpu")
    same_device_graph(rdg, tdg)
    same_tensors(tdg, T.build_device_graph(bulk(T, 7), device="cpu"))
    for mode in MODES:
        np.testing.assert_allclose(
            T.pagerank_device(tdg, mode=mode).numpy(),
            np.asarray(rpsw.pagerank_device(rdg, mode=mode)),
            rtol=1e-5, atol=1e-6)
    # and back: the port's graph flattens to the same arrays
    back = convert.device_graph_to_arrays(tdg)
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        assert np.array_equal(np.asarray(arrays[k]), back[k]), k
    bad = dict(arrays, dst_local=np.asarray(arrays["dst_local"])[:, ::-1])
    with pytest.raises(ValueError):
        convert.device_graph_from_arrays(bad, "cpu")


def test_hub_sums_to_float64_accuracy():
    """A hub with 200,000 in-edges: the float64 destination sum keeps
    PageRank within float32 rounding of a float64 numpy PageRank, where a
    float32 running sum of that many terms would drift."""
    n, hub = 50_000, 123
    rng = np.random.default_rng(8)
    src = np.concatenate([rng.integers(0, n, 200_000),
                          rng.integers(0, n, 100_000)])
    dst = np.concatenate([np.full(200_000, hub), rng.integers(0, n, 100_000)])
    g = T.GraphPAL.from_edges(src, dst, n_partitions=4, max_id=n - 1)
    r = T.pagerank_device(T.build_device_graph(g, device="cpu",
                                               with_window_plan=False),
                          n_iters=5, mode="dense_gather")
    iv = g.intervals
    outdeg = np.bincount(src, minlength=n)
    want = np.ones(n)
    for _ in range(5):
        acc = np.bincount(dst, weights=(want / np.maximum(outdeg, 1))[src],
                          minlength=n)
        want = 0.15 + 0.85 * acc
    got = r.reshape(-1).numpy()[iv.to_internal(np.arange(n))]
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    g = bulk(T, 9)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build_device_graph(g)
    t = live(T, 9)
    with pytest.raises(RuntimeError, match="CUDA"):
        t.snapshot()
    with t.read_view() as view:
        with pytest.raises(RuntimeError, match="CUDA"):
            view.snapshot()


def test_collectives_over_devices_are_not_ported():
    """The sweep over ranks is ported (`group`, the ranked tests below);
    the reference's `axis_name` keyword is not, and the refusals stay."""
    dg = T.build_device_graph(bulk(T, 10), device="cpu")
    with pytest.raises(TypeError):
        T.pagerank_device(dg, axis_name="intervals")
    with pytest.raises(ValueError, match="do not split"):
        dg.shard(0, 3)
    with pytest.raises(ValueError):
        T.pagerank_device(dg, mode="ring")
    no_plan = T.build_device_graph(bulk(T, 10), device="cpu",
                                   with_window_plan=False)
    with pytest.raises(ValueError, match="window plan"):
        T.pagerank_device(no_plan, mode="psw_windows")


RANKS = 4
REF_SHARD_MAP = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
import repro.core as R
from repro.core import psw as rpsw
from repro.jax_compat import shard_map

d = np.load(sys.argv[1])
g = R.GraphPAL.from_edges(d["src"], d["dst"], n_partitions=4,
                          max_id=int(d["max_id"]))
dg = rpsw.build_device_graph(g)
mesh = Mesh(np.array(jax.devices()[:4]), ("i",))
msg = lambda s: s[..., :1] * s[..., 1:] + 0.5
out = {}
for mode in ("dense_gather", "psw_windows"):
    def f(s, dl, m, x, si, eo, es, mode=mode):
        return rpsw.edge_centric_sweep_arrays(
            s, dl, m, dg.interval_len, x, msg, mode=mode, axis_name="i",
            send_idx=si, edge_owner=eo, edge_slot=es)
    spec = P("i")
    out[mode] = np.asarray(shard_map(f, mesh=mesh, in_specs=(spec,) * 7,
                                     out_specs=spec)(
        dg.src, dg.dst_local, dg.mask, jnp.asarray(d["x"]), dg.send_idx,
        dg.edge_owner, dg.edge_slot))
np.savez(sys.argv[2], **out)
"""


def reference_shard_map(tmp_path, src, dst, x):
    """The reference's sweep under shard_map on 4 host devices."""
    from _torch_ring import reference_subprocess
    inp, outp = tmp_path / "ref_in.npz", tmp_path / "ref_out.npz"
    np.savez(inp, src=src, dst=dst, x=x, max_id=N - 1)
    reference_subprocess(REF_SHARD_MAP, inp, outp)
    return dict(np.load(outp))


def test_sweep_over_ranks_matches_one_device_and_reference(tmp_path):
    """Four gloo ranks over 4 intervals (one a rank, the reference's
    layout) and over 8 (two a rank): the ranked sweep and PageRank bitwise
    equal to the one-device ones in both modes, and the 4-interval sweep
    within 1e-5 of the reference's shard_map."""
    from _torch_ring import psw_message, psw_sweep_shard, spawn_ring
    from test_torch_multihop import edges
    src, dst = edges(11)
    rng = np.random.default_rng(11)
    graphs, dgs = [], []
    for p in (4, 8):
        tdg = T.build_device_graph(T.GraphPAL.from_edges(
            src, dst, n_partitions=p, max_id=N - 1), device="cpu")
        x = rng.normal(size=(p, tdg.interval_len, 2)).astype(np.float32)
        graphs.append((convert.device_graph_to_arrays(tdg), x))
        dgs.append(tdg)
    ranks = spawn_ring(psw_sweep_shard, RANKS, tmp_path, graphs, 5)
    ref = reference_shard_map(tmp_path, src, dst, graphs[0][1])
    for i, (tdg, (_, x)) in enumerate(zip(dgs, graphs)):
        for mode in MODES:
            one = T.edge_centric_sweep(tdg, torch.from_numpy(x), psw_message,
                                       mode).numpy()
            got = np.concatenate([r[i]["sweep_" + mode] for r in ranks])
            assert np.array_equal(got, one), (tdg.n_partitions, mode)
            if i == 0:
                np.testing.assert_allclose(got, ref[mode], rtol=1e-5,
                                           atol=1e-5)
            pr = np.concatenate([r[i]["pr_" + mode] for r in ranks])
            assert np.array_equal(
                pr, T.pagerank_device(tdg, mode=mode).numpy()), mode


def test_shard_takes_each_ranks_rows():
    dg = T.build_device_graph(bulk(T, 12), device="cpu")
    parts = [dg.shard(r, 4) for r in range(4)]
    for name in FIELDS + ("seg_ptr",):
        whole = getattr(dg, name)
        assert torch.equal(torch.cat([getattr(p, name) for p in parts]),
                           whole), name
        assert getattr(parts[1], name).shape[0] == 2
    assert parts[0].n_partitions == dg.n_partitions


def sweep_messages(seed):
    """A bulk store's DeviceGraph on the CPU and float32 messages (P, E, 2)
    with a wide range of exponents (float64 sums that round), padding
    slots NaN."""
    dg = T.build_device_graph(bulk(T, seed), device="cpu")
    rng = np.random.default_rng(seed)
    shape = (*dg.src.shape, 2)
    m = rng.normal(size=shape) * 10.0 ** rng.integers(-6, 6, shape)
    msgs = torch.from_numpy(m.astype(np.float32))
    msgs[~dg.mask] = float("nan")
    return dg, msgs


def test_cpu_segment_sum_is_a_float64_index_add():
    """The CPU sum of each destination is a float64 `index_add_` of its
    messages in edge order, rounded once: bitwise, on values whose sums
    round, with padding never read."""
    dg, msgs = sweep_messages(13)
    got = psw_sweep.segment_sum(msgs, dg.seg_ptr)
    P, L = dg.n_partitions, dg.interval_len
    want = torch.zeros((P, L, 2), dtype=torch.float64)
    for p in range(P):
        live = dg.mask[p]
        want[p].index_add_(0, dg.dst_local[p][live].long(),
                           msgs[p][live].double())
    assert torch.equal(got, want.float())
    assert not torch.isnan(got).any()


def test_cpu_segment_sum_same_bits_under_other_padding():
    """The same edges padded to a wider E_max give the same bits."""
    dg, msgs = sweep_messages(14)
    wide = torch.cat([msgs, torch.full((msgs.shape[0], 333, 2),
                                       float("nan"))], 1)
    assert torch.equal(psw_sweep.segment_sum(wide, dg.seg_ptr),
                       psw_sweep.segment_sum(msgs, dg.seg_ptr))


@pytest.mark.parametrize("mode", MODES)
def test_identity_sweep_equals_message_sweep(mode):
    """The fused identity sweep (msg_fn None, what pagerank_device runs)
    is bitwise the sweep with the identity as a caller's msg_fn."""
    dg = T.build_device_graph(bulk(T, 15), device="cpu")
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.normal(size=(dg.n_partitions, dg.interval_len,
                                          3)).astype(np.float32))
    fused = T.edge_centric_sweep(dg, x, None, mode)
    assert fused.shape == x.shape
    assert torch.equal(fused, T.edge_centric_sweep(dg, x, lambda s: s, mode))


def test_window_send_is_consumer_major():
    """The exchange's send buffer: [c, o, w] = x[o, send_idx[o, c, w]]."""
    dg = T.build_device_graph(bulk(T, 16), device="cpu")
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(dg.n_partitions, dg.interval_len,
                                          2)).astype(np.float32))
    send = psw_sweep.window_send(x, dg.send_idx)
    P, W = dg.n_partitions, dg.window_width
    assert send.shape == (P, P, W, 2)
    for c, o in ((0, 0), (1, 3), (P - 1, 2)):
        assert torch.equal(send[c, o], x[o][dg.send_idx[o, c].long()])


def test_sweep_kernel_counter_stays_zero_on_cpu():
    """No CPU sweep counts as a kernel sweep."""
    dg = T.build_device_graph(bulk(T, 17), device="cpu")
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    try:
        before = telemetry.snapshot()["counters"].get("x.psw.sweep_kernel", 0)
        for mode in MODES:
            T.pagerank_device(dg, 5, mode=mode)
        after = telemetry.snapshot()["counters"].get("x.psw.sweep_kernel", 0)
        assert after == before
    finally:
        telemetry.set_enabled(was)
