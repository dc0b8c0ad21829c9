"""The port's PSW ring (repro_torch/graph/psw_ops.py) against the
reference's (repro/graph/psw_ops.py) and against index_select /
index_add_ autograd.

One rank runs in-process against the reference on a one-device mesh (the
checks of tests/test_psw_ring.py's single-device class). Four ranks run
in spawned CPU processes on gloo with a file store under `tmp_path`
(`_torch_ring.spawn_ring`), which is what the reference's 8-device script
checks: the ring's forward and its reverse-ring backward, the transpose,
bf16 through the ring, and the local ops on shard-aligned ids."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.graph.psw_ops as R
from repro.graph.segment_ops import edge_softmax as ref_edge_softmax
from repro_torch.graph import psw_ops as po
from repro_torch.graph.segment_ops import edge_softmax

from _torch_ring import ring_inputs, ring_ops, spawn_ring


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_one_rank_ring_is_a_ring_of_one_with_no_group():
    ring = po.ring_mesh(64)
    assert (ring.rank, ring.size, ring.n_loc, ring.n) == (0, 1, 64, 64)
    assert (ring.next, ring.prev) == (0, 0)
    x = torch.zeros((63, 2))
    with pytest.raises(ValueError, match="rows"):
        po.ring_gather(x, torch.zeros(3, dtype=torch.long), ring)
    with pytest.raises(ValueError, match="n = 63"):
        po.local_scatter_sum(x, torch.zeros(63, dtype=torch.long), 63, ring)


def test_ring_gather_matches_take(mesh1):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    idx = rng.integers(0, 64, (40,)).astype(np.int32)
    want = np.asarray(R.ring_gather(jnp.asarray(x), jnp.asarray(idx), mesh1))
    got = po.ring_gather(torch.from_numpy(x), torch.from_numpy(idx),
                         po.ring_mesh(64))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x[idx])


def test_ring_gather_vjp(mesh1):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    idx = rng.integers(0, 32, (20,)).astype(np.int32)
    want = jax.grad(lambda x: (R.ring_gather(x, jnp.asarray(idx), mesh1)
                               ** 2).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (po.ring_gather(xt, torch.from_numpy(idx), po.ring_mesh(32)) ** 2
     ).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6)


def test_ring_scatter_sum_and_vjp(mesh1):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(40, 5)).astype(np.float32)
    idx = rng.integers(0, 64, (40,)).astype(np.int32)
    want = R.ring_scatter_sum(jnp.asarray(v), jnp.asarray(idx), 64, mesh1)
    gwant = jax.grad(lambda v: (R.ring_scatter_sum(
        v, jnp.asarray(idx), 64, mesh1) ** 2).sum())(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_()
    got = po.ring_scatter_sum(vt, torch.from_numpy(idx), 64,
                              po.ring_mesh(64))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gwant), rtol=1e-6,
                               atol=1e-6)


def test_local_ops(mesh1):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    idx = rng.integers(0, 64, (40,)).astype(np.int32)
    v = rng.normal(size=(40, 5)).astype(np.float32)
    s = rng.normal(size=(40,)).astype(np.float32)
    ring = po.ring_mesh(64)
    jx, ji, jv = jnp.asarray(x), jnp.asarray(idx), jnp.asarray(v)
    ti = torch.from_numpy(idx)
    np.testing.assert_array_equal(
        po.local_gather(torch.from_numpy(x), ti, ring).numpy(),
        np.asarray(R.local_gather(jx, ji, mesh1)))
    np.testing.assert_allclose(
        po.local_scatter_sum(torch.from_numpy(v), ti, 64, ring).numpy(),
        np.asarray(R.local_scatter_sum(jv, ji, 64, mesh1)), rtol=1e-6,
        atol=1e-6)
    for scores in (s, v):          # one column, and several at once
        np.testing.assert_allclose(
            po.local_edge_softmax(torch.from_numpy(scores), ti, 64,
                                  ring).numpy(),
            np.asarray(R.local_edge_softmax(jnp.asarray(scores), ji, 64,
                                            mesh1)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        edge_softmax(torch.from_numpy(s), ti, 64).numpy(),
        np.asarray(ref_edge_softmax(jnp.asarray(s), ji, 64)), rtol=1e-5)


def test_ring_of_four_ranks_on_gloo(tmp_path):
    """Four spawned ranks: every op equals index_select / index_add_ on
    the global arrays, and the gradients equal their autograd."""
    n, e, f, world = 64, 40, 5, 4
    res = spawn_ring(ring_ops, world, tmp_path, n, e, f, 0, timeout=120)
    x, idx, v, aligned = ring_inputs(n, e, f, 0, world)
    cat = {k: np.concatenate([r[k] for r in res])
           for k in res[0] if k != "gx_bf16_dtype"}
    ti = torch.from_numpy(idx)

    xt = torch.from_numpy(x).requires_grad_()
    want = xt.index_select(0, ti)
    (want ** 2).sum().backward()
    np.testing.assert_array_equal(cat["gather"], want.detach().numpy())
    np.testing.assert_allclose(cat["gx"], xt.grad.numpy(), rtol=1e-5,
                               atol=1e-6)

    vt = torch.from_numpy(v).requires_grad_()
    want = torch.zeros((n, f)).index_add(0, ti, vt)
    (want ** 2).sum().backward()
    np.testing.assert_allclose(cat["scatter"], want.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cat["gv"], vt.grad.numpy(), rtol=1e-5,
                               atol=1e-6)

    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(cat["gather_bf16"],
                                  xb[ti].float().numpy())
    assert {r["gx_bf16_dtype"] for r in res} == {"torch.bfloat16"}
    counts = np.bincount(idx, minlength=n).astype(np.float32)
    np.testing.assert_array_equal(cat["gx_bf16"],
                                  np.repeat(counts[:, None], f, 1))

    ta = torch.from_numpy(aligned)
    np.testing.assert_array_equal(cat["local_gather"], x[aligned])
    np.testing.assert_allclose(
        cat["local_scatter"],
        torch.zeros((n, f)).index_add(0, ta, torch.from_numpy(v)).numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        cat["local_softmax"],
        edge_softmax(torch.from_numpy(v[:, 0]), ta, n).numpy(), rtol=1e-6,
        atol=1e-7)
