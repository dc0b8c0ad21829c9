"""The port's embedding bag (repro_torch/kernels/embedding_bag) against the
reference's, on the CPU, where the wrapper takes the plain torch version.

Held at TestEmbeddingBag's tolerances (rtol/atol 1e-5 on its shapes, 1e-4
in the property case) against the reference's jnp path
(`embedding_bag(..., use_kernel=False)`) and `embedding_bag_ref`: its
Pallas body calls `pl.load`, which jax 0.9 no longer has (ROADMAP queue 3
note a). Ids outside [0, V) raise ValueError in the port, where the
reference's jnp oracle clamps high ids and wraps negative ones (note f)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.embedding_bag import embedding_bag as ref_embedding_bag
from repro.kernels.embedding_bag import embedding_bag_ref
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_torch, ops)


def bags(b, k, v, d, seed, weights="dense"):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, v, (b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    if weights == "sparse":
        w *= (rng.random((b, k)) < 0.8)
    table = rng.normal(size=(v, d)).astype(np.float32)
    return idx, w, table


@pytest.mark.parametrize("b,k,v,d", [(64, 4, 1000, 32), (128, 16, 500, 64),
                                     (200, 2, 50, 128), (128, 1, 10, 16)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_matches_reference(b, k, v, d, mode):
    idx, w, table = bags(b, k, v, d, seed=b + k)
    got = embedding_bag(torch.from_numpy(idx), torch.from_numpy(w),
                        torch.from_numpy(table), mode=mode).numpy()
    args = (jnp.asarray(idx), jnp.asarray(w), jnp.asarray(table))
    want = np.asarray(ref_embedding_bag(*args, mode=mode, use_kernel=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = np.asarray(embedding_bag_ref(*args, mode=mode))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_property_weighted_bags(seed):
    rng = np.random.default_rng(seed)
    b, k = int(rng.integers(1, 80)), int(rng.integers(1, 12))
    v, d = int(rng.integers(1, 300)), int(rng.integers(1, 100))
    idx, w, table = bags(b, k, v, d, seed, weights="sparse")
    for mode in ("sum", "mean"):
        got = embedding_bag(torch.from_numpy(idx), torch.from_numpy(w),
                            torch.from_numpy(table), mode=mode).numpy()
        want = np.asarray(embedding_bag_ref(
            jnp.asarray(idx), jnp.asarray(w), jnp.asarray(table), mode=mode))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_padded_history_and_float64_oracle():
    """bert4rec's serving layout at a small size: left-padded histories
    (item 0, weight 0), every slot read; against float64 numpy."""
    rng = np.random.default_rng(3)
    B, K, V, D = 300, 200, 5000, 64
    lens = rng.integers(1, K + 1, B)
    real = np.arange(K)[None, :] >= (K - lens)[:, None]
    idx = np.where(real, rng.integers(1, V, (B, K)), 0).astype(np.int32)
    w = real.astype(np.float32)
    table = (rng.normal(size=(V, D)) * 0.02).astype(np.float32)
    sums = (w[..., None].astype(np.float64) * table[idx]).sum(1)
    for mode, want in (("sum", sums), ("mean", sums / lens[:, None])):
        got = embedding_bag(torch.from_numpy(idx), torch.from_numpy(w),
                            torch.from_numpy(table), mode=mode).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_copies_no_padded_table(monkeypatch):
    """The plain version (the kernel, on the card) gets the caller's table
    itself, and B and D stay unpadded: the reference pads both to 128."""
    seen = []

    def spy(idx, weights, table):
        seen.append(table)
        return embedding_bag_torch(idx, weights, table)

    monkeypatch.setattr(ops, "embedding_bag_torch", spy)
    idx, w, table = bags(5, 3, 40, 20, seed=1)
    t = torch.from_numpy(table)
    before = ops.launches
    out = embedding_bag(torch.from_numpy(idx), torch.from_numpy(w), t)
    assert ops.launches == before               # no kernel on the CPU
    assert len(seen) == 1 and seen[0] is t
    assert tuple(out.shape) == (5, 20)


def test_plain_is_a_slot_loop():
    idx, w, table = bags(7, 5, 30, 8, seed=2)
    t = torch.from_numpy(table)
    got = embedding_bag_torch(torch.from_numpy(idx), torch.from_numpy(w), t)
    acc = torch.zeros((7, 8))
    for k in range(5):
        acc = acc + torch.from_numpy(w[:, k, None]) * t[idx[:, k]]
    assert torch.equal(got, acc)
    # int64 ids give the same bits
    got64 = embedding_bag(torch.from_numpy(idx).long(), torch.from_numpy(w),
                          t)
    assert torch.equal(got64, got)


@pytest.mark.parametrize("bad_id,dtype", [
    (4, torch.int32), (-1, torch.int32), (4, torch.int64), (-1, torch.int64),
    (2**32 + 1, torch.int64)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ids_outside_the_table_raise(bad_id, dtype, mode):
    """V = 4 rows: ids V and -1 (and an int64 id that an int32 cast would
    bring back into range) raise, where the reference clamps and wraps."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[1, bad_id]], dtype=dtype)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        embedding_bag(idx, torch.ones((1, 2)), table, mode=mode)
    ok = embedding_bag(torch.tensor([[1, 3]], dtype=dtype), torch.ones((1, 2)),
                       table, mode=mode)
    assert torch.equal(ok, torch.tensor([[12., 14., 16.]]) / (
        2 if mode == "mean" else 1))


def test_reference_clamps_and_wraps_what_the_port_refuses():
    """The documented difference (ROADMAP queue 3 note f), pinned."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx, w = np.array([[5, -1]], np.int32), np.ones((1, 2), np.float32)
    ref = np.asarray(embedding_bag_ref(jnp.asarray(idx), jnp.asarray(w),
                                       jnp.asarray(table)))
    np.testing.assert_array_equal(ref, [[18, 20, 22]])    # row 3 twice
    with pytest.raises(ValueError):
        embedding_bag(torch.from_numpy(idx), torch.from_numpy(w),
                      torch.from_numpy(table))


@pytest.mark.parametrize("bad,exc", [
    (dict(mode="max"), ValueError),
    (dict(idx_dtype=torch.float32), ValueError),
    (dict(w_shape=(4, 2)), ValueError),
    (dict(table_dtype=torch.bfloat16), TypeError),
    (dict(numpy=True), TypeError),
])
def test_bad_inputs_raise(bad, exc):
    idx = torch.zeros((4, 3), dtype=bad.get("idx_dtype", torch.int32))
    w = torch.ones(bad.get("w_shape", (4, 3)))
    table = torch.ones((10, 6), dtype=bad.get("table_dtype", torch.float32))
    if bad.get("numpy"):
        table = table.numpy()
    with pytest.raises(exc):
        embedding_bag(idx, w, table, mode=bad.get("mode", "sum"))
