"""The port's ELL gather-reduce (repro_torch/kernels/segment_ell and
repro_torch/graph/padding.py::pad_to_ell) against the reference's, on the
CPU, where the wrapper takes the plain torch version.

`pad_to_ell` is held bitwise. The sums are held at TestSegmentEll's own
tolerances (rtol 1e-6, atol 1e-6; 1e-5 against the edge oracle, which sums
in another order) against the reference's jnp path: its Pallas body calls
`pl.load`, which jax 0.9 no longer has (ROADMAP queue 3 note a)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.graph.padding import pad_to_ell as ref_pad
from repro.kernels.psw_spmm import spmm_dense_ref
from repro.kernels.segment_ell import segment_ell as ref_segment_ell
from repro.kernels.segment_ell import segment_ell_ref
from repro_torch.graph import pad_to_ell
from repro_torch.kernels.segment_ell import (ops, segment_ell,
                                             segment_ell_from_edges,
                                             segment_ell_torch)


def graph(kind: str, seed: int = 0):
    """(src, dst, n): random multigraph, a hub of in-degree 5000 among
    random edges, or no edges."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n, e = 300, 3000
        return rng.integers(0, n, e), rng.integers(0, n, e), n
    if kind == "hub":
        n = 2000
        src = np.concatenate([rng.integers(0, n, 5000),
                              rng.integers(0, n, 3000)])
        dst = np.concatenate([np.full(5000, 17), rng.integers(0, n, 3000)])
        order = rng.permutation(src.shape[0])
        return src[order], dst[order], n
    assert kind == "empty"
    return np.empty(0, np.int64), np.empty(0, np.int64), 50


@pytest.mark.parametrize("kind", ["random", "hub", "empty"])
@pytest.mark.parametrize("max_degree", [1, 4, 15, 6000])
def test_pad_to_ell_matches_reference_bitwise(kind, max_degree):
    src, dst, n = graph(kind)
    want_idx, want_mask = ref_pad(src, dst, n, max_degree)
    idx, mask = pad_to_ell(src, dst, n, max_degree)
    assert idx.dtype == want_idx.dtype and mask.dtype == want_mask.dtype
    assert np.array_equal(idx, want_idx) and np.array_equal(mask, want_mask)


@pytest.mark.parametrize("n,k,m,f", [(100, 8, 50, 30), (256, 16, 256, 128),
                                     (33, 5, 20, 200), (128, 1, 10, 128),
                                     (70, 1, 20, 3), (50, 15, 40, 4),
                                     (64, 15, 30, 100), (64, 9, 30, 102)])
def test_plain_version_matches_reference(n, k, m, f):
    rng = np.random.default_rng(n * k)
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.7
    x = rng.normal(size=(m, f)).astype(np.float32)
    want = np.asarray(ref_segment_ell(jnp.asarray(idx), jnp.asarray(mask),
                                      jnp.asarray(x), use_kernel=False))
    before = ops.launches
    got = segment_ell(torch.from_numpy(idx), torch.from_numpy(mask),
                      torch.from_numpy(x))
    assert ops.launches == before          # the CPU takes the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    oracle = np.asarray(segment_ell_ref(jnp.asarray(idx), jnp.asarray(mask),
                                        jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_degree", [None, 3])
def test_from_edges_matches_edge_oracle(max_degree):
    rng = np.random.default_rng(7)
    n, e, f = 60, 200, 24
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    got = segment_ell_from_edges(src, dst, torch.from_numpy(x), n,
                                 max_degree=max_degree or e)
    if max_degree is None:      # cap above max in-degree: nothing dropped
        want = np.asarray(spmm_dense_ref(jnp.asarray(src), jnp.asarray(dst),
                                         jnp.asarray(x), n))
    else:                       # the first max_degree edges, stable order
        want = np.zeros((n, f), np.float32)
        seen = np.zeros(n, int)
        for s, d in zip(src[np.argsort(dst, kind="stable")],
                        np.sort(dst, kind="stable")):
            if seen[d] < max_degree:
                want[d] += x[s]
                seen[d] += 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_all_masked_and_garbage_in_masked_slots():
    idx = torch.zeros((128, 4), dtype=torch.int32)
    mask = torch.zeros((128, 4), dtype=torch.bool)
    x = torch.ones((8, 128))
    assert not segment_ell(idx, mask, x).any()
    # a masked slot's index is never used to gather
    idx = torch.tensor([[1, -7, 10**9], [10**9, 2, -1]], dtype=torch.int32)
    mask = torch.tensor([[True, False, False], [False, True, False]])
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = segment_ell_torch(idx, mask, x)
    assert torch.equal(out, x[[1, 2]])


@pytest.mark.parametrize("f", [4, 100])
def test_unaligned_x_view(f):
    """A contiguous x whose data starts 4 bytes into its buffer (the card
    takes the scalar path there): the same sums as an aligned copy."""
    rng = np.random.default_rng(f)
    n, k = 200, 15
    idx = torch.from_numpy(rng.integers(0, n, (n, k)).astype(np.int32))
    mask = torch.from_numpy(rng.random((n, k)) < 0.7)
    buf = torch.from_numpy(rng.normal(size=n * f + 1).astype(np.float32))
    x = buf[1:].view(n, f)
    assert x.data_ptr() % 16 == (buf.data_ptr() + 4) % 16
    got = segment_ell(idx, mask, x)
    assert torch.equal(got, segment_ell(idx, mask, x.clone()))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(segment_ell_ref(jnp.asarray(idx.numpy()),
                                                jnp.asarray(mask.numpy()),
                                                jnp.asarray(x.numpy()))),
        rtol=1e-6, atol=1e-6)


def test_bad_inputs_raise():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    mask = torch.ones((4, 2), dtype=torch.bool)
    with pytest.raises(ValueError):
        segment_ell(idx.long(), mask, torch.ones((3, 5)))
    with pytest.raises(ValueError):
        segment_ell(idx, mask[:, :1], torch.ones((3, 5)))
    with pytest.raises(TypeError):
        segment_ell(idx.numpy(), mask, torch.ones((3, 5)))
    with pytest.raises(ValueError):
        segment_ell_from_edges([0, 5], [1, 2], torch.ones((3, 5)), 4, 2)
