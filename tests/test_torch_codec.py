"""The port's Elias-Gamma codec and resident indexes (repro_torch/core/codec.py)
against the reference's (repro/core/codec.py), on the CPU, on the same
seeded inputs. Every comparison is exact: the packed bytes, bit counts,
decoded values, search positions and lookups must be equal."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import codec as R
from repro_torch.core import codec as T


def same(a, b):
    """Equal values and dtypes, or equal scalars."""
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def sorted_keys(seed: int, n: int, span: int = 1 << 40) -> np.ndarray:
    return np.unique(np.random.default_rng(seed).integers(0, span, n))


@pytest.mark.parametrize("seed,n,bits", [(0, 1, 1), (1, 7, 5), (2, 200, 20),
                                         (3, 3000, 40), (4, 513, 62)])
def test_gamma_encode_decode_bitwise(seed, n, bits):
    vals = np.random.default_rng(seed).integers(1, 1 << bits, n)
    (pr, nr), (pt, nt) = R.elias_gamma_encode(vals), T.elias_gamma_encode(vals)
    assert nr == nt and same(pr, pt)
    assert same(R.elias_gamma_decode(pr, nr), T.elias_gamma_decode(pt, nt))
    assert same(T.elias_gamma_encode_ref(vals)[0], pt)
    assert same(T.elias_gamma_decode_ref(pt, nt),
                R.elias_gamma_decode_ref(pr, nr))


def test_gamma_rejects_nonpositive_as_the_reference_does():
    for mod in (R, T):
        with pytest.raises(ValueError):
            mod.elias_gamma_encode(np.asarray([3, 0, 2]))


@pytest.mark.parametrize("seed,n", [(5, 1), (6, 64), (7, 65), (8, 5121),
                                    (9, 20000)])
def test_monotonic_plain_and_blocked_bitwise(seed, n):
    seq = np.sort(np.random.default_rng(seed).integers(0, 1 << 45, n))
    r, t = R.encode_monotonic(seq), T.encode_monotonic(seq)
    assert all(same(a, b) for a, b in zip(r, t))
    assert same(R.decode_monotonic(*r, n), T.decode_monotonic(*t, n))
    rb, tb = R.encode_monotonic_blocked(seq), T.encode_monotonic_blocked(seq)
    assert all(same(a, b) for a, b in zip(rb, tb))
    (rp, nb, first, ro), (tp, _, _, to) = rb, tb
    got = T.decode_monotonic_blocked(tp, nb, first, n, to)
    assert same(R.decode_monotonic_blocked(rp, nb, first, n, ro), got)
    assert np.array_equal(got, seq)


@pytest.mark.parametrize("seed,n,dups", [(10, 0, False), (11, 1, False),
                                         (12, 129, False), (13, 4993, False),
                                         (14, 700, True), (15, 30000, True)])
def test_blocked_gamma_pointer_bitwise(seed, n, dups):
    rng = np.random.default_rng(seed)
    arr = (np.sort(rng.integers(0, 50, n)) if dups
           else sorted_keys(seed, n))
    bpr, bpt = (R.BlockedGammaPointer.from_array(arr),
                T.BlockedGammaPointer.from_array(arr))
    assert bpr.nbytes() == bpt.nbytes()
    assert same(bpr.decode_all(), bpt.decode_all())
    top = int(arr.max()) + 2 if arr.size else 5
    keys = np.concatenate([arr[::7], rng.integers(0, top, 64)])
    assert same(bpr.searchsorted(keys), bpt.searchsorted(keys))
    if not arr.size:
        return
    ri, rv = bpr.searchsorted_with_values(keys)
    ti, tv = bpt.searchsorted_with_values(keys)
    assert same(ri, ti) and same(rv, tv)
    idx = rng.integers(0, arr.size, 100)
    assert same(bpr.values_at(idx), bpt.values_at(idx))
    assert np.array_equal(bpt.values_at(idx), arr[idx])


@pytest.mark.parametrize("seed,n,stride,chunk", [(16, 1, 4, 8),
                                                 (17, 3000, 64, 1024),
                                                 (18, 20000, 512, 256)])
def test_sparse_and_gamma_chunked_lookups_bitwise(seed, n, stride, chunk):
    keys = sorted_keys(seed, n, span=10 ** 7)
    probes = np.concatenate([keys[::3], np.random.default_rng(seed).integers(
        0, 10 ** 7, 200)])
    sr, st_ = R.SparseIndex(keys, stride=stride), T.SparseIndex(keys,
                                                                stride=stride)
    gr, gt = (R.GammaChunkedIndex(keys, chunk=chunk),
              T.GammaChunkedIndex(keys, chunk=chunk))
    assert (sr.nbytes(), gr.nbytes()) == (st_.nbytes(), gt.nbytes())
    assert same(gr.decode_all(), gt.decode_all())
    for j in range(-(-n // chunk)):
        assert same(gr.decode_chunk(j), gt.decode_chunk(j))
    for k in probes.tolist():
        want = sr.lookup(k)
        assert want == st_.lookup(k) == gr.lookup(k) == gt.lookup(k)


def test_gamma_chunked_empty_matches_reference():
    e = np.empty(0, np.int64)
    r, t = R.GammaChunkedIndex(e), T.GammaChunkedIndex(e)
    assert same(r.decode_all(), t.decode_all())
    assert r.lookup(3) == t.lookup(3) == -1


@given(st.lists(st.integers(0, 2 ** 40), min_size=1, max_size=400),
       st.lists(st.integers(0, 2 ** 40), min_size=1, max_size=20))
@settings(max_examples=40, deadline=None)
def test_property_codec_and_pointer_bitwise(raw, probes):
    arr = np.unique(np.asarray(raw, np.int64))
    keys = np.asarray(probes, np.int64)
    r, t = R.encode_monotonic_blocked(arr), T.encode_monotonic_blocked(arr)
    assert all(same(a, b) for a, b in zip(r, t))
    vals = np.asarray(raw, np.int64) + 1
    assert same(R.elias_gamma_encode(vals)[0], T.elias_gamma_encode(vals)[0])
    bpr, bpt = (R.BlockedGammaPointer.from_array(arr),
                T.BlockedGammaPointer.from_array(arr))
    assert same(bpr.searchsorted(keys), bpt.searchsorted(keys))
    assert same(bpt.decode_all(), arr)
