"""The port's synthetic data streams (repro_torch/data/) against the
reference's (repro/data/): the same LinkBench request mix and bulk load,
token batches and power-law edge stream for a seed, exactly."""
import numpy as np
import pytest

import repro.data as R
import repro_torch.data as T


def same_arrays(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def test_request_mix_is_the_references():
    assert T.REQUEST_MIX == R.REQUEST_MIX
    assert abs(sum(T.REQUEST_MIX.values()) - 1.0) < 1e-9


@pytest.mark.parametrize("realistic_ids,seed", [(True, 0), (False, 3)])
def test_linkbench_workload_equal_for_a_seed(realistic_ids, seed):
    kw = dict(n_vertices=5_000, edges_per_vertex=3.0,
              realistic_ids=realistic_ids, seed=seed)
    a = T.LinkBenchWorkload(T.LinkBenchConfig(**kw))
    b = R.LinkBenchWorkload(R.LinkBenchConfig(**kw))
    assert same_arrays(a.initial_graph(), b.initial_graph())
    got, want = list(a.requests(2_000)), list(b.requests(2_000))
    assert got == want
    assert {r["op"] for r in got} == set(T.REQUEST_MIX)


def test_token_stream_equal_and_random_access():
    cfg = dict(vocab_size=1000, batch=4, seq_len=32, seed=5)
    a = T.TokenStream(T.TokenStreamConfig(**cfg))
    b = R.TokenStream(R.TokenStreamConfig(**cfg))
    for step in (0, 1, 17):
        x, y = a.batch_at(step), b.batch_at(step)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    it = iter(a)
    next(it)
    assert np.array_equal(next(it)["tokens"], a.batch_at(1)["tokens"])


def test_graph_stream_equal_for_a_seed():
    a, b = T.GraphStream(100_000, seed=9), R.GraphStream(100_000, seed=9)
    for k in (1, 1000, 25_000):
        assert same_arrays(a.next_edges(k), b.next_edges(k))
