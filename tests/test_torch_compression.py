"""The port's error-feedback int8 all-reduce (repro_torch/optim/
compression.py) against the reference's (repro/optim/compression.py), on
seeded numpy gradients.

Tolerances: `ef_compress` / `ef_decompress` bitwise (the same float32
operations); `compressed_psum_tree` over four gloo ranks within 1e-6 of
the reference's `psum`s under shard_map on four host devices (the int32
sums are exact; the mean scale's float32 sum may round in another
order); `group=None` bitwise the local round trip."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.optim import compression as rc
from repro_torch.optim import (compressed_psum_tree, ef_compress,
                               ef_decompress)

SHAPES = {"w": (33, 17), "b": (17,), "e": (4, 5, 6)}
RANKS = 4


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_ef_compress_is_bitwise_the_reference(seed, scale):
    g, r = tree(seed, scale)["w"], tree(seed + 10, scale * 0.01)["w"]
    q, s, nr = ef_compress(torch.from_numpy(g), torch.from_numpy(r))
    rq, rs, rnr = rc.ef_compress(jnp.asarray(g), jnp.asarray(r))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(nr.numpy(), np.asarray(rnr))
    assert np.array_equal(ef_decompress(q, s).numpy(),
                          np.asarray(rc.ef_decompress(rq, rs)))


def test_ef_compress_of_zeros_and_bf16():
    q, s, nr = ef_compress(torch.zeros(8), torch.zeros(8))
    assert torch.equal(q, torch.zeros(8, dtype=torch.int8))
    assert float(s) == pytest.approx(1e-12 / 127.0)
    g = torch.from_numpy(tree(3)["w"]).to(torch.bfloat16)
    q, s, nr = ef_compress(g, torch.zeros(g.shape))
    rq, rs, rnr = rc.ef_compress(jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16), jnp.zeros(g.shape))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(nr.numpy(), np.asarray(rnr))


def test_one_rank_is_the_local_round_trip():
    g = {k: torch.from_numpy(v) for k, v in tree(4).items()}
    r = {k: torch.from_numpy(v * 0.01) for k, v in tree(5).items()}
    mean, new_r = compressed_psum_tree(g, r, None)
    for k in SHAPES:
        q, s, nr = ef_compress(g[k], r[k])
        assert torch.equal(mean[k], ef_decompress(q, s))
        assert torch.equal(new_r[k], nr)
        assert mean[k].dtype == g[k].dtype


REF_PSUM = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.jax_compat import shard_map
from repro.optim.compression import compressed_psum_tree

d = dict(np.load(sys.argv[1]))
keys = sorted(k[2:] for k in d if k.startswith("g_"))
g = {k: jnp.asarray(d["g_" + k]) for k in keys}
r = {k: jnp.asarray(d["r_" + k]) for k in keys}
mesh = Mesh(np.array(jax.devices()[:4]), ("i",))

def f(g, r):
    g = {k: v[0] for k, v in g.items()}
    r = {k: v[0] for k, v in r.items()}
    m, nr = compressed_psum_tree(g, r, "i")
    return ({k: v[None] for k, v in m.items()},
            {k: v[None] for k, v in nr.items()})

spec = {k: P("i") for k in keys}
m, nr = shard_map(f, mesh=mesh, in_specs=(spec, spec),
                  out_specs=(spec, spec))(g, r)
np.savez(sys.argv[2], **{"m_" + k: np.asarray(v) for k, v in m.items()},
         **{"r_" + k: np.asarray(v) for k, v in nr.items()})
"""


def test_compressed_psum_over_four_ranks_matches_reference(tmp_path):
    from _torch_ring import (compressed_psum_shard, reference_subprocess,
                             spawn_ring)
    grads = [tree(20 + i, 10.0 ** (i - 2)) for i in range(RANKS)]
    residuals = [{k: v * 1e-3 for k, v in tree(30 + i).items()}
                 for i in range(RANKS)]
    ranks = spawn_ring(compressed_psum_shard, RANKS, tmp_path, grads,
                       residuals)
    inp, outp = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **{f"g_{k}": np.stack([g[k] for g in grads])
                     for k in SHAPES},
             **{f"r_{k}": np.stack([r[k] for r in residuals])
                for k in SHAPES})
    reference_subprocess(REF_PSUM, inp, outp)
    ref = np.load(outp)
    for rank, (mean, new_r) in enumerate(ranks):
        for k in SHAPES:
            np.testing.assert_allclose(mean[k], ref["m_" + k][rank],
                                       rtol=1e-6, atol=1e-6)
            assert np.array_equal(mean[k], ranks[0][0][k])   # all ranks
            # the residual is local: bitwise this rank's ef_compress
            np.testing.assert_array_equal(new_r[k], ref["r_" + k][rank])
