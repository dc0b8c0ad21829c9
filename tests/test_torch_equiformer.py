"""The port's EquiformerV2 (repro_torch/models/gnn/equiformer_v2.py) against
the reference's forward, on the CPU, where its message scatter takes
psw_spmm's plain version.

The reference's params are initialised with its own jax key and carried
across with `repro_torch.convert.gnn_params_{to,from}_arrays`, so both
packages run the same weights on the same numpy batch. Logits are held at
rtol/atol 1e-4 in float32, the port's model tolerance (as
tests/test_torch_gnn.py holds GIN, PNA and MeshGraphNet); rotation and
translation invariance at the reference's own 2e-4 and 1e-5
(tests/test_models.py). `psw_ring` runs on one rank in-process against the
reference on a one-device mesh, and on four gloo ranks in spawned
processes (`_torch_ring.spawn_ring`) against one rank."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_arch as ref_get_arch
from repro.models.gnn import equiformer_v2 as req
from repro.sharding import DEFAULT_RULES, ShardingRules, use_rules
from repro_torch import configs, convert
from repro_torch.kernels.psw_spmm import ops as ps_ops
from repro_torch.models.gnn import equiformer_v2 as eq

from _torch_ring import equiformer_shard, spawn_ring

TOL = dict(rtol=1e-4, atol=1e-4)
# the smoke config, and a narrow one at the published l_max and m_max
NARROW = dict(n_layers=1, d_hidden=8, l_max=6, m_max=2, n_heads=2)


def both(seed, **replace):
    """(reference config, port config, reference params, port params)."""
    ref_cfg = dataclasses.replace(ref_get_arch("equiformer-v2").smoke_config,
                                  **replace)
    cfg = dataclasses.replace(configs.get_arch("equiformer-v2").smoke_config,
                              **replace)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    p_ref = req.init_params(jax.random.PRNGKey(seed), ref_cfg)
    p = convert.gnn_params_from_arrays(convert.gnn_params_to_arrays(p_ref),
                                       cfg, "cpu")
    return ref_cfg, cfg, p_ref, p


def numpy_batch(n, e, n_species, seed, pal_shards=0):
    """Random positions and species; the last 5 edges are padding (masked,
    from node 0) and the first 3 have zero length (src == dst), as has any
    other edge whose ends the draw made equal.
    `pal_shards` > 0 orders the edges PAL-like: e // pal_shards a shard,
    each ending in that shard's n // pal_shards rows."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    if pal_shards:
        n_loc, e_loc = n // pal_shards, e // pal_shards
        dst = rng.integers(0, n_loc, e) + np.repeat(
            np.arange(pal_shards) * n_loc, e_loc)
    else:
        dst = rng.integers(0, n, e)
    src[:3] = dst[:3]
    em = np.arange(e) < e - 5
    src[~em] = 0
    # a padding edge ends at node 0, or at its shard's first node
    dst[~em] = dst[~em] // (n // pal_shards) * (n // pal_shards) \
        if pal_shards else 0
    return {"species": rng.integers(0, n_species, n).astype(np.int32),
            "pos": rng.standard_normal((n, 3)).astype(np.float32),
            "src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "edge_mask": em, "node_mask": np.ones(n, bool)}


def mine(seed, **replace):
    """(port config, port params of its own init): for the checks that
    need no reference."""
    cfg = dataclasses.replace(configs.get_arch("equiformer-v2").smoke_config,
                              **replace)
    return cfg, eq.init_params(torch.Generator().manual_seed(seed), cfg,
                               "cpu")


def ref_forward(p_ref, b, ref_cfg, mesh=None):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if mesh is None:
        return np.asarray(req.forward(p_ref, jb, ref_cfg))
    with use_rules(ShardingRules(rules=dict(DEFAULT_RULES), mesh=mesh)):
        return np.asarray(req.forward(p_ref, jb, ref_cfg))


def port_forward(p, b, cfg):
    with torch.no_grad():
        return eq.forward(p, {k: torch.from_numpy(v) for k, v in b.items()},
                          cfg).numpy()


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("narrow", [False, True])
def test_forward_matches_reference(narrow, chunks):
    ref_cfg, cfg, p_ref, p = both(chunks, edge_chunks=chunks,
                                  **(NARROW if narrow else {}))
    b = numpy_batch(30, 120, cfg.n_species, seed=chunks + 10 * narrow)
    want = ref_forward(p_ref, b, ref_cfg)
    got = port_forward(p, b, cfg)
    assert got.shape == want.shape == (30, 1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("chunks", [1, 4])
def test_psw_ring_on_one_rank_matches_reference(mesh1, chunks):
    """Both packages cast x to bf16 for the ring: their ring results agree
    at 1e-4, while either is ~1e-3 from `take` mode."""
    ref_cfg, cfg, p_ref, p = both(3, edge_chunks=chunks,
                                  gather_mode="psw_ring")
    b = numpy_batch(32, 128, cfg.n_species, seed=4)
    got = port_forward(p, b, cfg)
    np.testing.assert_allclose(got, ref_forward(p_ref, b, ref_cfg, mesh1),
                               **TOL)
    take = port_forward(p, b, dataclasses.replace(cfg, gather_mode="take"))
    assert np.abs(take - got).max() > 1e-5       # the bf16 cast shows


def test_psw_ring_of_four_ranks_equals_one_rank(tmp_path):
    """A PAL-ordered batch on four gloo ranks: every rank's rows equal one
    rank's forward. One rank runs 4 edge chunks, each one shard's edges,
    and each of the four runs its edges as one chunk, so both sum each
    destination's messages in one order and cast the same float32 to bf16
    for the ring."""
    cfg, p = mine(5, gather_mode="psw_ring", edge_chunks=4)
    b = numpy_batch(40, 128, cfg.n_species, seed=6, pal_shards=4)
    one = port_forward(p, b, cfg)
    cfg4 = dataclasses.asdict(dataclasses.replace(cfg, edge_chunks=1))
    shards = spawn_ring(equiformer_shard, 4, tmp_path,
                        convert.gnn_params_to_arrays(p), cfg4, b,
                        timeout=120)
    assert [s.shape for s in shards] == [(10, 1)] * 4
    np.testing.assert_allclose(np.concatenate(shards), one, **TOL)


def test_psw_ring_refuses_a_ring_that_does_not_fit():
    cfg, p = mine(7, gather_mode="psw_ring")
    b = {k: torch.from_numpy(v) for k, v in
         numpy_batch(16, 32, cfg.n_species, seed=7).items()}
    from repro_torch.graph.psw_ops import ring_mesh
    with pytest.raises(ValueError, match="16 rows a rank"):
        eq.forward(p, b, cfg, ring=ring_mesh(8))
    with pytest.raises(ValueError, match="chunks"):
        eq.forward(p, b, dataclasses.replace(cfg, edge_chunks=3))
    with pytest.raises(ValueError, match="gather_mode"):
        eq.forward(p, b, dataclasses.replace(cfg, gather_mode="ring"))


def rand_rot(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def test_rotation_invariance():
    """The reference's test (2 layers, l_max 4, m_max 2, 4 heads, 2e-4)."""
    cfg, p = mine(5, n_layers=2, d_hidden=16, l_max=4, m_max=2, n_heads=4)
    b = numpy_batch(10, 30, cfg.n_species, seed=77)
    out1 = port_forward(p, b, cfg)
    out2 = port_forward(p, dict(b, pos=b["pos"] @ rand_rot(77).T), cfg)
    np.testing.assert_allclose(out1, out2, rtol=2e-4, atol=2e-4)


def test_translation_invariance():
    """The reference's test (1 layer, l_max 2, m_max 1, 4 heads, 1e-5)."""
    cfg, p = mine(6, n_layers=1, d_hidden=16, l_max=2, m_max=1, n_heads=4)
    b = numpy_batch(10, 30, cfg.n_species, seed=78)
    out1 = port_forward(p, b, cfg)
    shift = np.asarray([1.0, -2.0, 0.5], np.float32)
    out2 = port_forward(p, dict(b, pos=b["pos"] + shift), cfg)
    np.testing.assert_allclose(out1, out2, rtol=1e-5, atol=1e-5)


def test_message_scatter_goes_through_psw_spmm_rows(monkeypatch):
    """One layout a chunk a forward, one `psw_spmm_rows` a chunk and layer;
    the layouts hold the live edges only (no padding, no zero length)."""
    calls = {"prepare_rows": 0, "psw_spmm_rows": 0}
    nnz = []

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            out = fn(*a, **kw)
            if name == "prepare_rows":
                nnz.append(out.nnz)
            return out
        return wrapper

    for name in calls:
        monkeypatch.setattr(eq, name, counted(name, getattr(ps_ops, name)))
    cfg, p = mine(8, edge_chunks=4)
    nb = numpy_batch(30, 120, cfg.n_species, seed=9)
    eq.forward(p, {k: torch.from_numpy(v) for k, v in nb.items()}, cfg)
    assert calls == {"prepare_rows": 4, "psw_spmm_rows": 4 * cfg.n_layers}
    live = nb["edge_mask"] & (nb["src"] != nb["dst"])
    assert sum(nnz) == live.sum() < 120 - 5 - 3


def test_a_masked_edges_message_reaches_nothing():
    """Masked edges are left out of the scatter (ROADMAP queue 3, caveat
    e): node 29, whose species embeds as NaN, is named only by a masked
    edge into node 5. The port's other logits are those of a finite
    embedding, bitwise; the reference multiplies the masked edge's NaN
    message by 0 and puts NaN into node 5 (and on from there)."""
    ref_cfg, cfg, p_ref, p = both(10)
    b = numpy_batch(30, 120, cfg.n_species, seed=11)
    far, nan_species = 29, cfg.n_species - 1
    b["src"][b["src"] == far] = 28
    b["dst"][b["dst"] == far] = 28
    b["species"][b["species"] == nan_species] = 0
    b["species"][far] = nan_species
    assert not b["edge_mask"][-1]
    b["src"][-1], b["dst"][-1] = far, 5
    clean = port_forward(p, b, cfg)
    p["embed"][nan_species] = float("nan")
    got = port_forward(p, b, cfg)
    assert np.isnan(got[far]).all()
    np.testing.assert_array_equal(np.delete(got, far, 0),
                                  np.delete(clean, far, 0))
    p_ref = dict(p_ref, embed=p_ref["embed"].at[nan_species].set(jnp.nan))
    want = ref_forward(p_ref, b, ref_cfg)
    assert np.isnan(want[5]).all()
    assert np.flatnonzero(np.isnan(got).any(1)).tolist() == [far]


def test_prepare_rows_with_n_src_against_index_add():
    """A scatter layout: rows the destinations, sources the edge ids
    (n_src = E, not n)."""
    rng = np.random.default_rng(12)
    n, E, F = 50, 300, 7
    dst = rng.integers(0, n, E)
    dst[:40] = 3                               # a hub row, chunked
    live = np.flatnonzero(rng.random(E) < 0.8)
    msg = torch.from_numpy(rng.standard_normal((E, F)).astype(np.float32))
    lay = ps_ops.prepare_rows(live, dst[live], n, device="cpu", n_src=E)
    assert (lay.n_rows, lay.n_src, lay.nnz) == (n, E, live.size)
    assert bool((lay.val == 1).all()) and 3 in lay.hub_rows.tolist()
    want = torch.zeros((n, F)).index_add_(0, torch.from_numpy(dst[live]),
                                          msg[live])
    torch.testing.assert_close(ps_ops.psw_spmm_rows(lay, msg), want,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match=r"\[0, 300\)"):
        ps_ops.prepare_rows([300], [0], n, device="cpu", n_src=E)
    with pytest.raises(ValueError, match=r"\[0, 50\)"):
        ps_ops.prepare_rows([0], [50], n, device="cpu", n_src=E)


def test_remat_changes_no_value_and_keeps_gradients():
    """`remat_layers` and the chunk checkpoints recompute under grad and
    change nothing: logits and parameter gradients (through the plain
    scatter on the CPU) equal the unrematerialised forward's."""
    cfg, p = mine(13, edge_chunks=2)
    b = {k: torch.from_numpy(v) for k, v in
         numpy_batch(20, 64, cfg.n_species, seed=14).items()}
    grads = []
    for remat in (False, True):
        leaves = [t.requires_grad_() for t in
                  (p["embed"], p["layers"][0]["so2"]["m0"])]
        out = eq.forward(p, b, dataclasses.replace(cfg, remat_layers=remat))
        g = torch.autograd.grad(out.square().sum(), leaves)
        grads.append((out.detach(), g))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6,
                               atol=1e-6)
    for a, c in zip(grads[0][1], grads[1][1]):
        assert a.abs().sum() > 0
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunks,remat", [(1, False), (4, True)])
def test_node_ce_gradients_match_reference(chunks, remat):
    """l_max 2 (the smoke config): every parameter's gradient of the node
    cross-entropy within 1e-4 of `jax.grad` of the reference's, the
    message scatter's backward through psw_spmm's transpose (one a chunk,
    cached on its layout), with the chunk and layer checkpoints on."""
    from test_torch_gnn import node_ce_ref, port_param_grads
    ref_cfg, cfg, p_ref, p = both(11, edge_chunks=chunks, remat_layers=remat,
                                  d_out=5)
    assert cfg.l_max == 2
    b = numpy_batch(30, 120, cfg.n_species, seed=12)
    b["labels"] = np.random.default_rng(13).integers(0, 5, 30).astype(
        np.int32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_loss, g_ref = jax.value_and_grad(lambda q: node_ce_ref(
        req.forward(q, jb, ref_cfg), jb["labels"],
        jb["node_mask"].astype(jnp.float32)))(p_ref)
    loss, got = port_param_grads(
        eq, p, {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    np.testing.assert_allclose(loss, float(want_loss), **TOL)
    want = convert.gnn_params_to_arrays(g_ref)
    assert got.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, err_msg=key, **TOL)
    assert np.abs(got["embed"]).sum() > 0
