"""The port's GNNs (repro_torch/models/gnn: GIN, PNA, MeshGraphNet), their
configs and params conversion (EquiformerV2's too) against the
reference's, on the CPU (GIN's neighbour sum takes psw_spmm's plain
version there).

The reference's params are initialised with its own jax key and carried
across with `repro_torch.convert.gnn_params_{to,from}_arrays`, so both
packages run the same weights on the same numpy batch. Logits are held at
rtol/atol 1e-4 in float32, the port's model tolerance (as
tests/test_torch_transformer.py holds the transformer)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.graph.sampler import NeighborSampler as RefSampler
from repro.models.gnn import equiformer_v2 as req
from repro.models.gnn import gin as rgin
from repro.models.gnn import meshgraphnet as rmgn
from repro.models.gnn import pna as rpna
import repro.core as R
import repro_torch.core as T
from repro_torch import configs, convert
from repro_torch.graph import NeighborSampler
from repro_torch.kernels.psw_spmm import ops as ps_ops
from repro_torch.models.gnn import equiformer_v2 as eq
from repro_torch.models.gnn import gin, meshgraphnet, pna
from test_torch_multihop import N, bulk

TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = {"gin-tu": (rgin, gin), "pna": (rpna, pna),
          "meshgraphnet": (rmgn, meshgraphnet)}
# EquiformerV2's forward is held in tests/test_torch_equiformer.py
ALL_MODELS = {**MODELS, "equiformer-v2": (req, eq)}


def both(arch, seed, **replace):
    """(reference config, port config, reference params, port params): the
    smoke config with `replace`, the reference's params carried across."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke_config, **replace)
    cfg = dataclasses.replace(configs.get_arch(arch).smoke_config, **replace)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model, _ = MODELS[arch]
    p_ref = ref_model.init_params(jax.random.PRNGKey(seed), ref_cfg)
    p = convert.gnn_params_from_arrays(convert.gnn_params_to_arrays(p_ref),
                                       cfg, "cpu")
    return ref_cfg, cfg, p_ref, p


def numpy_batch(n, e, d_in, d_edge, seed, full_nodes=False):
    """A padded batch: the last edges and (unless `full_nodes`) nodes are
    padding, padded edges point at node 0 as the sampler pads them."""
    rng = np.random.default_rng(seed)
    n_live = n if full_nodes else n - 5
    e_live = e - 9
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    src[:e_live] = rng.integers(0, n_live, e_live)
    dst[:e_live] = rng.integers(0, n_live, e_live)
    return {"x": rng.standard_normal((n, d_in)).astype(np.float32),
            "src": src, "dst": dst,
            "edge_mask": np.arange(e) < e_live,
            "node_mask": np.arange(n) < n_live,
            "edge_attr": rng.standard_normal((e, d_edge)).astype(np.float32)}


def run_both(arch, ref_cfg, cfg, p_ref, p, b):
    ref_model, model = MODELS[arch]
    want = ref_model.forward(p_ref, {k: jnp.asarray(v) for k, v in b.items()},
                             ref_cfg)
    got = model.forward(p, {k: torch.from_numpy(v) for k, v in b.items()},
                        cfg)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got


def in_dims(cfg):
    if isinstance(cfg, meshgraphnet.MeshGraphNetConfig):
        return cfg.d_node_in, cfg.d_edge_in
    return cfg.d_in, 4


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("arch,readout", [("gin-tu", "node"),
                                          ("gin-tu", "graph"),
                                          ("pna", "node"), ("pna", "graph"),
                                          ("meshgraphnet", None)])
def test_forward_matches_reference(arch, readout, chunks):
    kw = {"edge_chunks": chunks}
    if readout is not None:
        kw["readout"] = readout
    ref_cfg, cfg, p_ref, p = both(arch, seed=chunks, **kw)
    b = numpy_batch(40, 128, *in_dims(cfg), seed=len(arch) + chunks)
    out = run_both(arch, ref_cfg, cfg, p_ref, p, b)
    assert torch.isfinite(out).all()


def node_ce_ref(out, labels, mask):
    """The reference's node cross-entropy (repro/launch/steps.py::_gnn_loss
    for a node task): mean over the live nodes."""
    logits = out.astype(jnp.float32)
    logz = jax.scipy.special.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
    ce = (logz - gold) * mask
    return ce.sum() / jnp.maximum(mask.sum(), 1)


def node_ce(out, labels, mask):
    logits = out.float()
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.long()[:, None])[:, 0]
    ce = ce * mask
    return ce.sum() / torch.clamp_min(mask.sum(), 1)


def port_param_grads(model, p, batch, cfg, ring=None):
    """(loss, {dotted key: gradient}) of node_ce through `model.forward`,
    every param a leaf that needs a gradient."""
    names, leaves = zip(*convert._flatten(p))
    for t in leaves:
        t.requires_grad_()
    extra = {} if ring is None else {"ring": ring}
    out = model.forward(p, batch, cfg, **extra)
    loss = node_ce(out, batch["labels"], batch["node_mask"].float())
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "meshgraphnet"])
def test_node_ce_gradients_match_reference(arch):
    """Every parameter's gradient of the node cross-entropy within 1e-4 of
    `jax.grad` of the reference's (GIN's neighbour sum backward through
    psw_spmm's transpose on the CPU; PNA and MeshGraphNet through the
    segment ops)."""
    kw = {} if arch == "meshgraphnet" else {"readout": "node"}
    ref_cfg, cfg, p_ref, p = both(arch, seed=7, **kw)
    b = numpy_batch(40, 128, *in_dims(cfg), seed=8)
    n_out = cfg.d_out if arch == "meshgraphnet" else cfg.n_classes
    b["labels"] = np.random.default_rng(9).integers(0, n_out, 40).astype(
        np.int32)
    ref_model, model = MODELS[arch]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_loss, g_ref = jax.value_and_grad(lambda q: node_ce_ref(
        ref_model.forward(q, jb, ref_cfg), jb["labels"],
        jb["node_mask"].astype(jnp.float32)))(p_ref)
    loss, got = port_param_grads(
        model, p, {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    np.testing.assert_allclose(loss, float(want_loss), **TOL)
    want = convert.gnn_params_to_arrays(g_ref)
    assert got.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, err_msg=key, **TOL)
    assert sum(np.abs(v).sum() for v in got.values()) > 0


def test_chunk_counts_agree():
    for arch in MODELS:
        _, c1, _, p = both(arch, seed=5, edge_chunks=1)
        c4 = dataclasses.replace(c1, edge_chunks=4)
        b = {k: torch.from_numpy(v) for k, v in
             numpy_batch(40, 128, *in_dims(c1), seed=6).items()}
        np.testing.assert_allclose(MODELS[arch][1].forward(p, b, c1).numpy(),
                                   MODELS[arch][1].forward(p, b, c4).numpy(),
                                   **TOL)


def test_pna_counts_padded_edges_at_the_last_node_as_the_reference():
    """Every node slot is real: the padded edges' degree lands on node
    n - 1, a real node, in both packages (ROADMAP queue 3, caveat l)."""
    ref_cfg, cfg, p_ref, p = both("pna", seed=7)
    b = numpy_batch(40, 128, cfg.d_in, 4, seed=8, full_nodes=True)
    got = run_both("pna", ref_cfg, cfg, p_ref, p, b)
    b_unpadded = {k: (v[:119] if k in ("src", "dst", "edge_mask",
                                       "edge_attr") else v)
                  for k, v in b.items()}
    clean = pna.forward(p, {k: torch.from_numpy(v)
                            for k, v in b_unpadded.items()}, cfg)
    assert not torch.allclose(got[-1], clean[-1], **TOL)


def test_sampled_batch_through_all_three_models():
    """The slice as a whole: each package samples a padded minibatch from
    its own store (bitwise the same arrays), gathers node features, and
    each model computes the seeds' logits, port against reference."""
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((N, 8)).astype(np.float32)
    seeds = rng.choice(N, 12, replace=False)
    ref_sub = RefSampler(bulk(R, 9), seed=9).sample(seeds, (15, 10))
    sub = NeighborSampler(bulk(T, 9), seed=9).sample(seeds, (15, 10))
    assert np.array_equal(sub.nodes, ref_sub.nodes)
    assert np.array_equal(sub.src, ref_sub.src)
    E = sub.src.shape[0]
    b = {"x": feats[sub.nodes] * sub.node_mask[:, None], "src": sub.src,
         "dst": sub.dst, "edge_mask": sub.edge_mask,
         "node_mask": sub.node_mask,
         "edge_attr": rng.standard_normal((E, 4)).astype(np.float32)}
    for arch in MODELS:
        kw = {} if arch == "meshgraphnet" else {"readout": "node"}
        ref_cfg, cfg, p_ref, p = both(arch, seed=10, **kw)
        out = run_both(arch, ref_cfg, cfg, p_ref, p, b)
        assert torch.isfinite(out[:sub.n_seeds]).all()


def test_gin_neighbour_sum_goes_through_psw_spmm_rows(monkeypatch):
    """One `prepare_rows` layout of the live edges a forward, one
    `psw_spmm_rows` a layer, whatever `edge_chunks` says."""
    calls = {"prepare_rows": 0, "psw_spmm_rows": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(gin, name, counted(name, getattr(ps_ops, name)))
    _, cfg, _, p = both("gin-tu", seed=11, readout="node")
    b = {k: torch.from_numpy(v) for k, v in
         numpy_batch(40, 128, cfg.d_in, 4, seed=12).items()}
    gin.forward(p, b, cfg)
    assert calls == {"prepare_rows": 1, "psw_spmm_rows": cfg.n_layers}
    gin.forward(p, b, dataclasses.replace(cfg, edge_chunks=4))
    assert calls == {"prepare_rows": 2, "psw_spmm_rows": 2 * cfg.n_layers}


def test_gin_sum_aggregation_counts_multiplicity():
    """GIN must distinguish multisets: double edges change the output (the
    port of the reference's test of the same name)."""
    ref_cfg = rgin.GINConfig(n_layers=1, d_hidden=8, d_in=4, n_classes=2,
                             readout="node")
    cfg = gin.GINConfig(n_layers=1, d_hidden=8, d_in=4, n_classes=2,
                        readout="node")
    p = convert.gnn_params_from_arrays(convert.gnn_params_to_arrays(
        rgin.init_params(jax.random.PRNGKey(2), ref_cfg)), cfg, "cpu")
    b1 = {"x": torch.ones((3, 4)), "src": torch.tensor([0, 1]),
          "dst": torch.tensor([2, 2]), "edge_mask": torch.ones(2, dtype=bool),
          "node_mask": torch.ones(3, dtype=bool)}
    b2 = dict(b1, src=torch.tensor([0, 0]))
    o1, o2 = gin.forward(p, b1, cfg), gin.forward(p, b2, cfg)
    xd = b1["x"].clone()
    xd[1] = 2.0
    o1d = gin.forward(p, dict(b1, x=xd), cfg)
    o2d = gin.forward(p, dict(b2, x=xd), cfg)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-6)
    assert float((o1d[2] - o2d[2]).abs().max()) > 1e-6


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "meshgraphnet",
                                  "equiformer-v2"])
def test_arch_specs_match_reference(arch):
    want, got = ref_get_arch(arch), configs.get_arch(arch)
    for name in ("name", "family", "source"):
        assert getattr(got, name) == getattr(want, name)
    for name in ("config", "smoke_config"):
        a, b = getattr(got, name), getattr(want, name)
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert list(got.shapes) == list(want.shapes)
    for k in want.shapes:
        assert dataclasses.asdict(got.shapes[k]) == \
            dataclasses.asdict(want.shapes[k])


def test_equiformer_resolves_in_the_port():
    """EquiformerV2 is ported (slice 6b): its spec is the reference's (the
    parametrized spec test), and the registry refuses no architecture."""
    assert configs.get_arch("equiformer-v2").config == eq.EquiformerV2Config()
    from repro_torch.configs.base import _NOT_PORTED
    assert _NOT_PORTED == {}


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "meshgraphnet",
                                  "equiformer-v2"])
def test_params_round_trip_bytes(arch):
    ref_cfg = ref_get_arch(arch).smoke_config
    cfg = configs.get_arch(arch).smoke_config
    d = convert.gnn_params_to_arrays(
        ALL_MODELS[arch][0].init_params(jax.random.PRNGKey(3), ref_cfg))
    p = convert.gnn_params_from_arrays(d, cfg, "cpu")
    back = convert.gnn_params_to_arrays(p)
    assert list(back) == list(d)
    for k in d:
        assert back[k].dtype == d[k].dtype and back[k].shape == d[k].shape
        assert back[k].tobytes() == d[k].tobytes(), k
    # a port tree is a template too, and the layout is the port's own init
    again = convert.gnn_params_from_arrays(back, p, "cpu")
    assert convert.gnn_params_to_arrays(again).keys() == d.keys()
    mine = ALL_MODELS[arch][1].init_params(torch.Generator().manual_seed(0),
                                           cfg, "cpu")
    assert {k: v.shape for k, v in convert.gnn_params_to_arrays(
        mine).items()} == {k: v.shape for k, v in d.items()}
    with pytest.raises(ValueError, match="keys differ"):
        convert.gnn_params_from_arrays(dict(list(d.items())[1:]), cfg, "cpu")
    k0 = next(iter(d))
    with pytest.raises(ValueError, match="shape"):
        convert.gnn_params_from_arrays({**d, k0: d[k0][:1]}, cfg, "cpu")
