"""The port's cell steps (repro_torch/launch/steps.py) against the
reference's (repro/launch/steps.py): `build_cell(...).fn` on the CPU at
the arches' smoke configs, the reference's jitted with no mesh, both on
the same params (the reference's jax-initialised ones carried across with
`repro_torch.convert`) and the same seeded numpy inputs.

Tolerances: LM train steps (loss, gradient norm, updated params, AdamW
moments) 1e-4, the port's model tolerance; the accum = 2 step against the
mean of two `jax.value_and_grad` calls and AdamW, 1e-4; retrieval,
prefill and decode 1e-4 (the bf16 caches to one bf16 step); one GNN train
step of each model 1e-4. The accumulation count equals the reference's
for every LM arch on both production meshes (its `AbstractMesh`es).
bert4rec's train and bulk-serve cells at their full batch rules are in
tests/test_torch_steps_recsys.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import sharding as R
from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as ref_steps
from repro.models import bert4rec as ref_b4
from repro.models import transformer as ref_tf
from repro.models.gnn import equiformer_v2 as req
from repro.models.gnn import gin as rgin
from repro.models.gnn import meshgraphnet as rmgn
from repro.models.gnn import pna as rpna
from repro.optim import adamw as ref_opt
from repro_torch import convert
from repro_torch import sharding as S
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import steps
from repro_torch.optim import adamw_init

TOL = dict(rtol=1e-4, atol=1e-4)
REF_GNN = {"gin-tu": rgin, "pna": rpna, "meshgraphnet": rmgn,
           "equiformer-v2": req}


def plans(arch, shape, **dims):
    """(ref spec, port spec, ref plan, port plan) at the smoke config with
    the cell's dims overridden."""
    out = []
    for get, mod, rules in ((ref_get_arch, ref_steps, R), (get_arch, steps,
                                                            S)):
        spec = get(arch)
        cell = spec.shapes[shape]
        spec = dataclasses.replace(
            spec, config=spec.smoke_config,
            shapes={shape: dataclasses.replace(
                cell, dims={**cell.dims, **dims})})
        out.append((spec, mod.build_cell(
            spec, shape, rules.ShardingRules(dict(rules.DEFAULT_RULES)), 1)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def arrays(tree):
    return convert.gnn_params_to_arrays(tree)


def close(got, want, tol=TOL, what=""):
    a, b = arrays(got), arrays(want)
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=f"{what}{k}", **tol)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(tree):
    return jax.tree.map(jnp.asarray, tree)


def lm_inputs(arch, seed, B, S_):
    rspec, tspec, rplan, tplan = plans(arch, "train_4k", batch=B, seq=S_)
    p_ref = ref_tf.init_params(jax.random.PRNGKey(seed), rspec.config)
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(p_ref), tspec.config, "cpu")
    rng = np.random.default_rng(seed)
    v = tspec.config.vocab_size
    batch = {"tokens": rng.integers(0, v, (B, S_)).astype(np.int32),
             "labels": rng.integers(0, v, (B, S_)).astype(np.int32)}
    return rspec, tspec, rplan, tplan, p_ref, p, batch


def check_step(out, p_ref, o_ref, m_ref, tol=TOL):
    p, o, m = out
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), **tol)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_ref["grad_norm"]), **tol)
    close(p, p_ref, tol, "params ")
    close(o["m"], o_ref["m"], tol, "m ")
    close(o["v"], o_ref["v"], tol, "v ")
    assert int(o["step"]) == int(o_ref["step"]) == 1


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b"])
def test_lm_train_step_matches_reference(arch):
    rspec, tspec, rplan, tplan, p_ref, p, batch = lm_inputs(arch, 1, 4, 16)
    assert rplan.meta == tplan.meta
    want = jax.jit(rplan.fn)(p_ref, ref_opt.adamw_init(p_ref), j(batch))
    got = tplan.fn(p, adamw_init(p), {k: t(v) for k, v in batch.items()})
    check_step(got, *want)


def test_lm_accumulated_step_is_the_mean_of_two_gradients(monkeypatch):
    """accum = 2: the port's step against two `jax.value_and_grad` calls on
    the batch's halves, their mean, and the reference's AdamW."""
    monkeypatch.setattr(steps, "lm_grad_accum", lambda *a, **k: 2)
    arch = "granite-3-2b"
    rspec, tspec, rplan, tplan, p_ref, p, batch = lm_inputs(arch, 2, 4, 16)
    assert tplan.meta["grad_accum"] == 2
    cfg = rspec.config
    losses, grads = [], []
    for half in (slice(0, 2), slice(2, 4)):
        mb = {k: jnp.asarray(v[half]) for k, v in batch.items()}
        l, g = jax.value_and_grad(ref_tf.loss_fn)(p_ref, mb, cfg)
        losses.append(l)
        grads.append(g)
    mean = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
    p_new, o_new, met = ref_opt.adamw_update(
        mean, ref_opt.adamw_init(p_ref), p_ref, ref_opt.AdamWConfig())
    got = tplan.fn(p, adamw_init(p), {k: t(v) for k, v in batch.items()})
    check_step(got, p_new, o_new, {"loss": (losses[0] + losses[1]) / 2,
                                   **met})


class _Mesh:
    """What `lm_grad_accum` reads of a DeviceMesh."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names


@pytest.mark.parametrize("multi", [False, True])
def test_accumulation_count_matches_reference_on_both_meshes(multi):
    from jax.sharding import AbstractMesh
    shape = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    try:
        amesh = AbstractMesh(shape, names)
    except TypeError:                               # older jax
        amesh = AbstractMesh(tuple(zip(names, shape)))
    n = 0
    for arch in ARCH_IDS:
        spec = get_arch(arch)
        if spec.family != "lm":
            continue
        dims = spec.shapes["train_4k"].dims
        want = ref_steps.build_cell(
            ref_get_arch(arch), "train_4k",
            R.ShardingRules(dict(R.DEFAULT_RULES), amesh),
            int(np.prod(shape))).meta["grad_accum"]
        got = steps.lm_grad_accum(spec.config, dims["batch"], dims["seq"],
                                  _Mesh(shape, names))
        assert got == want, arch
        n += 1
    assert n == 5
    assert steps.lm_grad_accum(get_arch("granite-3-2b").config, 8, 4096) == 2


def rec_params(seed):
    rspec, tspec, *_ = plans("bert4rec", "serve_p99")
    p_ref = ref_b4.init_params(jax.random.PRNGKey(seed), rspec.config)
    return p_ref, convert.bert4rec_params_from_arrays(
        convert.bert4rec_params_to_arrays(p_ref), tspec.config, "cpu")


def histories(cfg, n, seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, cfg.n_items + 1, (n, cfg.seq_len))
    lens = rng.integers(1, cfg.seq_len + 1, (n, 1))
    return np.where(np.arange(cfg.seq_len) >= cfg.seq_len - lens, seq,
                    0).astype(np.int32)


def test_topk_stable_keeps_the_reference_tie_order():
    vals = np.array([[1, 3, 3, 2, 3, 0, 3, -np.inf]], np.float32)
    ids = np.arange(8, dtype=np.int32)[None] * 10
    for k in (1, 2, 3, 5, 8):
        v, i = steps.topk_stable(t(vals), t(ids), k)
        rv, ri = jax.lax.top_k(jnp.asarray(vals), k)
        assert np.array_equal(v.numpy(), np.asarray(rv))
        assert np.array_equal(i.numpy(), ids[0][np.asarray(ri)])


def test_bert4rec_retrieval_step():
    rspec, tspec, rplan, tplan = plans("bert4rec", "retrieval_cand",
                                       n_candidates=150)
    p_ref, p = rec_params(7)
    seq = histories(tspec.config, 1, 8)
    cand = (np.random.default_rng(8).permutation(tspec.config.n_items)[:150]
            + 1).astype(np.int32)
    v_ref, i_ref = jax.jit(rplan.fn)(p_ref, jnp.asarray(seq),
                                     jnp.asarray(cand))
    v, i = tplan.fn(p, t(seq), t(cand))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), **TOL)
    assert np.array_equal(i.numpy(), np.asarray(i_ref))


def test_lm_prefill_and_decode_cells():
    B, S_ = 2, 16
    arch = "granite-3-2b"
    rspec, tspec, rplan, tplan = plans(arch, "prefill_32k", batch=B, seq=S_)
    _, _, rdec, tdec = plans(arch, "decode_32k", batch=B, seq=S_)
    p_ref = ref_tf.init_params(jax.random.PRNGKey(9), rspec.config)
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(p_ref), tspec.config, "cpu")
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, tspec.config.vocab_size, (B, S_)).astype(
        np.int32)
    l_ref, c_ref = jax.jit(rplan.fn)(p_ref, jnp.asarray(tokens))
    with torch.no_grad():
        lg, cache = tplan.fn(p, t(tokens))
    np.testing.assert_allclose(lg.float().numpy(), np.asarray(
        l_ref, np.float32), **TOL)
    bf16 = dict(rtol=1e-2, atol=1e-2)        # one bf16 step
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].float().numpy(), np.asarray(
            c_ref[k], np.float32), **bf16)
    # decode at the last slot of a random bf16 cache
    assert tdec.args[3] == S_ - 1
    cr = {k: (rng.standard_normal((tspec.config.n_layers, B, S_,
                                   tspec.config.n_kv_heads,
                                   tspec.config.head_dim)) * 0.5)
          for k in ("k", "v")}
    c_j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cr.items()}
    c_t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
           for k, v in c_j.items()}
    tok = tokens[:, :1]
    l_ref, c2_ref = jax.jit(rdec.fn)(p_ref, c_j, jnp.asarray(tok),
                                     jnp.int32(S_ - 1))
    with torch.no_grad():
        lg, c2 = tdec.fn(p, c_t, t(tok), S_ - 1)
    np.testing.assert_allclose(lg.float().numpy(), np.asarray(
        l_ref, np.float32), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(c2[k].float().numpy(), np.asarray(
            c2_ref[k], np.float32), **bf16)


GNN_DIMS = dict(n_nodes=300, n_edges=1200, d_feat=12, n_classes=5)


def gnn_batch(arch, dims, seed):
    rng = np.random.default_rng(seed)
    lead = (dims["batch"],) if "batch" in dims else ()
    N, E = dims["n_nodes"], dims["n_edges"]
    b = {"src": rng.integers(0, N, (*lead, E)).astype(np.int32),
         "dst": rng.integers(0, N, (*lead, E)).astype(np.int32),
         "edge_mask": rng.random((*lead, E)) < 0.9,
         "node_mask": rng.random((*lead, N)) < 0.95}
    if arch == "equiformer-v2":
        b["species"] = rng.integers(0, 128, (*lead, N)).astype(np.int32)
        b["pos"] = (rng.random((*lead, N, 3)) * 4).astype(np.float32)
    else:
        b["x"] = rng.standard_normal((*lead, N, dims["d_feat"])).astype(
            np.float32)
    if arch == "meshgraphnet":
        b["edge_attr"] = rng.standard_normal((*lead, E, 4)).astype(
            np.float32)
    if dims["task"] == "graph_reg":
        b["labels"] = rng.standard_normal(dims["batch"]).astype(np.float32)
    else:
        b["labels"] = rng.integers(0, dims["n_classes"], (*lead, N)).astype(
            np.int32)
    return b


@pytest.mark.parametrize("arch,shape,dims", [
    ("gin-tu", "full_graph_sm", GNN_DIMS),
    ("pna", "full_graph_sm", GNN_DIMS),
    ("meshgraphnet", "full_graph_sm", GNN_DIMS),
    ("equiformer-v2", "full_graph_sm", GNN_DIMS),
    ("gin-tu", "molecule", dict(batch=4, n_nodes=10, n_edges=20)),
])
def test_gnn_train_step_matches_reference(arch, shape, dims):
    rspec, tspec, rplan, tplan = plans(arch, shape, **dims)
    cell = tspec.shapes[shape]
    assert rplan.meta == tplan.meta
    rcfg = ref_steps._adapt_gnn_config(arch, rspec.config,
                                       rspec.shapes[shape].dims)
    cfg = steps._adapt_gnn_config(arch, tspec.config, cell.dims)
    p_ref = REF_GNN[arch].init_params(jax.random.PRNGKey(10), rcfg)
    p = convert.gnn_params_from_arrays(convert.gnn_params_to_arrays(p_ref),
                                       cfg, "cpu")
    batch = gnn_batch(arch, cell.dims, 11)
    want = jax.jit(rplan.fn)(p_ref, ref_opt.adamw_init(p_ref), j(batch))
    got = tplan.fn(p, adamw_init(p), {k: t(v) for k, v in batch.items()})
    check_step(got, *want)


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-2b", "train_4k"), ("granite-3-2b", "decode_32k"),
    ("bert4rec", "train_batch"), ("bert4rec", "retrieval_cand"),
    ("gin-tu", "ogb_products"), ("equiformer-v2", "molecule"),
    ("meshgraphnet", "full_graph_sm")])
def test_materialize_fills_the_args_shapes_with_valid_inputs(arch, shape):
    spec = get_arch(arch)
    dims = {"train_4k": dict(batch=4, seq=32), "decode_32k":
            dict(batch=2, seq=32), "train_batch": dict(batch=64),
            "retrieval_cand": dict(n_candidates=100),
            "ogb_products": dict(n_nodes=5000, n_edges=20000),
            "molecule": dict(batch=2, n_nodes=6, n_edges=10)}.get(shape, {})
    cell = spec.shapes[shape]
    spec = dataclasses.replace(spec, config=spec.smoke_config, shapes={
        shape: dataclasses.replace(cell, dims={**cell.dims, **dims})})
    plan = steps.build_cell(spec, shape, S.ShardingRules(
        dict(S.DEFAULT_RULES)), 1)
    args = steps.materialize(plan, "cpu")
    metas = pytree.tree_leaves(plan.args)
    reals = pytree.tree_leaves(args)
    assert len(metas) == len(reals)
    for m, r in zip(metas, reals):
        if isinstance(m, torch.Tensor):
            assert m.device.type == "meta"
            assert (r.shape, r.dtype) == (m.shape, m.dtype)
            assert r.device.type == "cpu"
            if r.is_floating_point():
                assert torch.isfinite(r).all()
        else:
            assert r == m
    # and the step runs on them
    out = plan.fn(*args)
    for leaf in pytree.tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            assert torch.isfinite(leaf).all()
