"""The port's MoE dispatch (`models/transformer.py::moe_mlp`) against the
reference's, on the CPU in float32.

The reference's params are initialised with its own jax key and carried
across with `repro_torch.convert`; inputs are seeded numpy normals, so the
router's logits have no ties (`lax.top_k` and `torch.topk` may order tied
experts differently). Outputs are held at 1e-5 and the balance loss at
1e-6. Each place where a port of GShard's dispatch is likely to go wrong
has a test of its own: the sequence chunks, the capacity formula, the
token order inside an expert when the capacity binds, the empty slots,
and decode against forward, which holds only when no token is dropped."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro_torch import configs, convert
from repro_torch.models import transformer as tf

MOE_ARCHS = ["qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def with_capacity(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def layer0(arch, cf, seed=1):
    """Both packages' layer-0 MoE params and configs at capacity factor
    `cf` (the reference's params carried across)."""
    ref_cfg = with_capacity(ref_get_arch(arch).smoke_config, cf)
    cfg = with_capacity(configs.get_arch(arch).smoke_config, cf)
    p_ref = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(p_ref), cfg, "cpu")
    lp_ref = jax.tree.map(lambda w: w[0], p_ref["layers"]["mlp"])
    lp = {k: v[0] for k, v in p["layers"]["mlp"].items()}
    return ref_cfg, cfg, lp_ref, lp


def both_moe(lp_ref, lp, x, ref_cfg, cfg):
    want, aux_ref = ref_tf.moe_mlp(lp_ref, jnp.asarray(x), ref_cfg)
    got, aux = tf.moe_mlp(lp, torch.from_numpy(x), cfg)
    return np.asarray(want), float(aux_ref), got.numpy(), float(aux)


def dropped_pairs(lp, x, cfg, s_chunk):
    """(token, expert) pairs past their expert's capacity, counted per
    routing group of `s_chunk` positions as the dispatch counts them."""
    B, S, d = x.shape
    n = 0
    for c in range(0, S, s_chunk):
        xg = torch.from_numpy(x[:, c:c + s_chunk].reshape(-1, d))
        _, _, idx = tf.route_tokens(lp["router"], xg, cfg.moe)
        cap = tf.moe_capacity(cfg.moe, xg.shape[0])
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
        n += int(torch.clamp_min(counts - cap, 0).sum())
    return n


@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("S", [16, 4096])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_reference(arch, S, cf):
    """One routing group (S = 16) and two sequence chunks (S = 4,096), with
    tokens dropped (capacity factor 0.5) and none (8.0)."""
    ref_cfg, cfg, lp_ref, lp = layer0(arch, cf)
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    want, aux_ref, got, aux = both_moe(lp_ref, lp, x, ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, aux_ref, rtol=1e-6, atol=1e-6)
    dropped = dropped_pairs(lp, x, cfg, min(S, tf.MOE_SEQ_CHUNK))
    assert (dropped > 0) == (cf < 1.0), dropped


def test_long_sequences_route_in_chunks_of_2048(monkeypatch):
    """S = 4,096 is routed as two chunks of B·2,048 tokens, each with its
    own capacity; routing all B·S tokens at once drops other tokens and
    gives other outputs, and S = 4,112 (not a multiple) is one group."""
    ref_cfg, cfg, lp_ref, lp = layer0(MOE_ARCHS[0], 0.5)
    x = np.random.default_rng(5).normal(size=(2, 4096, cfg.d_model)).astype(
        np.float32)
    groups = []
    real = tf._moe_core

    def spy(params, xc, c):
        groups.append(tuple(xc.shape))
        return real(params, xc, c)

    monkeypatch.setattr(tf, "_moe_core", spy)
    want, aux_ref, got, aux = both_moe(lp_ref, lp, x, ref_cfg, cfg)
    assert groups == [(2, 2048, cfg.d_model)] * 2
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, aux_ref, rtol=1e-6, atol=1e-6)
    whole, _ = real(lp, torch.from_numpy(x), cfg)
    assert np.abs(whole.numpy() - want).max() > 1e-2

    groups.clear()
    x = np.random.default_rng(6).normal(size=(1, 4112, cfg.d_model)).astype(
        np.float32)
    want, _, got, _ = both_moe(lp_ref, lp, x, ref_cfg, cfg)
    assert groups == [(1, 4112, cfg.d_model)]
    np.testing.assert_allclose(got, want, **TOL)


def test_capacity_truncates_as_the_reference():
    """cap = int(cf·t·K/E + 0.5), then at least 8 and a multiple of 8: at
    cf·t·K/E = 16.5 that is 24 slots, where rounding half to even would
    give 16. The dispatch at that shape matches the reference's."""
    mo = tf.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=1.0)
    assert tf.moe_capacity(mo, 66) == 24
    assert tf.moe_capacity(mo, 64) == 16
    assert tf.moe_capacity(mo, 1) == 8
    # qwen3-moe's full config, one prefill chunk of 4 x 2,048 tokens
    qwen = configs.get_arch(MOE_ARCHS[0]).config.moe
    assert tf.moe_capacity(qwen, 4 * 2048) == 640
    ref_cfg, cfg, lp_ref, lp = layer0(MOE_ARCHS[0], 1.0)
    assert cfg.moe.n_experts == 8 and cfg.moe.top_k == 2
    x = np.random.default_rng(7).normal(size=(1, 66, cfg.d_model)).astype(
        np.float32)
    want, _, got, _ = both_moe(lp_ref, lp, x, ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)


def steered(cfg, lp, n_tokens, seed):
    """Inputs whose router sends every token to experts 0 and 1 (distinct
    margins, no ties): expert 0 and 1 overflow, the others stay empty."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, n_tokens, cfg.d_model)).astype(np.float32)
    x[..., 0] = 4.0 + rng.random(n_tokens)
    router = lp["router"].clone()
    router[0, 0], router[0, 1] = 10.0, 8.0
    return x, router


def test_capacity_keeps_the_first_tokens_of_each_expert():
    """When the capacity binds, an expert keeps the tokens that come first
    in token order (a stable sort): with every token routed to experts 0
    and 1 at 16 slots each, tokens 0-15 keep both and tokens 16-31 lose
    both (their output is exactly 0), as in the reference."""
    ref_cfg, cfg, lp_ref, lp = layer0(MOE_ARCHS[0], 1.25)
    x, router = steered(cfg, lp, 32, seed=8)
    lp["router"] = router
    lp_ref = {**lp_ref, "router": jnp.asarray(router.numpy())}
    _, _, idx = tf.route_tokens(router, torch.from_numpy(x[0]), cfg.moe)
    assert torch.equal(idx, torch.tensor([[0, 1]] * 32))
    assert tf.moe_capacity(cfg.moe, 32) == 16
    want, _, got, _ = both_moe(lp_ref, lp, x, ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)
    assert (np.abs(got[0, :16]).max(-1) > 0).all()
    assert (got[0, 16:] == 0).all() and (want[0, 16:] == 0).all()


def test_empty_slots_run_token_0_through_the_expert_at_gate_0():
    """Empty slots gather token 0 with gate 0: the expert FFN runs on x[0]
    and its output is multiplied by 0, so a non-finite output of an
    expert no token chose makes token 0 NaN and leaves the others, in
    both packages."""
    ref_cfg, cfg, lp_ref, lp = layer0(MOE_ARCHS[0], 1.25)
    x, router = steered(cfg, lp, 32, seed=9)
    lp["router"] = router
    lp["w_down"] = lp["w_down"].clone()
    lp["w_down"][5] = torch.inf                   # expert 5: no token
    lp_ref = {**lp_ref, "router": jnp.asarray(router.numpy()),
              "w_down": jnp.asarray(lp["w_down"].numpy())}
    want, _, got, _ = both_moe(lp_ref, lp, x, ref_cfg, cfg)
    assert np.isnan(want[0, 0]).all() and np.isnan(got[0, 0]).all()
    np.testing.assert_allclose(got[0, 1:], want[0, 1:], **TOL)
    assert np.isfinite(got[0, 1:]).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_forward_when_no_token_is_dropped(arch):
    """A decode step routes B tokens and a forward B·S, so their capacities
    differ; at capacity factor E/K no token is dropped in either, and then
    prefill and every decode step equal the forward's logits (1e-4), with
    the reference's forward and summed balance loss."""
    smoke = configs.get_arch(arch).smoke_config
    cf = smoke.moe.n_experts / smoke.moe.top_k
    ref_cfg = with_capacity(ref_get_arch(arch).smoke_config, cf)
    cfg = with_capacity(smoke, cf)
    p_ref = ref_tf.init_params(jax.random.PRNGKey(3), ref_cfg)
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(p_ref), cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32))
    tt = torch.from_numpy(toks)
    want, aux_ref = ref_tf.forward(p_ref, jnp.asarray(toks, jnp.int32),
                                   ref_cfg)
    full, aux = tf.forward(p, tt, cfg)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    lg, cache = tf.prefill(p, tt[:, :16], cfg, max_seq=32,
                           cache_dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), full[:, 15].numpy(), rtol=1e-4,
                               atol=1e-4)
    for i in range(16, 24):
        lg, cache = tf.decode_step(p, cache, tt[:, i:i + 1], i, cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_gradients_match_reference(arch):
    """The gradient of a weighted sum of the MoE output plus its balance
    loss, with respect to x and every expert and router weight, within
    1e-5 of `jax.grad` of the reference's; the capacity binds (factor
    0.5), so dropped pairs take no gradient in either; the router's
    gradient is not 0 (it flows through the gates and the aux)."""
    ref_cfg, cfg, lp_ref, lp = layer0(arch, 0.5, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def ref_loss(q, xj):
        out, aux = ref_tf.moe_mlp(q, xj, ref_cfg)
        return jnp.sum(out * w) + aux

    g_ref, gx_ref = jax.grad(ref_loss, argnums=(0, 1))(lp_ref, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    names = sorted(lp)
    leaves = [lp[k].requires_grad_() for k in names]
    out, aux = tf.moe_mlp(lp, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [xt] + leaves)
    assert dropped_pairs(lp, x, cfg, 16) > 0
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_ref), **TOL)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref[name]),
                                   err_msg=name, **TOL)
    assert float(grads[1 + names.index("router")].abs().sum()) > 0
