"""The port's transformer (dense and MoE), configs, serving loop and params
conversion against the reference's, on the CPU (prefill attention takes
the flash kernel's plain version there).

The reference's params are initialised with its own jax key and carried
across with `repro_torch.convert`, so both packages run the same weights.
Logits, caches and decode steps are held at 1e-4 in float32, the tolerance
of the reference's `test_decode_matches_forward_fp32`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro.models import transformer as ref_tf
from repro_torch import configs, convert
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.serve import serve_requests
from repro_torch.models import transformer as tf

MOE_ARCHS = ["qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b"]
LM_ARCHS = ["granite-3-2b", "qwen3-14b", "granite-34b"] + MOE_ARCHS
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def port_cfg(ref_cfg):
    """The port's config of the same numbers (dtypes mapped to torch)."""
    kw = fields(ref_cfg)
    kw["param_dtype"] = DTYPES[kw["param_dtype"]]
    kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
    if kw["moe"] is not None:
        moe = fields(kw["moe"])
        moe["router_dtype"] = DTYPES[moe["router_dtype"]]
        kw["moe"] = tf.MoEConfig(**moe)
    return tf.TransformerConfig(**kw)


def both_params(arch, seed):
    ref_cfg = ref_get_arch(arch).smoke_config
    cfg = configs.get_arch(arch).smoke_config
    assert cfg == port_cfg(ref_cfg)
    p_ref = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(p_ref), cfg, "cpu")
    return ref_cfg, cfg, p_ref, p


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-14b"] + MOE_ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    """Each against the reference. Prefill and decode against the port's
    own forward too, where that holds: a MoE layer's capacity depends on
    how many tokens it routes together, so at the smoke configs' capacity
    factor 1.25 they agree only when no token is dropped (test_torch_moe
    holds them at E/K)."""
    ref_cfg, cfg, p_ref, p = both_params(arch, seed=2)
    toks = tokens(cfg, 2, 32, seed=3)   # chunks of 16 divide it
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    want, aux_ref = ref_tf.forward(p_ref, jt, ref_cfg)
    got, aux = tf.forward(p, tt, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    assert (float(aux) == 0.0) == (cfg.moe is None)
    dense = cfg.moe is None

    lw, cw = ref_tf.prefill(p_ref, jt[:, :16], ref_cfg, max_seq=32,
                            cache_dtype=jnp.float32)
    lg, cg = tf.prefill(p, tt[:, :16], cfg, max_seq=32,
                        cache_dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), **TOL)
    if dense:
        np.testing.assert_allclose(lg.numpy(), got[:, 15].numpy(), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cg[name].numpy(), np.asarray(cw[name]),
                                   **TOL)
    for i in range(16, 22):
        lw, cw = ref_tf.decode_step(p_ref, cw, jt[:, i:i + 1], jnp.int32(i),
                                    ref_cfg)
        lg, cg = tf.decode_step(p, cg, tt[:, i:i + 1], i, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), **TOL)
        if dense:
            np.testing.assert_allclose(lg.numpy(), got[:, i].numpy(), **TOL)
    d = convert.kv_cache_to_arrays(cg)
    back = convert.kv_cache_from_arrays(d, cfg, "cpu", torch.float32)
    assert all(torch.equal(back[n], cg[n]) for n in ("k", "v"))


def test_blockwise_attention_matches_reference():
    rng = np.random.default_rng(3)
    B, S, H, Hkv, D = 2, 32, 4, 2, 16
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    for causal in (True, False):
        want = ref_tf.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          causal=causal, q_chunk=8,
                                          kv_chunk=8)
        got = tf.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     causal=causal, q_chunk=8, kv_chunk=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_prefill_goes_through_flash_attention(monkeypatch):
    """Every layer's prefill attention is one flash_attention call."""
    _, cfg, _, p = both_params("granite-3-2b", seed=0)
    calls = []
    real = tf.flash_attention

    def spy(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal)

    monkeypatch.setattr(tf, "flash_attention", spy)
    before = fa_ops.launches
    tf.prefill(p, torch.from_numpy(tokens(cfg, 2, 9, seed=1)), cfg, 12)
    assert calls == [((2, 9, 4, 16), (2, 9, 2, 16), True)] * cfg.n_layers
    assert fa_ops.launches == before          # the plain version on the CPU


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    ref_spec, spec = ref_get_arch(arch), configs.get_arch(arch)
    for ref_cfg, cfg in ((ref_spec.config, spec.config),
                         (ref_spec.smoke_config, spec.smoke_config)):
        assert cfg == port_cfg(ref_cfg)
        assert cfg.n_params == ref_cfg.n_params
        assert cfg.n_active_params == ref_cfg.n_active_params
        assert cfg.padded_vocab == ref_cfg.padded_vocab
    assert {n: dataclasses.asdict(c) for n, c in spec.shapes.items()} == {
        n: dataclasses.asdict(c) for n, c in ref_spec.shapes.items()}
    assert spec.source == ref_spec.source
    p = tf.init_params(spec.smoke_config, device="cpu")
    assert sum(a.size for a in
               convert.transformer_params_to_arrays(p).values()) \
        == spec.smoke_config.n_params


def test_registry_lists_every_arch_and_refuses_unported_ones():
    """Every architecture of the reference resolves in the port (none is
    left unported); an unknown id raises KeyError."""
    from repro_torch.configs.base import _NOT_PORTED
    assert configs.list_archs() == ref_list_archs()
    assert _NOT_PORTED == {}
    for arch in configs.list_archs():
        assert configs.get_arch(arch).name == arch
    with pytest.raises(KeyError):
        configs.get_arch("gpt-2")


def test_moe_and_training_raise():
    """MoE layers run (init, forward with its balance loss, prefill, a
    decode step), and so does training: `loss_fn` of the dense and the MoE
    config is finite, with a finite gradient for every leaf and a router
    gradient that is not 0. (The port's loss and
    gradient against the reference's: tests/test_torch_train.py.)"""
    cfg = dataclasses.replace(configs.get_arch("granite-3-2b").smoke_config,
                              moe=tf.MoEConfig(4, 2, 64))
    assert cfg.n_params == ref_tf.TransformerConfig(
        2, 64, 4, 2, 128, 128, d_head=16,
        moe=ref_tf.MoEConfig(4, 2, 64)).n_params
    p = tf.init_params(cfg, device="cpu")
    assert sum(a.size for a in convert.transformer_params_to_arrays(
        p).values()) == cfg.n_params
    toks = torch.from_numpy(tokens(cfg, 2, 8, seed=0))
    with torch.no_grad():
        logits, aux = tf.forward(p, toks, cfg)
        last, cache = tf.prefill(p, toks, cfg, 10)
        step, _ = tf.decode_step(p, cache, last.argmax(-1)[:, None], 8, cfg)
    assert logits.shape == (2, 8, cfg.padded_vocab) and float(aux) > 0
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    labels = torch.from_numpy(tokens(cfg, 2, 8, seed=1))
    for c in (cfg, configs.get_arch("granite-3-2b").smoke_config):
        q = tf.init_params(c, device="cpu")
        names, leaves = zip(*convert._flatten(q))
        for t in leaves:
            t.requires_grad_()
        loss = tf.loss_fn(q, {"tokens": toks, "labels": labels}, c)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        assert loss.dim() == 0 and torch.isfinite(loss)
        assert all(torch.isfinite(g).all() for g in grads.values())
        if c.moe is not None:
            assert float(grads["layers.mlp.router"].abs().sum()) > 0


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b"])
def test_serve_requests_matches_reference_greedy_loop(arch):
    """The reference launcher's loop (prefill, then argmax decode, bf16
    caches) over the same params and prompts gives the same tokens."""
    ref_cfg, cfg, p_ref, p = both_params(arch, seed=0)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (5, 16))
    gen = 6
    want = []
    for i in range(0, 5, 2):
        toks = jnp.asarray(prompts[i:i + 2], jnp.int32)
        logits, cache = ref_tf.prefill(p_ref, toks, ref_cfg, max_seq=16 + gen)
        out = [jnp.argmax(logits, -1)]
        for j in range(gen - 1):
            logits, cache = ref_tf.decode_step(p_ref, cache, out[-1][:, None],
                                               jnp.int32(16 + j), ref_cfg)
            out.append(jnp.argmax(logits, -1))
        want.append(np.stack([np.asarray(o) for o in out], 1))
    got, stats = serve_requests(p, cfg, prompts, 2, gen, "cpu")
    np.testing.assert_array_equal(got, np.concatenate(want))
    assert [s["requests"] for s in stats] == [2, 2, 1]
    assert all(s["latency_s"] >= s["prefill_s"] > 0 for s in stats)


def test_params_from_arrays_checks_keys_and_shapes():
    cfg = configs.get_arch("qwen3-14b").smoke_config
    d = convert.transformer_params_to_arrays(
        tf.init_params(cfg, device="cpu"))
    assert "layers.attn.q_norm" in d and d["layers.attn.wq"].shape == (2, 64,
                                                                        64)
    bad = dict(d)
    bad["layers.attn.wq"] = bad["layers.attn.wq"][:, :, :32]
    with pytest.raises(ValueError, match="wq"):
        convert.transformer_params_from_arrays(bad, cfg, "cpu")
    bad = dict(d)
    del bad["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        convert.transformer_params_from_arrays(bad, cfg, "cpu")
    # bfloat16 leaves (jax's ml_dtypes or torch's) cross exactly
    jb = jnp.asarray(d["embed"], jnp.bfloat16)
    tb = torch.from_numpy(d["embed"]).to(torch.bfloat16)
    assert np.array_equal(convert.transformer_params_to_arrays(
        {"e": jb})["e"], convert.transformer_params_to_arrays({"e": tb})["e"])
