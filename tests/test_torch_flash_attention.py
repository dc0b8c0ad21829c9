"""The port's flash attention (repro_torch/kernels/flash_attention) against
the reference's, on the CPU, where the wrapper takes the plain torch
version.

Tolerances are TestFlashAttention's own: rtol/atol 2e-5 in float32
against `flash_attention_pallas` (interpret mode) and `attention_ref`,
2e-2 in bfloat16, 1e-4 for the gradients. The causal mask of the kernel and
its plain version is aligned top-left; the reference's `attention_ref` (and
so the reference's custom VJP) aligns it bottom-right. The two agree for
S == T only (ROADMAP queue 3 note b), so S < T is held against the Pallas
kernel and a hand-built top-left mask, and the port's gradient for causal
S != T against autograd through its forward's plain version (1e-5) and
`jax.grad` of the reference's top-left `blockwise_attention` (1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as ref_attention
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.transformer import blockwise_attention
from repro_torch.kernels.flash_attention import (attention_chunked,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_torch, ops)


def qkv(b, s, t, h, hkv, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(dtype),
            rng.normal(size=(b, t, hkv, d)).astype(dtype),
            rng.normal(size=(b, t, hkv, d)).astype(dtype))


def torch_of(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (2, 256, 8, 1, 128),
    (1, 512, 4, 4, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_ref(b, s, h, hkv, d, causal):
    q, k, v = qkv(b, s, s, h, hkv, d, seed=b * s + h)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    ref = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal))
    got = flash_attention(*torch_of(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    port_ref = attention_ref(*torch_of(q, k, v), causal).numpy()
    np.testing.assert_allclose(port_ref, ref, rtol=2e-5, atol=2e-5)


def top_left(q, k, v, causal):
    """Exact attention in float64 with the mask aligned top-left."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=2)
    vv = np.repeat(v.astype(np.float64), H // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * D ** -0.5
    if causal:
        s = np.where(np.arange(T)[None, :] <= np.arange(S)[:, None], s,
                     -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("causal", [True, False])
def test_shorter_queries_pin_the_top_left_mask(causal):
    q, k, v = qkv(2, 128, 512, 4, 2, 64, seed=2)
    got = flash_attention(*torch_of(q, k, v), causal=causal).numpy()
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, top_left(q, k, v, causal), rtol=2e-5,
                               atol=2e-5)
    if causal:       # the reference oracle aligns bottom-right: it differs
        bottom = attention_ref(*torch_of(q, k, v), True).numpy()
        assert np.abs(got - bottom).max() > 0.1


@pytest.mark.parametrize("s,t,q_chunk,kv_chunk", [
    (1000, 1000, 128, 96), (77, 300, 32, 64), (300, 77, 64, 32),
    (5, 1, 2, 4)])
def test_ragged_chunks_match_exact(s, t, q_chunk, kv_chunk):
    """Chunks that divide neither S nor T, and S > T."""
    q, k, v = qkv(1, s, t, 4, 1, 16, seed=s + t)
    for causal in (True, False):
        got = attention_chunked(*torch_of(q, k, v), causal=causal,
                                q_chunk=q_chunk, kv_chunk=kv_chunk).numpy()
        np.testing.assert_allclose(got, top_left(q, k, v, causal),
                                   rtol=2e-5, atol=2e-5)


def test_bf16():
    q, k, v = qkv(1, 128, 128, 2, 2, 64, seed=0)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref_attention(
        *(jnp.asarray(t.float().numpy()) for t in (qb, kb, vb)), causal=True))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)
    pallas = flash_attention_pallas(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb)),
        causal=True, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("hkv", [1, 2])
def test_grads_match_reference_custom_vjp(hkv):
    q, k, v = qkv(1, 128, 128, 2, hkv, 64, seed=1)

    def f(q, k, v):
        return (ref_flash(q, k, v, True) ** 2).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [t.requires_grad_() for t in torch_of(q, k, v)]
    (flash_attention(*ts, causal=True) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("b,s,t,h,hkv,d", [
    (1, 3, 5, 2, 1, 16), (1, 5, 3, 2, 1, 16), (2, 7, 12, 4, 2, 16),
    (1, 12, 7, 6, 2, 32)])
def test_causal_grads_are_the_forwards_when_s_differs_from_t(b, s, t, h,
                                                             hkv, d):
    """The backward differentiates the forward's top-left mask, for S < T
    and S > T, one kv head and GQA."""
    q, k, v = qkv(b, s, t, h, hkv, d, seed=s * t + h)
    g = np.random.default_rng(d).normal(size=q.shape).astype(np.float32)
    ts = [x.requires_grad_() for x in torch_of(q, k, v)]
    flash_attention(*ts, causal=True).backward(torch.from_numpy(g))
    plain = [x.detach().clone().requires_grad_() for x in ts]
    flash_attention_torch(*plain, True).backward(torch.from_numpy(g))
    for got, want in zip(ts, plain):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5,
                                   atol=1e-5)

    def f(q, k, v):
        out = blockwise_attention(q, k, v, causal=True, q_chunk=s,
                                  kv_chunk=t, q_pos0=0)
        return (out * jnp.asarray(g)).sum()

    args = [jnp.asarray(a) for a in (q, k, v)]
    want = jax.grad(f, argnums=(0, 1, 2))(*args)
    for got, w in zip(ts, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    # the reference's custom VJP differentiates its bottom-right oracle
    custom = jax.grad(lambda *a: (ref_flash(*a, True) * jnp.asarray(g)).sum(),
                      argnums=(0, 1, 2))(*args)
    assert max(float(np.abs(np.asarray(c) - x.grad.numpy()).max())
               for c, x in zip(custom, ts)) > 0.1


@pytest.mark.parametrize("s,t,causal,dtype", [
    (1100, 1100, True, torch.float32), (1100, 1300, True, torch.float32),
    (1300, 600, True, torch.float32), (700, 1100, False, torch.float32),
    (1100, 1100, True, torch.bfloat16)])
def test_backward_by_query_chunks_is_autograd_through_the_forward(
        s, t, causal, dtype):
    """Past one query chunk (Q_CHUNK = 512, ragged last chunks), with the
    keys a causal chunk sees cut at its last query, S = T, S < T, S > T
    and no mask: the chunked backward against autograd through the whole
    `flash_attention_torch` in float32 (1e-5); bfloat16 inputs get bf16
    gradients of the same float32 sums, so within one bf16 rounding
    (2^-8 relative) of them."""
    assert ops.Q_CHUNK == 512 and s > ops.Q_CHUNK
    q, k, v = qkv(1, s, t, 4, 2, 16, seed=s + t)
    g = np.random.default_rng(s).normal(size=q.shape).astype(np.float32)
    ts = [x.to(dtype).requires_grad_() for x in torch_of(q, k, v)]
    flash_attention(*ts, causal=causal).backward(
        torch.from_numpy(g).to(dtype))
    plain = [x.detach().float().requires_grad_() for x in ts]
    flash_attention_torch(*plain, causal).backward(
        torch.from_numpy(g).to(dtype).float())
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for got, want in zip(ts, plain):
        assert got.grad.dtype == dtype
        torch.testing.assert_close(got.grad.float(), want.grad, rtol=rtol,
                                   atol=1e-5)


def test_no_launch_on_cpu_and_plain_is_the_forward():
    q, k, v = torch_of(*qkv(2, 64, 64, 4, 2, 32, seed=5))
    before = ops.launches
    got = flash_attention(q, k, v)
    assert ops.launches == before
    assert torch.equal(got, flash_attention_torch(q, k, v, True))


@pytest.mark.parametrize("bad,exc", [
    (dict(dtype=torch.float16), TypeError),
    (dict(k_dtype=torch.bfloat16), TypeError),
    (dict(d=8), ValueError),
    (dict(d=24), ValueError),
    (dict(d=144), ValueError),
    (dict(hkv=3), ValueError),
    (dict(q_dim=3), ValueError),
    (dict(v_t=7), ValueError),
    (dict(numpy=True), TypeError),
])
def test_bad_inputs_raise(bad, exc):
    d = bad.get("d", 32)
    dt = bad.get("dtype", torch.float32)
    q = torch.zeros((1, 8, 4, d), dtype=dt)
    k = torch.zeros((1, 8, bad.get("hkv", 2), d),
                    dtype=bad.get("k_dtype", dt))
    v = torch.zeros((1, bad.get("v_t", 8), bad.get("hkv", 2), d),
                    dtype=bad.get("k_dtype", dt))
    if bad.get("q_dim"):
        q = q[0]
    if bad.get("numpy"):
        q = q.numpy()
    with pytest.raises(exc):
        flash_attention(q, k, v)
