"""The port's AdamW (`repro_torch/optim/adamw.py`) against the reference's
`repro/optim/adamw.py`, on the CPU in float32.

Params and gradients are seeded numpy arrays handed to both packages.
Params, moments and metrics are held at 1e-6 over several steps with
clipping and a schedule; the reference's own semantics
(`tests/test_substrate.py::TestAdamW`: the quadratic, the clip metric, the
warm-up) are checked on the port as well."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref
from repro_torch import convert
from repro_torch.optim import adamw as opt

TOL = dict(rtol=1e-6, atol=1e-6)


def trees(seed):
    """A nested tree of lists and dicts (a GNN's layout) as numpy."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": a(7, 5), "layers": [{"w": a(5, 5), "b": a(5)},
                                          {"w": a(5, 3), "b": a(3)}],
            "scale": a(1)}


def to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def to_torch(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


@pytest.mark.parametrize("clip,schedule", [(1.0, True), (None, False),
                                           (50.0, True)])
def test_five_steps_match_reference(clip, schedule):
    cfg_kw = dict(lr=0.05, weight_decay=0.1, clip_norm=clip)
    rcfg, cfg = ref.AdamWConfig(**cfg_kw), opt.AdamWConfig(**cfg_kw)
    rs = ref.linear_warmup_cosine(2, 5) if schedule else None
    s = opt.linear_warmup_cosine(2, 5) if schedule else None
    p_np = trees(0)
    rp, p = to_jax(p_np), to_torch(p_np)
    rstate, state = ref.adamw_init(rp), opt.adamw_init(p)
    assert state["step"].dtype == torch.int32
    for i in range(5):
        g_np = jax.tree.map(lambda x: x * (3.0 if i % 2 else 0.2),
                            trees(10 + i))
        rp, rstate, rm = ref.adamw_update(to_jax(g_np), rstate, rp, rcfg, rs)
        p, state, m = opt.adamw_update(to_torch(g_np), state, p, cfg, s)
        for key, want in convert.gnn_params_to_arrays(rp).items():
            np.testing.assert_allclose(
                convert.gnn_params_to_arrays(p)[key], want, **TOL)
        for name in ("m", "v"):
            got = convert.gnn_params_to_arrays(state[name])
            for key, want in convert.gnn_params_to_arrays(
                    rstate[name]).items():
                np.testing.assert_allclose(got[key], want, **TOL)
        assert int(state["step"]) == int(rstate["step"]) == i + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), **TOL)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), **TOL)


def test_update_is_in_place_and_casts_back_to_the_param_dtype():
    """params, m and v are the tensors passed in; a bfloat16 param stays
    bfloat16 while its moments are float32, as in the reference."""
    p_np = {"w": np.linspace(-1, 1, 8).astype(np.float32)}
    g_np = {"w": np.linspace(2, -3, 8).astype(np.float32)}
    cfg_kw = dict(lr=0.1, clip_norm=0.5)
    p = {"w": torch.from_numpy(p_np["w"]).to(torch.bfloat16)}
    state = opt.adamw_init(p)
    w, m = p["w"], state["m"]["w"]
    p2, state2, _ = opt.adamw_update(
        {"w": torch.from_numpy(g_np["w"]).to(torch.bfloat16)}, state, p,
        opt.AdamWConfig(**cfg_kw))
    assert p2["w"] is w and state2["m"]["w"] is m
    assert w.dtype == torch.bfloat16 and m.dtype == torch.float32
    rp = {"w": jnp.asarray(p_np["w"], jnp.bfloat16)}
    rp, rstate, _ = ref.adamw_update(
        {"w": jnp.asarray(g_np["w"], jnp.bfloat16)}, ref.adamw_init(rp), rp,
        ref.AdamWConfig(**cfg_kw))
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(rp["w"], np.float32))
    np.testing.assert_allclose(m.numpy(), np.asarray(rstate["m"]["w"]),
                               **TOL)


def test_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.adamw_init(params)
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        g, = torch.autograd.grad(torch.sum((w - 1.0) ** 2), w)
        params, state, _ = opt.adamw_update({"w": g}, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=1e-2)


def test_clip_and_metrics():
    params = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = opt.adamw_update(g, opt.adamw_init(params), params,
                                     opt.AdamWConfig(lr=1e-3, clip_norm=0.5))
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert torch.equal(g["w"], torch.full((4,), 100.0))    # left as it is
    clipped, norm = opt.clip_by_global_norm(g, 0.5)
    assert float(norm) == pytest.approx(200.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(0.5)


def test_schedules_match_reference():
    sched, rsched = opt.linear_warmup_cosine(10, 100), \
        ref.linear_warmup_cosine(10, 100)
    assert float(sched(torch.tensor(0))) == 0.0
    assert float(sched(torch.tensor(10))) == pytest.approx(1.0, abs=1e-3)
    assert float(sched(torch.tensor(100))) < 0.6
    cos, rcos = opt.cosine_schedule(50, 0.2), ref.cosine_schedule(50, 0.2)
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        t = torch.tensor(step, dtype=torch.int32)
        j = jnp.asarray(step, jnp.int32)
        assert sched(t).dtype == torch.float32
        np.testing.assert_allclose(float(sched(t)), float(rsched(j)), **TOL)
        np.testing.assert_allclose(float(cos(t)), float(rcos(j)), **TOL)


def test_state_carries_across_key_for_key():
    """A reference state (m, v and step over a nested tree) converts into
    the port's and back to the same arrays."""
    p_np = trees(3)
    rp = to_jax(p_np)
    rstate = ref.adamw_init(rp)
    rp, rstate, _ = ref.adamw_update(to_jax(trees(4)), rstate, rp,
                                     ref.AdamWConfig())
    arrays = convert.adamw_state_to_arrays(rstate)
    assert "step" in arrays and "m.layers.1.w" in arrays
    state = convert.adamw_state_from_arrays(arrays, to_torch(p_np), "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    back = convert.adamw_state_to_arrays(state)
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="keys"):
        convert.adamw_state_from_arrays({**arrays, "x.y": arrays["step"]},
                                        to_torch(p_np), "cpu")
