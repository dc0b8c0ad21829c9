"""The port's training path against the reference's, on the CPU in
float32: `models/transformer.py::loss_fn` and its gradient (dense and MoE,
under each remat policy) and `launch/train.py` (its `train_step`, the
checkpointed loop, resume).

The reference's params are initialised with its own jax key and carried
across with `repro_torch.convert`; batches come from the data pipeline's
`TokenStream`, which both packages share. The loss and its gradient are
held at 1e-4, the port's model tolerance (tests/test_torch_transformer.py);
the remat policies against each other at 1e-6; a resumed run bitwise."""
import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_arch as ref_get_arch
from repro.data import TokenStream as RefStream
from repro.data import TokenStreamConfig as RefStreamConfig
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_opt
from repro_torch import configs, convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw as opt

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-3-2b", "qwen3-moe-235b-a22b"]      # dense, MoE
BATCH, SEQ, STEPS = 2, 16, 3


def both(arch, seed):
    ref_cfg = ref_get_arch(arch).smoke_config
    cfg = configs.get_arch(arch).smoke_config
    assert cfg.compute_dtype == torch.float32
    p_ref = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(p_ref), cfg, "cpu")
    return ref_cfg, cfg, p_ref, p


def batch_np(cfg, step, batch=BATCH, seq=SEQ):
    return RefStream(RefStreamConfig(vocab_size=cfg.vocab_size, batch=batch,
                                     seq_len=seq)).batch_at(step)


def port_grads(p, batch, cfg):
    leaves, spec = pytree.tree_flatten(p)
    live = [t.detach().requires_grad_() for t in leaves]
    loss = tf.loss_fn(pytree.tree_unflatten(live, spec), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), convert.transformer_params_to_arrays(
        pytree.tree_unflatten(list(grads), spec))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_reference(arch):
    """The value and every parameter's gradient within 1e-4 of
    `jax.value_and_grad` of the reference's `loss_fn` (the padded vocab
    rows masked, the MoE aux added); the router's gradient is not 0; the
    three remat policies give the same gradients within 1e-6."""
    ref_cfg, cfg, p_ref, p = both(arch, seed=3)
    b = batch_np(cfg, 0)
    want, g_ref = jax.value_and_grad(ref_tf.loss_fn)(
        p_ref, {k: jnp.asarray(v) for k, v in b.items()}, ref_cfg)
    g_ref = convert.transformer_params_to_arrays(g_ref)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    per_remat = {}
    for remat in ("none", "full", "dots"):
        loss, g = port_grads(p, tb, dataclasses.replace(cfg, remat=remat))
        np.testing.assert_allclose(loss, float(want), **TOL)
        assert g.keys() == g_ref.keys()
        for key in g_ref:
            np.testing.assert_allclose(g[key], g_ref[key], err_msg=key,
                                       **TOL)
        per_remat[remat] = g
    for remat in ("full", "dots"):
        for key, v in per_remat["none"].items():
            np.testing.assert_allclose(per_remat[remat][key], v, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    if cfg.moe is not None:
        assert np.abs(per_remat["none"]["layers.mlp.router"]).sum() > 0


def test_padded_vocab_rows_take_no_probability():
    """A config whose vocab is not a multiple of 256: the padded rows of
    lm_head get a zero gradient, as the reference's -1e30 mask gives."""
    ref_cfg = dataclasses.replace(ref_get_arch("granite-3-2b").smoke_config,
                                  vocab_size=100)
    cfg = dataclasses.replace(configs.get_arch("granite-3-2b").smoke_config,
                              vocab_size=100)
    p_ref = ref_tf.init_params(jax.random.PRNGKey(5), ref_cfg)
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(p_ref), cfg, "cpu")
    b = batch_np(cfg, 1)
    want, g_ref = jax.value_and_grad(ref_tf.loss_fn)(
        p_ref, {k: jnp.asarray(v) for k, v in b.items()}, ref_cfg)
    loss, g = port_grads(p, {k: torch.from_numpy(v) for k, v in b.items()},
                         cfg)
    np.testing.assert_allclose(loss, float(want), **TOL)
    assert not g["lm_head"][100:].any()
    np.testing.assert_allclose(g["lm_head"],
                               convert.transformer_params_to_arrays(g_ref)
                               ["lm_head"], **TOL)


class MatmulCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in tf._DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_say():
    """Under grad, "full" reruns every layer's products in the backward,
    "dots" reruns none of them (it saved their outputs), "none" reruns
    nothing; under no_grad nothing is checkpointed."""
    _, cfg, _, p = both("granite-3-2b", seed=4)
    tb = {k: torch.from_numpy(v) for k, v in batch_np(cfg, 2).items()}
    counts = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        leaves, spec = pytree.tree_flatten(p)
        live = [t.detach().requires_grad_() for t in leaves]
        fwd, bwd = MatmulCount(), MatmulCount()
        with fwd:
            loss = tf.loss_fn(pytree.tree_unflatten(live, spec), tb, c)
        with bwd:
            torch.autograd.grad(loss, live)
        counts[remat] = (fwd.n, bwd.n)
    n_fwd = counts["none"][0]
    per_layer = (n_fwd - 1) // cfg.n_layers          # lm_head's one product
    assert counts["full"][0] == counts["dots"][0] == n_fwd
    # full: every product but the layer's last, whose output nothing saves
    # (the checkpoint stops recomputing once it has what the backward needs)
    assert counts["full"][1] >= counts["none"][1] + cfg.n_layers * (
        per_layer - 1)
    assert counts["dots"][1] == counts["none"][1]
    with torch.no_grad(), MatmulCount() as mode:
        tf.forward(p, tb["tokens"], dataclasses.replace(cfg, remat="full"))
    assert mode.n == n_fwd
    with pytest.raises(ValueError, match="remat"):
        tf.forward(p, tb["tokens"], dataclasses.replace(cfg, remat="some"))


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference trainer's loop (`repro/launch/train.py`: its step,
    schedule and defaults) for STEPS steps of granite-3-2b's smoke config
    from jax key 0: losses, and params and optimizer state after each step;
    a reference checkpoint of {"params", "opt"} after step 2."""
    ref_cfg = ref_get_arch("granite-3-2b").smoke_config
    ocfg = ref_opt.AdamWConfig(lr=3e-4)
    sched = ref_opt.linear_warmup_cosine(min(20, STEPS // 10 + 1), STEPS)

    @jax.jit
    def step_fn(params, state, batch):
        loss, grads = jax.value_and_grad(ref_tf.loss_fn)(params, batch,
                                                         ref_cfg)
        params, state, _ = ref_opt.adamw_update(grads, state, params, ocfg,
                                                schedule=sched)
        return params, state, loss

    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    state = ref_opt.adamw_init(params)
    run = {"params": [params], "opt": [state], "loss": []}
    ckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    for step in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in batch_np(ref_cfg, step).items()}
        params, state, loss = step_fn(params, state, b)
        run["params"].append(params)
        run["opt"].append(state)
        run["loss"].append(float(loss))
        if step + 1 == 2:
            RefManager(ckpt).save(2, {"params": params, "opt": state})
    run["ckpt"] = ckpt
    return run


def test_train_step_follows_the_reference_loop(reference_run):
    """`train_step` from the reference's initial params: each step's loss,
    and the params and optimizer state after it, within 1e-4."""
    cfg = configs.get_arch("granite-3-2b").smoke_config
    p = convert.transformer_params_from_arrays(
        convert.transformer_params_to_arrays(reference_run["params"][0]),
        cfg, "cpu")
    state = opt.adamw_init(p)
    ocfg = opt.AdamWConfig(lr=3e-4)
    sched = opt.linear_warmup_cosine(min(20, STEPS // 10 + 1), STEPS)
    for step in range(STEPS):
        b = {k: torch.from_numpy(v) for k, v in batch_np(cfg, step).items()}
        p, state, loss, metrics = train.train_step(p, state, b, cfg, ocfg,
                                                   sched)
        assert loss.dim() == 0 and metrics["lr"].dim() == 0
        np.testing.assert_allclose(float(loss), reference_run["loss"][step],
                                   **TOL)
        want = convert.transformer_params_to_arrays(
            reference_run["params"][step + 1])
        for key, v in convert.transformer_params_to_arrays(p).items():
            np.testing.assert_allclose(v, want[key], err_msg=key, **TOL)
        got_opt = convert.adamw_state_to_arrays(state)
        for key, v in convert.adamw_state_to_arrays(
                reference_run["opt"][step + 1]).items():
            np.testing.assert_allclose(got_opt[key], v, err_msg=key, **TOL)


def run_main(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--smoke", "--device", "cpu", "--batch", str(BATCH),
                    "--seq", str(SEQ), *argv])
    return out.getvalue()


def test_a_reference_checkpoint_resumes_in_the_port(reference_run, tmp_path):
    """The trainer resumes the reference's {"params", "opt"} checkpoint of
    step 2 and takes step 2 as the reference took it: the saved params and
    optimizer state of step 3 within 1e-4."""
    import shutil
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(reference_run["ckpt"], ckpt)
    log = run_main("--steps", str(STEPS), "--resume", "--ckpt-dir", ckpt,
                   "--log-every", "1")
    assert "resumed from step 2" in log and "step     2 loss" in log
    assert f"{reference_run['loss'][2]:.4f}" in log
    cfg = configs.get_arch("granite-3-2b").smoke_config
    p = tf.init_params(cfg, device="cpu")
    tree, step = CheckpointManager(ckpt).restore(
        {"params": p, "opt": opt.adamw_init(p)}, device="cpu")
    assert step == STEPS
    want_p = convert.transformer_params_to_arrays(reference_run["params"][3])
    for key, v in convert.transformer_params_to_arrays(
            tree["params"]).items():
        np.testing.assert_allclose(v, want_p[key], err_msg=key, **TOL)
    want_o = convert.adamw_state_to_arrays(reference_run["opt"][3])
    got_o = convert.adamw_state_to_arrays(tree["opt"])
    assert got_o.keys() == want_o.keys()
    for key, v in want_o.items():
        np.testing.assert_allclose(got_o[key], v, err_msg=key, **TOL)


def test_stopped_and_resumed_run_is_bitwise_the_uninterrupted_one(
        tmp_path, monkeypatch):
    """4 steps straight against 4 steps stopped by a fault in step 3 and
    resumed from the checkpoint of step 2: the final checkpoints hold the
    same bytes in every leaf (the reference's fault-tolerance contract,
    tests/test_substrate.py::test_resume_training_bit_identical)."""
    straight, stopped = str(tmp_path / "a"), str(tmp_path / "b")
    common = ("--steps", "4", "--ckpt-every", "2", "--log-every", "1")
    log = run_main(*common, "--ckpt-dir", straight)
    assert [ln.split()[1] for ln in log.splitlines()
            if ln.startswith("step")] == ["0", "1", "2", "3"]
    assert log.splitlines()[-1].startswith("done; final loss")

    real, calls = train.train_step, []

    def faulty(*a, **kw):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("injected fault in step 3")
        return real(*a, **kw)

    monkeypatch.setattr(train, "train_step", faulty)
    with pytest.raises(RuntimeError, match="injected"):
        run_main(*common, "--ckpt-dir", stopped)
    monkeypatch.setattr(train, "train_step", real)
    assert CheckpointManager(stopped).latest_step() == 2
    log = run_main(*common, "--ckpt-dir", stopped, "--resume")
    assert log.startswith("resumed from step 2")
    with np.load(os.path.join(straight, "step_0000000004.npz")) as a, \
            np.load(os.path.join(stopped, "step_0000000004.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "['opt']/['step']" in a.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
