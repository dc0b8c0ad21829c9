"""The port's MoE routing by data-parallel group
(`models/transformer.py::_moe_core`) against the reference's, which reads
the groups from its mesh (`repro/models/transformer.py::_moe_core`).

The reference runs jitted under a (data = dp, model = 1) mesh on dp host
devices, in a subprocess (`_torch_ring.reference_subprocess`); the port
under a `DeviceMesh` of the same shape over a `fake` process group (plain
tensors: every group routed in this process), and on two gloo ranks with
x a DTensor sharded over `data` (each rank routes its own group). The
capacity factor drops tokens, so the groups' own capacities decide which:
one global group gives another output. Outputs and the balance loss are
held within 1e-5. With one group the dispatch is bitwise the one-group
GShard dispatch it replaced, kept here as `one_group`."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro_torch import configs, convert
from repro_torch.models import transformer as tf
from repro_torch.sharding import DEFAULT_RULES, ShardingRules, use_rules

MOE_ARCHS = ["qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b"]
TOL = dict(rtol=1e-5, atol=1e-5)
CF = 0.5                                      # drops tokens
# (arch, B, S): two sequence chunks of 2,048 for qwen3-moe
SHAPES = [(MOE_ARCHS[0], 4, 4096), (MOE_ARCHS[1], 4, 32)]

REF_GROUPS = """
import dataclasses
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.jax_compat import mesh_axis_types
from repro.models import transformer as tf
from repro.sharding import DEFAULT_RULES, ShardingRules, use_rules

d = np.load(sys.argv[1])
out = {}
for arch in sys.argv[3].split(","):
    cfg = get_arch(arch).smoke_config
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(d["cf"])))
    lp = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in d.items()
          if k.startswith(arch + "/")}
    for dp in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:dp]).reshape(dp, 1),
                    ("data", "model"), **mesh_axis_types(2))
        for name in ("x", "x_odd"):
            x = jnp.asarray(d[arch + ":" + name])
            with use_rules(ShardingRules(dict(DEFAULT_RULES), mesh)):
                o, a = jax.jit(lambda p, x: tf.moe_mlp(p, x, cfg))(lp, x)
            out[f"{arch}:{name}:{dp}"] = np.asarray(o)
            out[f"{arch}:{name}:{dp}:aux"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""


def with_capacity(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def layer0(arch, cf=CF, seed=1):
    """(reference layer-0 MoE arrays, port layer-0 params, port config)."""
    ref_cfg = with_capacity(ref_get_arch(arch).smoke_config, cf)
    cfg = with_capacity(configs.get_arch(arch).smoke_config, cf)
    p_ref = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    arrays = convert.transformer_params_to_arrays(p_ref)
    p = convert.transformer_params_from_arrays(arrays, cfg, "cpu")
    lp = {k: v[0] for k, v in p["layers"]["mlp"].items()}
    return {k: v.numpy() for k, v in lp.items()}, lp, cfg


def inputs(arch, B, S, d):
    rng = np.random.default_rng(B * S)
    return {"x": rng.normal(size=(B, S, d)).astype(np.float32),
            "x_odd": rng.normal(size=(B - 1, S, d)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs and balance losses at dp 2 and 4 for each
    shape's x (B divisible by dp) and x_odd (B - 1, not divisible)."""
    from _torch_ring import reference_subprocess
    tmp = tmp_path_factory.mktemp("moe_groups")
    feed = {"cf": np.float32(CF)}
    for arch, B, S in SHAPES:
        arrays, _, cfg = layer0(arch)
        feed.update({f"{arch}/{k}": v for k, v in arrays.items()})
        feed.update({f"{arch}:{k}": v
                     for k, v in inputs(arch, B, S, cfg.d_model).items()})
    np.savez(tmp / "in.npz", **feed)
    reference_subprocess(REF_GROUPS, tmp / "in.npz", tmp / "out.npz",
                         ",".join(a for a, _, _ in SHAPES), devices=4,
                         timeout=240)
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture
def data_mesh():
    """mesh(dp): a (data = dp, model = 1) DeviceMesh over a fake group of
    dp ranks, destroyed after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()

    def mesh(dp):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=dp)
        return init_device_mesh("cpu", (dp, 1),
                                mesh_dim_names=("data", "model"))

    yield mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def port_moe(lp, x, cfg, mesh=None):
    with use_rules(ShardingRules(dict(DEFAULT_RULES), mesh)), \
            torch.no_grad():
        out, aux = tf.moe_mlp(lp, torch.from_numpy(x), cfg)
    return out.numpy(), float(aux)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch,B,S", SHAPES)
def test_groups_match_the_reference_under_a_data_mesh(reference, data_mesh,
                                                      arch, B, S, dp):
    """dp groups of B·S / dp tokens, each with its own capacity, as the
    reference routes under its mesh; one global group drops other tokens
    and gives another output."""
    _, lp, cfg = layer0(arch)
    x = inputs(arch, B, S, cfg.d_model)["x"]
    mesh = data_mesh(dp)
    assert tf.moe_groups(B) == 1
    with use_rules(ShardingRules(dict(DEFAULT_RULES), mesh)):
        assert tf.moe_groups(B) == dp
    got, aux = port_moe(lp, x, cfg, mesh)
    want = reference[f"{arch}:x:{dp}"]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, reference[f"{arch}:x:{dp}:aux"], **TOL)
    one, _ = port_moe(lp, x, cfg)
    assert np.abs(one - want).max() > 1e-2


@pytest.mark.parametrize("dp", [2, 4])
def test_a_batch_the_groups_do_not_split_is_one_group(reference, data_mesh,
                                                      dp):
    """B % dp != 0: one group, as the reference falls back to, bitwise the
    port's output with no mesh."""
    arch, B, S = SHAPES[1]
    _, lp, cfg = layer0(arch)
    x = inputs(arch, B, S, cfg.d_model)["x_odd"]
    mesh = data_mesh(dp)
    with use_rules(ShardingRules(dict(DEFAULT_RULES), mesh)):
        assert tf.moe_groups(B - 1) == 1
    got, aux = port_moe(lp, x, cfg, mesh)
    np.testing.assert_allclose(got, reference[f"{arch}:x_odd:{dp}"], **TOL)
    np.testing.assert_allclose(aux, reference[f"{arch}:x_odd:{dp}:aux"],
                               **TOL)
    alone, aux_alone = port_moe(lp, x, cfg)
    assert np.array_equal(got, alone) and aux == aux_alone


def test_two_gloo_ranks_route_their_own_groups(tmp_path):
    """Two gloo ranks, x Shard(0) over `data`: each rank's rows equal the
    one-process dp = 2 result bitwise, the output stays sharded, and no
    all-gather is issued (the groups are routed where they lie); the
    balance loss is all-reduced."""
    from _torch_ring import moe_groups_shard, spawn_ring
    arch, B, S = SHAPES[1]
    arrays, lp, cfg = layer0(arch)
    x = inputs(arch, B, S, cfg.d_model)["x"]
    ranks = spawn_ring(moe_groups_shard, 2, tmp_path, arch, CF, arrays, x)
    with torch.no_grad():
        want, aux = tf._moe_core(lp, torch.from_numpy(x), cfg, groups=2)
    got = np.concatenate([r["rows"] for r in ranks])
    assert np.array_equal(got, want.numpy())
    for r in ranks:
        assert r["placements"] == "(Shard(dim=0), Replicate())"
        assert r["aux"] == pytest.approx(float(aux), rel=1e-6)
        assert "all-gather" not in r["counts"], r["counts"]
        assert r["counts"].get("all-reduce", 0) >= 1, r["counts"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_each_group_routes_as_its_rows_alone(arch):
    """Group g of dp = 2 routes exactly as one group of its rows alone:
    the same experts, slot tables and slots, bitwise, and the same
    output."""
    _, lp, cfg = layer0(arch)
    B, S, d = 4, 32, cfg.d_model
    x = torch.from_numpy(inputs(arch, B, S, d)["x"])
    mo, tg = cfg.moe, B * S // 2
    cap = tf.moe_capacity(mo, tg)
    both = tf.route_groups(lp["router"], x.reshape(2, tg, d), mo, cap)
    for g in range(2):
        alone = tf.route_groups(lp["router"], x[2 * g:2 * g + 2].reshape(
            1, tg, d), mo, cap)
        for a, b in zip(both[:5], alone[:5]):
            assert torch.equal(a[g], b[0])
    with torch.no_grad():
        out, _ = tf._moe_core(lp, x, cfg, groups=2)
        halves = torch.cat([tf._moe_core(lp, x[:2], cfg)[0],
                            tf._moe_core(lp, x[2:], cfg)[0]])
    torch.testing.assert_close(out, halves, rtol=0, atol=0)


def one_group(params, x, cfg):
    """The one-group GShard dispatch the grouped `_moe_core` replaced."""
    mo = cfg.moe
    B, S, d = x.shape
    t, E, K = B * S, mo.n_experts, mo.top_k
    cdt = cfg.compute_dtype
    cap = tf.moe_capacity(mo, t)
    xg = x.reshape(t, d)
    probs, gates, idx = tf.route_tokens(params["router"], xg, mo)
    expert_of = idx.reshape(-1)
    order = torch.argsort(expert_of, stable=True)
    sorted_e = expert_of[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E + 1))
    counts = seg_start[1:] - seg_start[:-1]
    ce = counts.to(probs.dtype) / (t * K)
    aux = mo.aux_coef * E * torch.sum(probs.mean(0) * ce)
    pos_in_e = torch.arange(t * K) - seg_start[sorted_e]
    ok = pos_in_e < cap
    slot = torch.where(ok, sorted_e * cap + pos_in_e, E * cap)
    tfs = order.new_zeros(E * cap + 1)
    tfs[slot] = order // K
    tfs = tfs[:E * cap]
    ein = xg.to(cdt)[tfs].reshape(E, cap, d)
    g = torch.bmm(ein, params["w_gate"].to(cdt))
    u = torch.bmm(ein, params["w_up"].to(cdt))
    eout = torch.bmm(F.silu(g) * u, params["w_down"].to(cdt)).reshape(
        E * cap, d)
    slots = order.new_empty(t * K)
    slots[order] = slot
    slots, by_slot = slots.reshape(t, K).sort(dim=1)
    pair_gates = gates.to(cdt).gather(1, by_slot)
    dropped = slots == E * cap
    slots = slots.clamp(max=E * cap - 1)
    out = xg.new_zeros((t, d), dtype=cdt)
    for j in range(K):
        rows = eout[slots[:, j]] * pair_gates[:, j, None]
        out = out + rows.masked_fill_(dropped[:, j, None], 0)
    last = eout.reshape(E, cap, d)[:, -1] * 0
    out[0] = out[0] + torch.where((counts < cap)[:, None], last, 0).sum(0)
    return out.reshape(B, S, d), aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_one_group_is_bitwise_the_one_group_dispatch(arch, cf, dtype):
    """With no mesh (one group) the output and balance loss are bitwise
    those of the one-group dispatch, in float32 and bfloat16, with tokens
    dropped and none; the gradients too."""
    _, lp, cfg = layer0(arch, cf)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    x = torch.from_numpy(inputs(arch, 2, 64, cfg.d_model)["x"]).to(dtype)
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    results = []
    for fn in (tf._moe_core, one_group):
        xs = x.clone().requires_grad_()
        leaves = {k: v.clone().requires_grad_() for k, v in lp.items()}
        out, aux = fn(leaves, xs, cfg)
        grads = torch.autograd.grad((out.float() * w).sum() + aux,
                                    [xs] + list(leaves.values()))
        results.append([out, aux] + list(grads))
    for a, b in zip(*results):
        assert torch.equal(a, b)
