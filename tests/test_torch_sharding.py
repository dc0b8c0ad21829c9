"""The port's logical-axis sharding rules (repro_torch/sharding.py,
launch/mesh.py) and both `param_logical_axes` against the reference's.

`spec()` equals the reference's `PartitionSpec` entry for entry for every
logical axis, on no mesh and on meshes with the reference's axis names: a
one-device jax `Mesh` reshaped to (1, 1) and (1, 1, 1) for the reference,
a `DeviceMesh` of the same shape over a one-rank `fake` process group for
the port (created for this module and destroyed after it). The axis trees
are equal leaf for leaf, and match the params' structure and ranks."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils import _pytree as pytree

from repro import sharding as R
from repro.configs import get_arch as ref_get_arch
from repro.models import bert4rec as ref_b4
from repro.models import transformer as ref_tf
from repro_torch import sharding as S
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import bert4rec as b4
from repro_torch.models import transformer as tf

AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
LOGICAL = sorted(R.DEFAULT_RULES) + [None, "no_such_axis"]
LM_ARCHS = [a for a in ARCH_IDS if get_arch(a).family == "lm"]


@pytest.fixture(scope="module")
def one_rank():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def meshes(kind):
    """(reference mesh, port mesh) of shape (1,) * n with the kind's axis
    names, or (None, None)."""
    if kind is None:
        return None, None
    names = AXES[kind]
    ref = Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(names)), names)
    from torch.distributed.device_mesh import init_device_mesh
    return ref, init_device_mesh("cpu", (1,) * len(names),
                                 mesh_dim_names=names)


@pytest.mark.parametrize("kind", [None, "single", "multi"])
def test_spec_matches_the_reference_partition_spec(one_rank, kind):
    ref_mesh, mesh = meshes(kind)
    rr = R.ShardingRules(rules=dict(R.DEFAULT_RULES), mesh=ref_mesh)
    tr = S.ShardingRules(rules=dict(S.DEFAULT_RULES), mesh=mesh)
    assert S.DEFAULT_RULES == R.DEFAULT_RULES
    for a in LOGICAL:
        for b in LOGICAL:
            assert tr.spec(a, b) == tuple(rr.spec(a, b)), (a, b)
    # the module-level helpers under use_rules
    with R.use_rules(rr), S.use_rules(tr):
        assert S.spec_for("batch", None, "model") == tuple(
            R.spec_for("batch", None, "model"))
        assert (S.named_sharding("batch") is None) == (
            R.named_sharding("batch") is None)
    assert S.current_rules().mesh is None


def test_placements_take_mesh_axes_major_to_minor(one_rank):
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = meshes("multi")
    tr = S.ShardingRules(rules=dict(S.DEFAULT_RULES), mesh=mesh)
    R_, S0, S1 = Replicate(), Shard(0), Shard(1)
    assert tr.placements("batch", None) == (S0, S0, R_)
    assert tr.placements("model", "fsdp") == (R_, S1, S0)
    assert tr.placements("nodes", None) == (S0, S0, S0)
    assert tr.placements(None, None) == (R_, R_, R_)
    assert tr.sharding("experts", "fsdp", None) == S.NamedSharding(
        mesh, (R_, Shard(1), S0))
    with pytest.raises(ValueError, match="two dims"):
        S.ShardingRules({"a": "model", "b": "model"}, mesh).placements(
            "a", "b")
    with pytest.raises(ValueError, match="order"):
        S.ShardingRules({"a": ("data", "pod")}, mesh).placements("a")
    assert S.ShardingRules(dict(S.DEFAULT_RULES)).placements("batch") is None


def test_constrain_is_identity_off_a_mesh_and_redistributes_on_one(one_rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.arange(12.0).reshape(4, 3)
    assert S.constrain(x, "batch", None) is x
    _, mesh = meshes("single")
    rules = S.ShardingRules(rules=dict(S.DEFAULT_RULES), mesh=mesh)
    with S.use_rules(rules):
        assert S.constrain(x, "batch", None) is x        # a plain tensor
        d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        c = S.constrain(d, "batch", "model")
        assert c.placements == (Shard(0), Shard(1))
        assert torch.equal(c.full_tensor(), x)
        assert S.constrain(c, "batch", "model") is c
        u = S.unflatten(c, 1, (3, 1))
        assert u.shape == (4, 3, 1)
    assert torch.equal(S.unflatten(x, 1, (1, 3)), x.unflatten(1, (1, 3)))


def test_production_mesh_is_a_function_with_the_reference_shapes():
    import inspect
    src = inspect.getsource(tmesh.make_production_mesh)
    assert "(2, 16, 16)" in src and "(16, 16)" in src
    assert tmesh.H100_SXM["peak_flops_bf16"] == 989e12
    assert tmesh.H100_SXM["hbm_bytes"] == 80e9


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def same_tree_as_params(axes, params):
    a_leaves, a_spec = pytree.tree_flatten(axes, is_leaf=_is_axes)
    p_leaves, p_spec = pytree.tree_flatten(params)
    assert a_spec == p_spec
    for ax, p in zip(a_leaves, p_leaves):
        assert len(ax) == p.ndim, (ax, tuple(p.shape))


@pytest.mark.parametrize("arch,ep_mode", [(a, "expert") for a in LM_ARCHS]
                         + [(a, "ffn") for a in LM_ARCHS
                            if get_arch(a).config.moe is not None])
def test_transformer_logical_axes_match_reference(arch, ep_mode):
    cfg, ref_cfg = get_arch(arch).config, ref_get_arch(arch).config
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, ep_mode=ep_mode))
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, ep_mode=ep_mode))
    axes = tf.param_logical_axes(cfg)
    assert axes == ref_tf.param_logical_axes(ref_cfg)
    same_tree_as_params(axes, tf.init_params(cfg, torch.Generator(),
                                             device="meta"))


def test_bert4rec_logical_axes_match_reference():
    cfg, ref_cfg = get_arch("bert4rec").config, ref_get_arch("bert4rec").config
    axes = b4.param_logical_axes(cfg)
    assert axes == ref_b4.param_logical_axes(ref_cfg)
    same_tree_as_params(axes, b4.init_params(torch.Generator(), cfg,
                                             device="meta"))
