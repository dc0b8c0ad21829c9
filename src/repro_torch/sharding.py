"""Logical-axis sharding rules (port of the reference `repro/sharding.py`).

Models annotate params/activations with *logical* axis names; a
ShardingRules instance maps them to mesh axes. Rules silently drop mesh
axes that don't exist on the current mesh (so the same model code runs on
the single-pod (data, model) mesh, the multi-pod (pod, data, model) mesh,
and one device with no mesh at all).

The mesh is a `torch.distributed.device_mesh.DeviceMesh`. `spec` returns
the resolved mesh axes per tensor dim, entry for entry what the
reference's `PartitionSpec` holds; `placements` turns them into DTensor
placements per mesh dim (`Shard(d)` / `Replicate()`). When one tensor dim
is split over several mesh axes they are taken major to minor, as JAX
takes them; DTensor splits a dim over its mesh dims in mesh order, so the
axes of one dim must follow the mesh's order. `constrain` is the
reference's `with_sharding_constraint`: a DTensor is redistributed to the
placements, anything else (no mesh, a plain tensor on one device) passes
through unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["ShardingRules", "DEFAULT_RULES", "NamedSharding", "use_rules",
           "current_rules", "constrain", "spec_for", "named_sharding",
           "unflatten"]

Axis = Union[str, Tuple[str, ...], None]


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of one tensor on it."""
    mesh: object
    placements: tuple


@dataclasses.dataclass
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    rules: Dict[str, Axis]
    mesh: Optional[object] = None          # a DeviceMesh with dim names

    def _resolve(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        ax = self.rules.get(logical)
        if ax is None or self.mesh is None:
            return None
        names = set(self.mesh.mesh_dim_names)
        if isinstance(ax, str):
            return ax if ax in names else None
        ax = tuple(a for a in ax if a in names)
        return ax if ax else None

    def spec(self, *logical_axes: Optional[str]) -> Tuple[Axis, ...]:
        """Per tensor dim: None, a mesh axis, or a tuple of them (a tuple
        of one is its axis, as a PartitionSpec holds it)."""
        out = []
        for a in logical_axes:
            ax = self._resolve(a)
            out.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                       else ax)
        return tuple(out)

    def placements(self, *logical_axes: Optional[str]):
        """DTensor placements per mesh dim (None without a mesh)."""
        if self.mesh is None:
            return None
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        used = set()
        for dim, ax in enumerate(self.spec(*logical_axes)):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"mesh axes {axes} of dim {dim} are not in "
                                 f"the mesh's order {tuple(names)}")
            for a, m in zip(axes, order):
                if a in used:
                    raise ValueError(f"mesh axis {a!r} shards two dims of "
                                     f"{logical_axes}")
                used.add(a)
                out[m] = Shard(dim)
        return tuple(out)

    def sharding(self, *logical_axes: Optional[str]) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.placements(*logical_axes))

    def constrain(self, x, *logical_axes: Optional[str]):
        """Redistribute a DTensor to the placements if a mesh is active;
        identity otherwise. A dim whose size the product of its mesh axes
        does not divide (one request over 16 data shards) is replicated:
        DTensor's later views of such a dim fail."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(x, DTensor):
            return x
        pl = list(self.placements(*logical_axes))
        for dim in range(x.ndim):
            mesh_dims = [m for m, p in enumerate(pl)
                         if p.is_shard() and p.dim == dim]
            ways = 1
            for m in mesh_dims:
                ways *= self.mesh.size(m)
            if x.shape[dim] % ways:
                for m in mesh_dims:
                    pl[m] = Replicate()
        pl = tuple(pl)
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(self.mesh, pl)


# Logical axes used across the framework:
#   batch      token/sample batch             -> pod+data (pure DP)
#   fsdp       param dim sharded FSDP-style   -> data
#   model      tensor-parallel dim            -> model (heads / mlp / vocab)
#   experts    MoE expert dim                 -> model (EP)
#   nodes      graph vertex-interval dim      -> pod+data+model (PAL intervals)
#   edges      graph edge dim                 -> pod+data+model (PAL partitions)
#   table      embedding-table row dim        -> model (PAL-hashed rows)
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "model": "model",
    "experts": "model",
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
    "table": "model",
    "seq": None,
}

_state = threading.local()


def current_rules() -> ShardingRules:
    r = getattr(_state, "rules", None)
    if r is None:
        r = ShardingRules(rules=dict(DEFAULT_RULES), mesh=None)
    return r


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def constrain(x, *logical_axes: Optional[str]):
    return current_rules().constrain(x, *logical_axes)


def spec_for(*logical_axes: Optional[str]) -> Tuple[Axis, ...]:
    return current_rules().spec(*logical_axes)


def named_sharding(*logical_axes: Optional[str]):
    return current_rules().sharding(*logical_axes)


def unflatten(x, dim: int, sizes):
    """`x.unflatten(dim, sizes)`. A DTensor whose `dim` is split over mesh
    axes that do not divide sizes[0] is first replicated along them:
    DTensor cannot split such a dim (8 kv heads over a 16-wide `model`
    axis), where XLA's partitioner regroups it."""
    if type(x) is not torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if isinstance(x, DTensor):
            d = dim % x.ndim
            pl = list(x.placements)
            ways = 1
            for m, p in enumerate(pl):
                if p == Shard(d):
                    ways *= x.device_mesh.size(m)
            if sizes[0] % ways:
                pl = [Replicate() if p == Shard(d) else p for p in pl]
                x = x.redistribute(x.device_mesh, pl)
    return x.unflatten(dim, sizes)
