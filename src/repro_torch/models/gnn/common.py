"""Shared GNN building blocks (port of the reference
`repro/models/gnn/common.py`): functional, with params as nested lists and
dicts of tensors in the reference's layout, so `repro_torch.convert`
carries the reference's params across key for key.

Initialisation draws from an explicit `torch.Generator` on `device` (None:
the GPU), with the reference's shapes and scale (normal · d_in^-0.5,
zero biases); a torch generator gives other numbers than a jax key."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ...core.multihop import _resolve_device

__all__ = ["init_mlp", "mlp_apply", "init_linear", "linear", "layer_norm",
           "GraphBatch", "param_device"]

# A graph minibatch is a plain dict:
#   x:         (N, d_in) node features
#   src, dst:  (E,) integer local edge indices
#   edge_mask: (E,) bool
#   node_mask: (N,) bool
#   edge_attr: optional (E, d_e)
#   pos:       optional (N, 3) coordinates
#   labels:    optional (N,) or (B,) targets
GraphBatch = Dict[str, torch.Tensor]


def param_device(gen: Optional[torch.Generator], device) -> tuple:
    """(generator, device) for `init_params`: `device` None means the GPU,
    and a missing generator is one seeded 0 on that device."""
    dev = _resolve_device(device, "the model")
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    return gen, dev


def init_linear(gen: torch.Generator, d_in: int, d_out: int, device,
                dtype=torch.float32):
    """{"w": (d_in, d_out) normal · d_in^-0.5, "b": zeros (d_out,)}, drawn
    from `gen` (on `device`, or on the CPU for the "meta" device)."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=device) * (d_in ** -0.5)
    return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def linear(p, x):
    return x @ p["w"] + p["b"]


def init_mlp(gen: torch.Generator, dims: Sequence[int], device,
             dtype=torch.float32):
    return [init_linear(gen, a, b, device, dtype)
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(layers, x, act=torch.relu, final_act=False):
    for i, p in enumerate(layers):
        x = linear(p, x)
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def layer_norm(x, scale=None, bias=None, eps=1e-5):
    """The reference's layer norm: `jnp.var` is the population variance."""
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, unbiased=False)
    y = (x - m) * torch.rsqrt(v + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y
