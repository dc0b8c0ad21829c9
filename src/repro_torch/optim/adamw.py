"""AdamW + schedules + global-norm clipping over param trees (port of the
reference `repro/optim/adamw.py`).

The optimizer state mirrors the param tree (nested dicts and lists of
tensors, walked with `torch.utils._pytree`): {"m", "v"} of float32 tensors
and "step", an int32 0-d tensor, so `checkpoint/manager.py` saves
{"params", "opt"} under the reference's keys and either package resumes
the other's run.

The reference's cast points are kept: the gradient is scaled in its own
dtype, m, v and the update are float32, and each parameter is cast back
to its dtype. The learning rate is a tensor wherever a schedule gives it,
computed from the step tensor on its device, so an update never reads a
device value back to the host.

Unlike the reference, which is functional, `adamw_update` writes the new
params, m and v into the tensors it is given and returns them: at
granite-3-2b's full config a second copy of the params and both moments
would be another 31 GB. The grads are left as they are."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup_cosine", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def adamw_init(params):
    """{"m", "v"}: float32 zeros in the params' tree layout, on each leaf's
    device; "step": int32 0 on the first leaf's device."""
    leaves = pytree.tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, the leaves
    added in tree order as the reference adds them."""
    total = None
    for x in pytree.tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, their norm),
    each leaf scaled in its own dtype."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return pytree.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 schedule: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None):
    """Returns (params, state, metrics {"grad_norm", "lr"}), params, m and
    v updated in place (module docstring)."""
    step = state["step"] + 1
    lr = cfg.lr if schedule is None else cfg.lr * schedule(step)
    flat_g = pytree.tree_leaves(grads)
    scale = None
    gnorm = torch.zeros((), device=step.device)
    if cfg.clip_norm is not None:
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.clip_norm)

    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

    flat_p = pytree.tree_leaves(params)
    flat_m = pytree.tree_leaves(state["m"])
    flat_v = pytree.tree_leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(flat_p)} params, {len(flat_g)} grads, "
                         f"{len(flat_m)} m and {len(flat_v)} v leaves")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.to(torch.float32)
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
        del g, g32
        den = torch.sqrt(v / bc2).add_(cfg.eps)
        delta = (m / bc1).div_(den)
        del den
        p32 = p.to(torch.float32)
        delta.add_(cfg.weight_decay * p32)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p32 - delta.mul_(lr))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(total_steps: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        return final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    return fn


def linear_warmup_cosine(warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(max(total_steps - warmup, 1), final_frac)

    def fn(step: torch.Tensor) -> torch.Tensor:
        w = torch.clamp(step.to(torch.float32) / max(warmup, 1), max=1.0)
        return w * cos(torch.clamp(step - warmup, min=0))
    return fn
