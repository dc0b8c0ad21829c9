"""Frontier expansion over a destination CSR plan: a hand-written CUDA kernel
for Hopper (csrc/frontier_expand.cu), its plain torch version (ref.py) and
the plan builder and wrapper (ops.py). The launch count is `ops.launches`."""
from . import ops
from .ops import (
    FrontierPlan,
    build_frontier_plan,
    frontier_expand_counts,
)
from .ref import frontier_expand_torch

__all__ = [
    "FrontierPlan",
    "build_frontier_plan",
    "frontier_expand_counts",
    "frontier_expand_torch",
    "ops",
]
