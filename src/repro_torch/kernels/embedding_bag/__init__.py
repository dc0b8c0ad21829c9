"""Weighted embedding bags (pooled lookups): a hand-written CUDA kernel for
Hopper (csrc/embedding_bag.cu), its plain torch version (ref.py) and the
wrapper (ops.py). The launch count is `ops.launches`."""
from . import ops
from .ops import embedding_bag
from .ref import embedding_bag_torch

__all__ = ["embedding_bag", "embedding_bag_torch", "ops"]
