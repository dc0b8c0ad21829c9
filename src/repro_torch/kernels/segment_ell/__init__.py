"""ELL neighbour gather-reduce: a hand-written CUDA kernel for Hopper
(csrc/segment_ell.cu), its plain torch version (ref.py) and the wrapper
(ops.py). The launch count is `ops.launches`."""
from . import ops
from .ops import segment_ell, segment_ell_from_edges
from .ref import segment_ell_torch

__all__ = ["ops", "segment_ell", "segment_ell_from_edges",
           "segment_ell_torch"]
