"""The PSW sweep's window exchange and its gather-and-segment-sum: hand-written
CUDA kernels for Hopper (csrc/psw_sweep.cu) with no Pallas counterpart (the
reference sums with `jax.ops.segment_sum`), their plain torch versions
(ref.py) and the wrappers (ops.py). The launch count is `ops.launches`."""
from . import ops
from .ops import segment_sum, window_send
from .ref import edge_rows_torch, segment_sum_torch, window_send_torch

__all__ = [
    "edge_rows_torch",
    "ops",
    "segment_sum",
    "segment_sum_torch",
    "window_send",
    "window_send_torch",
]
