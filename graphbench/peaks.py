"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
at the full 700 W power limit), and the least time a piece of work could
take on it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def bound_s(bytes_once: float, ops: float,
            ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The larger of the bytes over the memory's rate and the operations
    over the arithmetic rate: what the work takes at best."""
    return max(bytes_once / HBM_BYTES_PER_S, ops / ops_per_s)
