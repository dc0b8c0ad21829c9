"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel of
the reference `repro/kernels/`: csrc/ (CUDA source with a plain C
interface), kernel.py (nvcc build at first use + ctypes binding), ref.py
(plain torch version) and ops.py (public wrapper). Ported so far:
frontier_expand."""
from . import frontier_expand
