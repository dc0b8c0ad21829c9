"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel of
the reference `repro/kernels/`: csrc/ (CUDA source with a plain C
interface), kernel.py (ctypes binding; `common.py` builds the source with
nvcc at first use), ref.py (plain torch version) and ops.py (public
wrapper). All five are ported: frontier_expand, segment_ell, psw_spmm,
embedding_bag and flash_attention. A sixth, psw_sweep, has no Pallas
counterpart: it does the PSW sweep's gather and destination sum, which the
reference leaves to `jax.ops.segment_sum`."""
from . import (embedding_bag, flash_attention, frontier_expand, psw_spmm,
               psw_sweep, segment_ell)
