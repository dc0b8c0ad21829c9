"""Causal GQA flash attention: a hand-written CUDA kernel for Hopper
(csrc/flash_attention.cu), its plain torch versions (ref.py) and the
autograd wrapper (ops.py). The launch count is `ops.launches`."""
from . import ops
from .ops import flash_attention
from .ref import attention_chunked, attention_ref, flash_attention_torch

__all__ = ["attention_chunked", "attention_ref", "flash_attention",
           "flash_attention_torch", "ops"]
