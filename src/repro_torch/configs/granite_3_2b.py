"""granite-3-2b [dense] 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base; hf]."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec
from .lm_common import lm_shape_cells


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
        vocab_size=49155, d_head=64, remat="full",
        q_chunk=1024, kv_chunk=1024)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, d_head=16, q_chunk=16, kv_chunk=16,
        compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(name="granite-3-2b", family="lm", config=full_config(),
                    smoke_config=smoke_config(), shapes=lm_shape_cells(),
                    source="hf:ibm-granite/granite-3.0-2b-base")
