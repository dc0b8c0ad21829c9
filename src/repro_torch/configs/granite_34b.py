"""granite-34b [dense] 88L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf]."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec
from .lm_common import lm_shape_cells


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
        vocab_size=49152, d_head=128, qk_norm=False, remat="full",
        q_chunk=1024, kv_chunk=1024)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=128, d_head=16, q_chunk=16, kv_chunk=16,
        compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(name="granite-34b", family="lm", config=full_config(),
                    smoke_config=smoke_config(), shapes=lm_shape_cells(),
                    source="arXiv:2405.04324; hf")
