"""qwen3-14b [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec
from .lm_common import lm_shape_cells


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
        vocab_size=151936, d_head=128, qk_norm=True, remat="full",
        rope_theta=1e6, q_chunk=1024, kv_chunk=1024)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, d_head=16, qk_norm=True, q_chunk=16, kv_chunk=16,
        compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(name="qwen3-14b", family="lm", config=full_config(),
                    smoke_config=smoke_config(), shapes=lm_shape_cells(),
                    source="hf:Qwen/Qwen3-8B")
