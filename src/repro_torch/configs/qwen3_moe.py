"""qwen3-moe-235b-a22b [moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8 — qk_norm [hf:Qwen/Qwen3-30B-A3B; hf]
(port of the reference `repro/configs/qwen3_moe.py`)."""
import torch

from ..models.transformer import MoEConfig, TransformerConfig
from .base import ArchSpec
from .lm_common import lm_shape_cells


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
        vocab_size=151936, d_head=128, qk_norm=True, remat="full",
        rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
        q_chunk=1024, kv_chunk=1024)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, d_head=16, qk_norm=True, q_chunk=16, kv_chunk=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
        compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(name="qwen3-moe-235b-a22b", family="lm",
                    config=full_config(), smoke_config=smoke_config(),
                    shapes=lm_shape_cells(),
                    source="hf:Qwen/Qwen3-30B-A3B")
