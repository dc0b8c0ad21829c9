"""phi3.5-moe-42b-a6.6b [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]
(port of the reference `repro/configs/phi35_moe.py`)."""
import torch

from ..models.transformer import MoEConfig, TransformerConfig
from .base import ArchSpec
from .lm_common import lm_shape_cells


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
        vocab_size=32064, d_head=128, remat="full",
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
        q_chunk=1024, kv_chunk=1024)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, d_head=16, q_chunk=16, kv_chunk=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(name="phi3.5-moe-42b-a6.6b", family="lm",
                    config=full_config(), smoke_config=smoke_config(),
                    shapes=lm_shape_cells(),
                    source="hf:microsoft/Phi-3.5-MoE-instruct")
