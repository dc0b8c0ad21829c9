"""Optimizers (port of the reference `repro/optim/`): AdamW with its
schedules and global-norm clipping, and the error-feedback int8
all-reduce of the data-parallel gradients (`compression.py`)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, cosine_schedule, global_norm,
                    linear_warmup_cosine)
from .compression import compressed_psum_tree, ef_compress, ef_decompress

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compressed_psum_tree", "cosine_schedule",
           "ef_compress", "ef_decompress", "global_norm",
           "linear_warmup_cosine"]
