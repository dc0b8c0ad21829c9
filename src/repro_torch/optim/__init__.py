"""Optimizers (port of the reference `repro/optim/`): AdamW with its
schedules and global-norm clipping. The error-feedback compressed psum
(`compression.py`) is an all-reduce and is ROADMAP slice 7's."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, cosine_schedule, global_norm,
                    linear_warmup_cosine)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "global_norm",
           "linear_warmup_cosine"]
