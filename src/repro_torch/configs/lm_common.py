"""Shared LM shape-cell definitions (port of the reference
`repro/configs/lm_common.py`)."""
from __future__ import annotations

from typing import Dict

from .base import ShapeCell

# assigned LM shapes: seq_len × global_batch
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

FULL_ATTN_SKIP = ("sub-quadratic attention required; this arch is pure "
                  "full-attention (no SSM/linear/hybrid variant assigned) — "
                  "skip per assignment, see DESIGN.md §4")


def lm_shape_cells(full_attention: bool = True) -> Dict[str, ShapeCell]:
    cells = {}
    for name, d in LM_SHAPES.items():
        skip = FULL_ATTN_SKIP if (name == "long_500k" and full_attention) else None
        cells[name] = ShapeCell(name=name, kind=d["kind"],
                                dims={"seq": d["seq"], "batch": d["batch"]},
                                skip=skip)
    return cells
