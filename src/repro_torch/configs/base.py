"""Arch registry (port of the reference `repro/configs/base.py`): every
architecture id of the reference is listed, and `get_arch` returns the
`ArchSpec` of a ported one (all ten are). An architecture whose model is
not ported yet would be listed in `_NOT_PORTED` and raise
`NotImplementedError` naming its ROADMAP slice."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

__all__ = ["ShapeCell", "ArchSpec", "get_arch", "list_archs", "ARCH_IDS"]

ARCH_IDS = [
    "granite-34b", "granite-3-2b", "qwen3-14b",
    "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
    "pna", "gin-tu", "equiformer-v2", "meshgraphnet",
    "bert4rec",
]

_MODULES = {
    "granite-34b": "repro_torch.configs.granite_34b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe",
    "pna": "repro_torch.configs.pna",
    "gin-tu": "repro_torch.configs.gin_tu",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "bert4rec": "repro_torch.configs.bert4rec",
}

# architectures whose model is not ported yet, and where that work stands
_NOT_PORTED: Dict[str, str] = {}


@dataclasses.dataclass
class ShapeCell:
    """One (arch × input-shape) cell."""

    name: str
    kind: str                 # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    skip: Optional[str] = None  # reason string if inapplicable


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str               # lm | gnn | recsys
    config: Any               # full published config
    smoke_config: Any         # reduced config for CPU smoke tests
    shapes: Dict[str, ShapeCell]
    source: str               # citation tag


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"{arch_id} is not ported yet "
                                  f"({_NOT_PORTED[arch_id]})")
    return importlib.import_module(_MODULES[arch_id]).spec()


def list_archs():
    return list(ARCH_IDS)
