"""The run's check that neither JAX nor the JAX package of this repository
is loaded: the top-level name of every module, the part before the first
dot, compared whole, so that `repro_torch` is not taken for `repro`."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
