"""Architecture configs (port of the reference `repro/configs/`):
dataclasses only, the reference's numbers."""
from .base import ARCH_IDS, ArchSpec, ShapeCell, get_arch, list_archs
