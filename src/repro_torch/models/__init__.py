"""Models (port of the reference `repro/models/`). Ported so far: the dense
decoder-only transformer; bert4rec, the GNNs and MoE are ROADMAP slice 8b's
remaining work."""
from . import transformer
