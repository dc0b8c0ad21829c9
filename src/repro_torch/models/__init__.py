"""Models (port of the reference `repro/models/`). Ported so far: the dense
decoder-only transformer and the GIN, PNA and MeshGraphNet GNNs;
EquiformerV2 is ROADMAP slice 6b's, bert4rec and MoE slice 8b's."""
from . import gnn, transformer
