"""GNN models (port of the reference `repro/models/gnn/`): GIN, PNA and
MeshGraphNet. EquiformerV2 and its Wigner algebra wait for the PSW ring
(`graph/psw_ops.py`), ROADMAP queue 1's slice 6b."""
from . import common, gin, meshgraphnet, pna
