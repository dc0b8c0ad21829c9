"""GNN models (port of the reference `repro/models/gnn/`): GIN, PNA,
MeshGraphNet and EquiformerV2 with its Wigner algebra."""
from . import common, equiformer_v2, gin, meshgraphnet, pna, wigner
