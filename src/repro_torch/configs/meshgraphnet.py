"""meshgraphnet [gnn] n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2
[arXiv:2010.03409; unverified]."""
from ..models.gnn.meshgraphnet import MeshGraphNetConfig
from .base import ArchSpec
from .gnn_common import gnn_shape_cells


def full_config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(n_layers=15, d_hidden=128, mlp_layers=2)


def smoke_config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(n_layers=2, d_hidden=16, mlp_layers=2,
                              d_node_in=8, d_edge_in=4, d_out=3)


def spec() -> ArchSpec:
    return ArchSpec(name="meshgraphnet", family="gnn", config=full_config(),
                    smoke_config=smoke_config(), shapes=gnn_shape_cells(),
                    source="arXiv:2010.03409")
