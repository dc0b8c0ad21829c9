"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826; paper]."""
from ..models.gnn.gin import GINConfig
from .base import ArchSpec
from .gnn_common import gnn_shape_cells


def full_config() -> GINConfig:
    return GINConfig(n_layers=5, d_hidden=64)


def smoke_config() -> GINConfig:
    return GINConfig(n_layers=2, d_hidden=16, d_in=8, n_classes=3)


def spec() -> ArchSpec:
    return ArchSpec(name="gin-tu", family="gnn", config=full_config(),
                    smoke_config=smoke_config(), shapes=gnn_shape_cells(),
                    source="arXiv:1810.00826")
