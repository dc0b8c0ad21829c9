"""pna [gnn] n_layers=4 d_hidden=75 aggregators=mean-max-min-std
scalers=id-amp-atten [arXiv:2004.05718; paper]."""
from ..models.gnn.pna import PNAConfig
from .base import ArchSpec
from .gnn_common import gnn_shape_cells


def full_config() -> PNAConfig:
    return PNAConfig(n_layers=4, d_hidden=75)


def smoke_config() -> PNAConfig:
    return PNAConfig(n_layers=2, d_hidden=16, d_in=8, n_classes=3)


def spec() -> ArchSpec:
    return ArchSpec(name="pna", family="gnn", config=full_config(),
                    smoke_config=smoke_config(), shapes=gnn_shape_cells(),
                    source="arXiv:2004.05718")
