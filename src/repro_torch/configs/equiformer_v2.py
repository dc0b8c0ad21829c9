"""equiformer-v2 [gnn] n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8
equivariance=SO(2)-eSCN [arXiv:2306.12059; unverified]. Port of the
reference `repro/configs/equiformer_v2.py`.

Non-geometric shapes (citation/product graphs) get synthesized unit-ball
positions and hashed species ids in input_specs — the arch requires
geometry; noted in DESIGN.md §4."""
from ..models.gnn.equiformer_v2 import EquiformerV2Config
from .base import ArchSpec
from .gnn_common import gnn_shape_cells


def full_config() -> EquiformerV2Config:
    return EquiformerV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                              n_heads=8)


def smoke_config() -> EquiformerV2Config:
    return EquiformerV2Config(n_layers=2, d_hidden=16, l_max=2, m_max=1,
                              n_heads=2)


def spec() -> ArchSpec:
    return ArchSpec(name="equiformer-v2", family="gnn", config=full_config(),
                    smoke_config=smoke_config(), shapes=gnn_shape_cells(),
                    source="arXiv:2306.12059")
