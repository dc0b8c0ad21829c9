"""Shared GNN shape-cell definitions (port of the reference
`repro/configs/gnn_common.py`; the same numbers).

d_feat / n_classes follow the public datasets these shapes describe:
full_graph_sm = Cora (2708/10556/1433, 7 classes); minibatch_lg = Reddit
(232,965 nodes, 114.6M edges, d=602, 41 classes, fanout 15-10);
ogb_products (2.44M/61.86M, d=100, 47 classes); molecule = QM9-like batched
small graphs. The sampled-minibatch cell is the PADDED subgraph the
NeighborSampler emits: 1024 seeds -> <=1024*15 L1 -> <=15360*10 L2 nodes.
"""
from __future__ import annotations

from typing import Dict

from .base import ShapeCell

# padded sampled-subgraph sizes for minibatch_lg (seeds + fanout closure)
MB_NODES = 1024 + 1024 * 15 + 1024 * 15 * 10          # 169,984 (128-aligned)
MB_EDGES = 1024 * 15 + 1024 * 15 * 10                 # 168,960 (128-aligned)

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7, task="node_class"),
    "minibatch_lg": dict(kind="train", n_nodes=MB_NODES, n_edges=MB_EDGES,
                         d_feat=602, n_classes=41, task="node_class",
                         seeds=1024, full_nodes=232_965,
                         full_edges=114_615_892, fanout=(15, 10)),
    "ogb_products": dict(kind="train", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47, task="node_class"),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16, n_classes=1, task="graph_reg"),
}


def gnn_shape_cells() -> Dict[str, ShapeCell]:
    return {name: ShapeCell(name=name, kind=d["kind"], dims=dict(d))
            for name, d in GNN_SHAPES.items()}
