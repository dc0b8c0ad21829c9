"""Message-passing substrate built on PAL storage (port of the reference
`repro/graph/`): segment ops, edge-chunked aggregation, the neighbour
sampler, the device layouts and `psw_ops`, the PSW ring over
`torch.distributed`."""
from .segment_ops import (
    aggregate_multi,
    degree,
    edge_softmax,
    gather_src,
    scatter_max,
    scatter_mean,
    scatter_min,
    scatter_std,
    scatter_sum,
)
from .sampler import NeighborSampler, SampledSubgraph
from .padding import pad_to_ell, bucket_edges_by_block

__all__ = [
    "aggregate_multi", "degree", "edge_softmax", "gather_src",
    "scatter_max", "scatter_mean", "scatter_min", "scatter_std", "scatter_sum",
    "NeighborSampler", "SampledSubgraph", "pad_to_ell", "bucket_edges_by_block",
]
