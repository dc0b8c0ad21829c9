"""Graph layouts for the device (port of `repro/graph/`; only `padding` so
far: segment_ops, chunked, sampler and psw_ops are ROADMAP slice 6)."""
from .padding import bucket_edges_by_block, pad_to_ell

__all__ = ["bucket_edges_by_block", "pad_to_ell"]
