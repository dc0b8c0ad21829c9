"""bert4rec [recsys] embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq [arXiv:1904.06690; paper] (port of the reference
`repro/configs/bert4rec.py`).

Item table: 10^6 rows (matches retrieval_cand's 1M candidate universe)."""
from ..models.bert4rec import Bert4RecConfig
from .base import ArchSpec, ShapeCell


RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def full_config() -> Bert4RecConfig:
    return Bert4RecConfig(n_items=1_000_000, embed_dim=64, n_blocks=2,
                          n_heads=2, seq_len=200)


def smoke_config() -> Bert4RecConfig:
    return Bert4RecConfig(n_items=200, embed_dim=16, n_blocks=2, n_heads=2,
                          seq_len=16)


def spec() -> ArchSpec:
    shapes = {n: ShapeCell(name=n, kind=d["kind"], dims=dict(d))
              for n, d in RECSYS_SHAPES.items()}
    return ArchSpec(name="bert4rec", family="recsys", config=full_config(),
                    smoke_config=smoke_config(), shapes=shapes,
                    source="arXiv:1904.06690")
