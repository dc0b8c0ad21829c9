"""The paper's own system config: GraphChi-DB storage/compute parameters
used by the benchmarks (twitter-2010-scale defaults scaled to CI size).
A copy of the reference `repro/configs/graphchi_db.py` (host-only)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphChiDBConfig:
    n_partitions: int = 16          # P (paper: hundreds at billions of edges)
    lsm_levels: int = 3             # L_G
    branching: int = 4              # f (paper's experiments use 4)
    buffer_cap: int = 100_000       # in-memory edge-buffer threshold
    max_partition_edges: int = 2_000_000
    durable: bool = False           # §7.3 durable vs memory-only buffers
    elias_gamma_index: bool = True  # §4.2.1 pointer-array compression


def full_config() -> GraphChiDBConfig:
    return GraphChiDBConfig()


def bench_config(scale: float = 1.0) -> GraphChiDBConfig:
    return GraphChiDBConfig(
        buffer_cap=max(int(20_000 * scale), 1000),
        max_partition_edges=max(int(200_000 * scale), 10_000))
