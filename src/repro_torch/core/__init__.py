"""GraphChi-DB core, ported: PAL + LSM + multi-hop queries + PSW analytics
(the disk, service and shard tiers are not ported yet)."""
from .pal import (
    EdgePartition,
    GraphPAL,
    IntervalMap,
    SortedRun,
    build_partition,
    merge_runs,
    merge_runs_into_partition,
    merge_sorted_runs,
    partition_from_run,
    run_from_arrays,
    run_from_partition,
    sorted_run_index,
)
from .lsm import BufferStaging, EdgeBuffer, LSMStats, LSMTree, MergeTxn
from .manifest import EpochGuard, LevelManifest, ManifestPartition, ManifestView
from .engine import (
    EdgeBatch,
    EdgeChunk,
    LSMEngine,
    ManifestEngine,
    PALEngine,
    SnapshotEngine,
    StorageEngine,
    as_engine,
)
from . import telemetry
from .telemetry import (
    REGISTRY,
    MetricsRegistry,
    chrome_trace,
    merge_snapshots,
    span,
    trace_export,
)
from .multihop import (
    EdgePredicate,
    KHopResult,
    TwoHopResult,
    dense_plan,
    expand,
    khop,
    semijoin,
    triangle_count,
    two_hop_counts,
)
from .psw import (
    DeviceGraph,
    build_device_graph,
    edge_centric_sweep,
    pagerank_device,
    pagerank_host,
    pagerank_out_of_core,
    psw_sweep_host,
    stream_interval_buckets,
)
from .query import (
    Frontier,
    bfs,
    bfs_perhop,
    consistent_engine,
    dedup_frontier,
    friends_of_friends,
    friends_of_friends_perhop,
    shortest_path,
    shortest_path_perhop,
    traverse_out,
)
