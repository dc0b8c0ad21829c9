"""GraphChi-DB core, ported: PAL + LSM + the on-disk tier (partition files,
`GraphDB`, the segmented WAL, the Elias-Gamma codec, failpoints and
integrity checks) + the service tier (`ServiceDB`, `Snapshot` sessions,
the `FrontDesk`, deadlines and circuit breakers) + the shard tier
(`ShardRouter` over spawned worker processes) + multi-hop queries + PSW
analytics. The names are the reference `repro.core`'s."""
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
from .failpoints import (
    CATALOG,
    CRASH_EXIT_CODE,
    FailpointError,
    failpoint,
    fp_armed,
    fp_clear,
    fp_hits,
    fp_set,
    fp_trace,
)
from .integrity import (
    CKSUM_ALGO,
    CRC_ALGO,
    CorruptionError,
    DeadlineExceeded,
    GraphDBError,
    OverloadError,
    ReadOnlyError,
    RecoveryError,
    WALCorruptionError,
    WALGapError,
    checksum32,
    crc32,
    fsync_dir,
    record_checksum,
)
from .deadline import (
    CircuitBreaker,
    Deadline,
    backoff_delays,
    current_deadline,
    deadline_scope,
)
from .lsm import BufferStaging, EdgeBuffer, LSMStats, LSMTree, MergeTxn
from .manifest import EpochGuard, LevelManifest, ManifestPartition, ManifestView
from .disk import (
    DiskPartition,
    GraphDB,
    IOStats,
    PartitionStore,
    RawDiskIndex,
    SparseDiskIndex,
    open_partition_file,
    partition_digest,
    write_partition_file,
)
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
from .service import ServiceDB, ServiceStats, Snapshot, tail_cache_stats
from .walog import SegmentedWAL
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
from .shardrouter import (
    ShardConfig,
    ShardEpochLost,
    ShardOverloadError,
    ShardProtocolError,
    ShardRemoteError,
    ShardRouter,
    ShardUnavailable,
    ShardedEngine,
    ShardedView,
    shard_of,
)
from .frontdesk import FrontDesk, FrontDeskStats
from .psw import (
    DeviceGraph,
    build_device_graph,
    edge_centric_sweep,
    edge_centric_sweep_arrays,
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
from .codec import (
    BlockedGammaPointer,
    GammaChunkedIndex,
    SparseIndex,
    decode_monotonic,
    decode_monotonic_blocked,
    elias_gamma_decode,
    elias_gamma_encode,
    encode_monotonic,
    encode_monotonic_blocked,
)
