"""Parallel Sliding Windows (paper §6), ported: port of `repro/core/psw.py`.

Two execution engines:

1. `psw_sweep_host` / `pagerank_host`: Algorithm 2 verbatim — sweep the P
   vertex intervals; for interval i load the subgraph (in-edges = the whole
   owner partition, out-edges = one contiguous *window* per partition, found
   via the source-sorted order), run the vertex update, write back. Host
   numpy copies of the reference, equal to it bitwise.

2. `DeviceGraph` + `edge_centric_sweep`: the device adaptation (DESIGN.md
   §2) on torch tensors. Each interval owns its destination partition. A
   sweep gathers source-vertex state from every interval, either through
   the precomputed PSW window rows (`mode="psw_windows"`, where the
   reference issues one `all_to_all`) or from the full vertex state
   (`mode="dense_gather"`, its `all_gather`). With `group=None` (the
   reference's `axis_name=None`) all intervals sit on one device and
   transposes stand in for the collectives. With a `torch.distributed`
   process group each rank passes its shard of the (P, ...) arrays (P /
   world intervals, `DeviceGraph.shard`), as the reference's callers do
   under `shard_map`, and the exchange is ONE `all_to_all_single` of the
   window rows (or one `all_gather_into_tensor` of the vertex state).

The host build of a `DeviceGraph` is the reference's algorithm, its arrays
bitwise equal to the reference's; the window plan's per-(owner, consumer)
uniques come from one `np.unique` per consumer instead of P. The
destination segment-sum (`jax.ops.segment_sum` in the reference) is a
fixed-order float64 scan differenced at the destination bounds, the same on
every device: no atomics, so a sweep gives the same bits on every run and
the same bits for every store layout holding the same edges, and a hub of
millions of in-edges sums to float64 accuracy before the float32 result is
rounded once. The scan runs along each partition's row on its own, so a
sweep over R ranks gives each interval the bits the one-device sweep
gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from . import telemetry
from .lsm import LSMTree
from .multihop import _resolve_device
from .pal import GraphPAL

GraphLike = Union[GraphPAL, LSMTree]


def _host_partitions(g: GraphLike) -> list:
    """Every physical partition of the store (all LSM levels, the PAL
    partition list, or a pinned ManifestView's partition proxies) —
    duck-typed, no storage-class branching. A `ManifestView`
    (core/manifest.py) satisfies the whole contract this module needs
    (`all_partitions` with stable `dead` refs, `buffers` as frozen staging
    shims, `to_coo`, `intervals`), so out-of-core PSW streaming and
    DeviceGraph compilation run against one epoch-pinned state while the
    writer and maintenance keep going."""
    all_parts = getattr(g, "all_partitions", None)
    return list(all_parts()) if all_parts is not None else list(g.partitions)


__all__ = [
    "DeviceGraph",
    "build_device_graph",
    "edge_centric_sweep",
    "edge_centric_sweep_arrays",
    "pagerank_device",
    "pagerank_out_of_core",
    "psw_sweep_host",
    "pagerank_host",
    "stream_interval_buckets",
]


# ---------------------------------------------------------------------------
# Host-side PSW (Algorithm 2)
# ---------------------------------------------------------------------------
def psw_sweep_host(
    g: GraphLike,
    update_interval: Callable[..., None],
) -> int:
    """One PSW iteration (paper Alg. 2). For each interval i the callback gets:

        update_interval(i, owner_partition, in_pos, windows)

    where `in_pos` are the dst-sorted edge positions of the owner partition
    and `windows` is a list of (partition, a, b) contiguous out-edge ranges —
    the sliding windows. Returns the number of random accesses a disk would
    have issued (Θ(P²)), for the benchmark I/O-proxy.
    """
    iv = g.intervals
    # PAL: one owner partition per interval; LSM: one owner per level +
    # windows from every partition (duck-typed on the partition layout)
    parts = g.partitions if not hasattr(g, "all_partitions") else None
    seeks = 0
    for i in range(iv.n_partitions):
        lo, hi = iv.interval_range(i)
        if parts is not None:
            owner = parts[i]
            all_parts = parts
        else:
            all_parts = g.all_partitions()
            owner = None
        windows = []
        for part in all_parts:
            a, b = part.window((lo, hi))
            windows.append((part, a, b))
            seeks += 1  # one seek per window (paper §6.1)
        if parts is not None:
            update_interval(i, owner, windows)
            seeks += 1  # owner partition sequential load
        else:
            owners = [
                p for p in all_parts if p.interval[0] <= lo < p.interval[1]
            ]
            update_interval(i, owners, windows)
            seeks += len(owners)
    return seeks


def pagerank_host(g: GraphLike, n_iters: int = 5, damping: float = 0.85) -> np.ndarray:
    """Vertex-centric PageRank with PSW, state on edges (paper §6.1).

    The edge state rank(src)/outdeg(src) lives in a fresh per-partition
    OVERLAY keyed by partition identity — the store's attribute columns are
    never written. Each sweep computes an interval's new ranks from its
    in-edge state and refreshes its out-edge state through the sliding
    windows. Returns ranks indexed by internal ID.
    """
    iv = g.intervals
    n = iv.max_vertices
    # PSW windows only cover partitions, so an LSM store merges its buffers
    # first (read-only analytics use snapshot() instead)
    flush_all = getattr(g, "flush_all", None)
    if flush_all is not None:
        flush_all()
    parts = _host_partitions(g)

    # out-degree (global pass)
    outdeg = np.zeros(n, dtype=np.int64)
    for p in parts:
        if p.n_edges:
            live = np.ones(p.n_edges, bool) if p.dead is None else ~p.dead
            np.add.at(outdeg, p.src[live], 1)
    ranks = np.full(n, 1.0, dtype=np.float64)
    # `parts` (and the window partitions psw_sweep_host hands back) are the
    # store's own stable partition objects, so identity keys are stable for
    # the whole run; `parts` holds them alive
    pr = {}
    for p in parts:
        if p.n_edges:
            pr[id(p)] = ranks[p.src] / np.maximum(outdeg[p.src], 1)
        else:
            pr[id(p)] = np.zeros(0, dtype=np.float64)

    def sweep(i, owner, windows):
        lo, hi = iv.interval_range(i)
        owners = owner if isinstance(owner, list) else [owner]
        acc = np.zeros(hi - lo, dtype=np.float64)
        for p in owners:
            if p.n_edges == 0:
                continue
            live = np.ones(p.n_edges, bool) if p.dead is None else ~p.dead
            sel = live & (p.dst >= lo) & (p.dst < hi)
            np.add.at(acc, p.dst[sel] - lo, pr[id(p)][sel])
        new_rank = (1 - damping) + damping * acc
        ranks[lo:hi] = new_rank
        # refresh out-edge state through the windows
        for p, a, b in windows:
            if b > a:
                s = p.src[a:b]
                pr[id(p)][a:b] = ranks[s] / np.maximum(outdeg[s], 1)

    for _ in range(n_iters):
        psw_sweep_host(g, sweep)
    return ranks


# ---------------------------------------------------------------------------
# Out-of-core PSW (disk tier, paper §6.1): stream buckets, never materialize
# ---------------------------------------------------------------------------
def stream_interval_buckets(g: GraphLike, evict_each: bool = False):
    """Yield `(i, src, dst)` per destination interval, internal IDs,
    canonically (dst, src)-sorted — exactly the rows `build_device_graph`
    would pack, produced ONE interval at a time so the whole edge set is
    never resident.

    Per interval, each owning partition contributes one contiguous slice of
    its dst-sorted permutation (read from mmap if the partition is
    disk-backed), buffers contribute a masked scan, and one small stable
    lexsort canonicalizes the bucket. Chunk concatenation follows the
    `to_coo` order, so the per-bucket sort is bit-identical to the global
    lexsort restricted to the bucket. With `evict_each`, disk partitions
    drop their mappings after every bucket, bounding resident memory by one
    bucket + the pinned indexes.
    """
    iv = g.intervals
    parts = _host_partitions(g)
    buffers = getattr(g, "buffers", None) or []
    for i in range(iv.n_partitions):
        lo, hi = iv.interval_range(i)
        chunks_s: list = []
        chunks_d: list = []
        for part in parts:
            plo, phi = part.interval
            if phi <= lo or plo >= hi or part.n_edges == 0:
                continue
            # disk partitions resolve the bucket's perm range against the
            # compressed resident index; RAM partitions use the arrays
            bounds = getattr(part, "dst_ptr_bounds", None)
            res = bounds(lo, hi) if bounds is not None else None
            if res is not None:
                pa, pb = res
            else:
                dv = part.dst_vertices
                a = int(np.searchsorted(dv, lo, side="left"))
                b = int(np.searchsorted(dv, hi, side="left"))
                pa, pb = int(part.dst_ptr[a]), int(part.dst_ptr[b])
            if pb == pa:
                continue
            # perm slice → ascending edge-array positions = to_coo order
            pos = np.sort(np.asarray(part.dst_perm[pa:pb], np.int64))
            if part.dead is not None:
                pos = pos[~part.dead[pos]]
            if pos.size:
                chunks_s.append(np.asarray(part.src[pos], np.int64))
                chunks_d.append(np.asarray(part.dst[pos], np.int64))
        for buf in buffers:
            if len(buf):
                st = buf.staging()
                m = (st.dst >= lo) & (st.dst < hi)
                if m.any():
                    chunks_s.append(st.src[m].astype(np.int64))
                    chunks_d.append(st.dst[m].astype(np.int64))
        if chunks_s:
            s = np.concatenate(chunks_s)
            d = np.concatenate(chunks_d)
            order = np.lexsort((s, d))
            s, d = s[order], d[order]
        else:
            s = np.empty(0, np.int64)
            d = np.empty(0, np.int64)
        yield i, s, d
        if evict_each:
            for part in parts:
                # a swept bucket's pages won't be re-read this pass: hint
                # the kernel to drop them so streaming the store doesn't
                # churn hotter data out of the page cache, then unmap
                advise = getattr(part, "advise_dontneed", None)
                if advise is not None:
                    advise()
                ev = getattr(part, "evict", None)
                if ev is not None:
                    ev()


def pagerank_out_of_core(g: GraphLike, n_iters: int = 5,
                         damping: float = 0.85,
                         evict_each: bool = True) -> np.ndarray:
    """Edge-centric PageRank streaming one destination-interval bucket at a
    time from the store — the paper's §6.1.1 model executed out-of-core:
    O(V) vertex state resident, one bucket of edges in flight, everything
    else on disk. Same synchronous iteration as `pagerank_device`. Returns
    ranks indexed by internal ID."""
    iv = g.intervals
    n = iv.max_vertices
    outdeg = np.zeros(n, np.int64)
    for i, s, d in stream_interval_buckets(g, evict_each=evict_each):
        if s.size:
            outdeg += np.bincount(s, minlength=n)
    ranks = np.ones(n, np.float64)
    inv_deg = 1.0 / np.maximum(outdeg, 1)
    for _ in range(n_iters):
        contrib = ranks * inv_deg
        acc = np.zeros(n, np.float64)
        for i, s, d in stream_interval_buckets(g, evict_each=evict_each):
            if s.size:
                lo, hi = iv.interval_range(i)
                acc[lo:hi] = np.bincount(d - lo, weights=contrib[s],
                                         minlength=hi - lo)
        ranks = (1.0 - damping) + damping * acc
    return ranks


# ---------------------------------------------------------------------------
# Device PSW (torch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceGraph:
    """Interval-sharded immutable graph arrays (struct-of-arrays, padded),
    torch tensors on one device.

    Leading axis P = number of intervals. Edges of partition i are
    dst-sorted (so segment ops see monotone ids) and padded to E_max.
    """

    n_partitions: int
    interval_len: int
    n_edges: int
    src: torch.Tensor        # (P, E) int32 global internal source IDs
    dst_local: torch.Tensor  # (P, E) int32 local destination offsets
    mask: torch.Tensor       # (P, E) bool  (False = padding)
    outdeg: torch.Tensor     # (P, L) int32 out-degree of owned vertices
    # PSW window-exchange plan (None until build_window_plan)
    send_idx: Optional[torch.Tensor] = None    # (P, P, W) owner-local rows
    edge_owner: Optional[torch.Tensor] = None  # (P, E) src owner interval
    edge_slot: Optional[torch.Tensor] = None   # (P, E) row in recv buffer
    # port only: seg_ptr[p, v] = first edge of partition p whose local
    # destination is >= v, so v's edges are seg_ptr[p, v]:seg_ptr[p, v + 1]
    seg_ptr: Optional[torch.Tensor] = None     # (P, L + 1) int64

    @property
    def window_width(self) -> int:
        return 0 if self.send_idx is None else int(self.send_idx.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def shard(self, rank: int, world: int) -> "DeviceGraph":
        """This rank's intervals: rows rank * P / world ... of every (P,
        ...) array (P / world of them; `n_partitions` stays P), the input
        of a sweep over a process group of `world` ranks."""
        P = self.n_partitions
        if world < 1 or P % world or not 0 <= rank < world:
            raise ValueError(f"{P} intervals do not split over rank {rank} "
                             f"of {world}")
        rows = slice(rank * (P // world), (rank + 1) * (P // world))
        sliced = {f.name: getattr(self, f.name)[rows]
                  for f in dataclasses.fields(self)
                  if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **sliced)

    def to(self, device) -> "DeviceGraph":
        """The same graph with every array on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _host_device_graph(g: GraphLike):
    """The reference's host build: (P, E_max) arrays S, D, M from one
    global (dst, src) lexsort, and the out-degrees."""
    iv = g.intervals
    P, L = iv.n_partitions, iv.interval_len
    src_o, dst_o = g.to_coo()
    src = np.asarray(iv.to_internal(src_o))
    dst = np.asarray(iv.to_internal(dst_o))
    del src_o, dst_o
    # ONE global (dst, src) lexsort canonically orders every bucket at once:
    # sorting by dst groups the destination intervals contiguously and
    # ascending, and within a bucket (dst, src)-order equals the per-bucket
    # sort — so an LSMTree.snapshot() (which feeds the live staging views
    # through `to_coo`) stays bit-identical to a bulk-built GraphPAL's
    # DeviceGraph.
    order = np.lexsort((src, dst))
    s_sorted, d_sorted = src[order], dst[order]
    del order
    bounds = np.searchsorted(d_sorted, np.arange(P + 1, dtype=np.int64) * L)
    counts = np.diff(bounds)
    e_max = max(1, int(counts.max(initial=0)))
    # round up to a lane-friendly multiple (the reference's TPU tiles are
    # 128-wide; kept so the arrays stay equal)
    e_max = -(-e_max // 128) * 128
    S = np.zeros((P, e_max), np.int32)
    D = np.zeros((P, e_max), np.int32)
    M = np.zeros((P, e_max), bool)
    for i in range(P):
        a, b = int(bounds[i]), int(bounds[i + 1])
        S[i, : b - a] = s_sorted[a:b]
        D[i, : b - a] = d_sorted[a:b] - i * L
        M[i, : b - a] = True
    outdeg = np.bincount(src, minlength=P * L).astype(np.int32)
    return S, D, M, outdeg.reshape(P, L), int(src.shape[0])


def _window_plan_arrays(S: np.ndarray, M: np.ndarray, P: int, L: int):
    """The PSW window exchange: which owner rows each consumer needs
    (unique srcs per (owner, consumer) pair), and per-edge slots into the
    receive buffer. Host-side, immutable alongside the partitions.

    Equal to the reference's `_build_window_plan`: consumer j's sorted
    unique sources, cut where the owner interval changes, are its per-owner
    uniques, and an edge's slot is its source's rank among them."""
    uniq = {}
    slots = {}
    w_max = 1
    for j in range(P):  # consumer partition j
        n_j = int(M[j].sum())
        u, inv = np.unique(S[j, :n_j], return_inverse=True)
        cut = np.searchsorted(u, np.arange(P + 1, dtype=np.int64) * L)
        for i in range(P):
            uniq[(i, j)] = u[cut[i]:cut[i + 1]]
            w_max = max(w_max, int(cut[i + 1] - cut[i]))
        slots[j] = (n_j, inv - cut[S[j, :n_j] // L])
    w_max = -(-w_max // 128) * 128
    send_idx = np.zeros((P, P, w_max), np.int32)
    for (i, j), u in uniq.items():
        send_idx[i, j, : u.shape[0]] = (u - i * L).astype(np.int32)
    edge_owner = (S // L).astype(np.int32)
    edge_slot = np.zeros_like(S)
    for j in range(P):
        n_j, slot = slots[j]
        edge_slot[j, :n_j] = slot      # padding rows keep slot 0
    return send_idx, edge_owner, edge_slot.astype(np.int32)


def build_device_graph(g: GraphLike, with_window_plan: bool = True,
                       device=None) -> DeviceGraph:
    """Compile a store (GraphPAL, LSMTree, ManifestView) into a DeviceGraph
    on `device` (None: the GPU, raising when there is none). The arrays
    are built on the host and then copied to the device once;
    `device="cpu"` keeps them on the host without a copy. The destination
    CSR `seg_ptr` is derived where the arrays land (`segment_ptr`)."""
    dev = _resolve_device(device, "the PSW device path")
    iv = g.intervals
    P, L = iv.n_partitions, iv.interval_len
    S, D, M, outdeg, n_edges = _host_device_graph(g)
    window = {}
    if with_window_plan:
        send_idx, edge_owner, edge_slot = _window_plan_arrays(S, M, P, L)
        window = {"send_idx": send_idx, "edge_owner": edge_owner,
                  "edge_slot": edge_slot}
    arrays = dict(src=S, dst_local=D, mask=M, outdeg=outdeg, **window)
    dg = DeviceGraph(n_partitions=P, interval_len=L, n_edges=n_edges,
                     **{k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in arrays.items()})
    if dev.type != "cpu":
        dg = dg.to(dev)
    dg.seg_ptr = segment_ptr(dg.dst_local, dg.mask, L)
    return dg


def segment_ptr(dst_local: torch.Tensor, mask: torch.Tensor,
                interval_len: int) -> torch.Tensor:
    """(P, L + 1) int64 destination CSR of dst-sorted (P, E) rows whose
    valid edges form a prefix: padding counts as destination L."""
    L = interval_len
    key = torch.where(mask, dst_local, torch.full_like(dst_local, L))
    bounds = torch.arange(L + 1, dtype=key.dtype, device=key.device)
    return torch.searchsorted(key.contiguous(),
                              bounds.expand(key.shape[0], L + 1).contiguous())


# -- collectives, with transposes standing in on one device -----------------
def _exchange_windows(x: torch.Tensor, send_idx: torch.Tensor,
                      group=None) -> torch.Tensor:
    """PSW window exchange.

    x: (Pl, L, d) owner-local vertex state; send_idx: (Pl, P, W)
    owner-local rows destined for each global consumer. Returns recv:
    (Pl, P, W, d) with recv[c, o] = x_owner_o[send_idx[o, c]]. Over a
    process group this is ONE `all_to_all_single`: the send buffer split
    over consumers, the receive buffer concatenated over owners (the
    reference's `all_to_all(split_axis=1, concat_axis=0)`); without one it
    is the same math via a transpose. The reference's `take_along_axis`
    broadcasts x over the consumer axis; torch.gather does not, so x is
    expanded (a view, no copy)."""
    Pl, L, d = x.shape
    P, W = send_idx.shape[1], send_idx.shape[2]
    idx = send_idx.long()[..., None].expand(Pl, P, W, d)
    send = torch.gather(x[:, None].expand(Pl, P, L, d), 2, idx)
    # send: (Pl owner, P consumer, W, d)
    if group is None:
        return send.transpose(0, 1)  # (P consumer, P owner, W, d)
    import torch.distributed as dist
    world = dist.get_world_size(group)
    buf = send.transpose(0, 1).contiguous()        # (P consumer, Pl owner)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    # out: (world owner rank, Pl consumer, Pl owner, W, d)
    return out.reshape(world, P // world, Pl, W, d).transpose(0, 1).reshape(
        P // world, world * Pl, W, d)


def _gather_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """(P * L, d): every interval's vertex state, in interval order."""
    if group is None:
        return x.reshape(-1, x.shape[-1])
    import torch.distributed as dist
    world = dist.get_world_size(group)
    out = torch.empty((world * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.reshape(-1, x.shape[-1])


_SCAN_BLOCK = 1024


def _rowwise_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along dim 1 of a 2-D tensor, in a fixed order.
    torch scans each row of a tensor with more than one row left to right
    within one CUDA block; a single row would go to a device-wide scan
    whose float grouping depends on timing, so a zero row is added. This
    is how torch 2.11.0+cu128 scans on an H100; it is not documented, so
    `test_segment_sum_sorted_is_deterministic` in
    tests/test_torch_kernel_cuda.py holds it on the card."""
    if x.shape[0] > 1:
        return torch.cumsum(x, 1)
    return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), 1)[:1]


def segment_sum_sorted(msgs: torch.Tensor,
                       seg_ptr: torch.Tensor) -> torch.Tensor:
    """out[p, v] = Σ msgs[p, seg_ptr[p, v]:seg_ptr[p, v + 1]] for (P, E, d)
    msgs and a (P, L + 1) destination CSR: the reference's per-partition
    sorted `segment_sum`. A float64 inclusive scan in blocks of
    `_SCAN_BLOCK` (each block scanned in order, then the block totals), read
    at the segment bounds and differenced, then rounded once to the input
    dtype. Fixed order, no atomics: deterministic on every device."""
    P, E, d = msgs.shape
    L = seg_ptr.shape[1] - 1
    rows = msgs.permute(0, 2, 1).reshape(P * d, E).to(torch.float64)
    nb = -(-E // _SCAN_BLOCK)
    if nb * _SCAN_BLOCK != E:
        rows = torch.nn.functional.pad(rows, (0, nb * _SCAN_BLOCK - E))
    inner = _rowwise_cumsum(rows.reshape(P * d * nb, _SCAN_BLOCK))
    del rows
    inner = inner.reshape(P * d, nb, _SCAN_BLOCK)
    carry = _rowwise_cumsum(inner[:, :, -1])          # (P*d, nb) inclusive
    inner[:, 1:] += carry[:, :-1, None]
    del carry
    scan = torch.nn.functional.pad(inner.reshape(P * d, nb * _SCAN_BLOCK),
                                   (1, 0))            # scan[:, i] = Σ_{<i}
    del inner
    ptr = seg_ptr[:, None, :].expand(P, d, L + 1).reshape(P * d, L + 1)
    at = torch.gather(scan, 1, ptr)
    out = (at[:, 1:] - at[:, :-1]).to(msgs.dtype)
    return out.reshape(P, d, L).permute(0, 2, 1).contiguous()


def edge_centric_sweep_arrays(
    src: torch.Tensor,          # (Pl, E) global src IDs
    dst_local: torch.Tensor,    # (Pl, E)
    mask: torch.Tensor,         # (Pl, E)
    interval_len: int,
    x: torch.Tensor,            # (Pl, L, d) vertex state (owner-local rows)
    msg_fn: Callable[[torch.Tensor], torch.Tensor],
    mode: str = "psw_windows",
    group=None,
    send_idx: Optional[torch.Tensor] = None,     # (Pl, P, W)
    edge_owner: Optional[torch.Tensor] = None,   # (Pl, E)
    edge_slot: Optional[torch.Tensor] = None,    # (Pl, E)
    seg_ptr: Optional[torch.Tensor] = None,      # (Pl, L + 1)
) -> torch.Tensor:
    """One edge-centric PSW sweep over per-shard arrays: gather source state
    (from the whole vertex state, or through the PSW window exchange),
    apply `msg_fn`, segment-sum into local destinations. `group`: a
    process group whose ranks each hold Pl = P / world intervals, or None
    (Pl = P, one device). Returns (Pl, L, d') sums."""
    if x.ndim == 2:
        x = x[..., None]
    with telemetry.span("x.psw.window_gather"):
        if mode == "dense_gather":
            x_all = _gather_all(x, group)                # (P*L, d)
            src_state = x_all[src]                       # (Pl, E, d)
        elif mode == "psw_windows":
            if send_idx is None:
                raise ValueError("window plan not built: build the "
                                 "DeviceGraph with with_window_plan=True")
            recv = _exchange_windows(x, send_idx, group)  # (Pl, P, W, d)
            w = recv.shape[2]
            flat = recv.reshape(recv.shape[0], -1, x.shape[-1])
            idx = (edge_owner * w + edge_slot).long()  # < P*W: no wrap
            src_state = torch.gather(
                flat, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
        else:
            raise ValueError(mode)
    msgs = msg_fn(src_state) * mask[..., None]
    if seg_ptr is None:
        seg_ptr = segment_ptr(dst_local, mask, interval_len)
    with telemetry.span("x.psw.segment_sum"):
        return segment_sum_sorted(msgs, seg_ptr)


def edge_centric_sweep(
    dg: DeviceGraph,
    x: torch.Tensor,
    msg_fn: Callable[[torch.Tensor], torch.Tensor],
    mode: str = "psw_windows",
    group=None,
) -> torch.Tensor:
    """Sweep over the DeviceGraph: all intervals on its device, or, over a
    process group, this rank's `dg.shard(rank, world)`."""
    return edge_centric_sweep_arrays(
        dg.src, dg.dst_local, dg.mask, dg.interval_len, x, msg_fn,
        mode=mode, group=group, send_idx=dg.send_idx,
        edge_owner=dg.edge_owner, edge_slot=dg.edge_slot,
        seg_ptr=dg.seg_ptr,
    )


def pagerank_device(dg: DeviceGraph, n_iters: int = 5, damping: float = 0.85,
                    mode: str = "psw_windows", group=None) -> torch.Tensor:
    """PageRank with the device PSW engine. Returns (Pl, L) float32 ranks
    on the DeviceGraph's device: all P intervals' with `group=None`, this
    rank's with a process group (dg then this rank's shard)."""
    with telemetry.span("x.psw.pagerank"):
        inv_deg = 1.0 / torch.clamp(dg.outdeg.to(torch.float32), min=1.0)
        r = torch.ones(inv_deg.shape, dtype=torch.float32, device=dg.device)
        for _ in range(n_iters):
            contrib = (r * inv_deg)[..., None]           # (Pl, L, 1)
            acc = edge_centric_sweep(dg, contrib, lambda s: s, mode, group)
            r = (1.0 - damping) + damping * acc[..., 0]
        return r
