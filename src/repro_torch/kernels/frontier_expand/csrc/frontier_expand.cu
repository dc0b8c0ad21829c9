// Frontier expansion over a compact destination CSR, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/frontier_expand/frontier_expand.py::frontier_expand_pallas
// together with its wrapper's sorted segment_sum per destination
// (src/repro/kernels/frontier_expand/ops.py::frontier_expand_counts):
//
//   out[d, j] = sum over the plan's edges (s, d):  x[s, j]
//
// The plan (ops.py::build_frontier_plan, built with torch on the card from
// the deduplicated packed edge keys) is the layout this kernel and the
// plain version (ref.py) read:
//   col (E,) int32       each edge's source, so each destination's edges
//                        are contiguous and in ascending source order;
//   edge_ptr (n_dst + 1) edges of d are col[edge_ptr[d]:edge_ptr[d + 1]];
//   chunks (C, 2)        [edge begin, edge end) pieces of at most
//                        `chunk_edges` edges of each heavy destination (one
//                        with more than `light_edges` edges); first the S
//                        chunks of the hubs of several chunks, then the
//                        lone chunks of the others;
//   chunk_row (C,)       the row chunk c writes: scratch row c (c < S), or
//                        its destination's row of out (a lone chunk);
//   reduce_dst, reduce_ptr  the CSR from the hubs of several chunks to
//                        their scratch rows, which pass 2 sums per hub.
//
// Work split. A warp walks one "group": 32 consecutive destinations (lane j
// owns destination 32w + j; a heavy one counts 0 edges and is left to its
// chunks) or one hub chunk (lane 0 owns it). Lanes stream the group's edges
// as one contiguous range, 32 at a time, with coalesced `col` loads; a lane
// finds the owner of its edge by a binary search over the lanes' exclusive
// prefix of edge counts. No warp walks more than max(32 * light_edges,
// chunk_edges) edges, so a power-law hub cannot hold the launch behind one
// warp.
//   * narrow panels (B < 32; B = 1 for bfs and khop): each lane gathers its
//     edge's x value (x is 16 MB at B = 1, L2-resident) and a segmented
//     shuffle scan sums the values per owner, so 32 independent gathers are
//     in flight per warp; lane j adds its destination's run. B > 1 repeats
//     the walk per column. (A CSR-vector walk, 4 or 8 lanes per
//     destination, ran 4-8% slower at B = 1 on the H100.)
//   * wide panels (B >= 32; 128 for two_hop): pass 0 reads x once and writes
//     one byte per (source, 128-column tile): does the tile hold a value
//     other than +-0 (NaN counts as non-zero)? The walk then gathers each
//     edge's flag, an L2-resident byte, and loads the x row only where the
//     flag is set: kInFlight rows at once, lanes on adjacent columns with
//     16-byte loads where B % 4 == 0 and x, out and scratch are 16-byte
//     aligned. Every destination's out row is written, zeros included.
//
// Summation. No atomics, and a fixed order: a destination's edges in edge
// order (narrow: per 32-edge window a fixed scan tree, windows in order;
// wide: one add per flagged row, from 0, in edge order), the chunk sums
// of a hub of several chunks added by pass 2 in a fixed strided-then-tree
// order. So results are deterministic. A hub of one chunk writes its sum p as its row, which is
// 0 + p bit for bit (p starts at +0, so it is never -0). A skipped row
// holds only +-0, and adding +-0 to a partial that starts at +0 changes no
// bit, so skipping never changes the result.
// The plain torch version (ref.py) sums per ELL row and then per
// destination: the two agree bitwise wherever the sums are exact (the 0/1
// and small-integer panels of the multi-hop path, with counts below 2**24),
// and on any panel whose non-finite entries decide the sum (inf, NaN); for
// other float inputs they agree to float32 rounding of the order.
//
// Bound. Each input read once and each output written once: the compact
// layout E*4 + (n_dst + 1)*8 bytes, x (n_src*B*4) and out (n_dst*B*4), at
// 3.35 TB/s; one add per gathered element is far below the fp32 rate.
// Skipping zero rows is what makes that bound reachable on the multi-hop
// panels, which are nearly all zero rows: the gather of every live edge's
// x row (E*B*4 bytes) is the limit only of a dense panel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;            // groups per block
constexpr int kCols = 4;                     // columns per lane, wide path
constexpr int kTile = kWarp * kCols;         // columns per warp and per flag
constexpr int kInFlight = 4;                 // x rows gathered before adding
constexpr int kFlagRows = 4;                 // rows per warp in pass 0
constexpr int kReduceThreads = 1024;         // pass 2 block

struct Walk {
  const int32_t* col;       // (E,)
  const int64_t* edge_ptr;  // (n_dst + 1,)
  const int64_t* chunks;    // (n_chunks, 2): [edge begin, edge end)
  const int64_t* chunk_row; // (n_chunks,): scratch row or destination
  int64_t n_dst;
  int64_t n_groups;         // destination groups: ceil(n_dst / 32)
  int64_t n_chunks;
  int64_t n_scratch;        // chunks [0, n_scratch) write scratch
  int light_edges;
};

// Lane's item in warp w: its edge range, and the row it writes (a
// destination of `out`, or a chunk of `scratch`); count 0 and no write for
// lanes past n_dst, heavy destinations, and lanes 1..31 of a chunk warp.
// Warp w writes `scratch` iff it walks one of the first n_scratch chunks.
struct Item {
  int64_t begin;
  int64_t row;
  int count;
  bool write;
};

__device__ __forceinline__ Item lane_item(const Walk& p, int64_t w,
                                          int lane) {
  Item it{0, 0, 0, false};
  if (w < p.n_groups) {
    const int64_t d = w * kWarp + lane;
    if (d < p.n_dst) {
      const int64_t b = p.edge_ptr[d], e = p.edge_ptr[d + 1];
      if (e - b <= p.light_edges) it = Item{b, d, (int)(e - b), true};
    }
  } else if (lane == 0) {
    const int64_t c = w - p.n_groups;
    const int64_t b = p.chunks[2 * c];
    it = Item{b, p.chunk_row[c], (int)(p.chunks[2 * c + 1] - b), true};
  }
  return it;
}

__device__ __forceinline__ bool to_scratch(const Walk& p, int64_t w) {
  return w >= p.n_groups && w - p.n_groups < p.n_scratch;
}

// Exclusive prefix of v over the warp's lanes; *total gets the sum.
__device__ __forceinline__ int warp_exclusive_scan(int v, int lane,
                                                   int* total) {
  int inc = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int t = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += t;
  }
  *total = __shfl_sync(kAll, inc, kWarp - 1);
  return inc - v;
}

// The largest lane j with off_j <= t (off is non-decreasing, off_0 = 0):
// for t < total, the lane whose edge range holds position t.
__device__ __forceinline__ int owner_lane(int off, int t) {
  int j = 0;
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    if (__shfl_sync(kAll, off, j + s) <= t) j += s;
  }
  return j;
}

// Lane's kCols columns of a 128-column tile: adjacent (kVec, one 16-byte
// load) or strided by 32 (scalar).
template <bool kVec>
__device__ __forceinline__ int64_t lane_col(int tile, int lane, int c) {
  return kVec ? (int64_t)tile * kTile + lane * kCols + c
              : (int64_t)tile * kTile + lane + c * kWarp;
}

template <bool kVec>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int tile, int lane, int B,
                                          float v[kCols]) {
  if (kVec) {
    const int64_t j = lane_col<true>(tile, lane, 0);
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < B) q = *reinterpret_cast<const float4*>(row + j);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = lane_col<false>(tile, lane, c);
      v[c] = j < B ? row[j] : 0.f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int tile,
                                           int lane, int B,
                                           const float v[kCols]) {
  if (kVec) {
    const int64_t j = lane_col<true>(tile, lane, 0);
    if (j < B)
      *reinterpret_cast<float4*>(row + j) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = lane_col<false>(tile, lane, c);
      if (j < B) row[j] = v[c];
    }
  }
}

// B < 32: lanes on edges, a segmented scan per 32-edge window.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
expand_narrow(Walk p, const float* __restrict__ x, float* __restrict__ out,
              float* __restrict__ scratch, int B) {
  const int lane = threadIdx.x % kWarp;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w >= p.n_groups + p.n_chunks) return;  // uniform across the warp
  const Item it = lane_item(p, w, lane);
  int total;
  const int off = warp_exclusive_scan(it.count, lane, &total);
  const int64_t base = it.begin - off;  // edge of position t of lane's item
  float* dst = to_scratch(p, w) ? scratch : out;
  for (int j = 0; j < B; ++j) {
    float acc = 0.f;
    for (int t0 = 0; t0 < total; t0 += kWarp) {
      const int t = t0 + lane;
      const int o = owner_lane(off, t);
      const int64_t e = __shfl_sync(kAll, base, o) + t;
      float v = t < total ? x[(int64_t)p.col[e] * B + j] : 0.f;
      // inclusive scan within each owner's run of lanes
#pragma unroll
      for (int s = 1; s < kWarp; s <<= 1) {
        const float u = __shfl_up_sync(kAll, v, s);
        const int ou = __shfl_up_sync(kAll, o, s);
        if (lane >= s && ou == o) v += u;
      }
      // lane j takes the scan at its item's last position in this window
      const int last = min(off + it.count, t0 + kWarp) - 1 - t0;
      const float run = __shfl_sync(kAll, v, last & (kWarp - 1));
      if (it.count > 0 && off < t0 + kWarp && off + it.count > t0)
        acc += run;
    }
    if (it.write) dst[it.row * B + j] = acc;
  }
}

// Pass 0 (B >= 32): flags[s * n_tiles + tile] = 1 where x's 128-column tile
// of row s holds anything but +-0 (NaN included).
template <bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
nonzero_tiles(const float* __restrict__ x, uint8_t* __restrict__ flags,
              int64_t n_src, int B, int n_tiles) {
  const int lane = threadIdx.x % kWarp;
  const int tile = blockIdx.y;
  const int64_t r0 =
      ((int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) * kFlagRows;
  bool nz[kFlagRows];
#pragma unroll
  for (int i = 0; i < kFlagRows; ++i) {  // kFlagRows loads in flight
    float v[kCols] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + i < n_src) load_cols<kVec>(x + (r0 + i) * B, tile, lane, B, v);
    nz[i] = (v[0] != 0.f) | (v[1] != 0.f) | (v[2] != 0.f) | (v[3] != 0.f);
  }
#pragma unroll
  for (int i = 0; i < kFlagRows; ++i) {
    const unsigned any = __ballot_sync(kAll, nz[i]);
    if (lane == 0 && r0 + i < n_src) flags[(r0 + i) * n_tiles + tile] = any != 0;
  }
}

// B >= 32: lanes on edges to find the flagged ones, then lanes on columns
// to gather their rows, kInFlight at a time, summed per owner in edge order.
template <bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
expand_wide(Walk p, const float* __restrict__ x,
            const uint8_t* __restrict__ flags, float* __restrict__ out,
            float* __restrict__ scratch, int B, int n_tiles) {
  const int lane = threadIdx.x % kWarp;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w >= p.n_groups + p.n_chunks) return;  // uniform across the warp
  const int tile = blockIdx.y;
  const Item it = lane_item(p, w, lane);
  int total;
  const int off = warp_exclusive_scan(it.count, lane, &total);
  const int64_t base = it.begin - off;
  float* dst = to_scratch(p, w) ? scratch : out;
  const unsigned writes = __ballot_sync(kAll, it.write);
  unsigned touched = 0;  // owners whose row has been written
  int cur = -1;          // owner whose sum `acc` holds (warp-uniform)
  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < total; t0 += kWarp) {
    const int t = t0 + lane;
    const int o = owner_lane(off, t);
    const int64_t e = __shfl_sync(kAll, base, o) + t;
    int32_t s = 0;
    bool live = false;
    if (t < total) {
      s = p.col[e];
      live = flags[(int64_t)s * n_tiles + tile] != 0;
    }
    unsigned bits = __ballot_sync(kAll, live);
    while (bits) {  // flagged edges in edge order, kInFlight rows at once
      int64_t src[kInFlight];
      int own[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        own[u] = -1;
        src[u] = 0;
        if (bits) {
          const int kk = __ffs(bits) - 1;
          bits &= bits - 1;
          src[u] = __shfl_sync(kAll, s, kk);
          own[u] = __shfl_sync(kAll, o, kk);
        }
      }
      float r[kInFlight][kCols];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (own[u] >= 0) load_cols<kVec>(x + src[u] * B, tile, lane, B, r[u]);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (own[u] < 0) continue;
        if (own[u] != cur) {
          if (cur >= 0) {
            const int64_t row = __shfl_sync(kAll, it.row, cur);
            store_cols<kVec>(dst + row * B, tile, lane, B, acc);
            touched |= 1u << cur;
          }
          cur = own[u];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += r[u][c];
      }
    }
  }
  if (cur >= 0) {
    const int64_t row = __shfl_sync(kAll, it.row, cur);
    store_cols<kVec>(dst + row * B, tile, lane, B, acc);
    touched |= 1u << cur;
  }
  const float zero[kCols] = {0.f, 0.f, 0.f, 0.f};
  for (unsigned rest = writes & ~touched; rest; rest &= rest - 1) {
    const int64_t row = __shfl_sync(kAll, it.row, __ffs(rest) - 1);
    store_cols<kVec>(dst + row * B, tile, lane, B, zero);
  }
}

// Pass 2: one block per (hub of several chunks, tile of tc columns; tc a
// power of two, B's if B < 32, else 32). kReduceThreads / tc splits stride
// over the hub's scratch rows in order, then a fixed tree adds the splits.
__global__ void __launch_bounds__(kReduceThreads)
reduce_hubs(const int64_t* __restrict__ reduce_dst,
            const int64_t* __restrict__ reduce_ptr,
            const float* __restrict__ scratch, float* __restrict__ out,
            int B, int tc) {
  __shared__ float part[kReduceThreads];
  const int h = blockIdx.x;
  const int cl = threadIdx.x % tc, split = threadIdx.x / tc;
  const int splits = kReduceThreads / tc;
  const int64_t j = (int64_t)blockIdx.y * tc + cl;
  const int64_t c1 = reduce_ptr[h + 1];
  float acc = 0.f;
  if (j < B) {
#pragma unroll 4
    for (int64_t c = reduce_ptr[h] + split; c < c1; c += splits)
      acc += scratch[c * B + j];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int half = splits / 2; half > 0; half /= 2) {
    if (split < half) part[threadIdx.x] += part[threadIdx.x + half * tc];
    __syncthreads();
  }
  if (split == 0 && j < B) out[reduce_dst[h] * B + j] = part[cl];
}

}  // namespace

extern "C" {

// Launches pass 0 (B >= 32), pass 1 and pass 2 (when a hub has several
// chunks) on `stream` (the caller's current torch stream) and returns
// cudaGetLastError() as an int: 0 when the launches were accepted. `flags`
// holds n_src * ceil(B / 128) bytes when B >= 32 and is unused otherwise;
// `scratch` holds n_scratch rows of B.
int frontier_expand_launch(const void* col, const void* edge_ptr,
                           const void* chunks, const void* chunk_row,
                           const void* reduce_dst, const void* reduce_ptr,
                           const void* x, void* out, void* scratch,
                           void* flags, long long n_src, long long n_dst,
                           long long n_chunks, long long n_scratch,
                           long long n_reduce, int light_edges, int B,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_dst <= 0 || B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_groups = (n_dst + kWarp - 1) / kWarp;
  Walk p{(const int32_t*)col, (const int64_t*)edge_ptr,
         (const int64_t*)chunks, (const int64_t*)chunk_row, n_dst, n_groups,
         n_chunks, n_scratch, light_edges};
  const float* xp = (const float*)x;
  float* o = (float*)out;
  float* s = (float*)scratch;
  const long long warps = n_groups + n_chunks;
  const dim3 block(kWarp * kWarpsPerBlock);
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1)
                                     / kWarpsPerBlock);
  if (B < kWarp) {
    expand_narrow<<<blocks, block, 0, st>>>(p, xp, o, s, B);
  } else {
    const int n_tiles = (B + kTile - 1) / kTile;
    if (n_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
    const bool vec = B % 4 == 0
        && (((uintptr_t)x | (uintptr_t)out | (uintptr_t)scratch) % 16) == 0;
    uint8_t* f = (uint8_t*)flags;
    const long long rows_per_block = (long long)kWarpsPerBlock * kFlagRows;
    const dim3 fgrid((unsigned)((n_src + rows_per_block - 1) / rows_per_block),
                     n_tiles);
    const dim3 grid(blocks, n_tiles);
    if (n_src > 0) {
      if (vec)
        nonzero_tiles<true><<<fgrid, block, 0, st>>>(xp, f, n_src, B, n_tiles);
      else
        nonzero_tiles<false><<<fgrid, block, 0, st>>>(xp, f, n_src, B,
                                                      n_tiles);
    }
    if (vec)
      expand_wide<true><<<grid, block, 0, st>>>(p, xp, f, o, s, B, n_tiles);
    else
      expand_wide<false><<<grid, block, 0, st>>>(p, xp, f, o, s, B, n_tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_reduce == 0) return (int)err;
  int tc = 1;
  while (tc < B && tc < kWarp) tc *= 2;
  const dim3 grid((unsigned)n_reduce, (unsigned)((B + tc - 1) / tc));
  reduce_hubs<<<grid, kReduceThreads, 0, st>>>(
      (const int64_t*)reduce_dst, (const int64_t*)reduce_ptr, s, o, B, tc);
  return (int)cudaGetLastError();
}

const char* frontier_expand_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
