// The PSW sweep's gather and destination sum, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The reference sums a sweep's messages into their
// destinations with `jax.ops.segment_sum` (src/repro/core/psw.py,
// edge_centric_sweep_arrays), which XLA compiles for the TPU. Here one pass
// reads each edge's source value and adds it into its destination:
//
//   out[p, v, k] = float32( sum over e in [seg_ptr[p, v], seg_ptr[p, v + 1])
//                           of float64( table[p * stride_p + row(p, e) * d + k] ) )
//
// for each partition p of the (Pl, ...) arrays and column k < d, where
//   row(p, e) = e                                  kIdentity: messages (Pl, E, d)
//             = src[p, e]                          kIndex: vertex state (N, d)
//             = edge_owner[p, e] * W + edge_slot[p, e]
//                                                  kWindow: window buffer recv[p]
// The index is computed here from the int32 arrays; no per-edge index is
// built in device memory. Edges past seg_ptr[p, L] (padding) are never read.
//
// Work split: merge path (Merrill and Garland, "Merge-based parallel sparse
// matrix-vector multiplication", SC 2016). Partition p's L row ends
// (seg_ptr[p, 1:]) and its n_p = seg_ptr[p, L] edges form one merged list of
// L + n_p items; block b of the partition takes items [b * kTile, (b + 1) *
// kTile), so every block has the same work whatever the degrees: a hub of
// 10^5 in-edges is spread over many blocks, and a run of empty destinations
// costs one item each. `tile_coords` finds each block's (row, edge)
// coordinate by a binary search; the blocks run partition-major, so the slice
// of the window buffer one partition gathers from (P * W * 4 bytes, ~10 MB at
// soc-LiveJournal1's shape) stays in the 50 MB L2 while its edges are summed.
//
// Summation, in float64 and in an order fixed by edge positions alone (no
// atomics): a thread adds its kItems merge items in order; a row that spans
// threads adds the threads' partials in thread order, then the finishing
// thread's own; a row that spans blocks is finished by `fix_rows`, which adds
// the blocks' partials in block order. Each row's sum is rounded to float32
// once. So runs give identical bits, stores holding the same edges give
// identical bits, and a sweep over ranks gives each partition the one-device
// bits. The plain torch version (ref.py) adds the same float64 terms in edge
// order with index_add_: the two agree bitwise wherever the float64 sum of a
// row's float32 terms is exact (PageRank's, on the tests' stores), and
// otherwise to float64 rounding before the one cast.
//
// `window_send` is the window exchange: send[c, o, w] = x[o, send_idx[o, c,
// w]] for every consumer c and local owner o, written consumer-major, which
// is the window buffer itself on one device and the send buffer of the
// all_to_all over a process group. It reads the int32 send_idx directly.
//
// Bound, per sweep over E edges and n = Pl * L destinations (kWindow): the
// index arrays 8E bytes, seg_ptr 8n, the window buffer written and read once
// (4 * Pl * P * W each) with send_idx (4 * Pl * P * W), out 4n; the gathers
// hit L2. One float64 add an edge is far below the card's rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // sum_tiles block
constexpr int kItems = 8;                  // merge items a thread
constexpr int kTile = kThreads * kItems;   // merge items a block
constexpr int kFlat = 256;                 // tile_coords, fix_rows, window_send
constexpr int kMaxGridY = 65535;

enum Mode { kIdentity = 0, kIndex = 1, kWindow = 2 };

struct Sweep {
  const float* table;
  const int32_t* idx_a;     // src (kIndex) or edge_owner (kWindow), (Pl, E)
  const int32_t* idx_b;     // edge_slot (kWindow), (Pl, E)
  const int64_t* seg_ptr;   // (Pl, L + 1)
  float* out;               // (Pl, L, d)
  int64_t* coord_i;         // (Pl, n_tiles + 1): rows before block b's start
  int64_t* coord_j;         // (Pl, n_tiles + 1): edges before block b's start
  double* carry;            // (Pl, n_tiles, d): the row open at block b's end
  double* head;             // (Pl, n_tiles, d): block b's part of its first row
  int64_t L;
  int64_t E;
  int64_t stride_p;         // table elements between partitions
  int64_t width;            // W (kWindow)
  int64_t n_tiles;
  int d;
};

template <int kMode>
__device__ __forceinline__ int64_t edge_row(const Sweep& s, int64_t p,
                                            int64_t e) {
  if (kMode == kIdentity) return e;
  const int64_t pe = p * s.E + e;
  if (kMode == kIndex) return s.idx_a[pe];
  return (int64_t)s.idx_a[pe] * s.width + s.idx_b[pe];
}

// coord[p, b] = the merge-path coordinate of diagonal min(b * kTile, L + n_p):
// i rows finished and j edges taken, i + j = the diagonal.
__global__ void __launch_bounds__(kFlat)
tile_coords(Sweep s, int64_t Pl) {
  const int64_t per = s.n_tiles + 1;
  const int64_t t = (int64_t)blockIdx.x * kFlat + threadIdx.x;
  if (t >= Pl * per) return;
  const int64_t p = t / per, b = t % per;
  const int64_t* row_end = s.seg_ptr + p * (s.L + 1) + 1;
  const int64_t n = row_end[s.L - 1];
  const int64_t diag = min(b * kTile, s.L + n);
  int64_t lo = max(diag - n, (int64_t)0), hi = min(diag, s.L);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row_end[mid] <= diag - mid - 1) lo = mid + 1;
    else hi = mid;
  }
  s.coord_i[t] = lo;
  s.coord_j[t] = diag - lo;
}

// One block of kTile merge items: the rows it finishes are written to out,
// but a first row begun in an earlier block leaves its part in `head`, and
// the row still open at the block's end leaves its part in `carry`.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
sum_tiles(Sweep s) {
  __shared__ int s_row[kTile];       // the block's row ends, less j0
  __shared__ float s_val[kTile];     // its edges' values, one column
  __shared__ int s_end[kThreads];    // the row each thread ends in
  __shared__ double s_run[kThreads]; // that row's sum over the thread
  const int64_t p = blockIdx.y, b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t* ci = s.coord_i + p * (s.n_tiles + 1);
  const int64_t* cj = s.coord_j + p * (s.n_tiles + 1);
  const int64_t i0 = ci[b], j0 = cj[b];
  const int n_rows = (int)(ci[b + 1] - i0), n_nz = (int)(cj[b + 1] - j0);
  const int total = n_rows + n_nz;
  if (total == 0) return;  // past the partition's items: uniform
  const int64_t* sp = s.seg_ptr + p * (s.L + 1);
  for (int q = tid; q < n_rows; q += kThreads)
    s_row[q] = (int)(sp[i0 + q + 1] - j0);
  const bool row0_split = sp[i0] < j0;  // row i0 began in an earlier block
  __syncthreads();
  // this thread's items: the merge-path coordinate of its diagonal
  const int dt = min(tid * kItems, total);
  const int n_items = min(kItems, total - dt);
  int lo = max(dt - n_nz, 0), hi = min(dt, n_rows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_row[mid] <= dt - mid - 1) lo = mid + 1;
    else hi = mid;
  }
  const int it0 = lo, jt0 = dt - lo;
  float* out = s.out + (p * s.L + i0) * s.d;
  const int64_t part = (p * s.n_tiles + b) * s.d;
  for (int k = 0; k < s.d; ++k) {
    {  // gather column k of the block's edges, kItems loads in flight
      int64_t row[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int q = tid + u * kThreads;
        row[u] = q < n_nz ? edge_row<kMode>(s, p, j0 + q) : 0;
      }
      const float* tab = s.table + p * s.stride_p + k;
      float v[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        v[u] = tid + u * kThreads < n_nz ? tab[row[u] * s.d] : 0.f;
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int q = tid + u * kThreads;
        if (q < n_nz) s_val[q] = v[u];
      }
    }
    __syncthreads();
    int it = it0, jt = jt0;
    int first = -1;          // the first row this thread finishes
    double first_run = 0.0;  // its sum over this thread
    double run = 0.0;
    for (int u = 0; u < n_items; ++u) {
      if (it < n_rows && (jt >= n_nz || s_row[it] <= jt)) {
        if (first < 0) {
          first = it;
          first_run = run;
        } else {
          out[(int64_t)it * s.d + k] = (float)run;
        }
        run = 0.0;
        ++it;
      } else {
        run += (double)s_val[jt];
        ++jt;
      }
    }
    s_end[tid] = it;
    s_run[tid] = run;
    __syncthreads();
    if (first >= 0) {  // add the earlier threads' parts, in thread order
      int q = tid;
      while (q > 0 && s_end[q - 1] == first) --q;
      double sum = first_run;
      if (q < tid) {
        sum = s_run[q];
        for (int r = q + 1; r < tid; ++r) sum += s_run[r];
        sum += first_run;
      }
      if (first == 0 && row0_split) s.head[part + k] = sum;
      else out[(int64_t)first * s.d + k] = (float)sum;
    }
    if (tid == kThreads - 1) {  // the row open at the block's end
      int q = kThreads - 1;     // (every idle thread ends in it too)
      while (q > 0 && s_end[q - 1] == n_rows) --q;
      double sum = s_run[q];
      for (int r = q + 1; r < kThreads; ++r) sum += s_run[r];
      s.carry[part + k] = sum;
    }
    __syncthreads();
  }
}

// A row that began in an earlier block than the one finishing it: the
// carries of the blocks it spans, in block order, then the finishing
// block's head, rounded once.
__global__ void __launch_bounds__(kFlat)
fix_rows(Sweep s, int64_t Pl) {
  const int64_t t = (int64_t)blockIdx.x * kFlat + threadIdx.x;
  if (t >= Pl * s.n_tiles) return;
  const int64_t p = t / s.n_tiles, b = t % s.n_tiles;
  const int64_t* ci = s.coord_i + p * (s.n_tiles + 1);
  const int64_t i0 = ci[b];
  if (b == 0 || ci[b + 1] == i0) return;  // finishes no row
  if (s.seg_ptr[p * (s.L + 1) + i0] >= s.coord_j[p * (s.n_tiles + 1) + b])
    return;  // its first row began in it: written by sum_tiles
  int64_t q = b - 1;  // the first block the row is open in
  while (q > 0 && ci[q] == i0) --q;
  const double* carry = s.carry + p * s.n_tiles * s.d;
  for (int k = 0; k < s.d; ++k) {
    double sum = carry[q * s.d + k];
    for (int64_t r = q + 1; r < b; ++r) sum += carry[r * s.d + k];
    sum += s.head[(p * s.n_tiles + b) * s.d + k];
    s.out[(p * s.L + i0) * s.d + k] = (float)sum;
  }
}

// send[c, o, w, :] = x[o, send_idx[o, c, w], :]: blockIdx.y (strided) walks
// the (consumer, owner) pairs, threads the window's slots.
__global__ void __launch_bounds__(kFlat)
window_send(const float* __restrict__ x, const int32_t* __restrict__ send_idx,
            float* __restrict__ send, int64_t P, int64_t Pl, int64_t L,
            int64_t W, int d) {
  const int64_t w = (int64_t)blockIdx.x * kFlat + threadIdx.x;
  if (w >= W) return;
  for (int64_t co = blockIdx.y; co < P * Pl; co += gridDim.y) {
    const int64_t c = co / Pl, o = co % Pl;
    const int64_t row = send_idx[(o * P + c) * W + w];
    const float* src = x + (o * L + row) * d;
    float* dst = send + (co * W + w) * d;
    for (int k = 0; k < d; ++k) dst[k] = src[k];
  }
}

}  // namespace

extern "C" {

// The window exchange's send buffer (P, Pl, W, d) from x (Pl, L, d) and
// send_idx (Pl, P, W), on `stream`; returns cudaGetLastError() as an int.
int psw_sweep_exchange_launch(const void* x, const void* send_idx,
                              void* send, long long P, long long Pl,
                              long long L, long long W, int d, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P <= 0 || Pl <= 0 || W <= 0 || d <= 0) return 0;
  const long long pairs = P * Pl;
  const dim3 grid((unsigned)((W + kFlat - 1) / kFlat),
                  (unsigned)(pairs < kMaxGridY ? pairs : kMaxGridY));
  window_send<<<grid, kFlat, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)send_idx, (float*)send, P, Pl, L, W, d);
  return (int)cudaGetLastError();
}

// out (Pl, L, d) <- the segment sums of `mode`'s rows of `table` over
// seg_ptr (Pl, L + 1), on `stream`. `coords` holds 2 * Pl * (n_tiles + 1)
// int64 and `partials` 2 * Pl * n_tiles * d float64, n_tiles = ceil((L + E)
// / kTile). Launches tile_coords, sum_tiles and fix_rows; returns
// cudaGetLastError() as an int: 0 when the launches were accepted.
int psw_sweep_sum_launch(int mode, const void* table, const void* idx_a,
                         const void* idx_b, const void* seg_ptr, void* out,
                         void* coords, void* partials, long long Pl,
                         long long L, long long E, long long stride_p,
                         long long width, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Pl <= 0 || L <= 0 || d <= 0) return 0;
  if (Pl > kMaxGridY) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_tiles = (L + E + kTile - 1) / kTile;
  int64_t* ci = (int64_t*)coords;
  double* carry = (double*)partials;
  Sweep s{(const float*)table, (const int32_t*)idx_a, (const int32_t*)idx_b,
          (const int64_t*)seg_ptr, (float*)out, ci, ci + Pl * (n_tiles + 1),
          carry, carry + Pl * n_tiles * d, L, E, stride_p, width, n_tiles,
          d};
  tile_coords<<<(unsigned)((Pl * (n_tiles + 1) + kFlat - 1) / kFlat), kFlat,
                0, st>>>(s, Pl);
  const dim3 grid((unsigned)n_tiles, (unsigned)Pl);
  if (mode == kIdentity) sum_tiles<kIdentity><<<grid, kThreads, 0, st>>>(s);
  else if (mode == kIndex) sum_tiles<kIndex><<<grid, kThreads, 0, st>>>(s);
  else if (mode == kWindow) sum_tiles<kWindow><<<grid, kThreads, 0, st>>>(s);
  else return (int)cudaErrorInvalidValue;
  fix_rows<<<(unsigned)((Pl * n_tiles + kFlat - 1) / kFlat), kFlat, 0, st>>>(
      s, Pl);
  return (int)cudaGetLastError();
}

const char* psw_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
