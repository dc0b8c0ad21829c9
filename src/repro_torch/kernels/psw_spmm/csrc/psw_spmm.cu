// PSW sparse A @ X as a row gather over a destination CSR, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/psw_spmm/psw_spmm.py::psw_spmm_pallas
// (wrapper src/repro/kernels/psw_spmm/ops.py::psw_spmm):
//
//   out[r, f] = sum over entries e of row r:  val[e] * x[col[e], f]
//
// row_ptr (n_rows + 1) int64, col (nnz) int32, val (nnz) float32: the
// adjacency as a destination CSR, each row's entries sorted by source, val
// the edge multiplicities the dense tiles held (ops.py::prepare_rows builds
// it from edges on the device, ops.py::compact_tiles from tiles). x (n_src,
// F) float32 -> out (n_rows, F) float32, neither padded.
//
// The Pallas kernel multiplies dense 128 x 128 adjacency tiles against x,
// which the MXU does for free. On the card the tiles of a social graph are
// 0.03% dense (the live tree of chip_smoke.py phase 6: 349,075 nonzeros in
// 63,953 tiles, 4.19 GB), so a tile kernel's floor is reading zeros. This
// kernel reads only the nonzeros.
//
// Bound: bytes. The function needs the CSR, x and out moved once (36.6 MB
// at the live tree's F = 128, 0.011 ms at 3.35 TB/s) and 2 * nnz * F
// operations (0.09 GFLOP, far less). The gathers move nnz * F * 4 bytes
// (179 MB at F = 128), but x (16.8 MB) stays in the 50 MB L2. Design:
//   * one warp per row, lanes on feature columns: 4 adjacent columns a lane
//     as one float4 load when F % 4 == 0 (and the pointers are 16-byte
//     aligned), else 4 columns 32 apart; a warp covers 128 columns, the
//     grid's y dimension the rest. The warp loads 32 entries' (col, val)
//     with one coalesced load, broadcasts them with __shfl_sync, and issues
//     4 entries' x loads before it adds any, so they are in flight
//     together. At most 64 registers a thread, so 32 warps an SM hide the
//     gathers' latency (8 loads in flight cost more in warps than they
//     gain: scripts/psw_spmm_variants.py times these constants);
//   * the reference's summation shape: the entries of one source block
//     (col / block) are summed on their own, fma from zero in source order,
//     and each such partial is added to the row's running total. For finite
//     x that is the tile kernel's sequence of operations with the zero
//     terms left out. One running sum over all of a hub's entries instead
//     missed a float64 oracle by 0.0236 at a destination with ~126k
//     in-edges, against 9.1e-4 this way (chip_smoke.py phase 6 on an H100);
//   * load balance: a row with more than `max_row` entries (a power-law
//     hub: the live tree's has 32,768 distinct sources) is cut at source
//     block boundaries into chunks (ops.py's plan). Pass 1 sums every chunk
//     into scratch (n_chunks, F), launched first, and every other row
//     straight into out; pass 2 adds each hub's chunk totals in chunk
//     order, one column a lane so that 64 loads are in flight, launched
//     behind pass 1 (programmatic dependent launch). One warp on a
//     12,204-row destination once cost frontier_expand 242 ms;
//   * no atomics and a fixed order, so repeat runs are bitwise equal; a row
//     without entries is written as zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCols = 4;                  // columns per lane
constexpr int kSlab = kWarp * kCols;      // columns per warp
constexpr int kWarpsPerBlock = 4;   // a block retires with its slowest warp
constexpr int kMinBlocks = 8;       // per SM: 64 registers a thread at most
constexpr int kUnroll = 4;                // x loads in flight per lane
constexpr int kRowsPerWarp = 2;           // rows a pass-1 warp walks
constexpr int kHubLoads = 64;             // pass 2's loads in flight
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const int64_t* row_ptr;   // (n_rows + 1)
  const int32_t* col;       // (nnz)
  const float* val;         // (nnz)
  const int64_t* hub_rows;  // (n_hubs)
  const int64_t* hub_ptr;   // (n_hubs + 1): hub h's chunks
  const int64_t* chunks;    // (n_chunks, 2): [entry begin, entry end)
  const float* x;           // (n_src, F)
  float* out;               // (n_rows, F)
  float* scratch;           // (n_chunks, F)
  int64_t n_rows, n_chunks, n_hubs, F;
  int block, max_row;
};

// The lane's 4 columns of row `r` (row stride F) at slab f0, zeros beyond F.
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ r,
                                          int64_t f0, int lane, int64_t F,
                                          float v[kCols]) {
  if (VEC) {
    const int64_t f = f0 + lane * kCols;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < F) t = __ldg(reinterpret_cast<const float4*>(r + f));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t f = f0 + lane + kWarp * j;
      v[j] = f < F ? __ldg(r + f) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ r, int64_t f0,
                                           int lane, int64_t F,
                                           const float v[kCols]) {
  if (VEC) {
    const int64_t f = f0 + lane * kCols;
    if (f < F)
      *reinterpret_cast<float4*>(r + f) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t f = f0 + lane + kWarp * j;
      if (f < F) r[f] = v[j];
    }
  }
}

// tot <- the sum of entries [lo, hi) at the lane's columns: one partial per
// run of entries from one source block, added to tot as the run ends.
template <bool VEC>
__device__ __forceinline__ void sum_entries(const Rows& p, int64_t lo,
                                            int64_t hi, int64_t f0, int lane,
                                            float tot[kCols]) {
  float part[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) tot[j] = part[j] = 0.f;
  int cur = -1;                           // the partial's source block
  for (int64_t b = lo; b < hi; b += kWarp) {
    const int n = (int)min((int64_t)kWarp, hi - b);
    int c = 0;
    float w = 0.f;
    if (lane < n) {
      c = p.col[b + lane];
      w = p.val[b + lane];
    }
    for (int k0 = 0; k0 < n; k0 += kUnroll) {
      float v[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cu = __shfl_sync(kFull, c, (k0 + u) & (kWarp - 1));
        if (k0 + u < n)
          load_cols<VEC>(p.x + (int64_t)cu * p.F, f0, lane, p.F, v[u]);
      }
      // the sources and weights again, rather than held in registers
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cu = __shfl_sync(kFull, c, (k0 + u) & (kWarp - 1));
        const float wu = __shfl_sync(kFull, w, (k0 + u) & (kWarp - 1));
        if (k0 + u < n) {
          const int blk = cu / p.block;
          if (blk != cur) {
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              tot[j] += part[j];
              part[j] = 0.f;
            }
            cur = blk;
          }
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            part[j] = fmaf(wu, v[u][j], part[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) tot[j] += part[j];
}

// Pass 1: warp u < n_chunks sums chunk u into scratch (the long work comes
// first); warp n_chunks + i sums rows [i kRowsPerWarp, (i + 1)
// kRowsPerWarp) (hubs are left to pass 2): fewer blocks to launch, while
// one wave of blocks walking all rows balanced the power-law rows worse.
template <bool VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
rows_kernel(Rows p) {
  // pass 2 may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x % kWarp;
  const int64_t u =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t f0 = (int64_t)blockIdx.y * kSlab;
  float tot[kCols];
  if (u < p.n_chunks) {
    sum_entries<VEC>(p, p.chunks[2 * u], p.chunks[2 * u + 1], f0, lane, tot);
    store_cols<VEC>(p.scratch + u * p.F, f0, lane, p.F, tot);
    return;
  }
  const int64_t r0 = (u - p.n_chunks) * kRowsPerWarp;
  const int64_t r1 = min(r0 + kRowsPerWarp, p.n_rows);
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t lo = p.row_ptr[r], hi = p.row_ptr[r + 1];
    if (hi - lo > p.max_row) continue;    // a hub: written by pass 2
    sum_entries<VEC>(p, lo, hi, f0, lane, tot);
    store_cols<VEC>(p.out + r * p.F, f0, lane, p.F, tot);
  }
}

// Pass 2: warp (h, 32-column slab) adds hub h's chunk totals in chunk
// order, one column a lane, so kHubLoads loads are in flight at a few
// registers each (the live tree's largest hub has ~256 chunks).
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
hubs_kernel(Rows p) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // pass 1 is done
  const int lane = threadIdx.x % kWarp;
  const int64_t h =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t f = (int64_t)blockIdx.y * kWarp + lane;
  if (h >= p.n_hubs || f >= p.F) return;
  float tot = 0.f;
  const int64_t end = p.hub_ptr[h + 1];
  for (int64_t c0 = p.hub_ptr[h]; c0 < end; c0 += kHubLoads) {
    float v[kHubLoads];
#pragma unroll
    for (int u = 0; u < kHubLoads; ++u)
      v[u] = c0 + u < end ? __ldg(p.scratch + (c0 + u) * p.F + f) : 0.f;
#pragma unroll
    for (int u = 0; u < kHubLoads; ++u)
      if (c0 + u < end) tot += v[u];
  }
  p.out[p.hub_rows[h] * p.F + f] = tot;
}

template <bool VEC>
cudaError_t launch(const Rows& p, cudaStream_t stream) {
  const long long slabs = (p.F + kSlab - 1) / kSlab;
  const long long units =
      p.n_chunks + (p.n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
  dim3 grid1((unsigned)((units + kWarpsPerBlock - 1) / kWarpsPerBlock),
             (unsigned)slabs);
  rows_kernel<VEC><<<grid1, kWarp * kWarpsPerBlock, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_hubs == 0) return err;
  // launched behind pass 1 (programmatic dependent launch), so its launch
  // latency hides under pass 1's tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.n_hubs + kWarpsPerBlock - 1) /
                                kWarpsPerBlock),
                     (unsigned)((p.F + kWarp - 1) / kWarp));
  cfg.blockDim = dim3(kWarp * kWarpsPerBlock);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, hubs_kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both passes on `stream` (the caller's current torch stream) and
// returns cudaGetLastError() as an int: 0 when the launches were accepted.
int psw_spmm_launch(const void* row_ptr, const void* col, const void* val,
                    const void* hub_rows, const void* hub_ptr,
                    const void* chunks, const void* x, void* out,
                    void* scratch, long long n_rows, long long n_chunks,
                    long long n_hubs, long long n_cols, int block,
                    int max_row, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (block <= 0 || max_row <= 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0 || n_cols <= 0) return 0;
  const long long slabs = (n_cols + kWarp - 1) / kWarp;   // pass 2's
  const long long blocks =
      (n_chunks + (n_rows + kRowsPerWarp - 1) / kRowsPerWarp +
       kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (slabs > 65535 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Rows p{(const int64_t*)row_ptr, (const int32_t*)col, (const float*)val,
         (const int64_t*)hub_rows, (const int64_t*)hub_ptr,
         (const int64_t*)chunks, (const float*)x, (float*)out,
         (float*)scratch, n_rows, n_chunks, n_hubs, n_cols, block, max_row};
  const bool vec = n_cols % kCols == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && (uintptr_t)scratch % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec ? launch<true>(p, st) : launch<false>(p, st));
}

const char* psw_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
