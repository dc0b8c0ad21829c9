// Frontier expansion over a virtual-row ELL plan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/frontier_expand/frontier_expand.py::frontier_expand_pallas
// together with its wrapper's sorted segment_sum over `row_dst`
// (src/repro/kernels/frontier_expand/ops.py::frontier_expand_counts):
//
//   out[d, j] = sum over rows r of d, slots k:  mask[r, k] * x[idx[r, k], j]
//
// The plan's rows are destination-sorted and `dst_ptr` (n_dst + 1, int64) is
// the CSR over them, so each destination owns a contiguous row range.
//
// Bound: the kernel is bound by gather bytes, not operations (one add per
// gathered element). Its gathers move
//     R*K*5 (idx int32 + mask byte) + E*B*4 (x rows) + n_dst*B*4 (out)
// bytes at 3.35 TB/s; when B*4 < 32 each gather still moves a 32-byte
// sector, so count E*32 instead of E*B*4 there. Design against that bound:
//   * wide panels (B >= 32): one warp per work item, lanes on adjacent
//     columns, so each gathered x row is one coalesced read; the warp loads
//     a row's 32 idx/mask slots with one coalesced load and broadcasts each
//     live source with __shfl_sync, skipping empty slots via __ballot_sync;
//   * narrow panels (B < 32, B = 1 for khop hops): one warp per work item,
//     lanes on slots, so a row's idx/mask are one coalesced load each and
//     the slots' gathers are in flight together; each column's row sum is a
//     shuffle tree, and lane j keeps column j's total. (One thread per
//     destination instead ran 2.6x slower at B = 1, with 32 scalar idx and
//     mask loads per row.)
//
// Load balance: in-degrees are power-law, and the hottest destination of a
// social graph holds ~1/40 of all rows. Walking it in one warp puts the
// whole kernel behind one warp's latency chain, so a destination with more
// than `split_rows` rows is "heavy": its rows are cut into chunks of at
// most `split_rows` rows. Pass 1 sums every light destination straight into
// `out` and every heavy chunk into `scratch` (n_chunks, B); pass 2 sums each
// heavy destination's chunk partials with one block. No atomics and a fixed
// order everywhere, so results are deterministic, and they equal the plain
// torch version bitwise whenever the sums are exact: the 0/1 indicator
// panels of the multi-hop path give integer counts below 2**24.
//
// Speed beyond this simple design (reuse of x rows through L2 or shared
// memory toward the read-once bound, persistent blocks) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWideCols = 4;                   // columns per lane
constexpr int kWideTile = kWarp * kWideCols;   // columns per warp
constexpr int kWarpsPerBlock = 8;              // work items per block
constexpr int kSplit = 32;                     // pass-2 chunk splits

struct Plan {
  const int32_t* idx;      // (R, K)
  const uint8_t* mask;     // (R, K)
  const int64_t* dst_ptr;  // (n_dst + 1)
  const int64_t* chunks;   // (n_chunks, 2): [row begin, row end)
  int64_t n_dst;
  int64_t n_chunks;
  int k_slots;
  int split_rows;
};

// Work item i < n_dst is destination i, written to out (skipped when heavy);
// item n_dst + c is heavy chunk c, written to scratch. Returns false for a
// skipped item.
__device__ __forceinline__ bool item_rows(const Plan& p, int64_t i,
                                          int64_t* r0, int64_t* r1) {
  if (i < p.n_dst) {
    *r0 = p.dst_ptr[i];
    *r1 = p.dst_ptr[i + 1];
    return *r1 - *r0 <= p.split_rows;
  }
  const int64_t c = i - p.n_dst;
  *r0 = p.chunks[2 * c];
  *r1 = p.chunks[2 * c + 1];
  return true;
}

// One warp per work item, lanes on slots: a row's idx/mask are one
// coalesced load each, every lane gathers its own slot, and the row's sum
// for column j is a fixed shuffle tree; lane j keeps column j's total.
__global__ void expand_narrow(Plan p, const float* __restrict__ x,
                              float* __restrict__ out,
                              float* __restrict__ scratch, int B) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= p.n_dst + p.n_chunks) return;  // uniform across the warp
  int64_t r0, r1;
  if (!item_rows(p, i, &r0, &r1)) return;  // uniform too
  float acc = 0.f;
  for (int64_t r = r0; r < r1; ++r) {
    for (int k0 = 0; k0 < p.k_slots; k0 += kWarp) {
      const int k = k0 + lane;
      int64_t s = 0;
      bool live = false;
      if (k < p.k_slots) {
        s = p.idx[r * p.k_slots + k];
        live = p.mask[r * p.k_slots + k] != 0;
      }
      for (int j = 0; j < B; ++j) {
        float v = live ? x[s * B + j] : 0.f;
#pragma unroll
        for (int o = kWarp / 2; o > 0; o /= 2)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == j) acc += v;
      }
    }
  }
  float* dst = i < p.n_dst ? out + i * B : scratch + (i - p.n_dst) * B;
  if (lane < B) dst[lane] = acc;
}

__global__ void expand_wide(Plan p, const float* __restrict__ x,
                            float* __restrict__ out,
                            float* __restrict__ scratch, int B) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= p.n_dst + p.n_chunks) return;  // uniform across the warp
  int64_t r0, r1;
  if (!item_rows(p, i, &r0, &r1)) return;  // uniform too
  const int col0 = blockIdx.y * kWideTile + lane;
  float acc[kWideCols];
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) acc[c] = 0.f;
  for (int64_t r = r0; r < r1; ++r) {
    float row[kWideCols];
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) row[c] = 0.f;
    for (int k0 = 0; k0 < p.k_slots; k0 += kWarp) {
      const int k = k0 + lane;
      int32_t s = 0;
      bool live = false;
      if (k < p.k_slots) {
        s = p.idx[r * p.k_slots + k];
        live = p.mask[r * p.k_slots + k] != 0;
      }
      unsigned bits = __ballot_sync(0xffffffffu, live);
      while (bits) {  // live slots in increasing slot order
        const int kk = __ffs(bits) - 1;
        bits &= bits - 1;
        const int64_t src = __shfl_sync(0xffffffffu, s, kk);
        const float* xr = x + src * B;
#pragma unroll
        for (int c = 0; c < kWideCols; ++c) {
          const int j = col0 + c * kWarp;
          if (j < B) row[c] += xr[j];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) acc[c] += row[c];
  }
  float* dst = i < p.n_dst ? out + i * B : scratch + (i - p.n_dst) * B;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) {
    const int j = col0 + c * kWarp;
    if (j < B) dst[j] = acc[c];
  }
}

// One block per (heavy destination, 32-column tile): kSplit rows of threads
// stride over the destination's chunks, then thread column j adds the
// kSplit partials in split order.
__global__ void reduce_heavy(const int64_t* __restrict__ heavy_dst,
                             const int64_t* __restrict__ heavy_ptr,
                             const float* __restrict__ scratch,
                             float* __restrict__ out, int B) {
  __shared__ float part[kSplit][kWarp + 1];
  const int h = blockIdx.x;
  const int j = blockIdx.y * kWarp + threadIdx.x;
  const int64_t c1 = heavy_ptr[h + 1];
  float acc = 0.f;
  if (j < B) {
    for (int64_t c = heavy_ptr[h] + threadIdx.y; c < c1; c += kSplit) {
      acc += scratch[c * B + j];
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < B) {
    float total = 0.f;
    for (int s = 0; s < kSplit; ++s) total += part[s][threadIdx.x];
    out[heavy_dst[h] * B + j] = total;
  }
}

}  // namespace

extern "C" {

// Launches both passes on `stream` (the caller's current torch stream) and
// returns cudaGetLastError() as an int: 0 when the launches were accepted.
int frontier_expand_launch(const void* idx, const void* mask,
                           const void* dst_ptr, const void* chunks,
                           const void* heavy_dst, const void* heavy_ptr,
                           const void* x, void* out, void* scratch,
                           long long n_dst, long long n_chunks,
                           long long n_heavy, int k_slots, int split_rows,
                           int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_dst <= 0 || B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  Plan p{(const int32_t*)idx, (const uint8_t*)mask, (const int64_t*)dst_ptr,
         (const int64_t*)chunks, n_dst, n_chunks, k_slots, split_rows};
  const float* xp = (const float*)x;
  float* o = (float*)out;
  float* s = (float*)scratch;
  const long long items = n_dst + n_chunks;
  if (B < kWarp) {
    dim3 grid((unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock));
    expand_narrow<<<grid, kWarpsPerBlock * kWarp, 0, st>>>(p, xp, o, s, B);
  } else {
    dim3 grid((unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock),
              (unsigned)((B + kWideTile - 1) / kWideTile));
    expand_wide<<<grid, kWarpsPerBlock * kWarp, 0, st>>>(p, xp, o, s, B);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_heavy == 0) return (int)err;
  dim3 grid((unsigned)n_heavy, (unsigned)((B + kWarp - 1) / kWarp));
  dim3 block(kWarp, kSplit);
  reduce_heavy<<<grid, block, 0, st>>>((const int64_t*)heavy_dst,
                                       (const int64_t*)heavy_ptr, s, o, B);
  return (int)cudaGetLastError();
}

const char* frontier_expand_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
