// Weighted embedding bags (pooled lookups), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas
// (wrapper src/repro/kernels/embedding_bag/ops.py::embedding_bag):
//
//   out[b, j] = sum over slots k = 0..K-1:  w[b, k] * table[idx[b, k], j]
//
// idx (B, K) int32, w (B, K) float32, table (V, D) float32 -> out (B, D)
// float32 (bert4rec's item table is float32). Every slot is read and
// multiplied, weight 0 included, as the Pallas kernel does (a padded slot
// holds row 0 and weight 0). The mean division is the wrapper's.
//
// Bound: gather bytes, not operations (one multiply and one add per
// gathered element). The least the card could move is the distinct rows
// the bags name, once, plus idx, w and out; a row gather that misses L2
// moves B*K*D*4. Design, as simple as it can be:
//   * one warp per bag; lanes on adjacent columns, so a gathered row is one
//     coalesced read (4 columns a lane, 128 a warp; grid.y walks 128-column
//     tiles);
//   * the warp loads 32 slots' idx and w with one coalesced load each and
//     broadcasts each slot with __shfl_sync, walking the slots in k order;
//   * each column's sum is acc = acc + w * row in slot order with
//     __fmul_rn / __fadd_rn, so nvcc fuses nothing into an FMA and the
//     result equals the plain torch K-loop (ref.py) bitwise.
// Row offsets are 64-bit: V * D passes 2**31 at a few million rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCols = 4;                   // columns per lane
constexpr int kTile = kWarp * kCols;       // columns per warp
constexpr int kWarpsPerBlock = 8;          // bags per block

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
embedding_bag_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ w,
                     const float* __restrict__ table, float* __restrict__ out,
                     int64_t n_bags, int k_slots, int64_t dim) {
  const int lane = threadIdx.x % kWarp;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (bag >= n_bags) return;  // uniform across the warp
  const int64_t col0 = (int64_t)blockIdx.y * kTile + lane;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  const int64_t row = bag * (int64_t)k_slots;
  for (int k0 = 0; k0 < k_slots; k0 += kWarp) {
    const int k = k0 + lane;
    int32_t r = 0;
    float wk = 0.f;
    if (k < k_slots) {
      r = idx[row + k];
      wk = w[row + k];
    }
    const int n = min(kWarp, k_slots - k0);
#pragma unroll 4
    for (int kk = 0; kk < n; ++kk) {  // slots in increasing k
      const int64_t src = __shfl_sync(0xffffffffu, r, kk);
      const float ws = __shfl_sync(0xffffffffu, wk, kk);
      const float* tr = table + src * dim;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int64_t j = col0 + c * kWarp;
        if (j < dim) acc[c] = __fadd_rn(acc[c], __fmul_rn(ws, tr[j]));
      }
    }
  }
  float* o = out + bag * dim;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t j = col0 + c * kWarp;
    if (j < dim) o[j] = acc[c];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (the caller's current torch stream) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
int embedding_bag_launch(const void* idx, const void* w, const void* table,
                         void* out, long long n_bags, int k_slots,
                         long long dim, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_bags <= 0 || dim <= 0) return 0;
  const long long col_tiles = (dim + kTile - 1) / kTile;
  if (col_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)((n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)col_tiles);
  embedding_bag_kernel<<<grid, kWarp * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)w, (const float*)table, (float*)out,
      n_bags, k_slots, dim);
  return (int)cudaGetLastError();
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
