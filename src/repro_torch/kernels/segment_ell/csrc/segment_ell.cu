// ELL neighbour gather-reduce, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_ell/segment_ell.py::segment_ell_pallas
// (wrapper src/repro/kernels/segment_ell/ops.py::segment_ell):
//
//   out[n, j] = sum over slots k = 0..K-1 with mask[n, k]:  x[idx[n, k], j]
//
// idx (N, K) int32, mask (N, K) bool, x (M, F) float32 -> out (N, F).
//
// Bound: gather bytes, not operations (one add per gathered element). The
// least the card could move is N*K*5 (idx + mask) + M*F*4 (x once) +
// N*F*4 (out) bytes at 3.35 TB/s; a row gather that misses L2 moves each
// kept edge's x row instead of x once, N*K*5 + kept*F*4 + N*F*4. Design
// against that bound, as simple as it can be:
//   * one warp per output row; lanes on adjacent columns, so each gathered
//     x row is one coalesced read (4 columns a lane, 128 a warp; grid.y
//     walks 128-column tiles);
//   * the warp loads 32 slots' idx and mask with one coalesced load each,
//     and __ballot_sync walks the live slots in increasing k, broadcasting
//     each source with __shfl_sync. A masked slot's x row is never loaded,
//     so its idx may hold anything (the Pallas body loads it and masks the
//     value with `where`);
//   * every column's sum runs in slot order k = 0..K-1, one float add per
//     live slot, no atomics: the result is deterministic and equals the
//     plain torch K-loop (ref.py) bitwise.
// All offsets are 64-bit: N*K and M*F pass 2**31 at full size.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCols = 4;                   // columns per lane
constexpr int kTile = kWarp * kCols;       // columns per warp
constexpr int kWarpsPerBlock = 8;          // output rows per block

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_ell_kernel(const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ x, float* __restrict__ out,
                   int64_t n_rows, int k_slots, int64_t n_cols) {
  const int lane = threadIdx.x % kWarp;
  const int64_t n =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (n >= n_rows) return;  // uniform across the warp
  const int64_t col0 = (int64_t)blockIdx.y * kTile + lane;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  const int64_t row = n * (int64_t)k_slots;
  for (int k0 = 0; k0 < k_slots; k0 += kWarp) {
    const int k = k0 + lane;
    int32_t s = 0;
    bool live = false;
    if (k < k_slots) {
      live = mask[row + k] != 0;
      if (live) s = idx[row + k];
    }
    unsigned bits = __ballot_sync(0xffffffffu, live);
    while (bits) {  // live slots in increasing slot order
      const int kk = __ffs(bits) - 1;
      bits &= bits - 1;
      const int64_t src = __shfl_sync(0xffffffffu, s, kk);
      const float* xr = x + src * n_cols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int64_t j = col0 + c * kWarp;
        if (j < n_cols) acc[c] += xr[j];
      }
    }
  }
  float* o = out + n * n_cols;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t j = col0 + c * kWarp;
    if (j < n_cols) o[j] = acc[c];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (the caller's current torch stream) and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
int segment_ell_launch(const void* idx, const void* mask, const void* x,
                       void* out, long long n_rows, int k_slots,
                       long long n_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || n_cols <= 0) return 0;
  const long long col_tiles = (n_cols + kTile - 1) / kTile;
  if (col_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)col_tiles);
  segment_ell_kernel<<<grid, kWarp * kWarpsPerBlock, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint8_t*)mask, (const float*)x,
      (float*)out, n_rows, k_slots, n_cols);
  return (int)cudaGetLastError();
}

const char* segment_ell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
