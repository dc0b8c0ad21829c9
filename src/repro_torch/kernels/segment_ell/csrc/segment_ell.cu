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
// Bound: bytes, not operations (one add per gathered element). Each input
// read once and each output written once is N*K*5 (idx + mask) + M*F*4 (x)
// + N*F*4 (out) bytes at 3.35 TB/s. A pull gather reaches that only when
// the x rows it gathers are reused from L2; with uniform sources over an x
// of M*F*4 bytes far beyond the 50 MB L2 (1.6 GB at M = 4M, F = 100) almost
// every kept slot's row comes from device memory, so the gather bound,
// N*K*5 + kept*F*4 + N*F*4 bytes, is what this design aims at. Device
// memory moves 64-byte pieces, so a kept row costs every piece it spans (a
// 400-byte row at F = 100 spans seven: 448 bytes); counted so, the kernel
// runs at 0.86-0.91 of that bound on the H100 (PERF.md). Design:
//   * lanes on columns, each lane on 4 columns: adjacent ones with one
//     16-byte load when F % 4 == 0 and x and out are 16-byte aligned (at
//     F = 100, 25 lanes and one load instruction a row), else 4 scalar
//     loads strided by the row group's width. A row group is `lanes` lanes,
//     the power of two that covers ceil(F / 4) (at most 32), so a warp sums
//     32 / lanes output rows at once where F is small; grid.y walks tiles
//     of 4 * lanes columns;
//   * a row group loads `lanes` slots' idx and mask per step, and
//     __ballot_sync picks its live slots in increasing k; the loads of up
//     to kInFlight live slots' x rows are issued before their adds, so
//     several rows are in flight per warp. A masked slot's x row is never
//     loaded and its idx never read, so it may hold anything (the Pallas
//     body loads it and masks the value with `where`);
//   * every column's sum runs in slot order k = 0..K-1, one float add per
//     live slot from 0, no atomics: the result is deterministic and equals
//     the plain torch K-loop (ref.py) bitwise (adding the plain version's
//     +0 for a masked slot to a partial that starts at +0 changes no bit).
// All offsets are 64-bit: N*K and M*F pass 2**31 at full size.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kCols = 4;             // columns per lane
constexpr int kWarpsPerBlock = 8;
constexpr int kInFlight = 4;         // x rows loaded before their adds
constexpr int kMinBlocks = 4;        // blocks per SM asked of ptxas

template <bool kVec>
__device__ __forceinline__ int64_t lane_col(int64_t tile0, int sub,
                                            int lanes, int c) {
  return kVec ? tile0 + sub * kCols + c : tile0 + sub + c * lanes;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
segment_ell_kernel(const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ x, float* __restrict__ out,
                   int64_t n_rows, int k_slots, int64_t n_cols, int lanes) {
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % lanes;      // lane within its row group
  const int grp = lane / lanes;      // row group within the warp
  const int64_t n =
      ((int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp)
          * (kWarp / lanes) + grp;
  const bool row_ok = n < n_rows;
  const unsigned own = lanes == kWarp ? kAll : (1u << lanes) - 1;
  const int64_t tile0 = (int64_t)blockIdx.y * kCols * lanes;
  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
  const int64_t row = n * (int64_t)k_slots;
  for (int k0 = 0; k0 < k_slots; k0 += lanes) {  // uniform across the warp
    const int k = k0 + sub;
    int32_t s = 0;
    bool live = false;
    if (row_ok && k < k_slots) {
      live = mask[row + k] != 0;
      if (live) s = idx[row + k];
    }
    // this group's live slots, lowest slot first
    unsigned bits = (__ballot_sync(kAll, live) >> (grp * lanes)) & own;
    while (__any_sync(kAll, bits != 0)) {
      int64_t src[kInFlight];
      bool got[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int kk = bits ? __ffs(bits) - 1 : 0;
        got[u] = bits != 0;
        bits &= bits - 1;
        src[u] = __shfl_sync(kAll, s, grp * lanes + kk);
      }
      float r[kInFlight][kCols];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const float* xr = x + src[u] * n_cols;
        if (kVec) {
          const int64_t j = lane_col<true>(tile0, sub, lanes, 0);
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (got[u] && j < n_cols) q = *reinterpret_cast<const float4*>(xr + j);
          r[u][0] = q.x, r[u][1] = q.y, r[u][2] = q.z, r[u][3] = q.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int64_t j = lane_col<false>(tile0, sub, lanes, c);
            r[u][c] = got[u] && j < n_cols ? xr[j] : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (got[u]) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] += r[u][c];
        }
      }
    }
  }
  if (!row_ok) return;
  float* o = out + n * n_cols;
  if (kVec) {
    const int64_t j = lane_col<true>(tile0, sub, lanes, 0);
    if (j < n_cols)
      *reinterpret_cast<float4*>(o + j) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = lane_col<false>(tile0, sub, lanes, c);
      if (j < n_cols) o[j] = acc[c];
    }
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
  int lanes = 1;
  while (lanes < kWarp && lanes * kCols < n_cols) lanes *= 2;
  const long long tile = (long long)kCols * lanes;
  const long long col_tiles = (n_cols + tile - 1) / tile;
  if (col_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const long long rows_per_block = (long long)kWarpsPerBlock * (kWarp / lanes);
  dim3 grid((unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
            (unsigned)col_tiles);
  const bool vec = n_cols % 4 == 0
      && (((uintptr_t)x | (uintptr_t)out) % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    segment_ell_kernel<true><<<grid, kWarp * kWarpsPerBlock, 0, st>>>(
        (const int32_t*)idx, (const uint8_t*)mask, (const float*)x,
        (float*)out, n_rows, k_slots, n_cols, lanes);
  else
    segment_ell_kernel<false><<<grid, kWarp * kWarpsPerBlock, 0, st>>>(
        (const int32_t*)idx, (const uint8_t*)mask, (const float*)x,
        (float*)out, n_rows, k_slots, n_cols, lanes);
  return (int)cudaGetLastError();
}

const char* segment_ell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
