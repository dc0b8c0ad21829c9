// PSW block-sparse SpMM (A @ X over dense adjacency tiles), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/psw_spmm/psw_spmm.py::psw_spmm_pallas
// (wrapper src/repro/kernels/psw_spmm/ops.py::psw_spmm):
//
//   out[db*128 + i, f] = sum over tiles t of dst block db, k = 0..127:
//                        tiles[t, i, k] * x[coords[t, 1]*128 + k, f]
//
// coords (T, 2) int32 (dst block, src block), sorted by dst block; tiles
// (T, 128, 128) float32; x (n_src_blocks*128, F) float32 -> out
// (n_dst_blocks*128, F).
//
// The Pallas kernel runs a sequential grid over the active tiles and lets
// consecutive tiles of one dst block accumulate in the same VMEM output
// block, zeroing it on the first visit. GPU blocks run in no order, so
// here one CTA owns one (dst block, 128-column block) of the output: it
// walks its tiles through `tile_ptr` (the CSR over the dst-sorted coords)
// and writes once. No atomics: the result is deterministic, and a dst block
// with no tiles is written as zeros. Like the Pallas kernel (`o_ref +=
// dot(tile, x)`), each tile's product is summed on its own, in registers,
// and then added to the block's running total, kept in shared memory. One
// running sum over all of a hub's tiles instead missed a float64 oracle by
// 0.0236 at a destination with ~126k in-edges, against 9.1e-4 this way
// (chip_smoke.py phase 6 on an H100).
//
// Bound: operations. Each active tile costs 2*128*128*F flops against
// 64 KiB of tile, so at F = 128 the kernel does 64 flops a tile byte, far
// above the 67 TFLOP/s / 3.35 TB/s = 20 of fp32 outside the tensor cores.
// It stays fp32 SIMT (no TF32: the reference's tests hold rtol 1e-5),
// blocked for register reuse:
//   * 256 threads, each an 8 x 8 block of the 128 x 128 output tile;
//   * the k dimension in slices of 32: the tile slice (stored k-major, row
//     stride padded to 132 floats) and the x slice go to shared memory, two
//     stages, so the next slice's global loads are in flight while the
//     current one is multiplied;
//   * per k, each thread reads 8 tile and 8 x values as float4s and does 64
//     FMAs, in k order; after a tile's last slice it adds its 64 sums to
//     its totals (thread-private, laid out so a warp's accesses hit 32
//     banks) and starts the next tile from zero;
//   * shared memory: 2 x 33,280 bytes of stages + 65,536 of totals, above
//     the 48 KiB default, so the launch opts in to more dynamic shared
//     memory.
// Tile offsets are 64-bit (T*128*128 passes 2**31 at 131k tiles).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;                       // tile side
constexpr int kF = 128;                       // output columns per CTA
constexpr int kKS = 32;                       // k-slice
constexpr int kAStride = kB + 4;              // k-major tile slice row
constexpr int kThreads = 256;
constexpr int kTM = 8;                        // rows per thread
constexpr int kTN = 8;                        // columns per thread
constexpr int kAFloats = kKS * kAStride;
constexpr int kXFloats = kKS * kF;
constexpr int kStageFloats = kAFloats + kXFloats;
constexpr int kTotFloats = kTM * kTN * kThreads;
constexpr int kSmemBytes =
    (2 * kStageFloats + kTotFloats) * (int)sizeof(float);
constexpr int kLoads = kKS * kB / kThreads;   // floats each thread stages

static_assert(kB / kTM * (kF / kTN) == kThreads, "thread layout");
static_assert(kLoads * kThreads == kKS * kB, "tile slice split");
static_assert(kLoads * kThreads == kKS * kF, "x slice split");

struct Slice {
  float a[kLoads];
  float x[kLoads];
};

// Step s of a CTA covers tile t0 + s / 4, k-slice (s % 4) * 32.
__device__ __forceinline__ void load_slice(
    Slice& r, const float* __restrict__ tiles, const int32_t* __restrict__ coords,
    const float* __restrict__ x, int64_t t, int k0, int64_t x_rows,
    int64_t n_cols, int64_t f0, int tid) {
  const float* tile = tiles + t * (int64_t)(kB * kB);
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int lin = l * kThreads + tid;   // row-major over (128 rows, 32 k)
    const int row = lin / kKS, kk = lin % kKS;
    r.a[l] = tile[row * kB + k0 + kk];
  }
  const int64_t xrow0 = (int64_t)coords[2 * t + 1] * kB + k0;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int lin = l * kThreads + tid;   // row-major over (32 k, 128 cols)
    const int kk = lin / kF, c = lin % kF;
    const int64_t xr = xrow0 + kk, f = f0 + c;
    r.x[l] = (xr < x_rows && f < n_cols) ? x[xr * n_cols + f] : 0.f;
  }
}

__device__ __forceinline__ void store_slice(const Slice& r, float* stage,
                                            int tid) {
  float* as = stage;
  float* xs = stage + kAFloats;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int lin = l * kThreads + tid;
    as[(lin % kKS) * kAStride + lin / kKS] = r.a[l];
  }
#pragma unroll
  for (int l = 0; l < kLoads; ++l) xs[l * kThreads + tid] = r.x[l];
}

__global__ void __launch_bounds__(kThreads)
psw_spmm_kernel(const int64_t* __restrict__ tile_ptr,
                const int32_t* __restrict__ coords,
                const float* __restrict__ tiles, const float* __restrict__ x,
                float* __restrict__ out, int64_t x_rows, int64_t n_cols) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int ty = tid / (kF / kTN), tx = tid % (kF / kTN);
  const int64_t db = blockIdx.x;
  const int64_t f0 = (int64_t)blockIdx.y * kF;
  const int64_t t0 = tile_ptr[db];
  const int64_t steps = (tile_ptr[db + 1] - t0) * (kB / kKS);

  // thread tid's total for its output (i, j):
  // tot[(i * kTN + j) * kThreads + tid]
  float* tot = smem + 2 * kStageFloats;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc[i][j] = 0.f;
      tot[(i * kTN + j) * kThreads + tid] = 0.f;
    }

  Slice r;
  if (steps > 0) {
    load_slice(r, tiles, coords, x, t0, 0, x_rows, n_cols, f0, tid);
    store_slice(r, smem, tid);
  }
  __syncthreads();
  for (int64_t s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) {
      load_slice(r, tiles, coords, x, t0 + (s + 1) / (kB / kKS),
                 (int)((s + 1) % (kB / kKS)) * kKS, x_rows, n_cols, f0, tid);
    }
    const float* as = smem + (s & 1) * kStageFloats;
    const float* xs = as + kAFloats;
#pragma unroll 4
    for (int k = 0; k < kKS; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          as + k * kAStride + ty * kTM);
      const float4 a1 = *reinterpret_cast<const float4*>(
          as + k * kAStride + ty * kTM + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(
          xs + k * kF + tx * kTN);
      const float4 b1 = *reinterpret_cast<const float4*>(
          xs + k * kF + tx * kTN + 4);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if ((s + 1) % (kB / kKS) == 0) {  // the tile's last slice
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          tot[(i * kTN + j) * kThreads + tid] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    if (more) store_slice(r, smem + ((s + 1) & 1) * kStageFloats, tid);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* o = out + (db * kB + ty * kTM + i) * n_cols;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t f = f0 + tx * kTN + j;
      if (f < n_cols) o[f] = tot[(i * kTN + j) * kThreads + tid];
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (the caller's current torch stream) and
// returns cudaGetLastError() as an int: 0 when the launch was accepted.
int psw_spmm_launch(const void* tile_ptr, const void* coords,
                    const void* tiles, const void* x, void* out,
                    long long n_dst_blocks, long long x_rows,
                    long long n_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_dst_blocks <= 0 || n_cols <= 0) return 0;
  const long long col_blocks = (n_cols + kF - 1) / kF;
  if (col_blocks > 65535) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(psw_spmm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_dst_blocks, (unsigned)col_blocks);
  psw_spmm_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int64_t*)tile_ptr, (const int32_t*)coords, (const float*)tiles,
      (const float*)x, (float*)out, x_rows, n_cols);
  return (int)cudaGetLastError();
}

int psw_spmm_smem_bytes(void) { return kSmemBytes; }

const char* psw_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
