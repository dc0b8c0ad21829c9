// Weighted embedding bags (pooled lookups), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas
// (wrapper src/repro/kernels/embedding_bag/ops.py::embedding_bag):
//
//   out[b, j] = sum over slots k = 0..K-1:  w[b, k] * table[idx[b, k], j]
//
// idx (B, K) int32 or int64, w (B, K) float32, table (V, D) float32 ->
// out (B, D) float32 (bert4rec's item table is float32). The mean division
// is the wrapper's. An id outside [0, V) is never read: its slot adds
// nothing and sets an error word (*err) to 1, which the wrapper reads
// after the launch.
//
// Bound: gather bytes, not operations (one multiply and one add per
// gathered element). The least the card could move is the distinct rows
// the bags name, once, plus idx, w and out. What the design does:
//   * one warp per bag and column tile; a lane holds VW adjacent columns
//     (VW = 2 or 1, picked by the launch from D and alignment so that
//     D = 64 is one 64-column tile of 8-byte loads: no idle lanes), so a
//     gathered row is one coalesced vector load per warp;
//   * the warp stages 32 slots' ids and weights with one coalesced load
//     each (the next group's loads issued before this group is walked),
//     decides from them alone which slots must be read, lists those in
//     slot order in shared memory (a lane's rank among them is its place),
//     and then issues up to kInFlight of the listed rows' loads, with no
//     branch between them, before the first add consumes them: many
//     gathers in flight per warp, not one;
//   * the adds stay in slot order: acc = acc + w * row with __fmul_rn /
//     __fadd_rn, so nvcc fuses nothing into an FMA and the result equals
//     the plain torch K-loop (ref.py) bitwise;
//   * a weight-0 slot that names the same row as the bag's previous
//     weight-0 slot is skipped, exactly. acc starts at +0.0 and, rounding
//     to nearest, a sum that starts at +0 never becomes -0, so the earlier
//     slot's acc + 0*v left every column with a finite v as it was and
//     made every column with an inf or NaN v a NaN, which no later add
//     undoes; the later slot, reading the same v, would change nothing.
//     Left-padded histories (item 0, weight 0) then read row 0 once a bag
//     instead of once a padded slot, and a padding row holding inf or NaN
//     still gives NaN, as the plain version and the reference do;
//   * blocks of kWarpsPerBlock warps, so that B = 512 spreads over the
//     132 SMs; few bags (B = 512 takes one wave of warps) get kDeep loads
//     in flight a warp, since no other warp hides a warp's wait, many bags
//     (16,384) kShallow, so that fewer registers keep more warps resident.
// Row offsets are 64-bit: V * D passes 2**31 at a few million rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;   // bags per block
constexpr int kDeep = 32;           // row loads in flight, few warps
constexpr int kShallow = 4;         // row loads in flight, many warps
constexpr int kDeepWarpsPerSm = 16; // kDeep while the warps fit at this

template <int VW> struct Vec;
template <> struct Vec<1> {
  float v[1];
  __device__ static Vec load(const float* p) { return {{__ldg(p)}}; }
  __device__ void store(float* p) const { *p = v[0]; }
};
template <> struct Vec<2> {
  float v[2];
  __device__ static Vec load(const float* p) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    return {{x.x, x.y}};
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
// A warp per (bag, column tile): the bag's slots walked in groups of 32,
// each group's slots to read listed in slot order in the warp's shared
// `list_*`, then read kInFlight at a time.
template <typename Id, int VW, int kInFlight>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
embedding_bag_kernel(const Id* __restrict__ idx, const float* __restrict__ w,
                     const float* __restrict__ table, float* __restrict__ out,
                     int* __restrict__ err, int64_t n_bags, int k_slots,
                     int64_t dim, int64_t n_rows) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ Id list_src[kWarpsPerBlock][kWarp];
  __shared__ float list_w[kWarpsPerBlock][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (bag >= n_bags) return;  // uniform across the warp
  const int64_t col = ((int64_t)blockIdx.y * kWarp + lane) * VW;
  const bool active = col < dim;  // D % VW == 0: the whole vector is in
  Vec<VW> acc;
#pragma unroll
  for (int c = 0; c < VW; ++c) acc.v[c] = 0.f;
  const int64_t base = bag * (int64_t)k_slots;
  int64_t zero_row = -1;  // row of the bag's last weight-0 slot so far
  Id r_next = 0;
  float w_next = 0.f;
  if (lane < k_slots) {
    r_next = idx[base + lane];
    w_next = w[base + lane];
  }
  for (int k0 = 0; k0 < k_slots; k0 += kWarp) {
    const bool in = k0 + lane < k_slots;
    const Id r = r_next;
    const float wk = w_next;
    if (k0 + kWarp + lane < k_slots) {  // stage the next group early
      r_next = idx[base + k0 + kWarp + lane];
      w_next = w[base + k0 + kWarp + lane];
    }
    const bool bad = in && (r < 0 || (int64_t)r >= n_rows);
    if (bad) *err = 1;
    // Which slots are no-ops: weight 0 and the row of the previous
    // weight-0 slot, in this group or the groups before.
    const bool zero = in && !bad && wk == 0.f;
    const unsigned zeros = __ballot_sync(kAll, zero);
    const unsigned before = zeros & ((1u << lane) - 1u);
    const Id prev = __shfl_sync(kAll, r, before ? 31 - __clz(before) : 0);
    const bool skip = zero && (before ? (int64_t)prev : zero_row) ==
                                  (int64_t)r;
    if (zeros) zero_row = (int64_t)__shfl_sync(kAll, r, 31 - __clz(zeros));
    // List the slots to read in order (a lane's rank among them is its
    // place), so that every slot of a batch is found at once.
    const bool take = in && !bad && !skip;
    const unsigned todo = __ballot_sync(kAll, take);
    __syncwarp();  // the previous group's list has been read
    if (take) {
      const int at = __popc(todo & ((1u << lane) - 1u));
      list_src[warp][at] = r;
      list_w[warp][at] = wk;
    }
    __syncwarp();
    const int n = __popc(todo);
    for (int j0 = 0; j0 < n; j0 += kInFlight) {
      Vec<VW> v[kInFlight];
      float ws[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {  // issue the loads...
        const int at = (j0 + j) % kWarp;
        const bool live = j0 + j < n;
        const Id src = list_src[warp][at];
        ws[j] = live ? list_w[warp][at] : 0.f;
        if (live && active) {
          v[j] = Vec<VW>::load(table + (int64_t)src * dim + col);
        } else {
#pragma unroll
          for (int c = 0; c < VW; ++c) v[j].v[c] = 0.f;
        }
      }
      // ...then add in slot order; a dead entry adds 0 * 0 = +0, which
      // leaves acc as it is (acc is never -0).
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
#pragma unroll
        for (int c = 0; c < VW; ++c)
          acc.v[c] = __fadd_rn(acc.v[c], __fmul_rn(ws[j], v[j].v[c]));
      }
    }
  }
  if (active) acc.store(out + bag * dim + col);
}

int sm_count(int device) {
  static int counts[64];
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    counts[device] = 132;
  return counts[device];
}

template <typename Id, int VW>
cudaError_t launch(const void* idx, const void* w, const void* table,
                   void* out, void* err, long long n_bags, int k_slots,
                   long long dim, long long n_rows, int device,
                   cudaStream_t stream) {
  const long long tile = (long long)kWarp * VW;
  const long long col_tiles = dim > 0 ? (dim + tile - 1) / tile : 1;
  if (col_tiles > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)((n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)col_tiles);
  const Id* i = (const Id*)idx;
  const float* ww = (const float*)w;
  const float* t = (const float*)table;
  // Few warps (B = 512: one wave) wait out each batch of loads with no
  // other warp to hide it: give each many loads in flight. Many warps
  // hide each other's latency; fewer registers a warp keep more resident.
  if (n_bags * col_tiles <= (long long)sm_count(device) * kDeepWarpsPerSm)
    embedding_bag_kernel<Id, VW, kDeep>
        <<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(
            i, ww, t, (float*)out, (int*)err, n_bags, k_slots, dim, n_rows);
  else
    embedding_bag_kernel<Id, VW, kShallow>
        <<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(
            i, ww, t, (float*)out, (int*)err, n_bags, k_slots, dim, n_rows);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch_ids(int vw, const void* idx, const void* w,
                       const void* table, void* out, void* err,
                       long long n_bags, int k_slots, long long dim,
                       long long n_rows, int device, cudaStream_t stream) {
  if (vw == 2)
    return launch<Id, 2>(idx, w, table, out, err, n_bags, k_slots, dim,
                         n_rows, device, stream);
  return launch<Id, 1>(idx, w, table, out, err, n_bags, k_slots, dim,
                       n_rows, device, stream);
}

bool aligned(const void* p, unsigned bytes) {
  return (uintptr_t)p % bytes == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` (the caller's current torch stream) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. idx is
// int64 when idx_64 is non-zero, else int32. *err must be 0 before the
// launch; the kernel sets it to 1 if any id lies outside [0, n_rows). err
// is device memory or pinned host memory, whose host address the kernel
// writes through (unified addressing).
int embedding_bag_launch(const void* idx, int idx_64, const void* w,
                         const void* table, void* out, void* err,
                         long long n_bags, int k_slots, long long dim,
                         long long n_rows, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n_bags <= 0 || (k_slots <= 0 && dim <= 0)) return 0;
  // Two columns (8 bytes) a lane where D needs more than 32 columns.
  const int vw =
      dim > 32 && dim % 2 == 0 && aligned(table, 8) && aligned(out, 8) ? 2
                                                                        : 1;
  e = idx_64 ? launch_ids<long long>(vw, idx, w, table, out, err,
                                     n_bags, k_slots, dim, n_rows, device,
                                     (cudaStream_t)stream)
             : launch_ids<int>(vw, idx, w, table, out, err, n_bags,
                               k_slots, dim, n_rows, device,
                               (cudaStream_t)stream);
  return (int)e;
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
