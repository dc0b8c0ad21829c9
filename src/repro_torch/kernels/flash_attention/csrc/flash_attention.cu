// Causal or full GQA flash attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (wrapper src/repro/kernels/flash_attention/ops.py::flash_attention):
//
//   out[b, s, h, :] = sum_t softmax_t(scale * q[b,s,h] . k[b,t,h/G]) v[b,t,h/G]
//
// q (B, S, H, D), k and v (B, T, Hkv, D) read through their strides (the
// last one 1; the Pallas wrapper's (B, H, S, D) transposes are copies a GPU
// does not need), G = H / Hkv, scale = D^-0.5, out (B, S, H, D) contiguous
// in the input dtype. The causal mask is aligned top-left, as the Pallas
// kernel and the model's blockwise attention align it: key t is visible to
// query s iff t <= s. The online-softmax state (m, l, acc) is fp32. D is a
// multiple of 16 up to 128; the kernels are built for 64 and 128 columns
// and zero-fill the columns beyond D.
//
// Bound: at the serving shape (S = T = 4096, D = 64) operations, not bytes:
// 4*B*H*D per visible (query, key) pair against 168 MB read once.
//
// bf16, on Hopper's tensor cores (fa_bf16_kernel):
//   * one CTA per (128 query rows, head, batch): two consumer warpgroups of
//     64 rows each and one producer warpgroup, of which one thread issues
//     every load; the producer gives up its registers (setmaxnreg 24) to
//     the consumers (240);
//   * loads are TMA: Q once, then K and V tiles of 128 keys into a ring of
//     3 stages (D 64) or 2 (D 128) in shared memory, each stage with full
//     barriers (K and
//     V apart, so S = Q K^T starts before V lands) and an empty barrier the
//     consumers arrive on. The tensor maps are built on the host per launch
//     from the tensors' strides (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so the library links no -lcuda) and passed
//     as __grid_constant__ parameters. Boxes are 64 columns (one 128-byte
//     bf16 row, 128-byte swizzle) by 128 rows; D = 128 takes two. TMA's
//     out-of-bounds zero fill covers ragged S and T and the columns beyond
//     D, so no thread masks a load;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory (K's
//     row-major tile is the K-major B operand); O += P V is wgmma with P
//     from registers (S's accumulator rounded to bf16 A fragments, l summed
//     in fp32 before the rounding) and V read through the descriptor's
//     transpose bit, so no thread transposes V;
//   * each warpgroup issues block kb's S = Q K^T before block kb - 1's
//     O += P V and waits for S alone, so kb's softmax (registers, exp2
//     domain: ex2.approx of an fma) runs while the tensor cores do kb - 1's
//     P V; O is rescaled once that is done. Only blocks that reach the
//     diagonal or T are masked; blocks above the diagonal are skipped;
//   * the grid is (H, B, query blocks) with the query blocks reversed: the
//     heaviest causal blocks launch first, and the G query heads of one kv
//     head are adjacent, so their K/V tiles come from L2.
//
// fp32 (fa_f32_kernel): SIMT fp32 throughout (TF32 would miss the
// reference's rtol 2e-5). One CTA (4 warps) per (64 query rows, head,
// batch); each thread holds 4 rows x 8 keys of S and 4 rows x D/8 columns
// of acc; P goes through shared memory. Its 66-115 KB of shared memory are
// opted in above 48 KiB.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // fp32: query rows per CTA
constexpr int kBK = 64;                 // fp32: keys per kv block
constexpr int kWarps = 4;               // fp32: 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, G, D;
  long long qb, qs, qh, kb, kt, kh, vb, vt, vh;  // strides, in elements
  float scale;
  int causal;
};

// Keys [0, kv_end) can be visible to rows [q0, q0 + rows), in blocks of bk.
__device__ __forceinline__ int kv_blocks(const Args& p, int q0, int rows,
                                         int bk) {
  const int kv_end = p.causal ? min(p.T, q0 + rows) : p.T;
  return (kv_end + bk - 1) / bk;
}

__device__ __forceinline__ bool visible(const Args& p, int row, int col) {
  return col < p.T && (!p.causal || col <= row);
}

// ------------------------------------------------------- bf16, Hopper ---

constexpr int kHQ = 128;               // query rows per CTA
constexpr int kHK = 128;               // keys per K/V tile
constexpr int kHThreads = 384;         // 2 consumer + 1 producer warpgroup
constexpr int kBox = 64;               // bf16 columns per TMA box: 128 bytes

template <int DP>
struct Smem {
  static constexpr int kStages = DP == 64 ? 3 : 2;   // the K/V ring
  static constexpr int kQ = kHQ * DP * 2;             // bytes
  static constexpr int kKV = kHK * DP * 2;
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr int kBytes = 1024 + kQ + 2 * kStages * kKV + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One box of a 4-d tensor map (column, row, head, batch) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int r, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(r), "r"(h), "r"(b) : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle. K-major tiles (Q, K):
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused.
// MN-major tiles (V read transposed): the same rows, 64-column boxes LBO
// bytes apart.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving register reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 128,
// bf16, shared, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared, MN-major: the descriptor's transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// shared, MN-major: the descriptor's transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// S (64 x 128) = the warpgroup's Q rows (qt) times the K tile (kt)^T, 16
// columns of D at a time: box c = ks / 4, 32-byte step ks % 4 inside it.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[kHK / 2],
                                         const uint8_t* qt,
                                         const uint8_t* kt) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int c = ks / 4, kk = ks % 4;
    wgmma_ss_n128(sc, desc(qt + c * kHQ * 128 + kk * 32, 16),
                  desc(kt + c * kHK * 128 + kk * 32, 16), ks > 0);
  }
}

// O += P V, 16 keys at a time (2048 bytes of the tile); V's boxes are
// kHK * 128 bytes apart.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[kHK / 16][4],
                                         const uint8_t* vt) {
#pragma unroll
  for (int kk = 0; kk < kHK / 16; ++kk) {
    if constexpr (DP == 64)
      wgmma_rs_n64(o, pa[kk], desc(vt + kk * 16 * 128, kHK * 128));
    else
      wgmma_rs_n128(o, pa[kk], desc(vt + kk * 16 * 128, kHK * 128));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The online softmax of one thread's two rows (row0, row0 + 8), exp2
// domain: sc[4 j + e] is row (e < 2 ? row0 : row0 + 8), key
// k0 + 8 j + cq + (e & 1) of the block.
struct Softmax {
  int row0, cq;
  float sl2;
  float m0 = -INFINITY, m1 = -INFINITY;    // running max, scaled
  float l0 = 0.f, l1 = 0.f;                // this thread's part of the sums
  float c0 = 1.f, c1 = 1.f;                // the last step's correction

  // sc <- exp2(sc * sl2 - max); updates m, l and the correction. Only a
  // block that reaches the diagonal or T (from the warpgroup's first row
  // r0) is masked.
  __device__ __forceinline__ void step(const Args& p, float (&sc)[kHK / 2],
                                       int k0, int r0) {
    const bool mask = (p.causal && k0 + kHK - 1 > r0) || k0 + kHK > p.T;
    float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j) {
      if (mask) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + cq + (e & 1);
          if (!visible(p, e < 2 ? row0 : row0 + 8, col))
            sc[4 * j + e] = -INFINITY;
        }
      }
      bm0 = fmaxf(bm0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      bm1 = fmaxf(bm1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, off));
      bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, off));
    }
    const float mn0 = fmaxf(m0, bm0 * sl2), mn1 = fmaxf(m1, bm1 * sl2);
    // a row with nothing visible yet keeps exp2(-inf - 0) = 0 terms
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    c0 = ex2(m0 - ms0);
    c1 = ex2(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], sl2, -ms0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], sl2, -ms0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], sl2, -ms1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], sl2, -ms1));
      s0 += sc[4 * j] + sc[4 * j + 1];
      s1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
  }

  template <int N>
  __device__ __forceinline__ void rescale(float (&o)[N]) const {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
      o[4 * n] *= c0;
      o[4 * n + 1] *= c0;
      o[4 * n + 2] *= c1;
      o[4 * n + 3] *= c1;
    }
  }

  // P, rounded to bf16: the accumulator of two 8-key steps is one 16-key A
  // fragment.
  __device__ __forceinline__ void pack(const float (&sc)[kHK / 2],
                                       uint32_t (&pa)[kHK / 16][4]) const {
#pragma unroll
    for (int kk = 0; kk < kHK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(kHThreads, 1)
fa_bf16_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, Args p) {
  using L = Smem<DP>;
  constexpr int kBoxes = DP / kBox;     // TMA boxes (64 columns) per tile
  constexpr int Stages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* Qs = smem;                               // [box][128 rows][64]
  uint8_t* Ks = Qs + L::kQ;                         // [stage][box][128][64]
  uint8_t* Vs = Ks + Stages * L::kKV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + Stages * L::kKV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + Stages;
  uint64_t* empty = bars + 1 + 2 * Stages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kHQ;  // heaviest first
  const int hk = h / p.G;
  const int n_kv = kv_blocks(p, q0, kHQ, kHK);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < Stages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2 * 128);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < kBoxes; ++c)
        tma_load(Qs + c * kHQ * 128, &tq, q_full, c * kBox, q0, h, b);
      for (int kb = 0; kb < n_kv; ++kb) {
        const int s = kb % Stages;
        mbar_wait(empty + s, ((kb / Stages) & 1) ^ 1);
        uint8_t* kt = Ks + s * L::kKV;
        uint8_t* vt = Vs + s * L::kKV;
        mbar_expect_tx(k_full + s, L::kKV);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(kt + c * kHK * 128, &tk, k_full + s, c * kBox, kb * kHK,
                   hk, b);
        mbar_expect_tx(v_full + s, L::kKV);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(vt + c * kHK * 128, &tv, v_full + s, c * kBox, kb * kHK,
                   hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128, lane = t % 32;
    Softmax sm;
    sm.row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // and row0 + 8
    sm.cq = 2 * (lane % 4);                    // its first column of a tile
    sm.sl2 = p.scale * kLog2e;                 // exp(x) = exp2(x * log2 e)
    float o[DP / 2], sc[kHK / 2];
    uint32_t pa[kHK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kHK / 2; ++i) sc[i] = 0.f;
    const uint8_t* qt = Qs + wg * 64 * 128;
    mbar_wait(q_full, 0);

    // Block kb's S = Q K^T is issued before block kb - 1's O += P V, so the
    // softmax of kb runs while the tensor cores do kb - 1's P V.
    if (n_kv > 0) {
      mbar_wait(k_full, 0);
      fence_regs(sc);
      wgmma_fence();
      issue_qk<DP>(sc, qt, Ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      sm.step(p, sc, 0, q0 + 64 * wg);
      sm.pack(sc, pa);
    }
    for (int kb = 1; kb < n_kv; ++kb) {
      const int s = kb % Stages, ps = (kb - 1) % Stages;
      mbar_wait(k_full + s, (kb / Stages) & 1);
      fence_regs(sc);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_qk<DP>(sc, qt, Ks + s * L::kKV);
      wgmma_commit();
      mbar_wait(v_full + ps, ((kb - 1) / Stages) & 1);
      issue_pv<DP>(o, pa, Vs + ps * L::kKV);
      wgmma_commit();
      wgmma_wait<1>();                         // S of block kb is done
      fence_regs(sc);
      sm.step(p, sc, kb * kHK, q0 + 64 * wg);
      wgmma_wait<0>();                         // P V of block kb - 1 too
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(empty + ps);
      sm.rescale(o);
      sm.pack(sc, pa);
    }
    if (n_kv > 0) {
      const int ps = (n_kv - 1) % Stages;
      mbar_wait(v_full + ps, ((n_kv - 1) / Stages) & 1);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<DP>(o, pa, Vs + ps * L::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty + ps);
    }
    const int cq = sm.cq, row0 = sm.row0, row1 = sm.row0 + 8;
    float l0 = sm.l0, l1 = sm.l1;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* O = (__nv_bfloat16*)p.o;
    const long long ostride = (long long)p.H * p.D;  // one query row
    const long long obase =
        ((long long)b * p.S) * ostride + (long long)h * p.D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + cq;
      if (col >= p.D) continue;
      if (row0 < p.S)
        *reinterpret_cast<uint32_t*>(O + obase + row0 * ostride + col) =
            pack_bf16(o[4 * n] / d0, o[4 * n + 1] / d0);
      if (row1 < p.S)
        *reinterpret_cast<uint32_t*>(O + obase + row1 * ostride + col) =
            pack_bf16(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or null.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (column, row, head, batch) bf16 tensor map of boxes of 64 columns x
// `box_rows` rows, 128-byte swizzle, zeros out of bounds. Strides in
// elements; a stride of a size-1 dimension is never followed, so any legal
// value stands in for it.
bool make_map(CUtensorMap* map, const void* base, int D, int rows,
              int heads, int batch, long long rs, long long hs, long long bs,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(rows > 0 ? rows : 1),
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const long long st[3] = {rs, hs, bs};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(dims[i + 1] == 1 ? 8 : st[i]) * 2;
  const cuuint32_t box[4] = {kBox, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_bf16(const Args& a, int B, int Hkv, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, a.D, a.S, a.H, B, a.qs, a.qh, a.qb, kHQ) ||
      !make_map(&tk, a.k, a.D, a.T, Hkv, B, a.kt, a.kh, a.kb, kHK) ||
      !make_map(&tv, a.v, a.D, a.T, Hkv, B, a.vt, a.vh, a.vb, kHK))
    return cudaErrorInvalidValue;
  constexpr int smem = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)a.H, (unsigned)B, (unsigned)((a.S + kHQ - 1) / kHQ));
  fa_bf16_kernel<DP><<<grid, kHThreads, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 ---

// Thread layout: lane = rg * 8 + cg. A warp's 16 rows are 4 groups of 4
// (rg); a thread holds keys cg + 8 j of S and columns cg + 8 j of acc.
constexpr int kLDP = kBK + 2;  // Ps row stride: the 4 row groups' 8 lanes
                               // land on 32 distinct banks

template <int DP>
constexpr int f32_smem_bytes() {
  return (2 * kBK * (DP + 1) + kBK * DP + kBQ * kLDP) * (int)sizeof(float);
}

template <int DP, int LD>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               long long ld_g, int r0,
                                               int rows, int D) {
  constexpr int kChunks = DP / 4;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows && c < D)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * ld_g + c);
    float* d = dst + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) fa_f32_kernel(Args p) {
  constexpr int LDQ = DP + 1, LDK = DP + 1, LDV = DP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDK;
  float* Ps = Vs + kBK * LDV;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane >> 3, cg = lane & 7;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.G;
  const float* Q = (const float*)p.q + b * p.qb + (long long)h * p.qh;
  const float* K = (const float*)p.k + b * p.kb + (long long)hk * p.kh;
  const float* V = (const float*)p.v + b * p.vb + (long long)hk * p.vh;

  stage_rows_f32<DP, LDQ>(Qs, Q, p.qs, q0, p.S, p.D);
  const int lr = warp * 16 + rg * 4;  // the thread's first row in the CTA
  float acc[4][DP / 8];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = kv_blocks(p, q0, kBQ, kBK);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // Qs written; every warp is done with Ks, Vs, Ps
    stage_rows_f32<DP, LDK>(Ks, K, p.kt, k0, p.T, p.D);
    stage_rows_f32<DP, LDV>(Vs, V, p.vt, k0, p.T, p.D);
    __syncthreads();

    float s[4][kBK / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[kBK / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(lr + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) kv[j] = Ks[(cg + 8 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + lr + i;
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int col = k0 + cg + 8 * j;
        s[i][j] = visible(p, row, col) ? s[i][j] * p.scale : -INFINITY;
        bm = fmaxf(bm, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
      const float mn = fmaxf(m[i], bm);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float c = expf(m[i] - ms);
      m[i] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float e = expf(s[i][j] - ms);
        ls += e;
        Ps[(lr + i) * kLDP + cg + 8 * j] = e;
      }
      l[i] = l[i] * c + ls;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) acc[i][j] *= c;
    }
    __syncwarp();  // a warp reads only its own rows of Ps
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DP / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(lr + i) * kLDP + c];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) vv[j] = Vs[c * LDV + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* O = (float*)p.o;
  const long long ostride = (long long)p.H * p.D;
  const long long obase = ((long long)b * p.S) * ostride + (long long)h * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + lr + i;
    if (row >= p.S) continue;
    const float den = fmaxf(li, 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = cg + 8 * j;
      if (col < p.D) O[obase + row * ostride + col] = acc[i][j] / den;
    }
  }
}

template <int DP>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.S + kBQ - 1) / kBQ), (unsigned)a.H, (unsigned)B);
  fa_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v and out alike). Launches on
// `stream` (the caller's current torch stream) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int T, int H, int Hkv,
                           int D, long long qb, long long qs, long long qh,
                           long long kb, long long kt, long long kh,
                           long long vb, long long vt, long long vh,
                           float scale, int causal, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D % 16 != 0 || D < 16 || D > 128 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B > 65535 || H > 65535 || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidConfiguration;
  Args a{q, k, v, o, S, T, H, H / Hkv, D, qb, qs, qh, kb, kt, kh, vb, vt, vh,
         scale, causal};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)(D <= 64 ? launch_bf16<64>(a, B, Hkv, st)
                         : launch_bf16<128>(a, B, Hkv, st));
  return (int)(D <= 64 ? launch_f32<64>(a, B, st)
                       : launch_f32<128>(a, B, st));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
