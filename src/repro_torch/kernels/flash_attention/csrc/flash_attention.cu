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
// query s iff t <= s. The online-softmax state (m, l, acc) is fp32.
//
// Bound: at the serving shape (S = T = 4096, D = 64) operations, not bytes:
// 4*B*H*D per visible (query, key) pair against 168 MB read once. Design,
// simple first:
//   * one CTA (4 warps) per (64 query rows, head, batch); each warp owns
//     16 query rows. kv blocks of 64 keys are staged in shared memory and
//     walked in order from key 0, so every row meets key 0 in its first
//     block and its running max is finite from then on;
//   * kv blocks that lie wholly above the diagonal are skipped (the Pallas
//     kernel computes them and discards them); keys >= T and query rows
//     >= S are masked here, so nothing is padded;
//   * bf16: S = Q K^T and O += P V on the tensor cores with mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate: the products are exact). P is
//     rounded to bf16 for the P V product; its row sums l are taken in fp32
//     before the rounding. Q stays in registers as A fragments; K is staged
//     row-major and V transposed, rows padded by 8 elements so the fragment
//     reads hit 32 distinct banks;
//   * fp32: SIMT fp32 throughout (TF32 would miss the reference's rtol
//     2e-5). Each thread holds 4 rows x 8 keys of S and 4 rows x D/8 columns
//     of acc; P goes through shared memory. Its 66-115 KB of shared memory
//     are opted in above 48 KiB.
// D is a multiple of 16 up to 128; the kernels are built for 64 and 128
// columns and zero-fill the columns beyond D. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per kv block
constexpr int kWarps = 4;               // 16 query rows each
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

// Keys [0, kv_end) can be visible to the CTA's rows [q0, q0 + kBQ).
__device__ __forceinline__ int kv_blocks(const Args& p, int q0) {
  const int kv_end = p.causal ? min(p.T, q0 + kBQ) : p.T;
  return (kv_end + kBK - 1) / kBK;
}

__device__ __forceinline__ bool visible(const Args& p, int row, int col) {
  return col < p.T && (!p.causal || col <= row);
}

// ---------------------------------------------------------------- bf16 ---

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8, fp32) += a (16x16, bf16, row-major) * b (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + 64) x columns [0, DP) of a (rows, D) matrix with row
// stride `ld_g` into shared memory with row stride LD; zeros outside.
template <int DP, int LD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ld_g, int r0, int rows,
                                           int D) {
  constexpr int kChunks = DP / 8;                 // 16-byte chunks a row
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && c < D)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld_g + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// the same block transposed: dst[c * LD + r] = src[r0 + r, c]
template <int DP, int LD>
__device__ __forceinline__ void stage_cols(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ld_g, int r0, int rows,
                                           int D) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i % kBK, c = (i / kBK) * 8;     // a warp: 32 rows, 1 chunk
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && c < D)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld_g + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * LD + r] = e[j];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) fa_bf16_kernel(Args p) {
  constexpr int LDK = DP + 8;   // Ks row stride, bf16
  constexpr int LDV = kBK + 8;  // Vt row stride, bf16
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[DP * LDV];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;  // fragment row group, column pair
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.G;
  const __nv_bfloat16* Q =
      (const __nv_bfloat16*)p.q + b * p.qb + (long long)h * p.qh;
  const __nv_bfloat16* K =
      (const __nv_bfloat16*)p.k + b * p.kb + (long long)hk * p.kh;
  const __nv_bfloat16* V =
      (const __nv_bfloat16*)p.v + b * p.vb + (long long)hk * p.vh;

  // Q's A fragments, staged through Ks
  stage_rows<DP, LDK>(Ks, Q, p.qs, q0, p.S, p.D);
  __syncthreads();
  uint32_t qa[DP / 16][4];
  const int r = warp * 16 + g;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const __nv_bfloat16* base = Ks + ks * 16 + tg * 2;
    qa[ks][0] = ld32(base + r * LDK);
    qa[ks][1] = ld32(base + (r + 8) * LDK);
    qa[ks][2] = ld32(base + r * LDK + 8);
    qa[ks][3] = ld32(base + (r + 8) * LDK + 8);
  }

  const int row0 = q0 + r, row1 = row0 + 8;  // the thread's two query rows
  const float sl2 = p.scale * kLog2e;        // exp(x) = exp2(x * log2 e)
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  const int n_kv = kv_blocks(p, q0);
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // every warp is done with Ks and Vt
    stage_rows<DP, LDK>(Ks, K, p.kt, k0, p.T, p.D);
    stage_cols<DP, LDV>(Vt, V, p.vt, k0, p.T, p.D);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDK + ks * 16 + tg * 2;
        mma_bf16(s[j], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tg * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        s[j][e] = visible(p, row, col) ? s[j][e] * sl2 : -INFINITY;
      }
      bm0 = fmaxf(bm0, fmaxf(s[j][0], s[j][1]));
      bm1 = fmaxf(bm1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, off));
      bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, off));
    }
    const float mn0 = fmaxf(m0, bm0), mn1 = fmaxf(m1, bm1);
    // a row with nothing visible yet keeps exp2(-inf - 0) = 0 terms
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float c0 = exp2f(m0 - ms0), c1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - ms0);
      s[j][1] = exp2f(s[j][1] - ms0);
      s[j][2] = exp2f(s[j][2] - ms1);
      s[j][3] = exp2f(s[j][3] - ms1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // P (bf16) V: the C fragments of two key tiles are one A fragment
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * LDV + kk * 16 + tg * 2;
        mma_bf16(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* O = (__nv_bfloat16*)p.o;
  const long long ostride = (long long)p.H * p.D;  // one query row
  const long long obase = ((long long)b * p.S) * ostride + (long long)h * p.D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + tg * 2;
    if (col >= p.D) continue;
    if (row0 < p.S)
      *reinterpret_cast<uint32_t*>(O + obase + row0 * ostride + col) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < p.S)
      *reinterpret_cast<uint32_t*>(O + obase + row1 * ostride + col) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
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

  const int n_kv = kv_blocks(p, q0);
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
cudaError_t launch_f32(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
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
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  Args a{q, k, v, o, S, T, H, H / Hkv, D, qb, qs, qh, kb, kt, kh, vb, vt, vh,
         scale, causal};
  dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    if (D <= 64)
      fa_bf16_kernel<64><<<grid, kThreads, 0, st>>>(a);
    else
      fa_bf16_kernel<128><<<grid, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)(D <= 64 ? launch_f32<64>(a, grid, st)
                       : launch_f32<128>(a, grid, st));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
