// Grouped expert GEMM for Hopper (sm_90a), fp32 FMAs on the CUDA cores: the
// float32 route of the wrapper (bf16 runs on moe_gemm_tc.cu's tensor-core
// kernels).
//
// Replaces src/repro/kernels/moe_gemm/kernel.py::moe_gemm_pallas (body
// _kernel). For every expert e of a capacity-bucketed MoE layer, with
// live = clamp(rows[e], 0, cap) (cap when rows is null),
//
//     y[e][r] = x[e][r] @ w[e] for r < live, 0 for r >= live
//     x (E, cap, d), w (E, d, f), y (E, cap, f)
//
// with fp32 accumulation and the output in x's type. A CTA whose first row
// is past `live` stores its zeros and returns; x rows past `live` are never
// read. Float32 stays on this kernel so integer-valued inputs come out
// bitwise equal to the plain version. The contraction runs
// over all of d: the Pallas kernel's d // 512 steps drop the last d % 512
// columns whenever the padded d is not a multiple of 512; this kernel does
// not copy that.
//
// Work division: one CTA per (N tile of 128 columns, M tile of BM rows,
// expert). It streams k-panels of 32 from x[e] (stored transposed, so every
// thread reads its rows as one float4) and w[e] through shared memory as
// fp32, prefetching the next panel into registers while it computes on the
// current one, and keeps the BM x 128 accumulator in registers: 256 threads,
// each BM/16 rows x 8 columns. Edges are predicated (rows past cap, columns
// past f, the k tail past d read as zeros and are never stored), so nothing
// is padded or copied.
//
// Two regimes on one path, picked by BM (the wrapper's block_rows): BM =
// 128 for cap in the hundreds, bound by operations (fp32 FMAs on the CUDA
// cores with 8 x 8 register blocking per thread); BM = 16 for a decode
// step's cap of 8, bound by the weight read, small tiles keeping many CTAs
// streaming w with 16-byte loads. This kernel is the wrapper's float32
// route; bf16 runs on the tensor-core kernels, and this kernel's bf16
// instantiation stays only as their yardstick. At the float32 shapes the
// serving check gives it (qwen2-moe-a2.7b, 4 x 256 tokens: x (64, 88,
// 2048), w (64, 2048, 1408), 3,460 live rows) a launch needs 20 GFLOP:
// bound by operations, 0.30 ms at an H100 SXM's fp32 CUDA-core peak.
//
// Requirements (checked by the wrapper): d and f multiples of 8, tensors
// contiguous and 16-byte aligned, rows int32 (E,) or null.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BN = 128;
constexpr int BK = 32;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void widen(const uint4& raw, float* dst) {
    dst[0] = __uint_as_float(raw.x); dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z); dst[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void widen(const uint4& raw, float* dst) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[2 * i] = __uint_as_float(w[i] << 16);
      dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ rows, T* __restrict__ y, int cap,
                int d, int f) {
  constexpr int VEC = Vec16<T>::n;
  constexpr int TM = BM / 16;                  // rows per thread
  constexpr int RV = TM < 4 ? TM : 4;          // contiguous rows per group
  constexpr int NG = TM / RV;                  // row groups per thread
  constexpr int GS = BM / NG;                  // row stride between groups
  constexpr int A_VECS = BM * BK / VEC;        // 16-byte loads per x panel
  constexpr int B_VECS = BK * BN / VEC;        // 16-byte loads per w panel
  constexpr int A_PER = (A_VECS + kThreads - 1) / kThreads;
  constexpr int B_PER = B_VECS / kThreads;
  static_assert(B_VECS % kThreads == 0, "w panel split");

  __shared__ __align__(16) float As[BK][BM];   // x panel, transposed
  __shared__ __align__(16) float Bs[BK][BN];   // w panel

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const T* xe = x + (size_t)e * cap * d;
  const T* we = w + (size_t)e * d * f;
  T* ye = y + (size_t)e * cap * f;
  const int live = rows ? min(max(rows[e], 0), cap) : cap;
  if (m0 >= live) {                       // nothing live: zeros, no loads
    const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int vecs = min(BN, f - n0) / 4;
    for (int i = tid; i < min(BM, cap - m0) * vecs; i += kThreads)
      store4(ye + (size_t)(m0 + i / vecs) * f + n0 + (i % vecs) * 4, zero);
    return;
  }

  uint4 ra[A_PER], rb[B_PER];
  // global -> registers for the panel at k0 (zeros outside the matrix)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int t = 0; t < A_PER; ++t) {
      const int idx = tid + t * kThreads;
      const int m = idx % BM, kc = idx / BM;
      ra[t] = make_uint4(0, 0, 0, 0);
      if (idx < A_VECS && m0 + m < live && k0 + kc * VEC < d)
        ra[t] = *reinterpret_cast<const uint4*>(
            xe + (size_t)(m0 + m) * d + k0 + kc * VEC);
    }
#pragma unroll
    for (int t = 0; t < B_PER; ++t) {
      const int idx = tid + t * kThreads;
      const int nc = idx % (BN / VEC), kr = idx / (BN / VEC);
      rb[t] = make_uint4(0, 0, 0, 0);
      if (k0 + kr < d && n0 + nc * VEC < f)
        rb[t] = *reinterpret_cast<const uint4*>(
            we + (size_t)(k0 + kr) * f + n0 + nc * VEC);
    }
  };
  // registers -> shared memory, widened to fp32
  auto stage = [&]() {
#pragma unroll
    for (int t = 0; t < A_PER; ++t) {
      const int idx = tid + t * kThreads;
      if (idx >= A_VECS) continue;
      const int m = idx % BM, kc = idx / BM;
      float vals[VEC];
      Vec16<T>::widen(ra[t], vals);
#pragma unroll
      for (int i = 0; i < VEC; ++i) As[kc * VEC + i][m] = vals[i];
    }
#pragma unroll
    for (int t = 0; t < B_PER; ++t) {
      const int idx = tid + t * kThreads;
      const int nc = idx % (BN / VEC), kr = idx / (BN / VEC);
      float vals[VEC];
      Vec16<T>::widen(rb[t], vals);
#pragma unroll
      for (int i = 0; i < VEC; i += 4) store4(&Bs[kr][nc * VEC + i], vals + i);
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = (d + BK - 1) / BK;
  fetch(0);
  stage();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch((kt + 1) * BK);   // in flight during the FMAs
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if constexpr (RV == 4) {
          const float4 av = *reinterpret_cast<const float4*>(&As[kk][g * GS + ty * 4]);
          a[g * 4 + 0] = av.x; a[g * 4 + 1] = av.y;
          a[g * 4 + 2] = av.z; a[g * 4 + 3] = av.w;
        } else {
#pragma unroll
          for (int i = 0; i < RV; ++i) a[g * RV + i] = As[kk][g * GS + ty * RV + i];
        }
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      stage();
      __syncthreads();
    }
  }

  const float zero[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int i = 0; i < RV; ++i) {
      const int m = m0 + g * GS + ty * RV + i;
      if (m >= cap) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + h * 64 + tx * 4;
        if (n < f)
          store4(ye + (size_t)m * f + n,
                 m < live ? &acc[g * RV + i][h * 4] : zero);
      }
    }
  }
}

template <typename T, int BM>
int launch(const void* x, const void* w, const int* rows, void* y, int E,
           int cap, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, (cap + BM - 1) / BM, E);
  moe_gemm_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), rows,
      static_cast<T*>(y), cap, d, f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bm(int bm, const void* x, const void* w, const int* rows, void* y,
              int E, int cap, int d, int f, cudaStream_t stream) {
  switch (bm) {
    case 16: return launch<T, 16>(x, w, rows, y, E, cap, d, f, stream);
    case 64: return launch<T, 64>(x, w, rows, y, E, cap, d, f, stream);
    case 128: return launch<T, 128>(x, w, rows, y, E, cap, d, f, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; bm: rows per CTA (16, 64 or 128);
// rows: int32 (E,) or null (every row live). Returns the cudaError_t of the
// launch (0 on success), or -1 for a dtype or bm without an instantiation.
extern "C" int moe_gemm_launch(int dtype, int bm, const void* x,
                               const void* w, const void* rows, void* y,
                               int E, int cap, int d, int f, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  if (dtype == 0) return launch_bm<float>(bm, x, w, r, y, E, cap, d, f, st);
  if (dtype == 1)
    return launch_bm<__nv_bfloat16>(bm, x, w, r, y, E, cap, d, f, st);
  return -1;
}
