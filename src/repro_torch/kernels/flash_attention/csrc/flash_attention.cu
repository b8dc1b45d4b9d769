// Causal online-softmax attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _attn_kernel). For every batch b, query head h and query row r,
//
//     o[b, r, h] = sum_c softmax_c(mask(softcap(scale * q[b,r,h] . k[b,c,h/rep])))
//                  * v[b, c, h/rep]
//
// with the Pallas kernel's semantics: scale, then softcap, then the mask
// (causal c <= r, window c > r - window) to -1e30; p = mask ? exp(s - m) : 0;
// a row whose l is 0 divides by 1; the output is in q's type.
//
// Layout: q, k, v and o are contiguous (B, S, H, D) tensors, the model's own
// layout, so the wrapper neither folds heads into the batch nor repeats kv
// heads (a query head h reads kv head h / rep) nor pads S: keys at or past S
// are masked and rows past S are not stored, which for causal attention is
// what padding S with zeros gives.
//
// Head dims: any D that is a multiple of 8 up to 256. The kernel is
// instantiated at DP, D rounded up to a multiple of 64 (64, 128, 192, 256):
// at D == DP with D known at compile time (FULL), else with D taken at run
// time, where columns at or past D load as zeros (so they add nothing to
// q . k, and P V gives zeros there) and are never stored. A row of D floats
// is a multiple of 32 bytes and of bf16 16 bytes, so every 16-byte vector a
// thread reads lies wholly inside or wholly past D, and every 4-column group
// it stores likewise. On an H100 the run-time masks cost 2-14 % at the
// published head dims (chip_smoke.py), hence the FULL instantiations.
//
// Work division: the Pallas grid walks every kv block of a (head, q block)
// pair in order and masks the dead ones. Here one CTA takes one (q block of
// 64 rows, head, batch) and loops over key blocks of 64 from the window's
// first reachable block to the causal frontier only; blocks outside are
// never read. Q's block is staged once in shared memory, each K/V tile per
// step (K transposed), all as fp32 (bf16 inputs are widened at the load).
// 256 threads form a 16 x 16 grid: each owns 4 query rows x 4 keys of the
// logit tile and 4 rows x D/16 columns of the fp32 output accumulator in
// registers; m and l per row live in registers too, reduced across the 16
// threads of a row with warp shuffles.
//
// Bound: at qwen2-moe's prefill (S = 2048, D = 128, causal) the launch does
// ~34 GFLOP of products against ~67 MB of q/k/v/o, so it is bound by
// operations. This first kernel does them as fp32 FMAs on the CUDA cores
// (register blocking 4 x 4 per shared load pair); mma/wgmma and TMA are
// later work.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per step
constexpr int PS = BK + 4;      // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

template <int DP>
struct Smem {
  static constexpr int QS = DP + 4;  // padded row stride of the Q tile
  static constexpr int q = 0;
  static constexpr int kt = q + BQ * QS;     // K^T: [DP][BK]
  static constexpr int v = kt + DP * BK;     // V:   [BK][DP]
  static constexpr int p = v + BK * DP;      // P:   [BQ][PS]
  static constexpr int floats = p + BQ * PS;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// 16 bytes of T from global memory widened to fp32 (8 bf16 or 4 floats).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[2 * i] = __uint_as_float(w[i] << 16);
      dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 4 consecutive fp32 values narrowed to T and stored.
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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int d, int S, int Hq,
          int Hkv, float scale, int causal, int window, float softcap) {
  using L = Smem<DP>;
  const int D = FULL ? DP : d;
  constexpr int VEC = Vec16<T>::n;
  constexpr int NCH = DP / VEC;     // 16-byte chunks per padded row
  constexpr int CG = DP / 64;       // output column groups of 4 per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::q;
  float* Kt = smem + L::kt;
  float* Vs = smem + L::v;
  float* Ps = smem + L::p;

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // key / column group
  const int ty = tid >> 4;          // query row group
  const int nqb = (S + BQ - 1) / BQ;
  const int qb = nqb - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * BQ;
  const size_t q_row = (size_t)Hq * D;    // elements between rows of q / o
  const size_t kv_row = (size_t)Hkv * D;
  const T* qb_ptr = q + (size_t)b * S * q_row + (size_t)h * D;
  const T* kb_ptr = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const T* vb_ptr = v + (size_t)b * S * kv_row + (size_t)hk * D;

  // Q tile, row-major (rows past S are zero)
  for (int idx = tid; idx < BQ * NCH; idx += kThreads) {
    const int r = idx / NCH, ch = idx % NCH;
    float vals[VEC];
    if (q0 + r < S && (FULL || ch * VEC < D)) {
      Vec16<T>::load(qb_ptr + (size_t)(q0 + r) * q_row + ch * VEC, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) store4(Qs + r * L::QS + ch * VEC + e, vals + e);
  }

  float m[4], l[4], acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.0f;
  }

  const int nkb = (S + BK - 1) / BK;
  const int kb_end = causal ? min(nkb, (q0 + BQ - 1) / BK + 1) : nkb;
  int kb_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kb_begin = (q0 - window + 1) / BK;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous step is done with Kt, Vs and Ps
    // K tile transposed (key fastest across lanes: conflict-free stores)
    for (int idx = tid; idx < BK * NCH; idx += kThreads) {
      const int c = idx % BK, ch = idx / BK;
      float vals[VEC];
      if (k0 + c < S && (FULL || ch * VEC < D)) {
        Vec16<T>::load(kb_ptr + (size_t)(k0 + c) * kv_row + ch * VEC, vals);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Kt[(ch * VEC + e) * BK + c] = vals[e];
    }
    // V tile row-major (keys past S are zero: p is 0 there, and 0 * v must
    // not meet whatever lies past the tensor)
    for (int idx = tid; idx < BK * NCH; idx += kThreads) {
      const int r = idx / NCH, ch = idx % NCH;
      float vals[VEC];
      if (k0 + r < S && (FULL || ch * VEC < D)) {
        Vec16<T>::load(vb_ptr + (size_t)(k0 + r) * kv_row + ch * VEC, vals);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4) store4(Vs + r * DP + ch * VEC + e, vals + e);
    }
    __syncthreads();

    // logits: rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * L::QS + d);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 kv = *reinterpret_cast<const float4*>(Kt + (d + dd) * BK + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qi = comp(qv[i], dd);
          s[i][0] = fmaf(qi, kv.x, s[i][0]);
          s[i][1] = fmaf(qi, kv.y, s[i][1]);
          s[i][2] = fmaf(qi, kv.z, s[i][2]);
          s[i][3] = fmaf(qi, kv.w, s[i][3]);
        }
      }
    }

    // scale, softcap, mask; online softmax per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        valid[j] = col < S && (!causal || col <= row) &&
                   (window <= 0 || col > row - window);
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        s[i][j] = valid[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG * 4; ++c) acc[i][c] *= alpha;
      store4(Ps + (ty * 4 + i) * PS + tx * 4, s[i]);
    }
    __syncthreads();

    // acc += P V: rows ty*4+i, columns g*64 + tx*4 + e
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PS + kk);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (kk + dd) * DP + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = comp(pv[i], dd);
            acc[i][g * 4 + 0] = fmaf(pi, vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(pi, vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(pi, vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(pi, vv.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

  // normalise (l == 0 divides by 1) and store the rows inside S, the
  // columns inside D
  T* ob_ptr = o + (size_t)b * S * q_row + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (!FULL && g * 64 + tx * 4 >= D) continue;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][g * 4 + e] / denom;
      store4(ob_ptr + (size_t)row * q_row + g * 64 + tx * 4, out);
    }
  }
}

template <typename T, int DP, bool FULL>
int launch(const void* q, const void* k, const void* v, void* o, int D, int B,
           int S, int Hq, int Hkv, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  auto kern = flash_fwd<T, DP, FULL>;
  const size_t smem = Smem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), D, S, Hq, Hkv, scale,
      causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int d,
              int B, int S, int Hq, int Hkv, float scale, int causal,
              int window, float softcap, cudaStream_t stream) {
  if (d == DP)
    return launch<T, DP, true>(q, k, v, o, d, B, S, Hq, Hkv, scale, causal,
                               window, softcap, stream);
  return launch<T, DP, false>(q, k, v, o, d, B, S, Hq, Hkv, scale, causal,
                              window, softcap, stream);
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int B, int S, int Hq, int Hkv, float scale, int causal,
             int window, float softcap, cudaStream_t stream) {
  if (d <= 0 || d > 256 || d % 8 != 0) return -1;
  switch ((d + 63) / 64) {
    case 1:
      return launch_dp<T, 64>(q, k, v, o, d, B, S, Hq, Hkv, scale, causal,
                              window, softcap, stream);
    case 2:
      return launch_dp<T, 128>(q, k, v, o, d, B, S, Hq, Hkv, scale, causal,
                               window, softcap, stream);
    case 3:
      return launch_dp<T, 192>(q, k, v, o, d, B, S, Hq, Hkv, scale, causal,
                               window, softcap, stream);
    default:
      return launch_dp<T, 256>(q, k, v, o, d, B, S, Hq, Hkv, scale, causal,
                               window, softcap, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d a multiple of 8 up to 256. Returns
// the cudaError_t of the launch (0 on success), or -1 for a head dim or
// dtype the kernel does not take.
extern "C" int flash_attention_launch(int dtype, int d, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int S, int Hq, int Hkv,
                                      float scale, int causal, int window,
                                      float softcap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, B, S, Hq, Hkv, scale, causal,
                           window, softcap, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, B, S, Hq, Hkv, scale,
                                   causal, window, softcap, st);
  return -1;
}
