// Scheduled block-sparse semiring tile product for Hopper (sm_90a), on the
// CUDA cores: the "simt" route of bsr_spgemm. The wrapper (kernel.py::route)
// sends min_plus at bs 64 and 128 here; plus_times and bool_or_and at bs 64
// and 128 run on the tensor cores (bsr_spgemm_tc.cu), every semiring at bs
// 16 and 32 on bsr_spgemm_warp.cu. This kernel instantiates every semiring
// at every bs (the earlier kernel, timed beside the others).
//
// Replaces src/repro/kernels/bsr_spgemm/kernel.py::bsr_spgemm_pallas.
// For every product s of the schedule window,
//
//     C[c_slot[s]]  (+)=  A[a_slot[s]] (x) B[b_slot[s]]        (bs x bs tiles)
//
// over one of three semirings. The schedule is sorted by output slot, so the
// products that share an output tile form one contiguous run; the host turns
// the first-visit flags (bit 0) into run starts once per plan.
//
// Work division: the Pallas grid walks the schedule serially on one core.
// Here each run of products goes to one thread block (CTA). The CTA loops
// over its run in order, streams k-panels of A and B through shared memory,
// keeps the bs x bs accumulator in registers (256 threads; at bs=128 each
// thread owns an 8x8 sub-tile, 64 floats), resets it to the semiring's
// identity at the run start and writes the output tile once at the run end.
// Blocks run independently: no output tile is written by two CTAs, so there
// are no atomics. Pad products target the trailing garbage slot exactly as
// in the Pallas kernel and are computed like any other run.
//
// Bound: at bs=128 every product is 2*128^3 = 4.2 MFLOP against at most
// 3 * 64 KiB of tile traffic, so the kernel is compute-bound on fp32 FMAs on
// the CUDA cores (plus-times and bool use fp32 FMA / compare, min-plus the
// same sequential-k min(acc, a + b) as the reference's rank-1 combine, in
// the NaN-propagating min of jnp.minimum and torch.minimum; no
// tensor cores and no TF32, so integer-valued inputs stay exact). The design
// answers that bound only with register blocking: each shared-memory value a
// thread reads feeds TM fused operations.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda_runtime.h>
#include <math.h>

#include "tile_rules.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid over the output tile

struct PlusTimes {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float combine(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
};

struct BoolOrAnd {
  // booleans are {0, 1}: or == max, and == (a != 0 && b != 0)
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float combine(float acc, float a, float b) {
    return fmaxf(acc, (a != 0.0f && b != 0.0f) ? 1.0f : 0.0f);
  }
};

struct MinPlus {
  static __device__ __forceinline__ float zero() { return INFINITY; }
  static __device__ __forceinline__ float combine(float acc, float a, float b) {
    return min_nan(acc, a + b);
  }
};

// V consecutive floats between registers and memory (V in {1, 2, 4}).
template <int V>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = src[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// One CTA per run [run_starts[r], run_starts[r+1]) of products sharing an
// output slot.
template <int BS, class Op>
__global__ void __launch_bounds__(kThreads)
bsr_spgemm_kernel(const float* __restrict__ a_tiles,
                  const float* __restrict__ b_tiles,
                  const int* __restrict__ a_slot,
                  const int* __restrict__ b_slot,
                  const int* __restrict__ c_slot,
                  const int* __restrict__ run_starts,
                  float* __restrict__ c_tiles) {
  constexpr int TM = BS / 16;           // rows (and cols) a thread owns
  constexpr int V = TM < 4 ? TM : 4;    // width of one vector access
  constexpr int G = TM / V;             // vector groups per thread and axis
  constexpr int SPAN = 16 * V;          // elements one group spans
  constexpr int BK = BS < 32 ? BS : 32; // depth of one k-panel
  constexpr int APAD = 4;               // keeps As rows 16-byte aligned

  // A's panel is stored transposed (As[k][row]) so that both operands are
  // read along k as contiguous vectors.
  __shared__ __align__(16) float As[BK][BS + APAD];
  __shared__ __align__(16) float Bs[BK][BS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int p0 = run_starts[blockIdx.x];
  const int p1 = run_starts[blockIdx.x + 1];

  // thread (ty, tx) owns rows g*SPAN + ty*V + v and the same pattern of cols
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = Op::zero();

  for (int p = p0; p < p1; ++p) {
    const float* A = a_tiles + static_cast<size_t>(a_slot[p]) * BS * BS;
    const float* B = b_tiles + static_cast<size_t>(b_slot[p]) * BS * BS;
    for (int k0 = 0; k0 < BS; k0 += BK) {
      __syncthreads();  // every thread is done with the previous panel
      for (int e = tid; e < BS * BK / 4; e += kThreads) {
        const int r = e / (BK / 4);
        const int q = e % (BK / 4);
        const float4 v = *reinterpret_cast<const float4*>(A + r * BS + k0 + 4 * q);
        As[4 * q + 0][r] = v.x;
        As[4 * q + 1][r] = v.y;
        As[4 * q + 2][r] = v.z;
        As[4 * q + 3][r] = v.w;
      }
      for (int e = tid; e < BK * BS / 4; e += kThreads) {
        const int kk = e / (BS / 4);
        const int q = e % (BS / 4);
        *reinterpret_cast<float4*>(&Bs[kk][4 * q]) =
            *reinterpret_cast<const float4*>(B + (k0 + kk) * BS + 4 * q);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TM];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          load_vec<V>(&As[kk][g * SPAN + ty * V], &av[g * V]);
          load_vec<V>(&Bs[kk][g * SPAN + tx * V], &bv[g * V]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j)
            acc[i][j] = Op::combine(acc[i][j], av[i], bv[j]);
      }
    }
  }

  float* C = c_tiles + static_cast<size_t>(c_slot[p0]) * BS * BS;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = (i / V) * SPAN + ty * V + (i % V);
#pragma unroll
    for (int g = 0; g < G; ++g)
      store_vec<V>(C + row * BS + g * SPAN + tx * V, &acc[i][g * V]);
  }
}

template <class Op>
cudaError_t launch_bs(int bs, dim3 grid, cudaStream_t stream, const float* a,
                      const float* b, const int* a_slot, const int* b_slot,
                      const int* c_slot, const int* run_starts, float* c) {
  switch (bs) {
    case 16:
      bsr_spgemm_kernel<16, Op><<<grid, kThreads, 0, stream>>>(
          a, b, a_slot, b_slot, c_slot, run_starts, c);
      break;
    case 32:
      bsr_spgemm_kernel<32, Op><<<grid, kThreads, 0, stream>>>(
          a, b, a_slot, b_slot, c_slot, run_starts, c);
      break;
    case 64:
      bsr_spgemm_kernel<64, Op><<<grid, kThreads, 0, stream>>>(
          a, b, a_slot, b_slot, c_slot, run_starts, c);
      break;
    case 128:
      bsr_spgemm_kernel<128, Op><<<grid, kThreads, 0, stream>>>(
          a, b, a_slot, b_slot, c_slot, run_starts, c);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// semiring: 0 plus_times, 1 bool_or_and, 2 min_plus. bs in {16, 32, 64, 128}.
// run_starts holds nruns + 1 absolute schedule positions (the last is the
// window's end). Returns the cudaError_t of the launch (0 on success).
extern "C" int bsr_spgemm_launch(int semiring, int bs, const void* a_tiles,
                                 const void* b_tiles, const void* a_slot,
                                 const void* b_slot, const void* c_slot,
                                 const void* run_starts, int nruns,
                                 void* c_tiles, void* stream) {
  if (nruns <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(nruns));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(a_tiles);
  const auto* b = static_cast<const float*>(b_tiles);
  const auto* as = static_cast<const int*>(a_slot);
  const auto* bsl = static_cast<const int*>(b_slot);
  const auto* cs = static_cast<const int*>(c_slot);
  const auto* rs = static_cast<const int*>(run_starts);
  auto* c = static_cast<float*>(c_tiles);
  switch (semiring) {
    case 0:
      return launch_bs<PlusTimes>(bs, grid, s, a, b, as, bsl, cs, rs, c);
    case 1:
      return launch_bs<BoolOrAnd>(bs, grid, s, a, b, as, bsl, cs, rs, c);
    case 2:
      return launch_bs<MinPlus>(bs, grid, s, a, b, as, bsl, cs, rs, c);
    default:
      return cudaErrorInvalidValue;
  }
}
