// Scheduled block-sparse min-plus tile product at bs 64 and 128 for Hopper
// (sm_90a): the "minplus" route of bsr_spgemm.
//
// Replaces src/repro/kernels/bsr_spgemm/kernel.py::bsr_spgemm_pallas (body
// _kernel) for the min_plus semiring at bs 64 and 128. For every product s
// of the schedule window,
//
//     C[c_slot[s]] = min(C[c_slot[s]], min_k A[a_slot[s]][:, k] + B[b_slot[s]][k, :])
//
// in the NaN-propagating min of jnp.minimum (min.NaN): a run of products
// sharing an output tile starts from +inf, and every slot no run writes
// holds +inf. The host turns the first-visit flags into run starts once per
// plan (kernel.py::run_starts_from_flags); pad products are left out of
// them and never computed.
//
// Bound. Min-plus has no tensor-core form: each term is an fp32 add and a
// min, two instructions at the CUDA cores' rate, 2 bs^3 a product, i.e.
// 66.9 TFLOP/s / 2 = 33.5 T instructions/s on an H100 SXM. At banded_
// clustered(65536, 64, 16)'s largest bs-64 launch (1,295 products) that is
// 0.0203 ms, against 0.0075 ms for its bytes: the kernel is bound by
// operations, and its runs are short (1-4 products).
//
// Design for that bound.
//  * Exact in any order: each a + b is one rounding and min is order-free
//    (a NaN counts as any NaN), so a product's k range may be split and the
//    pieces combined by min, bitwise equal to the plain version. The unit of
//    work is a k-panel (32 deep; 2 a product at bs 64, 4 at bs 128).
//  * Balance panels, not runs: CTAS CTAs an SM, persistent, worker w of G
//    taking panels [w U / G, (w + 1) U / G) of the window's U (a window of
//    fewer panels than workers: one panel each), so the launch ends when
//    its average worker does. A run cut by a share boundary is
//    written by the share holding its first panel; every later share that
//    holds a piece of it leaves its piece in `partials` (at most one a
//    share: its first run) and names the run in `heads`. A second small
//    kernel (combine) mins those pieces into the output: one CTA per cut run,
//    the one of its first head share, each thread holding its part of the
//    tile in registers while it reads every piece. No atomics: a repeated
//    launch is bitwise equal.
//  * A cp.async ring of raw k-panels, STAGES deep, that crosses product and
//    run boundaries: panel i + STAGES - 1 loads while panel i is computed.
//    Two stages were as fast as three on the card, or faster.
//    A lands row-major at a pitch of 36 floats, so the rows a warp reads at
//    once sit in distinct banks and are read along k as 16-byte (bs 64) or
//    8-byte (bs 128) vectors; B lands row-major as it lies.
//  * Register blocking: thread (ty, tx) of a 16 x TX grid owns rows ty + 16 i
//    (TM of them) and columns 4 tx + 4 TX g + v (TN = 8): each float it reads
//    from shared memory feeds 8 (B) or TM (A) terms. At bs 128 a thread holds
//    64 accumulators, and A is read two k a time to stay within 128
//    registers, two CTAs an SM.
//  * The identity fill inside the kernel, as the tc and warp routes do it:
//    each warp fills its share of the slots no run writes (tile_rules.cuh's
//    fill_gaps) while its first panels land, also in a window of pad
//    products only (no run), so the wrapper fills nothing.
//
// Requirements: tile stacks contiguous float32, 16-byte aligned, slots and
// run starts int32 (checked by the wrapper); and, as the schedule builds
// them, run_starts strictly increasing, c_slot nondecreasing over the
// window and below nc; partials (G, bs, bs) float32 and heads (G,) int32
// of scratch, G the worker count the launch is given.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_rules.cuh"

namespace {

constexpr int BK = 32;       // depth of a k-panel
constexpr int TY = 16;       // thread rows: thread (ty, tx) owns rows ty + 16 i
constexpr int COMBINE_THREADS = 256;

template <int BS>
struct Cfg {
  static constexpr int TX = BS == 128 ? 16 : 8;       // thread columns
  static constexpr int THREADS = TY * TX;             // 256 / 128
  static constexpr int WARPS = THREADS / 32;
  static constexpr int CTAS = BS == 128 ? 2 : 4;      // CTAs an SM
  static constexpr int TM = BS / TY;                  // rows a thread: 8 / 4
  static constexpr int TN = BS / TX;                  // columns a thread: 8
  static constexpr int NG = TN / 4;                   // float4 column groups
  static constexpr int AV = BS == 128 ? 2 : 4;        // k read per A vector
  static constexpr int KP = BS / BK;                  // panels a product
  static constexpr int STAGES = 2;
  static constexpr int APITCH = BK + 4;               // floats a row of A
  static constexpr int A_FLOATS = BS * APITCH;
  static constexpr int STAGE = A_FLOATS + BK * BS;    // A, then B
  static constexpr int SMEM = STAGES * STAGE * 4;
  static constexpr int CHUNKS = BS * BK / 4;          // 16 B chunks an operand
  static_assert(CHUNKS % THREADS == 0, "every thread loads alike");
  static_assert(TN % 4 == 0 && TM * TY == BS && TN * TX == BS,
                "the threads cover the tile");
  // bs 128: 2 x 68 KB; bs 64: 4 x 34 KB, of the SM's 228 KB (1 KB a CTA
  // reserved)
  static_assert(CTAS * (SMEM + 1024) <= 233472, "shared memory past the SM's");
};

// First panel of worker w's share of U panels among G workers: the first
// min(G, U) workers take equal shares, one panel or more each, and the rest
// none (they fill gaps only), so a run's pieces lie in consecutive shares.
__device__ __forceinline__ long long share_start(int w, int g, long long u) {
  const int n = u < g ? static_cast<int>(u) : g;
  return w >= n ? u : static_cast<long long>(w) * u / n;
}

// Panel kp of product (a, b) into a ring stage: A[:, 32 kp : 32 kp + 32]
// at a row pitch of APITCH, B[32 kp : 32 kp + 32, :] as it lies.
template <int BS>
__device__ __forceinline__ void load_panel(float* stage,
                                           const float* a_tiles,
                                           const float* b_tiles, int a, int b,
                                           int kp, int tid) {
  using C = Cfg<BS>;
  const float* ga = a_tiles + static_cast<size_t>(a) * BS * BS + kp * BK;
  const float* gb = b_tiles + (static_cast<size_t>(b) * BS + kp * BK) * BS;
  float* sb = stage + C::A_FLOATS;
#pragma unroll
  for (int j = 0; j < C::CHUNKS / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
    cp_async16(stage + r * C::APITCH + c, ga + r * BS + c);
    cp_async16(sb + 4 * i, gb + 4 * i);
  }
}

// The loads' walk: the next panel to load, and its product's tiles (read
// one panel ahead of their use).
struct Loader {
  long long u, end;
  int a, b;
};

// Issue the next panel of the share into `stage` (if any is left) and
// commit a group either way, so group i is always panel i.
template <int BS>
__device__ __forceinline__ void load_next(Loader& ld, float* stage,
                                          const float* a_tiles,
                                          const float* b_tiles,
                                          const int* a_slot,
                                          const int* b_slot, int rs0,
                                          int tid) {
  constexpr int KP = Cfg<BS>::KP;
  if (ld.u < ld.end) {
    load_panel<BS>(stage, a_tiles, b_tiles, ld.a, ld.b,
                   static_cast<int>(ld.u % KP), tid);
    if (++ld.u < ld.end && ld.u % KP == 0) {
      const int p = rs0 + static_cast<int>(ld.u / KP);
      ld.a = a_slot[p];
      ld.b = b_slot[p];
    }
  }
  cp_async_commit();
}

template <int N>
__device__ __forceinline__ void load_vec(const float* src, float (&dst)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  }
}

// acc[i][j] = min(acc[i][j], A[row i][k] + B[k][col j]) over the panel's
// 32 k, in order (any order gives the same bits).
template <int BS>
__device__ __forceinline__ void mp_panel(
    float (&acc)[Cfg<BS>::TM][Cfg<BS>::TN], const float* stage, int ty,
    int tx) {
  using C = Cfg<BS>;
  const float* sa = stage + ty * C::APITCH;
  const float* sb = stage + C::A_FLOATS + 4 * tx;
#pragma unroll 1
  for (int k0 = 0; k0 < BK; k0 += C::AV) {
    float av[C::TM][C::AV];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      load_vec(sa + i * TY * C::APITCH + k0, av[i]);
#pragma unroll
    for (int kk = 0; kk < C::AV; ++kk) {
      float bv[C::TN];
#pragma unroll
      for (int g = 0; g < C::NG; ++g) {
        float v[4];
        load_vec(sb + (k0 + kk) * BS + g * C::TX * 4, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[4 * g + e] = v[e];
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = min_nan(acc[i][j], av[i][kk] + bv[j]);
    }
  }
}

template <int BS>
__device__ __forceinline__ void reset(float (&acc)[Cfg<BS>::TM][Cfg<BS>::TN]) {
#pragma unroll
  for (int i = 0; i < Cfg<BS>::TM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg<BS>::TN; ++j) acc[i][j] = INFINITY;
}

// This thread's outputs into `tile`: streamed past L2 for a finished run,
// plain (kept in L2 for the combine) for a piece of a cut run.
template <int BS>
__device__ __forceinline__ void store_tile(
    const float (&acc)[Cfg<BS>::TM][Cfg<BS>::TN], float* tile, int ty,
    int tx, bool stream) {
  using C = Cfg<BS>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      float4* dst = reinterpret_cast<float4*>(
          tile + (ty + TY * i) * BS + g * C::TX * 4 + 4 * tx);
      const float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                   acc[i][4 * g + 2], acc[i][4 * g + 3]);
      if (stream) __stcs(dst, v);
      else *dst = v;
    }
}

template <int BS>
__global__ void __launch_bounds__(Cfg<BS>::THREADS, Cfg<BS>::CTAS)
bsr_spgemm_minplus_kernel(const float* __restrict__ a_tiles,
                          const float* __restrict__ b_tiles,
                          const int* __restrict__ a_slot,
                          const int* __restrict__ b_slot,
                          const int* __restrict__ c_slot,
                          const int* __restrict__ run_starts, int nruns,
                          int nc, float* __restrict__ out,
                          float* __restrict__ partials,
                          int* __restrict__ heads) {
  using C = Cfg<BS>;
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid % C::TX, ty = tid / C::TX;
  const int w = static_cast<int>(blockIdx.x);
  const int g = static_cast<int>(gridDim.x);
  const int rs0 = run_starts[0];
  const long long total = static_cast<long long>(run_starts[nruns] - rs0)
                          * C::KP;
  const long long u0 = share_start(w, g, total);
  const long long u1 = share_start(w + 1, g, total);
  const int n = static_cast<int>(u1 - u0);

  // the first panels load while the share's first run is found and the
  // gaps are filled
  Loader ld{u0, u1, 0, 0};
  if (n > 0) {
    const int p = rs0 + static_cast<int>(u0 / C::KP);
    ld.a = a_slot[p];
    ld.b = b_slot[p];
  }
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s)
    load_next<BS>(ld, ring + s * C::STAGE, a_tiles, b_tiles, a_slot, b_slot,
                  rs0, tid);
  // run r holds the share's first panel; a share that starts inside it
  // (head) leaves that run's piece in partials[w]
  int r = 0, rs_r = 0, rs_r1 = 0, c_out = 0;
  bool head = false;
  if (n > 0) {
    const int p = rs0 + static_cast<int>(u0 / C::KP);
    r = warp_lower_bound([&](int q) { return run_starts[q]; }, nruns, p + 1,
                         lane) - 1;
    rs_r = run_starts[r];
    rs_r1 = run_starts[r + 1];
    c_out = c_slot[rs_r];
    head = static_cast<long long>(rs_r - rs0) * C::KP < u0;
  }
  if (tid == 0) heads[w] = head ? r : -1;
  fill_gaps<BS>(out, c_slot, run_starts, nruns, nc, INFINITY,
                w * C::WARPS + tid / 32, g * C::WARPS, lane);
  if (n == 0) return;

  float acc[C::TM][C::TN];
  reset<BS>(acc);
  bool first = true;                      // in the share's first run
  for (int i = 0; i < n; ++i) {
    // panel i has landed for every thread; every thread is past panel
    // i - 1, whose stage the next load takes
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    load_next<BS>(ld, ring + ((i + C::STAGES - 1) % C::STAGES) * C::STAGE,
                  a_tiles, b_tiles, a_slot, b_slot, rs0, tid);
    mp_panel<BS>(acc, ring + (i % C::STAGES) * C::STAGE, ty, tx);
    const long long u = u0 + i + 1;       // panels done
    const long long run_end = static_cast<long long>(rs_r1 - rs0) * C::KP;
    if (u == run_end || u == u1) {
      if (first && head)
        store_tile<BS>(acc, partials + static_cast<size_t>(w) * BS * BS, ty,
                       tx, false);
      else
        store_tile<BS>(acc, out + static_cast<size_t>(c_out) * BS * BS, ty,
                       tx, run_end <= u1);
      reset<BS>(acc);
      first = false;
      if (u < u1) {
        ++r;
        rs_r = rs_r1;
        rs_r1 = run_starts[r + 1];
        c_out = c_slot[rs_r];
      }
    }
  }
}

// For each run cut by a share boundary: its output (written by the share
// holding its first panel) min its pieces in partials (one per later share
// that holds a piece, each naming the run in heads). CTA w works where
// share w left the run's first piece; each thread keeps PER float4 of the
// tile in registers and loads them from each piece at once.
template <int BS>
__global__ void __launch_bounds__(COMBINE_THREADS)
bsr_spgemm_minplus_combine(const int* __restrict__ c_slot,
                           const int* __restrict__ run_starts, int nruns,
                           const float* __restrict__ partials,
                           const int* __restrict__ heads,
                           float* __restrict__ out) {
  constexpr int KP = Cfg<BS>::KP;
  constexpr int PER = BS * BS / 4 / COMBINE_THREADS;
  const int w = static_cast<int>(blockIdx.x);
  const int g = static_cast<int>(gridDim.x);
  const int r = heads[w];
  if (r < 0) return;
  const int rs0 = run_starts[0];
  const long long total = static_cast<long long>(run_starts[nruns] - rs0)
                          * KP;
  const long long r0 = static_cast<long long>(run_starts[r] - rs0) * KP;
  const long long r1 = static_cast<long long>(run_starts[r + 1] - rs0) * KP;
  for (int x = w - 1; x >= 0 && share_start(x, g, total) > r0; --x)
    if (heads[x] == r) return;            // an earlier piece: its CTA combines
  float4* tile = reinterpret_cast<float4*>(
      out + static_cast<size_t>(c_slot[run_starts[r]]) * BS * BS)
      + threadIdx.x;
  float4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = tile[j * COMBINE_THREADS];
  for (int x = w; x < g && share_start(x, g, total) < r1; ++x) {
    if (heads[x] != r) continue;
    const float4* piece = reinterpret_cast<const float4*>(
        partials + static_cast<size_t>(x) * BS * BS) + threadIdx.x;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float4 q = piece[j * COMBINE_THREADS];
      v[j] = make_float4(min_nan(v[j].x, q.x), min_nan(v[j].y, q.y),
                         min_nan(v[j].z, q.z), min_nan(v[j].w, q.w));
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) __stcs(tile + j * COMBINE_THREADS, v[j]);
}

template <int BS>
int worker_count() {
  using C = Cfg<BS>;
  auto kern = bsr_spgemm_minplus_kernel<BS>;
  cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (st == cudaSuccess) st = cudaGetDevice(&dev);
  if (st == cudaSuccess)
    st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                       C::THREADS, C::SMEM);
  if (st != cudaSuccess) return -static_cast<int>(st);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * (per_sm < C::CTAS ? per_sm : C::CTAS);
}

template <int BS>
int launch(const float* a, const float* b, const int* a_slot,
           const int* b_slot, const int* c_slot, const int* run_starts,
           int nruns, float* c, int nc, float* partials, int* heads, int g,
           cudaStream_t stream) {
  using C = Cfg<BS>;
  auto kern = bsr_spgemm_minplus_kernel<BS>;
  cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (st != cudaSuccess) return (int)st;
  kern<<<g, C::THREADS, C::SMEM, stream>>>(a, b, a_slot, b_slot, c_slot,
                                           run_starts, nruns, nc, c,
                                           partials, heads);
  st = cudaGetLastError();
  if (st != cudaSuccess || nruns == 0) return (int)st;
  bsr_spgemm_minplus_combine<BS><<<g, COMBINE_THREADS, 0, stream>>>(
      c_slot, run_starts, nruns, partials, heads, c);
  return (int)cudaGetLastError();
}

}  // namespace

// bs 64 or 128. a_tiles (na, bs, bs), b_tiles (nb, bs, bs), c_tiles (nc, bs,
// bs); run_starts holds nruns + 1 absolute schedule positions (the last is
// the end of the window's real products). partials (workers, bs, bs) float32
// and heads (workers,) int32 are scratch; workers (the grid) is best
// bsr_spgemm_minplus_workers(bs). Every slot of c_tiles is written: run
// outputs, and +inf elsewhere (everywhere when nruns is 0). Two kernels
// run on the stream, the product and, when there are runs, the combine.
// Returns the cudaError_t of the launches (0 on success; nothing is launched
// when nc is 0), -1 for arguments the kernel does not take.
extern "C" int bsr_spgemm_minplus_launch(int bs, const void* a_tiles,
                                         const void* b_tiles,
                                         const void* a_slot,
                                         const void* b_slot,
                                         const void* c_slot,
                                         const void* run_starts, int nruns,
                                         void* c_tiles, int nc,
                                         void* partials, void* heads,
                                         int workers, void* stream) {
  if (nc <= 0) return 0;
  if (nruns < 0 || nruns > nc || workers <= 0) return -1;
  const auto* a = static_cast<const float*>(a_tiles);
  const auto* b = static_cast<const float*>(b_tiles);
  const auto* as = static_cast<const int*>(a_slot);
  const auto* bsl = static_cast<const int*>(b_slot);
  const auto* cs = static_cast<const int*>(c_slot);
  const auto* rs = static_cast<const int*>(run_starts);
  auto* c = static_cast<float*>(c_tiles);
  auto* part = static_cast<float*>(partials);
  auto* hd = static_cast<int*>(heads);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bs == 64)
    return launch<64>(a, b, as, bsl, cs, rs, nruns, c, nc, part, hd, workers,
                      st);
  if (bs == 128)
    return launch<128>(a, b, as, bsl, cs, rs, nruns, c, nc, part, hd, workers,
                       st);
  return -1;
}

// The workers of a launch at bs on the current device: CTAs an SM (at most
// Cfg::CTAS, as many as fit) times the SMs; minus the cudaError_t on a
// failed query, -1 for another bs.
extern "C" int bsr_spgemm_minplus_workers(int bs) {
  return bs == 64 ? worker_count<64>() : bs == 128 ? worker_count<128>() : -1;
}

// Dynamic shared memory, in bytes, of a launch at bs (0 for another bs).
extern "C" int bsr_spgemm_minplus_smem_bytes(int bs) {
  return bs == 64 ? Cfg<64>::SMEM : bs == 128 ? Cfg<128>::SMEM : 0;
}
