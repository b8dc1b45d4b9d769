// Scheduled block-sparse tile product at bs 16 and 32 for Hopper (sm_90a):
// the "warp" route of bsr_spgemm, for all three semirings.
//
// Replaces src/repro/kernels/bsr_spgemm/kernel.py::bsr_spgemm_pallas (body
// _kernel) at the tile sizes the session and its apps use by default. For
// every product s of the schedule window,
//
//     C[c_slot[s]]  (+)=  A[a_slot[s]] (x) B[b_slot[s]]        (bs x bs tiles)
//
// The schedule is sorted by output slot, so the products that share an
// output tile form one run; the host turns the first-visit flags into run
// starts once per plan (kernel.py::run_starts_from_flags). Every output tile
// a run targets is written once, by one warp; every other slot in [0, nc) is
// written once with the semiring's identity by this kernel too, so the
// wrapper fills nothing. No atomics: a repeated launch is bitwise equal.
//
// Bound. At the session's default (laplacian_2d(1024)^2, the 1D ring with 8
// parts, bs 32) part 0's launch holds 99,812 products in 51,810 runs, 1.93
// a run: 166 MB of distinct tiles read and 213 MB of output written, 0.113 ms
// at 3.35 TB/s. Its fp32 work (6.54 GFLOP) would take 0.098 ms at the CUDA
// cores' peak, one TF32 pass 0.013 ms. On the tensor cores the kernel is
// bound by bytes, and more than half of them are the output: an identity fill
// by the wrapper before the launch would write it a second time. Past the
// bound, each product reads its two tiles from L2 (817 MB at part 0, every
// distinct tile about 4.9 times); on the card that traffic, not the
// arithmetic, is what the kernel waits on.
//
// Design for that bound.
//  * One warp per run. wgmma's 64-row tile does not fit a 16- or 32-row
//    output, and a run holds about two products, so a CTA per run (the simt
//    route) has each of 256 threads own 2 x 2 outputs and feed one FMA per
//    float it reads. Here a warp holds a run's whole output tile in
//    mma.sync fragments (32 fp32 a lane at bs 32, 8 at bs 16).
//  * Persistent warps, 8 a CTA and as many CTAs as fit: global warp w takes
//    runs w, w + W, w + 2W, ..., so the whole grid moves through the
//    schedule together and the tiles that neighbouring runs share (at part
//    0, a B tile recurs within 8 products 80 % of the time) are L2 hits.
//  * A cp.async ring per warp, each stage one product's A and B tiles (2 x 4
//    KB at bs 32, 3 stages; 2 x 1 KB at bs 16, 4 stages), kept full across
//    the warp's run boundaries: 16 KB a warp, 128 KB an SM in flight at bs
//    32 while one product is computed (Little's law at 3.35 TB/s asks about
//    25 KB an SM). The copies bypass L1 (.cg): the ring leaves L1 too little
//    room to hold a tile until a neighbour needs it. Tiles land with their
//    16-byte chunks XOR-permuted per row (at()), so every fragment read hits
//    32 distinct banks. 8 warps of 3 stages fill the shared memory at bs 32;
//    fewer warps with deeper rings were slower on the card.
//  * plus_times and bool_or_and on the tensor cores, mma.sync m16n8k8 tf32
//    with an fp32 accumulator, in the tc route's arithmetic (tile_rules.cuh;
//    ref.bsr_spgemm_tc_model is its CPU model). A product is one k-panel
//    (bs <= 32). Its operands are checked while their fragments load: one not
//    TF32-exact (13 low bits set somewhere) is split into hi + lo in
//    registers and its lo passes run, lo terms before hi.hi; integer payloads
//    run one pass and stay bitwise equal to the plain version. A product
//    holding an infinity, a NaN or an |x| >= 2^127, or whose largest A and
//    B magnitudes multiply to 2^126 or more (where hi.hi could overflow and
//    the fp32 product would not; tile_rules.cuh's unsplit_panel), is summed
//    unsplit in IEEE fp32 on the CUDA cores, as in the plain version. The
//    tensor core truncates its accumulate, so each product sums into a fresh
//    accumulator and the run adds its products in IEEE fp32, starting from
//    its first (no literal identity is added); a zero result is stored as
//    +0. bool booleanizes (x != 0 -> 1), sums and clips to 1 at the run's
//    end: every term is >= 0, so this equals the plain version's max of
//    clipped products.
//  * min_plus on the CUDA cores: a lane owns 2 x 8 outputs at bs 32 (2 x 4
//    at bs 16), so each float it reads feeds 8 (4) combines, in the
//    NaN-propagating min of torch.minimum (min.NaN; fminf drops a NaN). It
//    runs an add and a min per term, 2 bs^3 instructions a product, so at
//    bs 32 two warps take each run (split_of), each its 16 rows of the
//    output from its 16 rows of A, to spread a launch's longest runs.
//  * The identity fill in the kernel: each warp takes an equal share of the
//    slots [0, nc), finds its first run by a 32-way search over the run
//    slots and writes the identity into every slot of its share that no run
//    writes, while its first products load (tile_rules.cuh's fill_gaps). A
//    window of pad products only (no run) gets every slot filled.
//
// Requirements: tile stacks contiguous float32, 16-byte aligned, slots and
// run starts int32 (checked by the wrapper); and, as the schedule builds
// them, run_starts strictly increasing, c_slot nondecreasing over the window
// and below nc.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tile_rules.cuh"

namespace {

constexpr int WARPS = 8;               // warps a CTA
constexpr int THREADS = WARPS * 32;

// Warps that share one run, each its BS / SPLIT rows of the output: two for
// min-plus at bs 32 (the header's design notes), one elsewhere.
template <int BS, int SR>
__host__ __device__ constexpr int split_of() {
  return SR == 2 && BS == 32 ? 2 : 1;
}

template <int BS>
struct Cfg {
  static constexpr int STAGES = BS == 32 ? 3 : 4;
  static constexpr int MIN_BLOCKS = BS == 32 ? 1 : 3;
  static constexpr int TILE = BS * BS;               // floats
  static constexpr int STAGE = 2 * TILE;             // A, then B
  static constexpr int SMEM = WARPS * STAGES * STAGE * 4;
  static constexpr int MT = BS / 16;                 // m16 fragment rows
  static constexpr int NT = BS / 8;                  // n8 fragment columns
  static constexpr int KS = BS / 8;                  // k8 steps
  static constexpr int NACC = BS * BS / 32;          // outputs a lane
  static_assert(NACC == MT * NT * 4, "the fragments cover the tile");
  // bs 32: 8 warps x 3 x 8 KB = 192 KB, 1 CTA an SM;
  // bs 16: 8 warps x 4 x 2 KB = 64 KB, 3 CTAs an SM
  static_assert(SMEM * MIN_BLOCKS <= 232448, "shared memory past the SM's");
};

// Word offset of element (r, c) of a staged tile: each row's 16-byte chunks
// XOR-permuted. An A fragment reads rows g and g + 8 (g = lane / 4) at
// columns t and t + 4 (t = lane % 4): the permutation by the row bits its 8
// rows vary spreads them over all 32 banks. A B fragment reads rows t and
// t + 4 at columns g: the permutation by the bits its 4 rows vary, one bit
// up, keeps the two chunks that 8 columns span apart.
template <int BS, bool B_SIDE>
__device__ __forceinline__ int at(int r, int c) {
  int x;
  if constexpr (B_SIDE)
    x = BS == 32 ? (r & 3) << 1 : ((r >> 1) & 1) << 1;
  else
    x = BS == 32 ? r & 7 : (r >> 1) & 3;
  return r * BS + (((c >> 2) ^ x) << 2) + (c & 3);
}

// One product's B tile and the rows [row0, row0 + BS / SPLIT) of its A
// tile into a ring stage, 16 bytes a lane at a time.
template <int BS, int SPLIT>
__device__ __forceinline__ void load_product(float* stage,
                                             const float* a_tiles,
                                             const float* b_tiles, int a,
                                             int b, int row0, int lane) {
  const float* ga = a_tiles + (static_cast<size_t>(a) * BS + row0) * BS;
  const float* gb = b_tiles + static_cast<size_t>(b) * BS * BS;
#pragma unroll
  for (int j = 0; j < BS * BS / 128; ++j) {
    const int i = lane + 32 * j;                     // 16-byte chunk
    const int r = i / (BS / 4), c = 4 * (i % (BS / 4));
    if (j < BS * BS / 128 / SPLIT)
      cp_async16(stage + at<BS, false>(row0 + r, c), ga + 4 * i);
    cp_async16(stage + BS * BS + at<BS, true>(r, c), gb + 4 * i);
  }
}

// A warp's walk over its runs, one product at a time: run r (products
// [p0, p1)), product p. Runs r, r + stride, ... belong to the warp.
struct Walk {
  int r, p0, p, p1;
};

__device__ __forceinline__ bool step(Walk& w, const int* run_starts,
                                     int nruns, int stride) {
  if (++w.p < w.p1) return true;
  for (w.r += stride; w.r < nruns; w.r += stride) {
    w.p0 = w.p = run_starts[w.r];
    w.p1 = run_starts[w.r + 1];
    if (w.p < w.p1) return true;
  }
  return false;
}

__device__ __forceinline__ bool start(Walk& w, int warp, const int* run_starts,
                                      int nruns, int stride) {
  w.r = warp - stride;
  w.p0 = w.p = w.p1 = 0;
  return step(w, run_starts, nruns, stride);
}

// d (16 x 8) += A (16 x 8) * B (8 x 8), tf32 in, fp32 accumulate: each
// operand reads the top 19 bits of its fp32 word.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// One pass over the product's k-steps into d: A's part a times B's part b
// (each as it lies, or its hi or its lo part). Fragment (mt, ks) of A holds
// rows 16 mt + g (+ 8) at columns 8 ks + t (+ 4); fragment (nt, ks) of B
// rows 8 ks + t (+ 4) at column 8 nt + g.
template <int BS>
__device__ __forceinline__ void pass(
    float (&d)[Cfg<BS>::MT][Cfg<BS>::NT][4],
    const float (&a)[Cfg<BS>::MT][Cfg<BS>::KS][4],
    const float (&b)[Cfg<BS>::NT][Cfg<BS>::KS][2]) {
  using C = Cfg<BS>;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        mma_tf32(d[mt][nt], a[mt][ks], b[nt][ks][0], b[nt][ks][1]);
}

// Every element of a fragment set split in place into its hi part, with
// its lo part into `lo` (tile_rules.cuh's split).
template <int N, int M, int E>
__device__ __forceinline__ void split_all(float (&x)[N][M][E],
                                          float (&lo)[N][M][E]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int e = 0; e < E; ++e) split(x[n][m][e], x[n][m][e], lo[n][m][e]);
}

// A product the split cannot carry, on the CUDA cores in IEEE fp32 from the
// staged tiles, into the same fragment places as the passes.
template <int BS>
__device__ void fma_product(float (&d)[Cfg<BS>::MT][Cfg<BS>::NT][4],
                            const float* as, const float* bs, int g, int t) {
  using C = Cfg<BS>;
#pragma unroll 1
  for (int k = 0; k < BS; ++k) {
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const float a0 = as[at<BS, false>(16 * mt + g, k)];
      const float a1 = as[at<BS, false>(16 * mt + g + 8, k)];
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(
            bs + at<BS, true>(k, 8 * nt + 2 * t));
        d[mt][nt][0] = fmaf(a0, bv.x, d[mt][nt][0]);
        d[mt][nt][1] = fmaf(a0, bv.y, d[mt][nt][1]);
        d[mt][nt][2] = fmaf(a1, bv.x, d[mt][nt][2]);
        d[mt][nt][3] = fmaf(a1, bv.y, d[mt][nt][3]);
      }
    }
  }
}

// plus_times (BOOL false) or bool_or_and on the tensor cores: one staged
// product into a fresh accumulator, then into the run's sum `acc`.
template <int BS, bool BOOL>
__device__ __forceinline__ void tc_product(float (&acc)[Cfg<BS>::NACC],
                                           const float* stage, bool first,
                                           int lane) {
  using C = Cfg<BS>;
  const float* as = stage;
  const float* bs = stage + C::TILE;
  const int g = lane >> 2, t = lane & 3;
  float a[C::MT][C::KS][4], b[C::NT][C::KS][2];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[mt][ks][e] = as[at<BS, false>(16 * mt + g + 8 * (e & 1),
                                        8 * ks + t + 4 * (e >> 1))];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        b[nt][ks][e] = bs[at<BS, true>(8 * ks + t + 4 * e, 8 * nt + g)];

  // which operand is not TF32-exact (1: A, 2: B), or 4 for a product the
  // split must not take (unsplit_panel); uniform over the warp
  uint32_t flags = 0;
  if constexpr (BOOL) {
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[mt][ks][e] = a[mt][ks][e] != 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          b[nt][ks][e] = b[nt][ks][e] != 0.0f ? 1.0f : 0.0f;
  } else {
    uint32_t a_bits = 0, b_bits = 0;
    float a_mag = 0.0f, b_mag = 0.0f;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_bits |= __float_as_uint(a[mt][ks][e]);
          a_mag = max_nan(a_mag, fabsf(a[mt][ks][e]));
        }
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          b_bits |= __float_as_uint(b[nt][ks][e]);
          b_mag = max_nan(b_mag, fabsf(b[nt][ks][e]));
        }
    // the warp's largest magnitudes: the bits of a magnitude order as its
    // value, a NaN's above infinity's
    a_mag = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(a_mag)));
    b_mag = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(b_mag)));
    flags = ((a_bits & kTf32LowBits) ? 1u : 0u)
            | ((b_bits & kTf32LowBits) ? 2u : 0u);
    flags = __reduce_or_sync(FULL, flags)
            | (unsplit_panel(a_mag, b_mag) ? 4u : 0u);
  }

  float d[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][nt][e] = 0.0f;
  if (flags & 4u) {
    fma_product<BS>(d, as, bs, g, t);
  } else {
    // a flagged operand is split once, hi in place; the lo passes first
    float a_lo[C::MT][C::KS][4], b_lo[C::NT][C::KS][2];
    if (flags & 1u) split_all(a, a_lo);
    if (flags & 2u) split_all(b, b_lo);
    if (flags == 3u) pass<BS>(d, a_lo, b_lo);
    if (flags & 1u) pass<BS>(d, a_lo, b);
    if (flags & 2u) pass<BS>(d, a, b_lo);
    pass<BS>(d, a, b);
  }
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = acc[(mt * C::NT + nt) * 4 + e];
        x = first ? d[mt][nt][e] : x + d[mt][nt][e];
      }
}

// A finished run's tile from the fragments: lane (g, t) holds rows
// 16 mt + g (+ 8), columns 8 nt + 2 t (+ 1).
template <int BS, bool BOOL>
__device__ __forceinline__ void tc_store(const float (&acc)[Cfg<BS>::NACC],
                                         float* tile, int lane) {
  using C = Cfg<BS>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[(mt * C::NT + nt) * 4 + 2 * h + e];
          v[e] = BOOL ? fminf(x, 1.0f) : __fadd_rn(x, 0.0f);   // -0 -> +0
        }
        __stcs(reinterpret_cast<float2*>(
                   tile + (16 * mt + g + 8 * h) * BS + 8 * nt + 2 * t),
               make_float2(v[0], v[1]));
      }
}

// min_plus: of the run's rows [row0, row0 + BS / SPLIT), lane (rg, cg) =
// (lane % 8, lane / 8) owns rows row0 + rg + 8 i and columns (BS / 4) cg + j;
// acc[i * (BS / 4) + j], +inf at the run's start.
template <int BS, int SPLIT>
__device__ __forceinline__ void mp_product(float (&acc)[Cfg<BS>::NACC],
                                           const float* stage, bool first,
                                           int row0, int lane) {
  constexpr int MR = BS / 8 / SPLIT, NCOL = BS / 4;
  const float* as = stage;
  const float* bs = stage + BS * BS;
  const int rg = row0 + (lane & 7), cg = lane >> 3;
  if (first) {
#pragma unroll
    for (int i = 0; i < MR * NCOL; ++i) acc[i] = INFINITY;
  }
#pragma unroll
  for (int k4 = 0; k4 < BS / 4; ++k4) {
    float4 av[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          as + at<BS, false>(rg + 8 * i, 4 * k4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * k4 + kk;
      float bv[NCOL];
#pragma unroll
      for (int q = 0; q < NCOL / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + at<BS, true>(k, NCOL * cg + 4 * q));
        bv[4 * q] = v.x;
        bv[4 * q + 1] = v.y;
        bv[4 * q + 2] = v.z;
        bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < NCOL; ++j)
          acc[i * NCOL + j] = min_nan(acc[i * NCOL + j], ai + bv[j]);
      }
    }
  }
}

template <int BS, int SPLIT>
__device__ __forceinline__ void mp_store(const float (&acc)[Cfg<BS>::NACC],
                                         float* tile, int row0, int lane) {
  constexpr int MR = BS / 8 / SPLIT, NCOL = BS / 4;
  const int rg = row0 + (lane & 7), cg = lane >> 3;
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int q = 0; q < NCOL / 4; ++q) {
      const float* v = acc + i * NCOL + 4 * q;
      __stcs(reinterpret_cast<float4*>(tile + (rg + 8 * i) * BS + NCOL * cg
                                       + 4 * q),
             make_float4(v[0], v[1], v[2], v[3]));
    }
}

// SR: 0 plus_times, 1 bool_or_and, 2 min_plus.
template <int BS, int SR>
__global__ void __launch_bounds__(THREADS, Cfg<BS>::MIN_BLOCKS)
bsr_spgemm_warp_kernel(const float* __restrict__ a_tiles,
                       const float* __restrict__ b_tiles,
                       const int* __restrict__ a_slot,
                       const int* __restrict__ b_slot,
                       const int* __restrict__ c_slot,
                       const int* __restrict__ run_starts, int nruns, int nc,
                       float* __restrict__ out) {
  using C = Cfg<BS>;
  constexpr int SPLIT = split_of<BS, SR>();
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int warp = static_cast<int>(blockIdx.x) * WARPS + wid;
  const int nwarps = static_cast<int>(gridDim.x) * WARPS;
  // SPLIT consecutive warps take the same runs, each its share of the rows
  const int team = warp / SPLIT, nteams = nwarps / SPLIT;
  const int row0 = (warp % SPLIT) * (BS / SPLIT);
  float* ring = smem + wid * C::STAGES * C::STAGE;

  // the loads run STAGES - 1 products ahead of the computation, across the
  // warp's run boundaries; the gap fill runs while the first ones land
  Walk ld;
  bool loading = start(ld, team, run_starts, nruns, nteams);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (loading) {
      load_product<BS, SPLIT>(ring + s * C::STAGE, a_tiles, b_tiles,
                              a_slot[ld.p], b_slot[ld.p], row0, lane);
      loading = step(ld, run_starts, nruns, nteams);
    }
    cp_async_commit();
  }
  fill_gaps<BS>(out, c_slot, run_starts, nruns, nc,
                SR == 2 ? INFINITY : 0.0f, warp, nwarps, lane);

  Walk cur;
  if (!start(cur, team, run_starts, nruns, nteams)) return;
  float acc[C::NACC];
  for (int it = 0;; ++it) {
    // product `it` has landed for every lane; every lane is past product
    // it - 1, whose stage the next load takes
    cp_async_wait<C::STAGES - 2>();
    __syncwarp();
    if (loading) {
      load_product<BS, SPLIT>(
          ring + ((it + C::STAGES - 1) % C::STAGES) * C::STAGE, a_tiles,
          b_tiles, a_slot[ld.p], b_slot[ld.p], row0, lane);
      loading = step(ld, run_starts, nruns, nteams);
    }
    cp_async_commit();
    const float* stage = ring + (it % C::STAGES) * C::STAGE;
    const bool first = cur.p == cur.p0;
    if constexpr (SR == 2)
      mp_product<BS, SPLIT>(acc, stage, first, row0, lane);
    else
      tc_product<BS, SR == 1>(acc, stage, first, lane);
    if (cur.p == cur.p1 - 1) {
      float* tile = out + static_cast<size_t>(c_slot[cur.p]) * BS * BS;
      if constexpr (SR == 2)
        mp_store<BS, SPLIT>(acc, tile, row0, lane);
      else
        tc_store<BS, SR == 1>(acc, tile, lane);
    }
    if (!step(cur, run_starts, nruns, nteams)) break;
  }
}

template <int BS, int SR>
int launch(const float* a, const float* b, const int* a_slot,
           const int* b_slot, const int* c_slot, const int* run_starts,
           int nruns, float* c, int nc, cudaStream_t stream) {
  using C = Cfg<BS>;
  auto kern = bsr_spgemm_warp_kernel<BS, SR>;
  cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (st == cudaSuccess) st = cudaGetDevice(&dev);
  if (st == cudaSuccess)
    st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                       C::SMEM);
  if (st != cudaSuccess) return (int)st;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // no more warps than slots: every warp has runs or a share of the fill
  const int need = (nc + WARPS - 1) / WARPS;
  const int grid = need < sms * per_sm ? need : sms * per_sm;
  kern<<<grid, THREADS, C::SMEM, stream>>>(a, b, a_slot, b_slot, c_slot,
                                           run_starts, nruns, nc, c);
  return (int)cudaGetLastError();
}

template <int SR>
int launch_bs(int bs, const float* a, const float* b, const int* a_slot,
              const int* b_slot, const int* c_slot, const int* run_starts,
              int nruns, float* c, int nc, cudaStream_t stream) {
  if (bs == 16)
    return launch<16, SR>(a, b, a_slot, b_slot, c_slot, run_starts, nruns, c,
                          nc, stream);
  if (bs == 32)
    return launch<32, SR>(a, b, a_slot, b_slot, c_slot, run_starts, nruns, c,
                          nc, stream);
  return -1;
}

}  // namespace

// semiring: 0 plus_times, 1 bool_or_and, 2 min_plus; bs 16 or 32. a_tiles
// (na, bs, bs), b_tiles (nb, bs, bs), c_tiles (nc, bs, bs); run_starts holds
// nruns + 1 absolute schedule positions (the last is the window's end).
// Every slot of c_tiles is written: run outputs, and the semiring's
// identity elsewhere (everywhere when nruns is 0). Returns the cudaError_t
// of the launch (0 on success; nothing is launched when nc is 0), -1 for
// arguments the kernel does not take.
extern "C" int bsr_spgemm_warp_launch(int semiring, int bs,
                                      const void* a_tiles,
                                      const void* b_tiles,
                                      const void* a_slot, const void* b_slot,
                                      const void* c_slot,
                                      const void* run_starts, int nruns,
                                      void* c_tiles, int nc, void* stream) {
  if (nc <= 0) return 0;
  if (nruns < 0 || nruns > nc) return -1;
  const auto* a = static_cast<const float*>(a_tiles);
  const auto* b = static_cast<const float*>(b_tiles);
  const auto* as = static_cast<const int*>(a_slot);
  const auto* bsl = static_cast<const int*>(b_slot);
  const auto* cs = static_cast<const int*>(c_slot);
  const auto* rs = static_cast<const int*>(run_starts);
  auto* c = static_cast<float*>(c_tiles);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0:
      return launch_bs<0>(bs, a, b, as, bsl, cs, rs, nruns, c, nc, st);
    case 1:
      return launch_bs<1>(bs, a, b, as, bsl, cs, rs, nruns, c, nc, st);
    case 2:
      return launch_bs<2>(bs, a, b, as, bsl, cs, rs, nruns, c, nc, st);
    default:
      return -1;
  }
}

// Dynamic shared memory, in bytes, of a launch at bs (0 for another bs).
extern "C" int bsr_spgemm_warp_smem_bytes(int bs) {
  return bs == 16 ? Cfg<16>::SMEM : bs == 32 ? Cfg<32>::SMEM : 0;
}
