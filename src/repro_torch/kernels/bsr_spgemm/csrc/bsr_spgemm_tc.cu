// Scheduled block-sparse tile product on Hopper's tensor cores (sm_90a): the
// "tc" route of bsr_spgemm, for plus_times and bool_or_and at bs 64 and 128.
//
// Replaces src/repro/kernels/bsr_spgemm/kernel.py::bsr_spgemm_pallas (body
// _kernel) for those two semirings. For every product s of the schedule
// window,
//
//     C[c_slot[s]]  (+)=  A[a_slot[s]] (x) B[b_slot[s]]        (bs x bs tiles)
//
// The schedule is sorted by output slot, so the products that share an
// output tile form one run; the host turns the first-visit flags into run
// starts once per plan (kernel.py::run_starts_from_flags). Every output tile
// a run targets is written once, by one CTA; every other slot in [0, nc) is
// written once with the identity (0) by this kernel too, so the wrapper
// fills nothing. No atomics: a repeated launch is bitwise equal.
//
// Arithmetic. tf32 wgmma multiplies the top 19 bits of each fp32 word and
// accumulates in fp32. An operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and the product sums the four terms hi.hi + hi.lo +
// lo.hi + lo.lo in fp32. Each term's products are exact (11 x 11
// significant bits), hi + lo == x for every integer |x| < 2^22, and
// lo == 0 for every integer |x| <= 2048, so integer-valued tiles whose
// exact sums stay below 2^24 come out bitwise equal to the fp32 plain
// version. A TF32-exact x (its 13 low bits zero) is its own hi with no lo,
// so a k-panel is first only checked: where every element of A (of B) is
// exact, A (B) is used as it lies and the lo.hi and lo.lo (hi.lo and lo.lo)
// passes are skipped; a vote of the consumer threads behind one barrier
// makes the decision uniform, and only a flagged operand is split. Integer
// payloads such as the Laplacian's run one pass. The split breaks IEEE's
// non-finite rules: inf * (hi + lo) is NaN where hi and lo differ in sign,
// and an |x| >= 2^127 may round its hi to infinity; hi may also round up by
// up to 2^-11 of x, so hi.hi of two finite operands can overflow where
// their fp32 product does not. So the first pass also takes the largest
// magnitude of each operand's panel; a panel where either holds an element
// with an exponent of 0xFE or 0xFF (|x| >= 2^127, infinity or NaN), or where
// the two largest magnitudes multiply to 2^126 or more (tile_rules.cuh's
// unsplit_panel), is not split but summed on the CUDA cores in IEEE fp32
// from the panel as it landed, as the plain version sums it.
// bool_or_and booleanizes while staging (x != 0 -> 1, as _bool_matmul), runs
// the hi.hi pass only, and clips min(acc, 1) at the end of the run: every
// term is >= 0, so sum-then-clip equals the plain version's clip-then-max.
// The tensor core's fp32 accumulate truncates below the accumulator's last
// place, so every k-panel (32 deep) sums into a fresh wgmma accumulator
// (scale-d = 0 at its first MMA, the lo terms before hi.hi) and the run
// adds its panels in IEEE fp32 registers, starting from its first panel:
// no literal identity is ever added. A zero result is stored as +0
// (acc + 0.0f), as the plain version's segment sum gives it.
//
// Bound. At the main path's launch (laplacian_2d(1024)^2, bs 128, part 0)
// 23,228 products into 11,994 output tiles, 1.94 products a run: 1.43 GB of
// tiles read once and written once (0.43 ms at 3.35 TB/s, the output alone
// 55 %), against 0.197 ms for one tf32 pass at the tensor-core peak. One
// pass makes the kernel bound by bytes; four passes (general floats) by
// operations (0.79 ms).
//
// Design for that bound.
//  * Persistent CTAs, one per SM at bs 128 (two at bs 64), walk the runs
//    round-robin (run r goes to CTA r % grid), so the CTAs move through the
//    schedule together and neighbouring runs share A and B tiles in L2.
//  * A producer keeps a TMA ring of raw k-panels (32 deep) full across run
//    boundaries: A[:, k0:k0+32] lands 128-byte swizzled, already the K-major
//    layout wgmma reads; B[k0:k0+32, :] lands row-major. At bs 128 the
//    producer is a warpgroup that gives its registers to the consumers
//    (setmaxnreg), which hold a panel accumulator and a run accumulator.
//  * The consumer warpgroups (two of 64 rows at bs 128, one at bs 64) stage
//    panel i+1 while the wgmma of panel i runs: the exactness check of A,
//    B transposed into the K-major swizzled B^T (tf32 wgmma has no
//    transpose bit), lanes along n so the 16-byte stores are free of bank
//    conflicts, and the split pass for flagged operands only. Operand sets
//    are double-buffered.
//  * A run's epilogue stores its tile straight from the accumulator
//    fragments, 16 bytes a lane after one shuffle with the neighbour lane,
//    streaming past L2, while the producer loads the next run's panels.
//  * Before its runs each consumer warp fills its share of [0, nc) with the
//    identity wherever no run writes (tile_rules.cuh's fill_gaps), so a
//    chunked window that visits few slots costs no whole-output fill.
//
// Requirements: tile stacks contiguous float32, 16-byte aligned, slots and
// run starts int32 (checked by the wrapper); and, as the schedule builds
// them, run_starts strictly increasing, c_slot nondecreasing over the
// window and below nc.
//
// Tensor maps are encoded per launch on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so the library needs no -lcuda,
// and passed as __grid_constant__ parameters.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"
#include "tile_rules.cuh"

namespace {

constexpr int BK = 32;          // depth of a k-panel: one 128-byte fp32 row
constexpr int CONSUMER_BAR = 1; // named barrier of the consumer threads
constexpr int PRODUCER_REGS = 40;   // setmaxnreg at bs 128: registers a
constexpr int CONSUMER_REGS = 232;  // producer thread keeps / a consumer gets

template <int BS>
struct Cfg {
  static constexpr int NWG = BS / 64;            // consumer warpgroups
  static constexpr int NCONS = NWG * 128;        // consumer threads
  // bs 128: a producer warpgroup, so setmaxnreg can hand its registers to
  // the consumers (two fp32 accumulators of 64 a thread); bs 64: a warp
  static constexpr bool PRODUCER_WG = BS == 128;
  static constexpr int THREADS = NCONS + (PRODUCER_WG ? 128 : 32);
  static constexpr int MIN_BLOCKS = BS == 64 ? 2 : 1;
  static constexpr int STAGES = BS == 64 ? 3 : 4;
  static constexpr int KP = BS / BK;             // panels a product
  static constexpr int PANEL = BS * BK * 4;      // one operand panel, bytes
  static constexpr int STAGE = 2 * PANEL;        // raw A, raw B
  static constexpr int OPS = 3 * PANEL;          // A lo, B^T hi, B^T lo
  static constexpr int CHUNKS = PANEL / 16;      // 16-byte chunks a panel
  static_assert(CHUNKS % NCONS == 0, "every consumer stages alike");
  // 1024 of slack aligns the buffers to the swizzle's 1024-byte atoms:
  //   bs 128: 4 x 32 KB ring + 2 x 48 KB operands = 224 KB, 1 CTA an SM
  //   bs  64: 3 x 16 KB ring + 2 x 24 KB operands =  96 KB, 2 CTAs an SM
  // a vote set: per consumer warp its flags and the bits of its largest A
  // and B magnitudes (stage_finish)
  static constexpr int VOTES = 3 * (NCONS / 32);
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * OPS
                              + 2 * STAGES * 8 + 2 * VOTES * 4;
  static_assert(SMEM <= 232448, "shared memory past the 227 KB a CTA has");
};

// The CTA's walk over its runs, one k-panel at a time: run r (products
// [p0, p1)), product p, panel kp. Producer and consumers walk it alike.
struct Cursor {
  int r, p0, p, p1, kp;
};

// Step to the next panel; false past the CTA's last run.
template <int KP>
__device__ __forceinline__ bool advance(Cursor& c, const int* run_starts,
                                        int nruns) {
  if (++c.kp < KP) return true;
  c.kp = 0;
  if (++c.p < c.p1) return true;
  const int grid = static_cast<int>(gridDim.x);
  for (c.r += grid; c.r < nruns; c.r += grid) {
    c.p0 = c.p = run_starts[c.r];
    c.p1 = run_starts[c.r + 1];
    if (c.p < c.p1) return true;
  }
  return false;
}

template <int KP>
__device__ __forceinline__ bool first_panel(Cursor& c, const int* run_starts,
                                            int nruns) {
  c.r = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
  c.p0 = c.p = c.p1 = 0;
  c.kp = KP - 1;
  return advance<KP>(c, run_starts, nruns);
}

__device__ __forceinline__ float4 booleanize(float4 v) {
  return make_float4(v.x != 0.0f ? 1.0f : 0.0f, v.y != 0.0f ? 1.0f : 0.0f,
                     v.z != 0.0f ? 1.0f : 0.0f, v.w != 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ uint32_t bits_of(float4 v) {
  return __float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z)
         | __float_as_uint(v.w);
}

// m and the four magnitudes, as their largest, NaN if any is NaN: one
// instruction an element (the absolute value is an operand modifier).
__device__ __forceinline__ float mag_of(float m, float4 v) {
  return max_nan(max_nan(m, max_nan(fabsf(v.x), fabsf(v.y))),
                 max_nan(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ void split4(float4 v, float4& h, float4& l) {
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
}

// Panel layout: raw A (BS rows of 32 fp32, 128-byte swizzled: hi in place)
// and raw B (32 rows of BS) in a ring stage; A lo, B^T hi and B^T lo in an
// operand set. Row n of B^T is 128 bytes, its 16-byte chunk kc at
// kc ^ (n % 8) (the 128-byte swizzle); lanes run along n, so neither the
// raw reads nor the transposed stores conflict on banks.
template <int BS>
struct Panel {
  float4* a;
  const float* b;
  float4* a_lo;
  float4* bt_hi;
  float4* bt_lo;
  __device__ Panel(uint8_t* raw, uint8_t* ops)
      : a(reinterpret_cast<float4*>(raw)),
        b(reinterpret_cast<const float*>(raw + BS * BK * 4)),
        a_lo(reinterpret_cast<float4*>(ops)),
        bt_hi(reinterpret_cast<float4*>(ops + BS * BK * 4)),
        bt_lo(reinterpret_cast<float4*>(ops + 2 * BS * BK * 4)) {}
  // B[4 kc .. 4 kc + 3][n] and its place in B^T
  __device__ float4 b_col(int n, int kc) const {
    const float* col = b + 4 * kc * BS + n;
    return make_float4(col[0], col[BS], col[2 * BS], col[3 * BS]);
  }
  static __device__ int bt_at(int n, int kc) { return n * 8 + (kc ^ (n & 7)); }
};

// First pass over a landed panel. bool: booleanize A in place and B into
// B^T, done. plus_times: copy B into B^T, which is its hi wherever B is
// TF32-exact, and report which operand holds an element that is not (low
// 13 bits set): bit 1 for A, 2 for B; and this thread's largest magnitude
// of each (a_mag, b_mag, NaN if it saw one). A TF32-exact operand is its own
// hi and has no lo, so integer panels need nothing more.
template <int BS, bool BOOL>
__device__ __forceinline__ uint32_t stage_copy(uint8_t* raw, uint8_t* ops,
                                               uint64_t* full,
                                               uint32_t parity, float& a_mag,
                                               float& b_mag, int tid) {
  using C = Cfg<BS>;
  mbar_wait(full, parity);
  const Panel<BS> pn(raw, ops);
  uint32_t a_bits = 0, b_bits = 0;
  a_mag = b_mag = 0.0f;
#pragma unroll
  for (int j = 0; j < C::CHUNKS / C::NCONS; ++j) {
    const int i = tid + j * C::NCONS;
    const float4 v = pn.a[i];
    if constexpr (BOOL) {
      pn.a[i] = booleanize(v);
    } else {
      a_bits |= bits_of(v);
      a_mag = mag_of(a_mag, v);
    }
  }
#pragma unroll
  for (int j = 0; j < C::CHUNKS / C::NCONS; ++j) {
    const int i = tid + j * C::NCONS;
    const int n = i % BS, kc = i / BS;
    const float4 v = pn.b_col(n, kc);
    if constexpr (BOOL) {
      pn.bt_hi[Panel<BS>::bt_at(n, kc)] = booleanize(v);
    } else {
      pn.bt_hi[Panel<BS>::bt_at(n, kc)] = v;
      b_bits |= bits_of(v);
      b_mag = mag_of(b_mag, v);
    }
  }
  return ((a_bits & kTf32LowBits) ? 1u : 0u)
         | ((b_bits & kTf32LowBits) ? 2u : 0u);
}

// Second pass, for the operands `flags` names only: split every element
// into hi (A's in place, B's into B^T) and lo (A lo, B^T lo), rereading the
// raw panel, which stays in its stage until the panel's MMAs are done.
template <int BS>
__device__ __forceinline__ void stage_split(uint8_t* raw, uint8_t* ops,
                                            uint32_t flags, int tid) {
  using C = Cfg<BS>;
  const Panel<BS> pn(raw, ops);
  if (flags & 1u) {
#pragma unroll
    for (int j = 0; j < C::CHUNKS / C::NCONS; ++j) {
      const int i = tid + j * C::NCONS;
      float4 h, l;
      split4(pn.a[i], h, l);
      pn.a[i] = h;
      pn.a_lo[i] = l;
    }
  }
  if (flags & 2u) {
#pragma unroll
    for (int j = 0; j < C::CHUNKS / C::NCONS; ++j) {
      const int i = tid + j * C::NCONS;
      const int n = i % BS, kc = i / BS;
      float4 h, l;
      split4(pn.b_col(n, kc), h, l);
      pn.bt_hi[Panel<BS>::bt_at(n, kc)] = h;
      pn.bt_lo[Panel<BS>::bt_at(n, kc)] = l;
    }
  }
}

__device__ __forceinline__ void consumer_sync(int count) {
  asm volatile("bar.sync %0, %1;" :: "n"(CONSUMER_BAR), "r"(count)
               : "memory");
}

// Finish staging a panel whose first pass every consumer has done: make
// the pass's writes visible to wgmma and agree on the flags behind one
// barrier (each warp ORs its lanes' flags into its words of `votes` and
// takes its lanes' largest magnitudes, whose bits order as their values, a
// NaN's above infinity's; every consumer folds the words after the
// barrier), then run the split pass where a flag is set. Returns the
// uniform flags: which lo passes the panel's MMAs need, or 4 for a panel
// that goes to the CUDA cores unsplit (fma_panel, where unsplit_panel holds
// for the panel's largest A and B magnitudes). Alternate panels use
// alternate vote sets: a set is written again two panels on, past the next
// panel's barrier, so after every consumer has read it.
template <int BS, bool BOOL>
__device__ __forceinline__ uint32_t stage_finish(uint8_t* raw, uint8_t* ops,
                                                 uint32_t* votes,
                                                 uint32_t mine, float a_mag,
                                                 float b_mag, int tid) {
  constexpr int NCONS = Cfg<BS>::NCONS;
  fence_proxy_async();
  if constexpr (BOOL) {
    consumer_sync(NCONS);
    return 0u;
  }
  const uint32_t warp = __reduce_or_sync(FULL, mine);
  const uint32_t a_max = __reduce_max_sync(FULL, __float_as_uint(a_mag));
  const uint32_t b_max = __reduce_max_sync(FULL, __float_as_uint(b_mag));
  if (tid % 32 == 0) {
    votes[3 * (tid / 32)] = warp;
    votes[3 * (tid / 32) + 1] = a_max;
    votes[3 * (tid / 32) + 2] = b_max;
  }
  consumer_sync(NCONS);
  uint32_t flags = 0, a_bits = 0, b_bits = 0;
#pragma unroll
  for (int w = 0; w < NCONS / 32; ++w) {
    flags |= votes[3 * w];
    a_bits = max(a_bits, votes[3 * w + 1]);
    b_bits = max(b_bits, votes[3 * w + 2]);
  }
  if (unsplit_panel(__uint_as_float(a_bits), __uint_as_float(b_bits)))
    return 4u;
  if (flags) {
    stage_split<BS>(raw, ops, flags, tid);
    fence_proxy_async();
    consumer_sync(NCONS);
  }
  return flags;
}

// The wgmma of one panel for this warpgroup's 64 rows into a fresh
// accumulator: the lo passes `flags` asks for first, each over the panel's
// four k-steps of 8, then hi.hi. The tensor core's fp32 accumulate drops
// the bits below the accumulator's last place (on an H100, one accumulator
// for a whole run put float products past a 1e-4 tolerance), so each panel
// sums into zeros, the small lo terms before the large hi.hi ones, and the
// run adds the panels up in IEEE fp32 (run_sum).
template <int BS>
__device__ __forceinline__ void mma_panel(float (&part)[BS / 2],
                                          uint32_t a_hi, uint32_t a_lo,
                                          uint32_t bt_hi, uint32_t bt_lo,
                                          uint32_t flags) {
  __syncwarp();                         // wgmma is .sync.aligned
  fence_acc(part);
  wgmma_fence();
  int scale = 0;                        // the panel's first MMA zeroes it
  // k advances 32 bytes inside each 128-byte row; 8-row groups 1024 B
  // apart in both operands
  if (flags == 3u) {
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks, scale = 1)
      wgmma_tf32(part, sw128_desc(a_lo + ks * 32, 16, 1024),
                 sw128_desc(bt_lo + ks * 32, 16, 1024), scale);
  }
  if (flags & 1u) {
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks, scale = 1)
      wgmma_tf32(part, sw128_desc(a_lo + ks * 32, 16, 1024),
                 sw128_desc(bt_hi + ks * 32, 16, 1024), scale);
  }
  if (flags & 2u) {
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks, scale = 1)
      wgmma_tf32(part, sw128_desc(a_hi + ks * 32, 16, 1024),
                 sw128_desc(bt_lo + ks * 32, 16, 1024), scale);
  }
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks, scale = 1)
    wgmma_tf32(part, sw128_desc(a_hi + ks * 32, 16, 1024),
               sw128_desc(bt_hi + ks * 32, 16, 1024), scale);
  wgmma_commit();
  fence_acc(part);
}

// A panel on the CUDA cores in IEEE fp32, read as it landed: this thread's
// fragment (rows `row` and row + 8, mma_panel's columns) of A[:, k0:k0+32]
// (128-byte swizzled: 16-byte chunk c of row r at c ^ (r % 8)) times
// B[k0:k0+32, :] (row-major), for a panel the split cannot take.
template <int BS>
__device__ __forceinline__ void fma_panel(float (&part)[BS / 2],
                                          const uint8_t* raw, int row,
                                          int lane) {
  const float* a = reinterpret_cast<const float*>(raw);
  const float* b = reinterpret_cast<const float*>(raw + BS * BK * 4);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BS / 2; ++i) part[i] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < BK; ++k) {
    const int at = ((k / 4) ^ (row & 7)) * 4 + k % 4;
    const float a0 = a[row * BK + at], a1 = a[(row + 8) * BK + at];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      const float2 bv =
          *reinterpret_cast<const float2*>(b + k * BS + 8 * j + col);
      part[4 * j] = fmaf(a0, bv.x, part[4 * j]);
      part[4 * j + 1] = fmaf(a0, bv.y, part[4 * j + 1]);
      part[4 * j + 2] = fmaf(a1, bv.x, part[4 * j + 2]);
      part[4 * j + 3] = fmaf(a1, bv.y, part[4 * j + 3]);
    }
  }
}

// acc = part at a run's first panel, acc + part (round to nearest) after.
template <int N>
__device__ __forceinline__ void run_sum(float (&acc)[N],
                                        const float (&part)[N], bool first) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = first ? part[i] : acc[i] + part[i];
}

// The warpgroup's 64 rows of a finished run into the output tile. Fragment
// (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4)
// (+ 1); neighbour lanes swap half their values, so an even lane stores
// four columns of the upper row and an odd lane four of the lower row.
template <int BS, bool BOOL>
__device__ __forceinline__ void store_tile(const float (&acc)[BS / 2],
                                           float* tile, int row0, int lane) {
  const int q = lane & 3;
  const bool odd = q & 1;
  float* dst = tile + (row0 + lane / 4 + (odd ? 8 : 0)) * BS + 2 * (q & ~1);
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = BOOL ? fminf(acc[4 * j + e], 1.0f)
                  : __fadd_rn(acc[4 * j + e], 0.0f);   // -0 -> +0
    const float t0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
    const float t1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
    __stcs(reinterpret_cast<float4*>(dst + 8 * j),
           odd ? make_float4(t0, t1, v[2], v[3])
               : make_float4(v[0], v[1], t0, t1));
  }
}

template <int BS, bool BOOL>
__global__ void __launch_bounds__(Cfg<BS>::THREADS, Cfg<BS>::MIN_BLOCKS)
bsr_spgemm_tc_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     const int* __restrict__ a_slot,
                     const int* __restrict__ b_slot,
                     const int* __restrict__ c_slot,
                     const int* __restrict__ run_starts, int nruns, int nc,
                     float* __restrict__ out) {
  using C = Cfg<BS>;
  constexpr int KP = C::KP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;                              // raw A, raw B a stage
  uint8_t* opbuf = ring + C::STAGES * C::STAGE;      // two operand sets
  uint64_t* full = reinterpret_cast<uint64_t*>(opbuf + 2 * C::OPS);
  uint64_t* empty = full + C::STAGES;
  // two vote sets (stage_finish)
  uint32_t* votes = reinterpret_cast<uint32_t*>(empty + C::STAGES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG);       // one arrival per consumer WG
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::NCONS) {
    // producer: one thread keeps the ring full, across run boundaries
    if constexpr (C::PRODUCER_WG)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (tid == C::NCONS) {
      Cursor c;
      int it = 0, a = 0, b = 0;
      for (bool more = first_panel<KP>(c, run_starts, nruns); more;
           more = advance<KP>(c, run_starts, nruns), ++it) {
        if (c.kp == 0) {
          a = a_slot[c.p];
          b = b_slot[c.p];
        }
        const int s = it % C::STAGES;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* raw = ring + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_3d(raw, &amap, &full[s], c.kp * BK, 0, a);
        tma_load_3d(raw + C::PANEL, &bmap, &full[s], 0, c.kp * BK, b);
      }
    }
    return;
  }
  if constexpr (C::PRODUCER_WG)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64)
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row0 = wg * 64 + ((tid % 128) / 32) * 16;
  fill_gaps<BS>(out, c_slot, run_starts, nruns, nc, 0.0f,
                static_cast<int>(blockIdx.x) * (C::NCONS / 32) + tid / 32,
                static_cast<int>(gridDim.x) * (C::NCONS / 32), lane);

  Cursor cur;
  if (!first_panel<KP>(cur, run_starts, nruns)) return;
  float part[BS / 2];                   // one panel, on the tensor cores
  float acc[BS / 2];                    // the run so far
#pragma unroll
  for (int i = 0; i < BS / 2; ++i) part[i] = acc[i] = 0.0f;
  float a_mag, b_mag;
  uint32_t flags = stage_copy<BS, BOOL>(ring, opbuf, &full[0], 0, a_mag,
                                        b_mag, tid);
  flags = stage_finish<BS, BOOL>(ring, opbuf, votes, flags, a_mag, b_mag,
                                 tid);
  for (int it = 0;; ++it) {
    // panel `it` is staged: its MMAs run while the next panel is staged
    // into the other operand set
    const int s = it % C::STAGES;
    const uint32_t ops = smem_u32(opbuf + (it & 1) * C::OPS);
    if (!BOOL && flags == 4u)
      fma_panel<BS>(part, ring + s * C::STAGE, row0 + lane / 4, lane);
    else
      mma_panel<BS>(part, smem_u32(ring + s * C::STAGE) + wg * 64 * 128,
                    ops + wg * 64 * 128, ops + C::PANEL, ops + 2 * C::PANEL,
                    flags);
    Cursor nxt = cur;
    const bool more = advance<KP>(nxt, run_starts, nruns);
    const int n = it + 1;
    uint8_t* next_raw = ring + (n % C::STAGES) * C::STAGE;
    uint8_t* next_ops = opbuf + (n & 1) * C::OPS;
    uint32_t next_flags = 0;
    if (more) {
      next_flags = stage_copy<BS, BOOL>(next_raw, next_ops,
                                        &full[n % C::STAGES],
                                        (n / C::STAGES) & 1, a_mag, b_mag,
                                        tid);
      next_flags = stage_finish<BS, BOOL>(next_raw, next_ops,
                                          votes + (n & 1) * C::VOTES,
                                          next_flags, a_mag, b_mag, tid);
    }
    wgmma_wait<0>();
    fence_acc(part);
    if (tid % 128 == 0) mbar_arrive(&empty[s]);  // this WG is done with s
    run_sum(acc, part, cur.kp == 0 && cur.p == cur.p0);
    if (cur.kp == KP - 1 && cur.p == cur.p1 - 1)
      store_tile<BS, BOOL>(acc, out + (size_t)c_slot[cur.p] * BS * BS, row0,
                           lane);
    if (!more) break;
    // every consumer is past panel it's MMAs: the next panel's staging may
    // overwrite this panel's operand set
    consumer_sync(C::NCONS);
    flags = next_flags;
    cur = nxt;
  }
}

// ---- host side -------------------------------------------------------------

// 3-D map over a contiguous (n, bs, bs) float32 tile stack, dimensions (bs,
// bs, n) innermost first, boxes of box0 x box1 x 1.
int encode_map(CUtensorMap* map, const void* base, int n, int bs,
               uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return -2;
  const cuuint64_t dims[3] = {(cuuint64_t)bs, (cuuint64_t)bs, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)bs * 4,
                                 (cuuint64_t)bs * bs * 4};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int BS, bool BOOL>
int launch(const void* a, int na, const void* b, int nb, const int* a_slot,
           const int* b_slot, const int* c_slot, const int* run_starts,
           int nruns, float* c, int nc, cudaStream_t stream) {
  using C = Cfg<BS>;
  CUtensorMap am, bm;
  // A: 32 columns (128 bytes) x bs rows, 128-byte swizzle (K-major for
  // wgmma); B: bs columns x 32 rows, row-major
  int err = encode_map(&am, a, na, BS, BK, BS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_map(&bm, b, nb, BS, BS, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  auto kern = bsr_spgemm_tc_kernel<BS, BOOL>;
  cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (st != cudaSuccess) return (int)st;
  int dev = 0, sms = 0, per_sm = 0;
  st = cudaGetDevice(&dev);
  if (st == cudaSuccess)
    st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                       C::THREADS, C::SMEM);
  if (st != cudaSuccess) return (int)st;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = nc < sms * per_sm ? nc : sms * per_sm;
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(am, bm, a_slot, b_slot, c_slot,
                                              run_starts, nruns, nc, c);
  return (int)cudaGetLastError();
}

template <bool BOOL>
int launch_bs(int bs, const void* a, int na, const void* b, int nb,
              const int* a_slot, const int* b_slot, const int* c_slot,
              const int* run_starts, int nruns, float* c, int nc,
              cudaStream_t stream) {
  if (bs == 64)
    return launch<64, BOOL>(a, na, b, nb, a_slot, b_slot, c_slot, run_starts,
                            nruns, c, nc, stream);
  if (bs == 128)
    return launch<128, BOOL>(a, na, b, nb, a_slot, b_slot, c_slot,
                             run_starts, nruns, c, nc, stream);
  return -1;
}

}  // namespace

// semiring: 0 plus_times, 1 bool_or_and; bs 64 or 128. a_tiles (na, bs, bs),
// b_tiles (nb, bs, bs), c_tiles (nc, bs, bs); run_starts holds nruns + 1
// absolute schedule positions (the last is the window's end). Every slot of
// c_tiles is written: run outputs, and 0 elsewhere (everywhere when nruns is
// 0). Returns the cudaError_t of the launch (0 on success; nothing is
// launched when nc is 0), -1 for arguments the kernel does not take, -2
// when the CUDA driver API's cuTensorMapEncodeTiled cannot be reached, -3
// when it refuses a tensor map.
extern "C" int bsr_spgemm_tc_launch(int semiring, int bs, const void* a_tiles,
                                    int na, const void* b_tiles, int nb,
                                    const void* a_slot, const void* b_slot,
                                    const void* c_slot,
                                    const void* run_starts, int nruns,
                                    void* c_tiles, int nc, void* stream) {
  if (nc <= 0) return 0;
  if (nruns < 0 || na <= 0 || nb <= 0) return -1;
  const auto* as = static_cast<const int*>(a_slot);
  const auto* bsl = static_cast<const int*>(b_slot);
  const auto* cs = static_cast<const int*>(c_slot);
  const auto* rs = static_cast<const int*>(run_starts);
  auto* c = static_cast<float*>(c_tiles);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0:
      return launch_bs<false>(bs, a_tiles, na, b_tiles, nb, as, bsl, cs, rs,
                              nruns, c, nc, st);
    case 1:
      return launch_bs<true>(bs, a_tiles, na, b_tiles, nb, as, bsl, cs, rs,
                             nruns, c, nc, st);
    default:
      return -1;
  }
}

// Dynamic shared memory, in bytes, of a launch at bs (0 for another bs).
extern "C" int bsr_spgemm_tc_smem_bytes(int bs) {
  return bs == 64 ? Cfg<64>::SMEM : bs == 128 ? Cfg<128>::SMEM : 0;
}
