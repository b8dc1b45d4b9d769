// Grouped expert GEMM on Hopper's tensor cores (sm_90a) at float32
// accuracy: float32 x, w and y, split-TF32 wgmma, fp32 accumulation. The
// "fp32" route of the wrapper (float32 at every cap).
//
// Replaces src/repro/kernels/moe_gemm/kernel.py::moe_gemm_pallas (body
// _kernel) for float32, in place of the CUDA-core kernel moe_gemm.cu (kept
// for timings). For every expert e of a
// capacity-bucketed MoE layer, with live = clamp(rows[e], 0, cap) (cap when
// rows is null),
//
//     y[e][r] = x[e][r] @ w[e]   for r < live,     y[e][r] = 0 for r >= live
//     x (E, cap, d), w (E, d, f), y (E, cap, f), all contiguous
//
// The contraction runs over all of d (the Pallas kernel drops the last
// d % 512 columns when d is not a multiple of 512; this one does not).
//
// Arithmetic (split TF32). A tf32 wgmma reads the top 19 bits of each fp32
// word, about 2^-11 relative error: past the float32 tolerance. So x and w
// are split into hi = rna_tf32(v) and lo = rna_tf32(v - hi) (hopper.cuh's
// split_finite), and every k-panel of 32 sums lo_x.hi_w + hi_x.lo_w +
// hi_x.hi_w (lo.lo, 2^-22, is left out) into a fresh accumulator: the
// tensor core's fp32 accumulate truncates below the accumulator's last
// place (found by bsr_spgemm_tc.cu on an H100), so each panel starts from
// zeros, the small lo terms first, and the panels are added up in IEEE fp32
// registers in panel order. Integer-valued inputs with |v| < 2^11 have
// lo = 0 and exact products, and sums below 2^24 are exact in any order,
// so they come out bitwise equal to the plain version. The split breaks
// IEEE's non-finite rules (inf * (hi + lo) is NaN where hi and lo differ in
// sign; an |v| near FLT_MAX rounds its hi to infinity), and its hi.hi can
// overflow where the fp32 product does not (v = nextafter(2^64, 0) has
// hi = 2^64, and hi.hi = 2^128 is inf where v.v = 3.4028233e38). So a
// panel is summed unsplit by fp32 FMAs from the panel as it landed where
// hopper.cuh's unsplit_panel holds for the largest |x| of the warp's row
// pair and the largest |w| of the w panel: either is an infinity, a NaN or
// >= 2^127 (wide), or their fp32 product is NaN or >= 2^126. inf, NaN and
// products near FLT_MAX then come out as in the plain version; the split
// of such a panel is computed and discarded, so the split need not handle
// those values. No atomics and a fixed summation order: a launch repeats
// bitwise. The CPU model of this arithmetic is ref.moe_gemm_tf32_model.
//
// Bound. At the float32 serving check's first prefill GEMM (qwen2-moe-a2.7b
// at full width, 4 x 256 tokens: x (64, 88, 2048), w (64, 2048, 1408),
// 3,460 live rows) the launch needs 19.95 GFLOP against 798 MB: the 64
// experts' weights (738 MB), the live x rows (28 MB) and y (32 MB). As fp32
// FMAs on the CUDA cores that is bound by operations (0.298 ms at 66.9
// TFLOP/s); three TF32 passes on the tensor cores take 0.121 ms at 494.7
// TFLOP/s, so this kernel is bound by the weight read: 0.238 ms at 3.35
// TB/s.
//
// Design for that bound.
// * Work division: one CTA per (M tile of 128 rows, N tile of 128 columns,
//   expert), the M tile fastest in the grid, so the M tiles of one
//   (expert, N tile) run together and w[e] comes from HBM about once. Two
//   consumer warpgroups and two producer warpgroups that give the
//   consumers their registers (setmaxnreg). More than 64 live rows in the
//   tile: each consumer warpgroup takes 64 rows at all 128 columns
//   (m64n128k8). At most 64 (a serving batch's usual tile): both take rows
//   0-63, each 64 of the columns (m64n64k8), so that two warpgroups still
//   take turns at the tensor cores. A CTA whose first row is at or past
//   `live` stores its zeros and returns before any load.
// * Loads: one producer thread keeps a 5-stage TMA ring of k-panels full:
//   x[e] rows [m0, m0 + 128) x 32 columns through a 3-D map over (E, cap,
//   d), 128-byte swizzled (K-major as stored), and w[e] rows [k0, k0 + 32)
//   x 128 columns through a 3-D map over (E, d, f), row-major. TMA's zero
//   fill covers rows past cap, columns past f and the k tail, so nothing
//   is padded or copied.
// * w as B, staged K-major: w[e] is N-major and tf32 wgmma has no
//   transpose bit, so the producers' other seven warps rewrite each landed
//   w panel into w^T hi and lo (128 rows of 32 k, 128-byte swizzled; two
//   stages), lanes along n so that the reads and the 16-byte stores are
//   free of bank conflicts, behind mbarrier handoffs (staged: every stager
//   arrives; wfree and empty: every consumer warp, once the panel's MMAs
//   are done), so the staging runs beside the consumers' MMAs. Each stager
//   warp also reports the largest magnitude in its share of the panel. This
//   staging is the CUDA-core work the design has to hide: 184.5 M weight
//   elements a launch at the shape above. On an H100 three staging warps
//   left the launch slower than seven, and hopper.cuh's split (with its
//   non-finite case) slower than split_finite.
// * x as A, from registers: each consumer thread loads its A fragments for
//   the panel's four k-steps with four 16-byte loads and splits them in
//   registers (no hi / lo buffer for x), then issues the wgmma with A in
//   registers; the next panel's fragments are loaded and split while this
//   panel's MMAs run. A thread's 16-byte chunks hold physical columns
//   8t .. 8t + 7 (t = lane % 4) where the tf32 A fragment of k-step kk
//   wants columns t and t + 4: so k-step kk's column j is physical column
//   8 (j % 4) + 4 (j / 4) + kk, and w^T's staging writes its k positions in
//   that same order; the product is unchanged.
// * Epilogue: stores the fragments straight to y, rows inside cap and
//   columns inside f; rows at or past `live` as zeros.
//
// Shared memory: a TMA ring of 5 stages (x panel and w panel as landed,
// 16 KB each), 2 stages of w^T hi and lo (16 KB each), 1024 bytes of slack
// that aligns the buffers to the swizzle's 1024-byte atoms, the barriers
// and the stager warps' magnitudes: 230,576 bytes, one CTA an SM.
//
// Requirements (checked by the wrapper): d and f multiples of 8, tensors
// contiguous and 16-byte aligned, rows int32 (E,) or null. Tensor maps are
// encoded per launch on the host by cuTensorMapEncodeTiled (reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda) and passed as
// __grid_constant__ parameters.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr int BM = 128;             // rows a CTA (two warpgroups of 64)
constexpr int BN = 128;             // columns a CTA
constexpr int BK = 32;              // depth of a k-panel: one 128-byte row
constexpr int RST = 5;              // TMA ring stages: x and w as landed
constexpr int WST = 2;              // staged stages: w^T hi and lo
constexpr int NCONS = 256;          // consumer threads
constexpr int NPROD = 256;          // producer threads (two warpgroups)
constexpr int THREADS = NCONS + NPROD;
constexpr int NSTAGE = NPROD - 32;  // its staging threads (all but warp 0)
constexpr int PANEL = BM * BK * 4;  // 16 KB: an x panel, a w panel, w^T
static_assert(PANEL == BK * BN * 4, "x and w panels of one size");
constexpr int MAGS = NSTAGE / 32 + 1;  // magnitude words a staged stage
constexpr int SMEM = 1024 + (RST + WST) * 2 * PANEL + 2 * (RST + WST) * 8
                     + WST * MAGS * 4;
static_assert(SMEM <= 232448, "shared memory past the 227 KB a CTA has");
// setmaxnreg: registers a producer thread keeps / a consumer gets. Their
// sum per SM sub-partition lane, 2 x 32 + 2 x 216 = 496, stays below 512
// (flash_attention_tf32.cu: at 512 a consumer's increase never completed
// on an H100 and the launch hung); 40 / 208 spills in the consumers.
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 216;

// A w panel (BK rows of BN, row-major as landed) into w^T hi and lo, K-major
// and 128-byte swizzled: row n is 128 bytes, its 16-byte chunk c at
// c ^ (n % 8), and chunk c holds k = 8 e + 4 (c % 2) + c / 2 for e = 0..3
// (k-step c / 2, A columns 4 (c % 2) .. + 3 in the x fragments' order).
// Lanes run along n. Returns the largest magnitude bits this thread saw.
__device__ __forceinline__ uint32_t stage_w(const uint8_t* raw, uint8_t* hi,
                                            uint8_t* lo, int st) {
  const float* w = reinterpret_cast<const float*>(raw);
  uint32_t m = 0;
#pragma unroll 2
  for (int i = st; i < BN * BK / 4; i += NSTAGE) {
    const int n = i % BN, c = i / BN;
    const float* col = w + (4 * (c & 1) + (c >> 1)) * BN + n;
    const float4 v = make_float4(col[0], col[8 * BN], col[16 * BN],
                                 col[24 * BN]);
    m = mag4(m, v);
    float4 h, l;
    split_finite(v.x, h.x, l.x);
    split_finite(v.y, h.y, l.y);
    split_finite(v.z, h.z, l.z);
    split_finite(v.w, h.w, l.w);
    const int off = n * 128 + ((c ^ (n & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
  return m;
}

// A consumer thread's A operand of one k-panel: hi and lo of each k-step's
// fragment, and the largest magnitude bits of the x values they came from.
struct Frags {
  uint32_t h[4][4], l[4][4];
  uint32_t mag;
};

// Loads this thread's x values of a landed panel (tile rows g and g + 8,
// physical columns 8 t .. 8 t + 7: chunks 2 t and 2 t + 1, swizzled by the
// row) and splits them into the four k-steps' fragments: k-step kk holds
// a[0] = (g, 8 t + kk), a[1] = (g + 8, 8 t + kk), a[2] = (g, 8 t + 4 + kk),
// a[3] = (g + 8, 8 t + 4 + kk).
__device__ __forceinline__ void load_frags(const uint8_t* xpanel, int g,
                                           int t, Frags& fr) {
  const float4* xs = reinterpret_cast<const float4*>(xpanel);
  const int sw = g & 7;
  const float4 r0a = xs[g * 8 + ((2 * t) ^ sw)];
  const float4 r0b = xs[g * 8 + ((2 * t + 1) ^ sw)];
  const float4 r1a = xs[(g + 8) * 8 + ((2 * t) ^ sw)];
  const float4 r1b = xs[(g + 8) * 8 + ((2 * t + 1) ^ sw)];
  fr.mag = mag4(mag4(mag4(mag4(0u, r0a), r0b), r1a), r1b);
  const float va[4][4] = {{r0a.x, r1a.x, r0b.x, r1b.x},
                          {r0a.y, r1a.y, r0b.y, r1b.y},
                          {r0a.z, r1a.z, r0b.z, r1b.z},
                          {r0a.w, r1a.w, r0b.w, r1b.w}};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float h, l;
      split_finite(va[kk][r], h, l);
      fr.h[kk][r] = __float_as_uint(h);
      fr.l[kk][r] = __float_as_uint(l);
    }
}

// Keeps the compiler from reusing a fragment's registers while the
// asynchronous MMAs that read them may still run.
__device__ __forceinline__ void fence_frags(Frags& fr) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" : "+r"(fr.h[i][j]), "+r"(fr.l[i][j]) :: "memory");
}

// A panel on the CUDA cores in IEEE fp32, read as it landed: this thread's
// fragment (tile rows g and g + 8, tile columns c0 + 8 j + 2 t (+ 1)) of
// x[:, k0:k0+32] (128-byte swizzled: chunk c of row r at c ^ (r % 8)) times
// w[k0:k0+32, :] (row-major), for a panel the split cannot take.
template <int NC>
__device__ __forceinline__ void fma_panel(float (&part)[NC / 2],
                                          const uint8_t* xs,
                                          const uint8_t* ws, int g, int c0,
                                          int t) {
  const float* x = reinterpret_cast<const float*>(xs);
  const float* w = reinterpret_cast<const float*>(ws) + c0 + 2 * t;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) part[i] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < BK; ++k) {
    const int at = (((k >> 2) ^ (g & 7)) << 2) + (k & 3);
    const float a0 = x[g * BK + at], a1 = x[(g + 8) * BK + at];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(w + k * BN + 8 * j);
      part[4 * j] = fmaf(a0, b.x, part[4 * j]);
      part[4 * j + 1] = fmaf(a0, b.y, part[4 * j + 1]);
      part[4 * j + 2] = fmaf(a1, b.x, part[4 * j + 2]);
      part[4 * j + 3] = fmaf(a1, b.y, part[4 * j + 3]);
    }
  }
}

// Zeros into y[e] rows [r0, r1) x columns [n0, n0 + nc), 16 bytes a store
// (f, n0 and nc are multiples of 8).
__device__ __forceinline__ void zero_rows(float* ye, int r0, int r1, int n0,
                                          int nc, int f, int tid, int nt) {
  const int vecs = nc / 4;
  for (int i = tid; i < (r1 - r0) * vecs; i += nt) {
    const int r = r0 + i / vecs, c = n0 + (i % vecs) * 4;
    *reinterpret_cast<float4*>(ye + (size_t)r * f + c) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// A CTA's shared memory (1024-byte aligned) and its barriers.
struct Smem {
  uint8_t* ring;      // RST stages: x panel, w panel as landed
  uint8_t* wt;        // WST stages: w^T hi, w^T lo
  uint64_t* full;     // RST: a stage landed
  uint64_t* empty;    // RST: every MMA of its panel done
  uint64_t* staged;   // WST: w^T hi and lo written
  uint64_t* wfree;    // WST: every MMA on them done
  uint32_t* wmag;     // WST x MAGS: a stager warp's largest |w| bits
  __device__ explicit Smem(uint8_t* base)
      : ring(base),
        wt(base + RST * 2 * PANEL),
        full(reinterpret_cast<uint64_t*>(wt + WST * 2 * PANEL)),
        empty(full + RST),
        staged(empty + RST),
        wfree(staged + WST),
        wmag(reinterpret_cast<uint32_t*>(wfree + WST)) {}
};

// One consumer warpgroup's share of a tile, over every k-panel, into y:
// fragment (warp w, lane l) of the m64nNC accumulator holds tile rows g and
// g + 8 (g = 16 w + l / 4 plus the warpgroup's first row) and tile columns
// c0 + 8 j + 2 t (+ 1), t = l % 4: element 4 j + 2 i + c is row g + 8 i,
// column c0 + 8 j + 2 t + c. Rows at or past `live` are stored as zeros.
template <int NC>
__device__ __forceinline__ void consume(const Smem& sm, int nk, int g, int c0,
                                        int t, int lane, float* ye, int m0,
                                        int n0, int cap, int f, int live) {
  float acc[NC / 2], part[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = part[i] = 0.0f;
  // panel it: wait for its w^T; lo_x.hi_w, hi_x.lo_w, then hi_x.hi_w, each
  // over the four k-steps (32 bytes apart inside the 128-byte rows; 8-row
  // groups 1024 B apart), into a fresh accumulator; while they run, load
  // and split the next panel's fragments; then the unsplit FMAs where
  // unsplit_panel holds for the row pair and the w panel, release both
  // stages, and add the partial to acc in IEEE fp32 (acc starts at +0, so
  // no -0 comes out)
  auto panel = [&](int it, Frags& cur, Frags& nxt) {
    const int s = it % RST, q = it % WST;
    const uint8_t* st = sm.ring + s * 2 * PANEL;
    mbar_wait(&sm.staged[q], (it / WST) & 1);
    const uint32_t bt = smem_u32(sm.wt + q * 2 * PANEL) + c0 * 128;
    const uint64_t dh = sw128_desc(bt, 16, 1024);
    const uint64_t dl = sw128_desc(bt + PANEL, 16, 1024);
    __syncwarp();                         // wgmma is .sync.aligned
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_rs(part, cur.l[kk], dh + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_rs(part, cur.h[kk], dl + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_rs(part, cur.h[kk], dh + 2 * kk, 1);
    wgmma_commit();
    if (it + 1 < nk) {
      const int s1 = (it + 1) % RST;
      mbar_wait(&sm.full[s1], ((it + 1) / RST) & 1);
      load_frags(sm.ring + s1 * 2 * PANEL, g, t, nxt);
    }
    wgmma_wait<0>();
    fence_acc(part);
    fence_frags(cur);
    // rows g and g + 8 are spread over the 4 lanes of a quad
    uint32_t xm = cur.mag;
    xm = max(xm, __shfl_xor_sync(0xffffffffu, xm, 1));
    xm = max(xm, __shfl_xor_sync(0xffffffffu, xm, 2));
    const uint32_t* wm = sm.wmag + q * MAGS;
    uint32_t wmax = 0;
#pragma unroll
    for (int i = 0; i < NSTAGE / 32; ++i) wmax = max(wmax, wm[i]);
    if (unsplit_panel(__uint_as_float(xm), __uint_as_float(wmax)))
      fma_panel<NC>(part, st, st + PANEL, g, c0, t);
    __syncwarp();
    if (lane == 0) {                      // this warp is done with both
      mbar_arrive(&sm.wfree[q]);
      mbar_arrive(&sm.empty[s]);
    }
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] += part[i];
  };
  Frags fa, fb;
  mbar_wait(&sm.full[0], 0);
  load_frags(sm.ring, g, t, fa);
  for (int it = 0; it < nk; it += 2) {
    panel(it, fa, fb);
    if (it + 1 < nk) panel(it + 1, fb, fa);
  }

  // epilogue: rows inside cap, columns inside f; rows at or past live as
  // zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + g + 8 * i;
    if (r >= cap) continue;
    const bool keep = r < live;
    float* yr = ye + (size_t)r * f + n0 + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      if (n0 + c0 + 8 * j + 2 * t < f)
        *reinterpret_cast<float2*>(yr + 8 * j) =
            keep ? make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1])
                 : make_float2(0.0f, 0.0f);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
moe_gemm_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const int* __restrict__ rows, float* __restrict__ y,
                     int cap, int d, int f) {
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int live = rows ? min(max(rows[e], 0), cap) : cap;
  float* ye = y + (size_t)e * cap * f;
  if (m0 >= live) {                       // nothing live: zeros, no loads
    zero_rows(ye, m0, min(m0 + BM, cap), n0, min(BN, f - n0), f, tid,
              THREADS);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  if (tid == 0) {
    for (int s = 0; s < RST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NCONS / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < WST; ++s) {
      mbar_init(&sm.staged[s], NSTAGE);
      mbar_init(&sm.wfree[s], NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nk = (d + BK - 1) / BK;
  if (tid >= NCONS) {
    // producer warpgroups: one thread keeps the ring full, the other seven
    // warps stage every w panel
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (tid == NCONS) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % RST;
        mbar_wait(&sm.empty[s], ((it / RST) & 1) ^ 1);
        uint8_t* st = sm.ring + s * 2 * PANEL;
        mbar_expect_tx(&sm.full[s], 2 * PANEL);
        tma_load_3d(st, &xmap, &sm.full[s], it * BK, m0, e);
        tma_load_3d(st + PANEL, &wmap, &sm.full[s], n0, it * BK, e);
      }
    } else if (tid >= NCONS + 32) {
      const int st = tid - NCONS - 32;
      const int lane = tid % 32;
      for (int it = 0; it < nk; ++it) {
        const int s = it % RST, q = it % WST;
        mbar_wait(&sm.full[s], (it / RST) & 1);
        mbar_wait(&sm.wfree[q], ((it / WST) & 1) ^ 1);
        uint8_t* hi = sm.wt + q * 2 * PANEL;
        const uint32_t m = __reduce_max_sync(
            0xffffffffu, stage_w(sm.ring + s * 2 * PANEL + PANEL, hi,
                                 hi + PANEL, st));
        if (lane == 0) sm.wmag[q * MAGS + st / 32] = m;
        fence_proxy_async();
        mbar_arrive(&sm.staged[q]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));

  // consumers. More than 64 live rows in the tile: warpgroup wg takes tile
  // rows [64 wg, 64 wg + 64) at all 128 columns (m64n128k8). At most 64:
  // both take rows [0, 64), warpgroup wg the columns [64 wg, 64 wg + 64)
  // (m64n64k8), so two warpgroups still take turns at the tensor cores, and
  // rows [64, 128) are stored as zeros.
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int g = ((tid % 128) / 32) * 16 + lane / 4;
  if (live - m0 > 64) {
    consume<128>(sm, nk, 64 * wg + g, 0, t, lane, ye, m0, n0, cap, f, live);
  } else {
    consume<64>(sm, nk, g, 64 * wg, t, lane, ye, m0, n0, cap, f, live);
    zero_rows(ye, min(m0 + 64, cap), min(m0 + BM, cap), n0,
              min(BN, f - n0), f, tid, NCONS);
  }
}

// ---- host side -------------------------------------------------------------

// 3-D map over a contiguous (n2, n1, n0) float32 array: boxes of box0 x
// box1, zeros outside the array.
int encode_map(CUtensorMap* map, const void* base, uint64_t n2, uint64_t n1,
               uint64_t n0, uint32_t box0, uint32_t box1,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return -2;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 4, n1 * n0 * 4};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

}  // namespace

// rows: int32 (E,) or null (every row live). Returns the cudaError_t of the
// launch (0 on success), -1 for arguments the kernel does not take, -2 when
// the CUDA driver API's cuTensorMapEncodeTiled cannot be reached, -3 when
// it refuses a tensor map.
extern "C" int moe_gemm_tf32_launch(const void* x, const void* w,
                                    const void* rows, void* y, int E, int cap,
                                    int d, int f, void* stream) {
  if (E <= 0 || cap <= 0 || d <= 0 || f <= 0 || d % 8 || f % 8) return -1;
  CUtensorMap xm, wm;
  // x: 32 columns (128 bytes) x 128 rows, 128-byte swizzle (K-major for
  // wgmma); w: 128 columns x 32 rows, row-major
  int err = encode_map(&xm, x, E, cap, d, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_map(&wm, w, E, d, f, BN, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  const cudaError_t st = cudaFuncSetAttribute(
      moe_gemm_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (st != cudaSuccess) return (int)st;
  const dim3 grid((cap + BM - 1) / BM, (f + BN - 1) / BN, E);
  moe_gemm_tf32_kernel<<<grid, THREADS, SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      xm, wm, static_cast<const int*>(rows), static_cast<float*>(y), cap, d,
      f);
  return (int)cudaGetLastError();
}

// The blocking of every launch: out[0] rows and out[1] columns a CTA,
// out[2] the k-panel depth, out[3] the TMA ring's stages, out[4] the staged
// w^T stages, out[5] the dynamic shared memory in bytes (ptxas reports only
// static shared memory).
extern "C" void moe_gemm_tf32_config(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  out[3] = RST;
  out[4] = WST;
  out[5] = SMEM;
}
