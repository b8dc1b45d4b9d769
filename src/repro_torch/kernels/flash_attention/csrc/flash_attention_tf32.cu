// Online-softmax attention forward on Hopper's tensor cores (sm_90a) at
// float32 accuracy: float32 q, k, v and o, split-TF32 wgmma for QK^T and PV,
// fp32 logits, softmax state and accumulator.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _attn_kernel) for float32, in place of the CUDA-core kernel
// flash_attention.cu (kept for timings). For every batch b, query head h and
// query row r,
//
//     o[b, r, h] = sum_c softmax_c(mask(softcap(scale * q[b,r,h] . k[b,c,h/rep])))
//                  * v[b, c, h/rep]
//
// with the Pallas kernel's semantics: scale, then softcap, then the mask
// (causal c <= r, window c > r - window, and keys at or past S) to -1e30;
// p = mask ? exp(s - m) : 0 against the running row max m; l and the
// accumulator rescaled by exp(m_old - m_new); a row whose l is 0 divides by
// 1. exp(s - m) is computed as 2^(s' - m') with s' and m' in log2 units.
//
// Arithmetic (split TF32). A tf32 wgmma reads the top 19 bits of each fp32
// word: one pass keeps about 2^-11 relative error, past the float32
// tolerance. So every operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (hopper.cuh's split), and each product sums the
// three terms lo.hi + hi.lo + hi.hi in fp32 accumulators, for QK^T (q and k
// split in shared memory) and for PV (p split in registers, v in shared
// memory): about 2^-21 relative error; lo.lo (2^-22) is left out. Which
// hi: the rounded one, written over the landed fp32 tile in place. Using
// the landed tile as it lies as hi (the tensor core's own reading of the
// word) would need the card's reading of the low 13 bits verified, and
// saves no buffer here, since hi takes the landed tile's place anyway.
// The tensor core's fp32 accumulate truncates below the accumulator's last
// place (bsr_spgemm_tc.cu found that on an H100), so PV sums each key block
// into a fresh accumulator, the lo terms first, and the row's accumulator
// adds the blocks in IEEE fp32 registers; QK^T is fresh every block too.
// The split breaks IEEE's non-finite rules and its hi.hi can overflow where
// the fp32 product does not: for q = k = nextafter(2^64, 0) in one
// coordinate and -q, k in another k-step, hi.hi adds 2^128 to the
// accumulator and the logit comes out inf where the plain one is finite.
// So a key block whose largest |k| and the CTA's largest |q| meet
// hopper.cuh's unsplit_panel (either an infinity, a NaN or >= 2^127, or a
// product that is NaN or >= 2^126) takes its QK^T unsplit: IEEE fp32 FMAs
// on the CUDA cores, from q and k in device memory. PV needs no such test,
// since p <= 1. So q and k may hold any value; v must be finite and below
// 2^127 in magnitude (the split keeps a non-finite v whole in hi, and
// 0 * inf is NaN), and the scaled logits below FLT_MAX / log2(e) (they are
// kept in log2 units). The CPU model is ref.attention_tf32_model.
//
// Bound. At qwen2-moe-a2.7b's prefill (q, k, v (4, 2048, 16, 128), causal)
// the unmasked (row, key) pairs need 68.75 GFLOP of QK^T and PV against
// 268 MB of q, k, v and o (0.080 ms at 3.35 TB/s). Three TF32 passes are
// 206 GFLOP: 0.417 ms at the tensor-core peak (494.7 TFLOP/s), so the
// launch is bound by operations; the same work as fp32 FMAs on the CUDA
// cores (66.9 TFLOP/s) is 1.028 ms.
//
// Design.
// * Layout. q, k, v and o stay in the model layout (B, S, H, D); a query
//   head h reads kv head h / rep through the tensor map's coordinate. Q and
//   K land through 4-D TMA maps over (D, H, S, B) in 32-column boxes (128
//   bytes a row, 128-byte swizzle: the K-major layout wgmma reads); V lands
//   row-major and unswizzled, a whole block in one box. TMA bounds-checks
//   every dimension, so rows past S and columns past D arrive as zeros: a
//   head dim D is processed at DP = D rounded up to 32 (224 to 256), the
//   zero columns add nothing to QK^T, and PV's extra columns are not
//   stored.
// * Work division. One CTA per (BQ query rows, head, batch): one or two
//   consumer warpgroups of 64 rows and a producer warpgroup. One thread of
//   the producer loads Q once and keeps rings of K and V blocks of BK keys
//   in flight (separate barriers for K and V); its other three warps stage
//   the blocks. At two consumer warpgroups the producer gives its
//   registers to them (setmaxnreg 56 / 224). Only the key blocks from the
//   window's first reachable block to the causal frontier are loaded; the
//   grid runs the longest causal rows of every (head, batch) first.
// * Staging. The consumers split Q once (hi in place, lo beside it). The
//   producer's staging warps split each K block the same way (lo into one
//   K lo buffer) as soon as every QK^T of the block before is done, and
//   transpose and split each V block into V^T hi and lo as soon as every
//   PV of the block before is done; mbarriers hand each buffer over in
//   both directions (ready: 96 staging threads arrive; free: every
//   consumer warp arrives), so the staging runs beside the consumers'
//   MMAs and softmax, and the two consumer warpgroups never wait for each
//   other. tf32 wgmma takes shared-memory operands K-major only (no
//   transpose bit), so V (keys x D, D contiguous) becomes V^T, DP rows of
//   BK keys, 128-byte swizzled (64-byte at BK 16), lanes along D so that
//   the loads and the 16-byte stores are free of bank conflicts.
// * S = Q K^T: wgmma m64nBKk8, Q as A and K as B in shared memory, both
//   K-major as stored. The consumers fold Q's largest magnitude while they
//   split it, each staging warp K's while it splits a block (qk_mag), and a
//   block where unsplit_panel holds for the two replaces its S by qk_fma's.
//   Softmax in fp32 registers on the accumulator
//   fragment; the mask is applied only in blocks that cross the causal
//   diagonal, the window's edge or S. A warpgroup skips the MMAs of a
//   block that is fully masked for its 64 rows.
// * O += P V: P is the register A operand, split in registers. The
//   accumulator fragment holds keys 2t and 2t + 1 of each group of 8 where
//   the tf32 A fragment wants keys t and t + 4, so the keys of each group
//   are taken in the order 0 2 4 6 1 3 5 7 (A column t is key 2t, column
//   t + 4 key 2t + 1), and the V^T staging writes its key columns in that
//   same order: the product is unchanged and P needs no shuffle. PV runs
//   in m64n128k8 column chunks (m64n64k8 or m64n32k8 where 128 does not
//   divide DP).
// * Epilogue: divide by l (1 where l is 0) and store the rows inside S and
//   the columns inside D. No atomics and a fixed order of the key blocks:
//   a launch repeats bitwise.
//
// Shared memory per DP (Cfg below), in bytes, besides 1024 of slack that
// aligns the buffers to the swizzle atoms, the barriers and the four
// magnitude words (Q's, and K's per staging warp); Q hi and lo,
// KST K stages (hi in place) and K lo, VST V stages and V^T hi and lo:
//   DP   BQ  BK   Q hi+lo   K stages+lo   V stages   V^T hi+lo   total
//   32  128  64   2 x 16    3 x  8        2 x  8     2 x  8       88 KB
//   64  128  64   2 x 32    3 x 16        2 x 16     2 x 16      176 KB
//   96  128  32   2 x 48    3 x 12        2 x 12     2 x 12      180 KB
//  128  128  32   2 x 64    3 x 16        1 x 16     2 x 16      224 KB
//  160   64  32   2 x 40    3 x 20        2 x 20     2 x 20      220 KB
//  192   64  32   2 x 48    2 x 24        1 x 24     2 x 24      216 KB
//  256   64  16   2 x 64    3 x 16        1 x 16     2 x 16      224 KB
// Q's hi and lo take half of it from DP 128 up; with a V ring of one stage
// the next V block lands while this block's V^T is in use.
//
// Not yet done (speed work): double-buffered staged operands, so that a
// warpgroup could issue the next block's QK^T before its softmax (no
// shared memory is left for them at DP 128), a persistent tile loop and a
// TMA-store epilogue. Turns of the two warpgroups at the MMAs (QK^T of
// warpgroup 0, QK^T of 1, PV of 0, PV of 1 through named barriers) made
// the launch slower on an H100 and were dropped; so were one consumer
// warpgroup of 64 rows over 64-key blocks at DP 128, and a (batch, head)
// major grid order meant to share K and V in L2.
//
// Requirements (checked by the wrapper): D a multiple of 8 up to 256, Hkv
// dividing Hq, tensors contiguous and 16-byte aligned. Tensor maps are
// encoded per launch on the host by cuTensorMapEncodeTiled (reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda) and passed as
// __grid_constant__ parameters.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr int CONSUMER_BAR = 1;     // named barrier of the consumer threads
// setmaxnreg at two consumer warpgroups: registers a producer thread keeps
// (its staging warps need more than a TMA issuer) / a consumer gets. Their
// sum per SM sub-partition lane, 56 + 2 x 224 = 504, stays below the 512
// the register file holds: at 48 + 2 x 232 = 512 the consumers' increase
// never completed on an H100 and the launch hung.
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int NWG = DP <= 128 ? 2 : 1;      // consumer warpgroups
  static constexpr int NCONS = NWG * 128;
  static constexpr int THREADS = NCONS + 128;        // + producer warpgroup
  static constexpr int NSTAGE = 96;                  // its staging threads
  static constexpr int BQ = NWG * 64;                // query rows per CTA
  static constexpr int BK = DP <= 64 ? 64 : DP <= 192 ? 32 : 16;
  static constexpr int KST = DP == 192 ? 1 : 2;      // K stages
  static constexpr int VST = DP <= 96 || DP == 160 ? 2 : 1;
  static constexpr int PC =                          // PV column chunk
      DP % 128 == 0 ? 128 : DP % 64 == 0 ? 64 : 32;
  // PV columns summed per wgmma group: all of DP where the accumulator
  // fits twice in the registers, one chunk at a time above
  static constexpr int PART = DP <= 128 ? DP : PC;
  static constexpr int NBOX = DP / 32;               // 32-column boxes a row
  static constexpr int Q_BOX = BQ * 128;             // bytes of one Q box
  static constexpr int K_BOX = BK * 128;             // of one K box
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * K_BOX;      // one K, V or V^T block
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + (KST + VST + 3) * KV_BYTES
                              + (5 + 2 * KST + 2 * VST) * 8 + 4 * 4;
  static_assert(SMEM <= 232448, "shared memory past the 227 KB a CTA has");
  static_assert(KV_BYTES % 1024 == 0, "buffers on 1024-byte atoms");
};

// 2^x (MUFU.EX2; relative error about 2^-22, subnormal results flushed)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int NCONS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" :: "n"(CONSUMER_BAR), "n"(NCONS)
               : "memory");
}

// Split `n16` 16-byte chunks in place: hi over the fp32 tile, lo into `lo`
// at the same offsets (the swizzled layout is kept: the split is
// elementwise). Returns the largest magnitude bits this thread saw.
template <int NTHREADS>
__device__ __forceinline__ uint32_t split_tile(uint8_t* tile, uint8_t* lo,
                                               int n16, int tid) {
  float4* h = reinterpret_cast<float4*>(tile);
  float4* l = reinterpret_cast<float4*>(lo);
  uint32_t m = 0;
#pragma unroll 2
  for (int i = tid; i < n16; i += NTHREADS) {
    const float4 v = h[i];
    m = mag4(m, v);
    float4 a, b;
    split(v.x, a.x, b.x);
    split(v.y, a.y, b.y);
    split(v.z, a.z, b.z);
    split(v.w, a.w, b.w);
    h[i] = a;
    l[i] = b;
  }
  return m;
}

// S = Q K^T of one block in IEEE fp32 on the CUDA cores, for a block the
// split must not take: this thread's fragment (rows row0 and row0 + 8, keys
// k0 + 8 j + cq (+ 1)), each a dot product over d = 0 .. D - 1 of q and k as
// they lie in device memory ((B, S, H, D), row stride H D). Rows and keys
// past S give 0 (the mask drops those keys; those rows are not stored).
template <int BK>
__device__ __forceinline__ void qk_fma(float (&sacc)[BK / 2],
                                       const float* q, const float* k, int S,
                                       int Hq, int Hkv, int D, int b, int h,
                                       int hk, int row0, int k0, int cq) {
  const float* qr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    qr[i] = row < S ? q + ((size_t)(b * S + row) * Hq + h) * D : nullptr;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + cq + e;
      float s0 = 0.0f, s1 = 0.0f;
      if (key < S) {
        const float* kr = k + ((size_t)(b * S + key) * Hkv + hk) * D;
#pragma unroll 1
        for (int d = 0; d < D; ++d) {
          const float kv = kr[d];
          if (qr[0]) s0 = fmaf(qr[0][d], kv, s0);
          if (qr[1]) s1 = fmaf(qr[1][d], kv, s1);
        }
      }
      sacc[4 * j + e] = s0;
      sacc[4 * j + 2 + e] = s1;
    }
}

// Byte offset, in V^T, of the 16-byte chunk `cc` (logical key columns
// 4 cc .. 4 cc + 3) of row d. BK >= 32: 32-key boxes of DP rows x 128 bytes,
// chunk c of a row at c ^ (d % 8); BK 16: rows of 64 bytes, chunk c at
// c ^ ((d / 2) % 4).
template <int DP, int BK>
__device__ __forceinline__ int vt_offset(int d, int cc) {
  if constexpr (BK >= 32)
    return (cc / 8) * DP * 128 + d * 128 + (((cc % 8) ^ (d & 7)) << 4);
  else
    return d * 64 + ((cc ^ ((d >> 1) & 3)) << 4);
}

// V (BK keys x DP, row-major as landed) into V^T hi and lo, K-major: row d,
// logical key column L. Within each group of 8 keys, logical column t is
// key 2t and column t + 4 is key 2t + 1 (the P fragment's order), so chunk
// cc holds keys 8 (cc / 2) + (cc % 2) + {0, 2, 4, 6}. Lanes run along d.
template <int DP, int BK, int NTHREADS>
__device__ __forceinline__ void stage_v(const uint8_t* raw, uint8_t* vt_hi,
                                        uint8_t* vt_lo, int tid) {
  const float* v = reinterpret_cast<const float*>(raw);
#pragma unroll 2
  for (int i = tid; i < DP * BK / 4; i += NTHREADS) {
    const int d = i % DP, cc = i / DP;
    const int key = 8 * (cc / 2) + (cc & 1);
    float4 h, l;
    split(v[key * DP + d], h.x, l.x);
    split(v[(key + 2) * DP + d], h.y, l.y);
    split(v[(key + 4) * DP + d], h.z, l.z);
    split(v[(key + 6) * DP + d], h.w, l.w);
    const int off = vt_offset<DP, BK>(d, cc);
    *reinterpret_cast<float4*>(vt_hi + off) = h;
    *reinterpret_cast<float4*>(vt_lo + off) = l;
  }
}

// wgmma descriptor of V^T (at shared address vt) and the step, in its
// address field (bytes / 16), to k-step kk (8 keys) at column chunk n0.
template <int BK>
__device__ __forceinline__ uint64_t vt_desc(uint32_t vt) {
  if constexpr (BK >= 32)
    return sw128_desc(vt, 16, 1024);
  else
    return sw64_desc(vt, 16, 512);
}

template <int DP, int BK>
__device__ __forceinline__ int vt_step(int kk, int n0) {
  if constexpr (BK >= 32)
    return ((kk / 4) * DP * 128 + n0 * 128 + (kk % 4) * 32) >> 4;
  else
    return (n0 * 64 + kk * 32) >> 4;
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::THREADS, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const float* __restrict__ qg,
                      const float* __restrict__ kg, float* __restrict__ o,
                      int S, int Hq, int Hkv, int D, float scale, int causal,
                      int window, float softcap) {
  using C = Cfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NCONS = C::NCONS;
  constexpr int KST = C::KST, VST = C::VST;
  constexpr int NWARPS = NCONS / 32;      // consumer warps
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_hi = smem;                               // Q, split in place
  uint8_t* q_lo = q_hi + C::Q_BYTES;
  uint8_t* k_ring = q_lo + C::Q_BYTES;                // K, split in place
  uint8_t* k_lo = k_ring + KST * C::KV_BYTES;
  uint8_t* v_ring = k_lo + C::KV_BYTES;               // V stages, as landed
  uint8_t* vt_hi = v_ring + VST * C::KV_BYTES;
  uint8_t* vt_lo = vt_hi + C::KV_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vt_lo + C::KV_BYTES);
  uint64_t* kfull = qfull + 1;
  uint64_t* kempty = kfull + KST;
  uint64_t* vfull = kempty + KST;
  uint64_t* vempty = vfull + VST;
  uint64_t* klo_ready = vempty + VST;     // K lo of this block staged
  uint64_t* klo_free = klo_ready + 1;     // every QK^T of the block done
  uint64_t* vt_ready = klo_free + 1;      // V^T of this block staged
  uint64_t* vt_free = vt_ready + 1;       // every PV of the block done
  // largest magnitude bits: [0] of Q (every consumer folds into it), [1 + w]
  // of this K block's share that staging warp w split
  uint32_t* qk_mag = reinterpret_cast<uint32_t*>(vt_free + 1);

  // the grid is query block major, longest causal rows first across every
  // (head, batch), so the last CTAs to start are the shortest
  const int tid = threadIdx.x;
  const int nqb = (S + BQ - 1) / BQ;
  const int heads = gridDim.x / nqb;             // Hq * B
  const int rank = blockIdx.x / heads;
  const int h = blockIdx.x % Hq;
  const int b = (blockIdx.x % heads) / Hq;
  const int q0 = (causal ? nqb - 1 - rank : rank) * BQ;
  const int hk = h / (Hq / Hkv);
  // key blocks from the window's first reachable one to the causal frontier
  const int nkb = (S + BK - 1) / BK;
  const int kb_end = causal ? min(nkb, (min(q0 + BQ, S) - 1) / BK + 1) : nkb;
  const int kb_begin =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int nblk = kb_end - kb_begin;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], NWARPS);
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], C::NSTAGE);
    }
    mbar_init(klo_ready, C::NSTAGE);
    mbar_init(klo_free, NWARPS);
    mbar_init(vt_ready, C::NSTAGE);
    mbar_init(vt_free, NWARPS);
    qk_mag[0] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // producer warpgroup: one thread of its first warp loads Q once and
    // keeps the K and V rings full; its other three warps stage every
    // block for the consumers
    if constexpr (C::NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (tid == NCONS) {
      mbar_expect_tx(qfull, C::Q_BYTES);
      for (int c = 0; c < C::NBOX; ++c)
        tma_load_4d(q_hi + c * C::Q_BOX, &qmap, qfull, c * 32, h, q0, b);
      for (int it = 0; it < nblk; ++it) {
        const int k0 = (kb_begin + it) * BK;
        const int ks = it % KST, vs = it % VST;
        mbar_wait(&kempty[ks], ((it / KST) & 1) ^ 1);
        uint8_t* kd = k_ring + ks * C::KV_BYTES;
        mbar_expect_tx(&kfull[ks], C::KV_BYTES);
        for (int c = 0; c < C::NBOX; ++c)
          tma_load_4d(kd + c * C::K_BOX, &kmap, &kfull[ks], c * 32, hk, k0, b);
        mbar_wait(&vempty[vs], ((it / VST) & 1) ^ 1);
        mbar_expect_tx(&vfull[vs], C::KV_BYTES);
        tma_load_4d(v_ring + vs * C::KV_BYTES, &vmap, &vfull[vs], 0, hk, k0,
                    b);
      }
    } else if (tid >= NCONS + 32) {
      // stagers: K split in place (lo into k_lo) once every QK^T of the
      // block before is done; V transposed and split into V^T once every
      // PV of the block before is done
      const int st = tid - NCONS - 32;
      for (int it = 0; it < nblk; ++it) {
        const int ks = it % KST, vs = it % VST;
        const uint32_t ph = it & 1;
        mbar_wait(&kfull[ks], (it / KST) & 1);
        mbar_wait(klo_free, ph ^ 1);
        const uint32_t m = __reduce_max_sync(
            0xffffffffu, split_tile<C::NSTAGE>(k_ring + ks * C::KV_BYTES,
                                               k_lo, C::KV_BYTES / 16, st));
        if (tid % 32 == 0) qk_mag[1 + st / 32] = m;
        fence_proxy_async();
        mbar_arrive(klo_ready);
        mbar_wait(&vfull[vs], (it / VST) & 1);
        mbar_wait(vt_free, ph ^ 1);
        stage_v<DP, BK, C::NSTAGE>(v_ring + vs * C::KV_BYTES, vt_hi, vt_lo,
                                   st);
        fence_proxy_async();
        mbar_arrive(vt_ready);
        mbar_arrive(&vempty[vs]);
      }
    }
    return;
  }
  if constexpr (C::NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));

  // consumers: warpgroup wg owns query rows [r0, r0 + 64). Fragment (warp
  // w, lane l) of an m64nN accumulator holds rows r0 + 16 w + l / 4 (+ 8)
  // and columns 8 j + 2 (l % 4) (+ 1): element 4 j + 2 i + e is row
  // row0 + 8 i, column 8 j + 2 (l % 4) + e.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = q0 + wg * 64;
  const int r_last = r0 + 63;
  const int row0 = r0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // logits and the row max m are kept in log2 units (times log2 e), so
  // exp(s - m) is one 2^x
  const bool cap = softcap > 0.0f;
  const float scale_log2 = scale * kLog2e;
  const float scale_cap = cap ? scale / softcap : 0.0f;
  const float cap_log2 = softcap * kLog2e;
  const uint32_t qh_base = smem_u32(q_hi) + wg * 64 * 128;
  const uint32_t ql_base = smem_u32(q_lo) + wg * 64 * 128;
  const uint32_t kl_base = smem_u32(k_lo);
  const uint64_t vth = vt_desc<BK>(smem_u32(vt_hi));
  const uint64_t vtl = vt_desc<BK>(smem_u32(vt_lo));

  mbar_wait(qfull, 0);
  const uint32_t qm = __reduce_max_sync(
      0xffffffffu, split_tile<NCONS>(q_hi, q_lo, C::Q_BYTES / 16, tid));
  if (lane == 0) atomicMax(&qk_mag[0], qm);
  fence_proxy_async();
  consumer_sync<NCONS>();
  const float q_mag = __uint_as_float(qk_mag[0]);

  float acc[DP / 2];
  float part[C::PART / C::PC][C::PC / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < C::PART / C::PC; ++c)
#pragma unroll
    for (int i = 0; i < C::PC / 2; ++i) part[c][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};          // this thread's columns only

  for (int it = 0; it < nblk; ++it) {
    const int ks = it % KST;
    const uint32_t ph = it & 1;
    const int k0 = (kb_begin + it) * BK;
    const uint32_t kh_base = smem_u32(k_ring + ks * C::KV_BYTES);
    // warpgroup-uniform: is the block fully masked for these 64 rows, or
    // does any (row, key) of it need the mask? A dead block's MMAs are
    // skipped, its barriers kept.
    const bool dead = r0 >= S || (causal && k0 > r_last) ||
                      (window > 0 && k0 + BK - 1 <= r0 - window);
    const bool masked = (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && k0 <= r_last - window) || k0 + BK > S;

    // S = Q K^T: lo.hi, hi.lo, then hi.hi, each over DP / 8 k-steps; step
    // 4 c + j reads box c at byte 32 j of each 128-byte row, 8-row groups
    // 1024 B apart. Descriptors advance by their address field (bytes / 16);
    // the box loop stays rolled so they are not all held in registers. A
    // block where unsplit_panel holds for Q's and this K block's largest
    // magnitudes (uniform over the CTA) then overwrites the accumulator
    // with qk_fma's: placed after the wgmma, not beside it as an else, the
    // rare branch costs the loop half as much (tools/ab_flash_fp32.py).
    float sacc[BK / 2];
    mbar_wait(klo_ready, ph);
    const uint32_t k_bits = max(max(qk_mag[1], qk_mag[2]), qk_mag[3]);
    const bool unsplit = unsplit_panel(q_mag, __uint_as_float(k_bits));
    __syncwarp();                         // every lane has read qk_mag
    if (!dead) {
      __syncwarp();                       // wgmma is .sync.aligned
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint64_t da =
            sw128_desc(pass == 0 ? ql_base : qh_base, 16, 1024);
        const uint64_t db =
            sw128_desc(pass == 1 ? kl_base : kh_base, 16, 1024);
#pragma unroll 1
        for (int c = 0; c < C::NBOX; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_tf32(sacc, da + c * (C::Q_BOX >> 4) + 2 * j,
                       db + c * (C::K_BOX >> 4) + 2 * j, pass + c + j > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      if (unsplit)
        qk_fma<BK>(sacc, qg, kg, S, Hq, Hkv, D, b, h, hk, row0, k0, cq);
    }
    if (lane == 0) {                      // this warp is done with K
      mbar_arrive(klo_free);
      mbar_arrive(&kempty[ks]);
    }

    // scale, softcap, mask; online softmax per row (4 lanes share a row);
    // the accumulator is rescaled by alpha where the block's PV is added
    float rescale[2];
    uint32_t ph_a[BK / 8][4], pl_a[BK / 8][4];
    if (!dead) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = sacc[4 * j + 2 * i + e];
            float x = cap ? cap_log2 * tanhf(a * scale_cap) : a * scale_log2;
            if (masked) {
              const int col = k0 + 8 * j + cq + e;
              const bool ok = col < S && (!causal || col <= row) &&
                              (window <= 0 || col > row - window);
              x = ok ? x : kNegInf;
            }
            sacc[4 * j + 2 * i + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = ex2(m[i] - m_new);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = ex2(sacc[4 * j + 2 * i + e] - m_new);
            if (masked) {
              const int col = k0 + 8 * j + cq + e;
              const bool ok = col < S && (!causal || col <= row) &&
                              (window <= 0 || col > row - window);
              p = ok ? p : 0.0f;
            }
            sacc[4 * j + 2 * i + e] = p;
            rs += p;
          }
        }
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
        rescale[i] = alpha;
      }

      // P hi and lo as tf32 A fragments: k-step kk is keys [8 kk, 8 kk + 8);
      // this thread holds keys 2t, 2t + 1 (t = lane % 4) of rows g, g + 8,
      // which are A columns t, t + 4 in the key order V^T was staged in
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int src[4] = {0, 2, 1, 3};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = sacc[4 * kk + src[r]];   // finite, in [0, 1]
          const float hi = tf32_rna(p);
          ph_a[kk][r] = __float_as_uint(hi);
          pl_a[kk][r] = __float_as_uint(tf32_rna(p - hi));
        }
      }
    }

    // O = alpha O + P V over column groups of PART: lo.hi, hi.lo, hi.hi per
    // chunk of PC into a fresh accumulator, added to the rescaled acc in
    // IEEE fp32 (one FMA)
    mbar_wait(vt_ready, ph);
    if (!dead) {
#pragma unroll
      for (int g0 = 0; g0 < DP; g0 += C::PART) {
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < C::PART / C::PC; ++c) {
          const int n0 = g0 + c * C::PC;
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk)
              wgmma_tf32_rs(part[c], pass == 0 ? pl_a[kk] : ph_a[kk],
                            (pass == 1 ? vtl : vth) + vt_step<DP, BK>(kk, n0),
                            pass + kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::PART / C::PC; ++c) {
          fence_acc(part[c]);
#pragma unroll
          for (int i = 0; i < C::PC / 2; ++i) {
            float& a = acc[(g0 + c * C::PC) / 2 + i];
            a = fmaf(a, rescale[(i / 2) % 2], part[c][i]);
          }
        }
      }
    }
    if (lane == 0) mbar_arrive(vt_free);  // this warp is done with V^T
  }

  // epilogue: l summed over the 4 lanes of a row; divide (l == 0 -> 1);
  // store the rows inside S and the columns inside D
  const size_t row_stride = (size_t)Hq * D;
  float* ob = o + (size_t)b * S * row_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float denom = li == 0.0f ? 1.0f : li;
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    float* orow = ob + (size_t)row * row_stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) = make_float2(
            acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
    }
  }
}

// ---- host side -------------------------------------------------------------

// 4-D map over a contiguous (B, S, H, D) float32 tensor, dimensions (D, H,
// S, B) innermost first: boxes of `cols` columns x 1 head x `rows`
// positions, zeros outside the tensor.
int encode_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
               int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)S * H * D * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int D, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap qm, km, vm;
  // Q and K: 32 columns (128 bytes) a box, 128-byte swizzle; V: a whole
  // block of DP columns, row-major
  int err = encode_map(&qm, q, B, S, Hq, D, 32, C::BQ,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_map(&km, k, B, S, Hkv, D, 32, C::BK,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_map(&vm, v, B, S, Hkv, D, DP, C::BK,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  auto kern = flash_fwd_tf32_kernel<DP>;
  const cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (st != cudaSuccess) return (int)st;
  const dim3 grid(((S + C::BQ - 1) / C::BQ) * Hq * B);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(o), S, Hq, Hkv, D, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

// The padded head dim a launch at head dim d runs at: d rounded up to 32,
// with 224 taken to 256.
int padded(int d) {
  const int dp = (d + 31) / 32 * 32;
  return dp == 224 ? 256 : dp;
}

template <int DP>
void config_of(int* out) {
  out[0] = DP;
  out[1] = Cfg<DP>::BQ;
  out[2] = Cfg<DP>::BK;
  out[3] = Cfg<DP>::SMEM;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success), -1 for arguments the
// kernel does not take, -2 when the CUDA driver API's cuTensorMapEncodeTiled
// cannot be reached, -3 when it refuses a tensor map.
extern "C" int flash_attention_tf32_launch(int d, const void* q,
                                           const void* k, const void* v,
                                           void* o, int B, int S, int Hq,
                                           int Hkv, float scale, int causal,
                                           int window, float softcap,
                                           void* stream) {
  if (d <= 0 || d > 256 || d % 8 || B <= 0 || S <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded(d)) {
    case 32:
      return launch<32>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                        softcap, st);
    case 64:
      return launch<64>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                        softcap, st);
    case 96:
      return launch<96>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                        softcap, st);
    case 128:
      return launch<128>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                         softcap, st);
    case 160:
      return launch<160>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                         softcap, st);
    case 192:
      return launch<192>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                         softcap, st);
    default:
      return launch<256>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                         softcap, st);
  }
}

// The blocking of a launch at head dim d: out[0] the padded head dim,
// out[1] query rows and out[2] keys a block, out[3] the dynamic shared
// memory in bytes (ptxas reports only static shared memory).
extern "C" void flash_attention_tf32_config(int d, int* out) {
  switch (padded(d)) {
    case 32: return config_of<32>(out);
    case 64: return config_of<64>(out);
    case 96: return config_of<96>(out);
    case 128: return config_of<128>(out);
    case 160: return config_of<160>(out);
    case 192: return config_of<192>(out);
    default: return config_of<256>(out);
  }
}
