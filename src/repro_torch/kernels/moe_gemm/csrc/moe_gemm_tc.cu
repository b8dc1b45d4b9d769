// Grouped expert GEMM on Hopper's tensor cores (sm_90a): bf16 in, fp32
// accumulate, bf16 out.
//
// Replaces src/repro/kernels/moe_gemm/kernel.py::moe_gemm_pallas (body
// _kernel) for bfloat16. For every expert e of a capacity-bucketed MoE
// layer, with live = clamp(rows[e], 0, cap) (cap when rows is null),
//
//     y[e][r] = x[e][r] @ w[e]   for r < live,     y[e][r] = 0 for r >= live
//
// x (E, cap, d), w (E, d, f), y (E, cap, f), all contiguous. The Pallas
// kernel computes dot_general(x, w, preferred_element_type=f32) on bf16
// blocks: bf16 products summed in fp32, which is what bf16 MMA with fp32
// accumulators computes; only the summation order differs. The contraction
// runs over all of d (the Pallas kernel drops the last d % 512 columns when
// d is not a multiple of 512; this one does not). Rows at or past `live`
// are zero in the MoE layer's buckets and nobody reads their outputs, so
// neither kernel reads those x rows or forms their products.
//
// Two kernels, chosen by the wrapper from cap (kernel.py::route):
//
// * moe_gemm_tc_prefill_kernel, cap > 16. At qwen2-moe-a2.7b's prefill
//   (cap 688, d 2048, f 1408, 12,417 live rows of 44,032) the function
//   needs 72 GFLOP and ~0.52 GB (live x rows, the 60 routed experts'
//   weights, y written whole): bound by bytes, ~0.16 ms on an H100 SXM;
//   the live 128-row tiles (about 160 of 384) hold ~118 GFLOP, 0.12 ms at
//   the bf16 tensor-core peak. One CTA per 128 x 128 output tile, the M
//   tile fastest in the grid so the M tiles of one (expert, N tile) run
//   together and w[e] comes from HBM about once, from L2 after that. A
//   producer warp keeps a 4-stage ring of 64-deep k-panels filled by TMA
//   (3-D tensor maps over (E, cap, d) and (E, d, f), 128-byte swizzle,
//   32 KB a stage; TMA's zero fill covers rows past cap and the k tail, so
//   nothing is padded); two consumer warpgroups of 64 rows each run
//   wgmma.mma_async m64n128k16 with fp32 accumulators, keeping one k-panel
//   of MMAs in flight. A is x[e], K-major as stored; B is w[e] as stored,
//   N-major, read through wgmma's transpose bit, so the weights are never
//   copied. A CTA whose first row is past `live` stores its zeros and
//   returns before any load; a warpgroup whose 64 rows are all past `live`
//   runs no MMA.
//
// * moe_gemm_tc_decode_kernel, cap <= 16. At a decode step (cap 8, 16
//   token-expert assignments reaching ~10 of 64 experts) the work is
//   bound by reading the reached experts' weights: ~58 MB, ~0.017 ms.
//   Only experts with live > 0 read weights; the CTAs of the others zero
//   their slice of y and return. Grid (N tiles of 128, K splits of about
//   1024, E); the K splits of one (expert, N tile) form a thread-block
//   cluster, and blockIdx.z walks the live experts first, then the empty
//   ones (ranked with warp ballots, so a CTA that has nothing to do leaves
//   at once). Each CTA stages its split of x[e]'s <= 16 rows in shared
//   memory once, streams its w panels (32 x 128, 8 KB) through a 6-stage
//   TMA ring (48 KB in flight per CTA, two CTAs an SM at d = 2048), and
//   runs mma.sync m16n8k16 with the weights loaded by ldmatrix.trans.
//   Fewer, longer splits measured faster than more, shorter ones on the
//   card: the per-CTA start-up, not the bytes in flight, set the time
//   once every live CTA was resident. The splits are
//   reduced in a fixed order (rank 0, 1, ...) by the cluster's rank 0
//   through distributed shared memory: no float atomics, so a repeated
//   launch is bitwise equal.
//
// Requirements (checked by the wrapper): d and f multiples of 8, tensors
// contiguous and 16-byte aligned, rows int32 (E,) or null.
//
// Tensor maps are encoded per launch on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so the library needs no -lcuda,
// and passed as __grid_constant__ parameters.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout
// type 1); offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, fp32) += A (64 x 16, K-major) * B (16 x 128, N-major:
// transpose bit set), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, row) * b (16 x 8, col), bf16.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- shared helpers --------------------------------------------------------

__device__ __forceinline__ int live_rows(const int* rows, int e, int cap) {
  return rows ? min(max(rows[e], 0), cap) : cap;
}

// Zeros into y[e] rows [r0, r1) x columns [n0, n0 + nc), 16 bytes a store
// (f, n0 and nc are multiples of 8).
__device__ __forceinline__ void zero_rows(bf16* ye, int r0, int r1, int n0,
                                          int nc, int f, int tid, int nt) {
  const int vecs = nc / 8;
  for (int i = tid; i < (r1 - r0) * vecs; i += nt) {
    const int r = r0 + i / vecs, c = n0 + (i % vecs) * 8;
    *reinterpret_cast<uint4*>(ye + (size_t)r * f + c) = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_pair(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// ---- prefill: TMA + wgmma --------------------------------------------------

constexpr int PBM = 128, PBN = 128, PBK = 64, PST = 4;
constexpr int P_A_BYTES = PBM * PBK * 2;            // 16 KB: 128 rows x 128 B
constexpr int P_B_BYTES = PBK * PBN * 2;            // 16 KB: two 64-col boxes
constexpr int P_B_HALF = P_B_BYTES / 2;
constexpr int P_STAGE = P_A_BYTES + P_B_BYTES;      // 32 KB
constexpr int P_THREADS = 384;                      // 2 consumer WGs + producer
constexpr int P_SMEM = PST * P_STAGE + 1024 + 2 * PST * 8;

__global__ void __launch_bounds__(P_THREADS, 1)
moe_gemm_tc_prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const int* __restrict__ rows, bf16* __restrict__ y,
                           int cap, int d, int f) {
  const int m0 = blockIdx.x * PBM;
  const int n0 = blockIdx.y * PBN;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int live = live_rows(rows, e, cap);
  bf16* ye = y + (size_t)e * cap * f;
  const int nc = min(PBN, f - n0);
  if (m0 >= live) {                       // nothing live: zeros, no loads
    zero_rows(ye, m0, min(m0 + PBM, cap), n0, nc, f, tid, P_THREADS);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the ring to them
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PST * P_STAGE);
  uint64_t* empty = full + PST;
  if (tid == 0) {
    for (int s = 0; s < PST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per consumer WG
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nk = (d + PBK - 1) / PBK;
  const int wg = tid / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    if (tid == 256) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % PST;
        mbar_wait(&empty[s], ((it / PST) & 1) ^ 1);
        uint8_t* a = smem + s * P_STAGE;
        uint8_t* b = a + P_A_BYTES;
        mbar_expect_tx(&full[s], P_STAGE);
        tma_load_3d(a, &xmap, &full[s], it * PBK, m0, e);
        tma_load_3d(b, &wmap, &full[s], n0, it * PBK, e);
        tma_load_3d(b + P_B_HALF, &wmap, &full[s], n0 + 64, it * PBK, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64)
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const bool active = m0 + wg * 64 < live;
  const bool leader = (tid % 128) == 0;
  for (int it = 0; it < nk; ++it) {
    const int s = it % PST;
    mbar_wait(&full[s], (it / PST) & 1);
    __syncwarp();                         // wgmma is .sync.aligned
    if (active) {
      const uint32_t a = smem_u32(smem + s * P_STAGE) + wg * 64 * 128;
      const uint32_t b = smem_u32(smem + s * P_STAGE + P_A_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PBK / 16; ++kk) {
        // A: 8-row groups 1024 B apart, k advances 32 B inside the swizzle
        // row; B: 8-row k groups 1024 B apart, the two 64-column halves
        // 8 KB apart, k advances 16 rows = 2048 B
        wgmma_m64n128k16(acc, sw128_desc(a + kk * 32, 16, 1024),
                         sw128_desc(b + kk * 2048, P_B_HALF, 1024));
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();                    // the previous panel's MMAs are done
      if (leader && it > 0) mbar_arrive(&empty[(it - 1) % PST]);
    } else if (leader) {
      mbar_arrive(&empty[s]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: fragment (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and
  // columns 8 j + 2 (l % 4) (+ 1) of the warpgroup's 64 x 128 tile
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int rbase = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rbase + 8 * i;
      if (r < cap && col < f) {
        const bool keep = r < live;
        store_pair(ye + (size_t)r * f + col, keep ? acc[4 * j + 2 * i] : 0.0f,
                   keep ? acc[4 * j + 2 * i + 1] : 0.0f);
      }
    }
  }
}

// ---- decode: weight streaming, split K over a cluster ----------------------

// The z-th expert with live rows, in expert order, or, for z at or past
// their count, the (z - count)-th expert without: every warp ranks the
// experts 32 at a time with ballots (one coalesced load of rows a chunk).
__device__ __forceinline__ void pick_expert(const int* rows, int E, int cap,
                                            int z, int* e_out, int* live_out) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;
  int e = -1, live = 0, nlive = 0;
  for (int base = 0; base < E; base += 32) {
    const int r = base + lane < E ? live_rows(rows, base + lane, cap) : 0;
    const unsigned m = __ballot_sync(0xffffffffu, r > 0);
    const unsigned hit = __ballot_sync(
        0xffffffffu, r > 0 && nlive + __popc(m & below) == z);
    if (hit) {
      e = base + __ffs(hit) - 1;
      live = __shfl_sync(0xffffffffu, r, __ffs(hit) - 1);
    }
    nlive += __popc(m);
  }
  for (int base = 0, nd = nlive; e < 0 && base < E; base += 32) {
    const bool dead = base + lane < E && live_rows(rows, base + lane, cap) == 0;
    const unsigned m = __ballot_sync(0xffffffffu, dead);
    const unsigned hit = __ballot_sync(
        0xffffffffu, dead && nd + __popc(m & below) == z);
    if (hit) e = base + __ffs(hit) - 1;
    nd += __popc(m);
  }
  *e_out = e;
  *live_out = live;
}

constexpr int DM = 16, DBN = 128, DBK = 32, DST = 6;
constexpr int D_STAGE = DBK * DBN * 2;              // 8 KB: two 64-col boxes
constexpr int D_HALF = D_STAGE / 2;
constexpr int D_THREADS = 160;                      // 4 consumer warps + producer
constexpr int D_KS_ALIGN = 64;                      // split length granule

__global__ void __launch_bounds__(D_THREADS)
moe_gemm_tc_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                          const bf16* __restrict__ x,
                          const int* __restrict__ rows, bf16* __restrict__ y,
                          int E, int cap, int d, int f, int ks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * DBN;
  const int nc = min(DBN, f - n0);

  // blockIdx.z = z takes the z-th expert with live rows, then the empty ones
  int e, live;
  pick_expert(rows, E, cap, blockIdx.z, &e, &live);
  bf16* ye = y + (size_t)e * cap * f;
  if (live == 0) {                        // empty expert: zeros, no loads
    if (blockIdx.y == 0) zero_rows(ye, 0, cap, n0, nc, f, tid, D_THREADS);
    return;
  }

  const int kb = blockIdx.y * ks;
  const int nk = (min(ks, d - kb) + DBK - 1) / DBK;
  const int kpad = nk * DBK;
  const int lda = ks + 8;                 // staggers rows by 16 B: no conflicts

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sa = reinterpret_cast<bf16*>(ring + DST * D_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sa + DM * lda);
  uint64_t* empty = full + DST;
  if (tid == 0) {
    for (int s = 0; s < DST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp == 4) {
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % DST;
        mbar_wait(&empty[s], ((it / DST) & 1) ^ 1);
        uint8_t* b = ring + s * D_STAGE;
        mbar_expect_tx(&full[s], D_STAGE);
        tma_load_3d(b, &wmap, &full[s], n0, kb + it * DBK, e);
        tma_load_3d(b + D_HALF, &wmap, &full[s], n0 + 64, kb + it * DBK, e);
      }
    }
  } else {
    // stage x[e] rows [0, live) x [kb, kb + kpad) once; zeros elsewhere
    const int vpr = kpad / 8;
    for (int i = tid; i < DM * vpr; i += 128) {
      const int r = i / vpr, c = (i % vpr) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < live && kb + c < d)
        v = *reinterpret_cast<const uint4*>(x + ((size_t)e * cap + r) * d +
                                            kb + c);
      *reinterpret_cast<uint4*>(sa + r * lda + c) = v;
    }
    asm volatile("bar.sync 1, 128;" ::: "memory");

    // warp w owns columns [32 w, 32 w + 32): 16-byte chunks c0 .. c0 + 3 of
    // the 64-column box w / 2
    const int g = lane / 4, q = lane % 4;
    const int c0 = (warp & 1) * 4, mi = lane / 8, r8 = lane % 8;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % DST;
      mbar_wait(&full[s], (it / DST) & 1);
      __syncwarp();                       // ldmatrix / mma are .sync.aligned
      const uint32_t box = smem_u32(ring + s * D_STAGE + (warp / 2) * D_HALF);
#pragma unroll
      for (int k16 = 0; k16 < DBK / 16; ++k16) {
        const int kk = it * DBK + k16 * 16 + 2 * q;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(sa + g * lda + kk);
        a[1] = *reinterpret_cast<const uint32_t*>(sa + (g + 8) * lda + kk);
        a[2] = *reinterpret_cast<const uint32_t*>(sa + g * lda + kk + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(sa + (g + 8) * lda + kk + 8);
        // lanes 8 m .. 8 m + 7 address the rows of 8 x 8 matrix m: k rows
        // 16 k16 + r8 (+ 8 for odd m) of chunk c0 + 2 h + m / 2, 128-byte
        // swizzled (chunk ^ row % 8)
        const int krow = k16 * 16 + r8 + 8 * (mi & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int chunk = c0 + 2 * h + (mi >> 1);
          uint32_t b[4];
          ldmatrix_x4_trans(b, box + krow * 128 + ((chunk ^ r8) << 4));
          mma_m16n8k16(acc[2 * h], a, b[0], b[1]);
          mma_m16n8k16(acc[2 * h + 1], a, b[2], b[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // this split's partial sums into shared memory (over the drained ring)
    asm volatile("bar.sync 1, 128;" ::: "memory");
    float* red = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = warp * 32 + nb * 8 + 2 * q;
      *reinterpret_cast<float2*>(red + g * DBN + col) =
          make_float2(acc[nb][0], acc[nb][1]);
      *reinterpret_cast<float2*>(red + (g + 8) * DBN + col) =
          make_float2(acc[nb][2], acc[nb][3]);
    }
  }
  __syncwarp();
  cluster.sync();
  if (cluster.block_rank() == 0 && warp < 4) {
    const float* red = reinterpret_cast<const float*>(ring);
    const int splits = (int)cluster.num_blocks();
    for (int i = tid; i < cap * (DBN / 2); i += 128) {
      const int r = i / (DBN / 2), c = (i % (DBN / 2)) * 2;
      if (c >= nc) continue;
      float v0 = 0.0f, v1 = 0.0f;
      for (int rk = 0; rk < splits; ++rk) {   // fixed order: deterministic
        const float* src = cluster.map_shared_rank(red, rk);
        v0 += src[r * DBN + c];
        v1 += src[r * DBN + c + 1];
      }
      if (r >= live) v0 = v1 = 0.0f;
      store_pair(ye + (size_t)r * f + n0 + c, v0, v1);
    }
  }
  cluster.sync();                         // keep every split's sums alive
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D map over a contiguous (n2, n1, n0) bf16 array: boxes of 64 x box1
// (128 bytes a row, 128-byte swizzle), zeros outside the array.
int encode_map(CUtensorMap* map, const void* base, uint64_t n2, uint64_t n1,
               uint64_t n0, uint32_t box1) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return -2;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n1 * n0 * 2};
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

int launch_prefill(const void* x, const void* w, const int* rows, void* y,
                   int E, int cap, int d, int f, cudaStream_t stream) {
  CUtensorMap xm, wm;
  int err = encode_map(&xm, x, E, cap, d, PBM);
  if (!err) err = encode_map(&wm, w, E, d, f, PBK);
  if (err) return err;
  cudaFuncSetAttribute(moe_gemm_tc_prefill_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  const dim3 grid((cap + PBM - 1) / PBM, (f + PBN - 1) / PBN, E);
  moe_gemm_tc_prefill_kernel<<<grid, P_THREADS, P_SMEM, stream>>>(
      xm, wm, rows, static_cast<bf16*>(y), cap, d, f);
  return (int)cudaGetLastError();
}

// The decode kernel's K split for a contraction of d: about 1024 deep, at
// most 8 splits (a portable cluster), each a multiple of 64.
void decode_split(int d, int* splits, int* ks) {
  int s = (d + 1023) / 1024;
  if (s > 8) s = 8;
  *ks = ((d + s - 1) / s + D_KS_ALIGN - 1) / D_KS_ALIGN * D_KS_ALIGN;
  *splits = (d + *ks - 1) / *ks;
}

int decode_smem(int ks) {
  return DST * D_STAGE + 1024 + DM * (ks + 8) * 2 + 2 * DST * 8;
}

int launch_decode(const void* x, const void* w, const int* rows, void* y,
                  int E, int cap, int d, int f, cudaStream_t stream) {
  int splits, ks;
  decode_split(d, &splits, &ks);
  CUtensorMap wm;
  const int err = encode_map(&wm, w, E, d, f, DBK);
  if (err) return err;
  const int smem = decode_smem(ks);
  cudaFuncSetAttribute(moe_gemm_tc_decode_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((f + DBN - 1) / DBN, splits, E);
  cfg.blockDim = dim3(D_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t st = cudaLaunchKernelEx(
      &cfg, moe_gemm_tc_decode_kernel, wm, static_cast<const bf16*>(x), rows,
      static_cast<bf16*>(y), E, cap, d, f, ks);
  if (st != cudaSuccess) return (int)st;
  return (int)cudaGetLastError();
}

}  // namespace

// decode: 1 for the weight-streaming kernel (cap <= 16), 0 for the wgmma
// kernel; rows: int32 (E,) or null (every row live). Returns the
// cudaError_t of the launch (0 on success), -1 for arguments the kernels do
// not take, -2 when the CUDA driver API's cuTensorMapEncodeTiled cannot be
// reached, -3 when it refuses a tensor map.
extern "C" int moe_gemm_tc_launch(int decode, const void* x, const void* w,
                                  const void* rows, void* y, int E, int cap,
                                  int d, int f, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  if (E <= 0 || cap <= 0 || d <= 0 || f <= 0 || d % 8 || f % 8) return -1;
  if (decode) {
    if (cap > DM) return -1;
    return launch_decode(x, w, r, y, E, cap, d, f, st);
  }
  return launch_prefill(x, w, r, y, E, cap, d, f, st);
}

// Dynamic shared memory, in bytes, of a launch of either kernel at
// contraction depth d.
extern "C" int moe_gemm_tc_smem_bytes(int decode, int d) {
  if (!decode) return P_SMEM;
  int splits, ks;
  decode_split(d, &splits, &ks);
  return decode_smem(ks);
}
