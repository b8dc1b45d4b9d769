// Online-softmax attention forward on Hopper's tensor cores (sm_90a): bf16
// q, k, v in, fp32 logits, softmax state and accumulator, bf16 out.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _attn_kernel) for bfloat16. For every batch b, query head h and
// query row r,
//
//     o[b, r, h] = sum_c softmax_c(mask(softcap(scale * q[b,r,h] . k[b,c,h/rep])))
//                  * v[b, c, h/rep]
//
// with the Pallas kernel's semantics: scale, then softcap, then the mask
// (causal c <= r, window c > r - window, and keys at or past S) to -1e30;
// p = mask ? exp(s - m) : 0 against the running row max m; l and the
// accumulator rescaled by exp(m_old - m_new); a row whose l is 0 divides by
// 1; the output is bf16.
//
// Numerics. QK^T: bf16 products are exact in fp32, so wgmma with fp32
// accumulators gives the Pallas kernel's f32 dot up to summation order.
// PV: the Pallas kernel keeps p in f32; here p is rounded to bf16 in
// registers to feed wgmma (as SDPA and FlashAttention do). l is summed from
// the unrounded fp32 p. That rounding is the one numerical difference; the
// CPU tests model it and hold it against the Pallas kernel within the bf16
// tolerance (atol 2e-2 + rtol 1e-2). exp(s - m) is computed as 2^(s' - m')
// with s' and m' in log2 units (s' = s log2 e).
//
// Bound. At qwen2-moe-a2.7b's prefill (q, k, v (4, 2048, 16, 128), causal)
// the unmasked (row, key) pairs need 68.7 GFLOP (QK^T and PV) against
// 134 MB of q, k, v and o: 0.0695 ms at the bf16 tensor-core peak (989.4
// TFLOP/s), 0.040 ms at 3.35 TB/s, so the launch is bound by operations.
// The design puts those operations on wgmma and keeps every operand load
// off the consumers' path:
//
// * Layout. q, k, v and o stay in the model layout (B, S, H, D). Each is
//   read through a 4-D TMA tensor map over (D, H, S, B) with 64-column boxes
//   and a 128-byte swizzle; a query head h reads kv head h / rep through the
//   map's coordinate. Nothing is folded, repeated, padded or copied. TMA
//   bounds-checks every dimension against the map's own size, so rows past
//   S and columns past D arrive as zeros: a head dim D is processed at
//   DP = D rounded up to 64 (160 -> 192), the zero columns add nothing to
//   QK^T, and PV's extra columns are not stored.
// * Work division. One CTA per (128 query rows, head, batch), 384 threads:
//   two consumer warpgroups of 64 rows each and a producer warpgroup whose
//   one working thread loads the Q tile once, then keeps a 2-stage ring of
//   K and V blocks in flight (separate barriers for K and V, so QK^T starts
//   while V lands). The producer warpgroup gives its registers to the
//   consumers with setmaxnreg (40 / 232 a thread; 384 threads launch with
//   168, and ptxas spilled the accumulators under that cap). Blocks hold
//   BK = 128 keys at DP <= 128 and 64 keys above, so the ring fits in
//   shared memory (bytes per DP in Cfg below). Only the key blocks from the window's first reachable block
//   to the causal frontier are loaded; the grid runs the longest causal
//   rows of every (head, batch) first.
// * S = Q K^T: wgmma m64nBKk16 with both operands in shared memory, Q as A
//   and K as B, both K-major as stored (a key's D values are contiguous):
//   no transpose.
// * Softmax in fp32 registers on the accumulator fragment; the mask is
//   applied only in blocks that cross the causal diagonal, the window's
//   edge or S. A warpgroup skips the MMAs of a block that is fully masked
//   for its 64 rows.
// * O += P V: P is packed to bf16 pairs in registers, which is exactly the
//   register A-operand layout of wgmma m64nDPk16; V is the B operand,
//   N-major as stored, read through the transpose bit.
// * Epilogue: divide by l (1 where l is 0), convert to bf16, store the rows
//   inside S and the columns inside D. No atomics: a launch repeats bitwise.
//
// Not yet done (speed work): overlap of one block's softmax with the next
// block's QK^T inside a warpgroup, ping-pong scheduling between the two
// warpgroups, a persistent tile loop and a TMA-store epilogue.
//
// Requirements (checked by the wrapper): D a multiple of 8 up to 256 (TMA
// strides are 16-byte multiples), Hkv dividing Hq, tensors contiguous and
// 16-byte aligned. Tensor maps are encoded per launch on the host by
// cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda) and passed as __grid_constant__ parameters.
//
// Plain C interface for ctypes: every pointer and the stream are void*.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- wgmma shapes of this kernel -------------------------------------------

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (64 x 64) = (scale_d ? d : 0) + A (64 x 16) * B (16 x 64), A and B
  // K-major bf16 in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }

  // d (64 x 64) += A (64 x 16, bf16 in registers) * B (16 x 64, bf16 in
  // shared memory, N-major: transpose bit set)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128) = (scale_d ? d : 0) + A (64 x 16) * B (16 x 128), A and B
  // K-major bf16 in shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n\t}"
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
      : "l"(da), "l"(db), "r"(scale_d));
  }

  // d (64 x 128) += A (64 x 16, bf16 in registers) * B (16 x 128, bf16 in
  // shared memory, N-major: transpose bit set)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, p, 1, 1, 1;\n\t}"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  // d (64 x 192) += A (64 x 16, bf16 in registers) * B (16 x 192, bf16 in
  // shared memory, N-major: transpose bit set)
  static __device__ __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %101, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n\t}"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d (64 x 256) += A (64 x 16, bf16 in registers) * B (16 x 256, bf16 in
  // shared memory, N-major: transpose bit set)
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %133, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n\t}"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// ---- the kernel ------------------------------------------------------------

constexpr int BQ = 128;             // query rows per CTA, 64 per warpgroup
constexpr int THREADS = 384;        // two consumer warpgroups + producer WG
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: registers a producer thread
constexpr int CONSUMER_REGS = 232;  // keeps / a consumer thread gets
constexpr int STAGES = 2;           // K/V blocks in flight
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory per padded head dim DP, in bytes, besides 1024 of slack
// that aligns the tiles to the 128-byte swizzle's 1024-byte atoms:
//   DP  64: BK 128, Q 16 KB + 2 x (K 16 KB + V 16 KB) =  80 KB
//   DP 128: BK 128, Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB
//   DP 192: BK  64, Q 48 KB + 2 x (K 24 KB + V 24 KB) = 144 KB
//   DP 256: BK  64, Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB
template <int DP>
struct Cfg {
  static constexpr int BK = DP <= 128 ? 128 : 64;   // keys per block
  static constexpr int NBOX = DP / 64;              // 64-column boxes a row
  static constexpr int Q_BOX = BQ * 128;            // bytes of one Q box
  static constexpr int KV_BOX = BK * 128;           // of one K or V box
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;    // one K or V block
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE
                              + (1 + 3 * STAGES) * 8;
  static_assert(SMEM <= 232448, "shared memory past the 227 KB a CTA has");
};

// 2^x (MUFU.EX2; relative error about 2^-22, subnormal results flushed)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    bf16* __restrict__ o, int S, int Hq, int Hkv, int D,
                    float scale, int causal, int window, float softcap) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ring = smem + C::Q_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

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
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per consumer WG
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // producer warpgroup: hands most of its registers to the consumers
    // (setmaxnreg acts per warpgroup); one thread loads Q once and keeps
    // the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (tid == 256) {
      mbar_expect_tx(qfull, C::Q_BYTES);
      for (int c = 0; c < C::NBOX; ++c)
        tma_load_4d(qs + c * C::Q_BOX, &qmap, qfull, c * 64, h, q0, b);
      for (int it = 0; it < nblk; ++it) {
        const int s = it % STAGES;
        const int k0 = (kb_begin + it) * BK;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* ks = ring + s * C::STAGE;
        uint8_t* vs = ks + C::KV_BYTES;
        mbar_expect_tx(&kfull[s], C::KV_BYTES);
        for (int c = 0; c < C::NBOX; ++c)
          tma_load_4d(ks + c * C::KV_BOX, &kmap, &kfull[s], c * 64, hk, k0, b);
        mbar_expect_tx(&vfull[s], C::KV_BYTES);
        for (int c = 0; c < C::NBOX; ++c)
          tma_load_4d(vs + c * C::KV_BOX, &vmap, &vfull[s], c * 64, hk, k0, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
  // consumers: warpgroup wg owns query rows [r0, r0 + 64). Fragment (warp
  // w, lane l) of an m64nN accumulator holds rows r0 + 16 w + l / 4 (+ 8)
  // and columns 8 j + 2 (l % 4) (+ 1): element 4 j + 2 i + e is row
  // row0 + 8 i, column 8 j + 2 (l % 4) + e.
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = q0 + wg * 64;
  const int r_last = r0 + 63;
  const int row0 = r0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const bool leader = (tid % 128) == 0;
  // logits and the row max m are kept in log2 units (times log2 e), so
  // exp(s - m) is one 2^x
  const bool cap = softcap > 0.0f;
  const float scale_log2 = scale * kLog2e;
  const float scale_cap = cap ? scale / softcap : 0.0f;
  const float cap_log2 = softcap * kLog2e;
  const uint32_t q_base = smem_u32(qs) + wg * 64 * 128;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};          // this thread's columns only

  mbar_wait(qfull, 0);
  for (int it = 0; it < nblk; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = (kb_begin + it) * BK;
    const uint32_t ks = smem_u32(ring + s * C::STAGE);
    const uint32_t vs = ks + C::KV_BYTES;
    // warpgroup-uniform: is the block fully masked for these 64 rows, or
    // does any (row, key) of it need the mask?
    const bool dead = r0 >= S || (causal && k0 > r_last) ||
                      (window > 0 && k0 + BK - 1 <= r0 - window);
    const bool masked = (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && k0 <= r_last - window) || k0 + BK > S;

    mbar_wait(&kfull[s], parity);
    if (dead) {
      mbar_wait(&vfull[s], parity);       // keep in phase with the ring
    } else {
      __syncwarp();                       // wgmma is .sync.aligned
      // S = Q K^T over DP / 16 steps of 16: step kk reads box kk / 4 at
      // byte 32 (kk % 4) of each 128-byte row; 8-row groups 1024 B apart
      float sacc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        Wgmma<BK>::ss(sacc,
                      sw128_desc(q_base + (kk / 4) * C::Q_BOX + off, 16, 1024),
                      sw128_desc(ks + (kk / 4) * C::KV_BOX + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);

      // scale, softcap, mask; online softmax per row (4 lanes share a row)
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
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[4 * j + 2 * i] *= alpha;
          acc[4 * j + 2 * i + 1] *= alpha;
        }
      }

      // P in bf16: the accumulator fragment of keys [16 kk, 16 kk + 16),
      // packed in pairs, is wgmma's register A fragment for k-step kk
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
      }

      // O += P V: V N-major through the transpose bit; its 64-column boxes
      // are KV_BOX apart, 8-key groups 1024 B apart, k-step 16 keys = 2 KB
      mbar_wait(&vfull[s], parity);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<DP>::rs(acc, pa[kk], sw128_desc(vs + kk * 2048, C::KV_BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if (leader) mbar_arrive(&empty[s]);   // this warpgroup is done with s
  }

  // epilogue: l summed over the 4 lanes of a row; divide (l == 0 -> 1);
  // store the rows inside S and the columns inside D
  const size_t row_stride = (size_t)Hq * D;
  bf16* ob = o + (size_t)b * S * row_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float denom = li == 0.0f ? 1.0f : li;
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    bf16* orow = ob + (size_t)row * row_stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
    }
  }
}

// ---- host side -------------------------------------------------------------

// 4-D map over a contiguous (B, S, H, D) bf16 tensor, dimensions (D, H, S,
// B) innermost first: boxes of 64 columns x 1 head x `rows` positions
// (128 bytes a row, 128-byte swizzle), zeros outside the tensor.
int encode_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
               int rows) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
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
  int err = encode_map(&qm, q, B, S, Hq, D, BQ);
  if (!err) err = encode_map(&km, k, B, S, Hkv, D, C::BK);
  if (!err) err = encode_map(&vm, v, B, S, Hkv, D, C::BK);
  if (err) return err;
  auto kern = flash_fwd_tc_kernel<DP>;
  const cudaError_t st = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (st != cudaSuccess) return (int)st;
  const dim3 grid(((S + BQ - 1) / BQ) * Hq * B);
  kern<<<grid, THREADS, C::SMEM, stream>>>(qm, km, vm, static_cast<bf16*>(o),
                                           S, Hq, Hkv, D, scale, causal,
                                           window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success), -1 for arguments the
// kernel does not take, -2 when the CUDA driver API's cuTensorMapEncodeTiled
// cannot be reached, -3 when it refuses a tensor map.
extern "C" int flash_attention_tc_launch(int d, const void* q, const void* k,
                                         const void* v, void* o, int B, int S,
                                         int Hq, int Hkv, float scale,
                                         int causal, int window, float softcap,
                                         void* stream) {
  if (d <= 0 || d > 256 || d % 8 || B <= 0 || S <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch<64>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                        softcap, st);
    case 2:
      return launch<128>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                         softcap, st);
    case 3:
      return launch<192>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                         softcap, st);
    default:
      return launch<256>(q, k, v, o, B, S, Hq, Hkv, d, scale, causal, window,
                         softcap, st);
  }
}

// Dynamic shared memory, in bytes, of a launch at head dim d (ptxas reports
// only static shared memory).
extern "C" int flash_attention_tc_smem_bytes(int d) {
  switch ((d + 63) / 64) {
    case 1: return Cfg<64>::SMEM;
    case 2: return Cfg<128>::SMEM;
    case 3: return Cfg<192>::SMEM;
    default: return Cfg<256>::SMEM;
  }
}
