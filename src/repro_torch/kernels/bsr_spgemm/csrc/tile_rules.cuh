// Rules shared by the bsr_spgemm kernels (bsr_spgemm.cu, bsr_spgemm_tc.cu,
// bsr_spgemm_warp.cu, bsr_spgemm_minplus.cu): the NaN-propagating min and
// max, cp.async, and the identity fill of the output slots no run writes.
// The tests for elements the split cannot carry (wide) and for a k-panel it
// must not take (unsplit_panel) are hopper.cuh's, beside the split.
//
// Included by relative path; cuda_lib.library_path hashes it into every
// library that includes it.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// The 13 mantissa bits a tf32 read drops: a word with any of them set is not
// TF32-exact and needs a lo part.
constexpr uint32_t kTf32LowBits = 0x1FFFu;

// The larger of a and b, or NaN where either is one (max.NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The smaller of a and b, or NaN where either is one (min.NaN), as
// torch.minimum and jnp.minimum give it; fminf would drop the NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 16 bytes from global to shared memory, past L1 (.cg), asynchronously;
// the copies a thread issued since its last commit form one group, and
// cp_async_wait<N> returns once at most N of its groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The first q in [0, n) whose key(q) >= s, or n if none, for keys
// nondecreasing in q: a 32-way search, each lane probing one point of
// [l, h) a round. Every lane of the warp calls it with the same arguments.
template <class Key>
__device__ int warp_lower_bound(Key key, int n, int s, int lane) {
  int l = 0, h = n;
  while (l < h) {
    const long long m = h - l;
    const int q = l + static_cast<int>((m * lane) >> 5);
    const unsigned ge = __ballot_sync(FULL, key(q) >= s);
    if (!ge) {
      l += static_cast<int>((m * 31) >> 5) + 1;
      continue;
    }
    const int j = __ffs(ge) - 1;
    h = l + static_cast<int>((m * j) >> 5);
    if (j) l += static_cast<int>((m * (j - 1)) >> 5) + 1;
    else l = h;
  }
  return l;
}

// `zero` into every slot of this warp's share of [0, nc) that no run
// writes (warp `warp` of `nwarps`, each an equal share): the first run of
// the share by a 32-way search over the run slots, then 32 slots a round,
// each lane reading the slot of one run. Run slots (c_slot at each run
// start) are strictly increasing.
template <int BS>
__device__ void fill_gaps(float* out, const int* c_slot,
                          const int* run_starts, int nruns, int nc,
                          float zero, int warp, int nwarps, int lane) {
  const int per = (nc + nwarps - 1) / nwarps;
  const int lo = warp * per;
  const int hi = min(nc, lo + per);
  if (lo >= hi) return;
  int l = warp_lower_bound(
      [&](int q) { return c_slot[run_starts[q]]; }, nruns, lo, lane);
  const float4 z = make_float4(zero, zero, zero, zero);
  for (int base = lo; base < hi; base += 32) {
    const int i = l + lane;
    const int s = i < nruns ? c_slot[run_starts[i]] : INT_MAX;
    const bool here = s < base + 32 && s < hi;   // runs are >= base here
    const unsigned written = __reduce_or_sync(FULL, here ? 1u << (s - base)
                                                         : 0u);
    l += __popc(__ballot_sync(FULL, here));
    const int n = min(32, hi - base);
    unsigned todo = ~written & (n == 32 ? FULL : (1u << n) - 1u);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      float4* t =
          reinterpret_cast<float4*>(out + (size_t)(base + j) * BS * BS);
#pragma unroll
      for (int e = 0; e < BS * BS / 128; ++e) __stcs(t + lane + 32 * e, z);
    }
  }
}

}  // namespace
