// Rules shared by the bsr_spgemm kernels (bsr_spgemm.cu, bsr_spgemm_tc.cu,
// bsr_spgemm_warp.cu): the NaN-propagating min and max. The test for
// elements the TF32 split cannot carry (wide) is hopper.cuh's, beside the
// split.
//
// Included by relative path; cuda_lib.library_path hashes it into every
// library that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

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

}  // namespace
