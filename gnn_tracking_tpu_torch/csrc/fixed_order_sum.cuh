// The fixed-order sum of weight-gradient partials, shared by the fused relational backwards
// (fused_relational.cu, fused_relational_bf16.cu: one partial a block; fused_relational_wide.cu:
// one a slice of edges): partial b covers the unmasked edges [b te, (b + 1) te) and holds its sums
// in partial[b][0 .. p); out[i] is their sum in partial order, so a second launch gives the same
// bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fixed_order_sum {

__device__ __forceinline__ void store(float* out, float s) { *out = s; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float s) { *out = __float2bfloat16_rn(s); }

// out[i] = sum of partial[b][i] over the blocks b < `blocks` that took a tile (the first
// ceil(*count_ptr / te)), in block order, stored as Out (bf16 rounded to nearest); 0 where no
// block did (no unmasked edge). Launch with one thread per i, at most 256 a block.
template <typename Out>
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ partial, int blocks, int te,
                    const int* __restrict__ count_ptr, long p, Out* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const int tiles = blocks > 0 ? (*count_ptr + te - 1) / te : 0;
  const int used = tiles < blocks ? tiles : blocks;
  float s = 0.f;
  for (int b = 0; b < used; ++b) s += partial[(long)b * p + i];
  store(out + i, s);
}

}  // namespace fixed_order_sum
