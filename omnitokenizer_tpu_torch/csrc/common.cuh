// Helpers shared by the port's CUDA kernels (compiled for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace otk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Store a 16x16 f32 accumulator tile as bf16 at `out` (row stride `ldo`
// elements), rows at or past `rows_left` skipped. `stage` is this warp's
// 256-float scratch in shared memory.
template <typename Frag>
__device__ __forceinline__ void store_tile_bf16(const Frag& acc, float* stage, bf16* out,
                                                int ldo, int rows_left) {
  nvcuda::wmma::store_matrix_sync(stage, acc, 16, nvcuda::wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  if (r < rows_left) {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(stage[r * 16 + c0 + i]);
    *reinterpret_cast<uint4*>(out + (size_t)r * ldo + c0) = *reinterpret_cast<const uint4*>(v);
  }
  __syncwarp();
}

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0) from global (row stride
// `ld_src`) into shared memory (row stride `ld_dst`) with 16-byte vectors;
// rows past `rows_valid` are zero-filled.
__device__ __forceinline__ void load_rows_bf16(bf16* dst, int ld_dst, const bf16* src, int ld_src,
                                               int rows, int rows_valid, int cols) {
  const int vec_per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = (i % vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * ld_src + c);
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = v;
  }
}

}  // namespace otk
