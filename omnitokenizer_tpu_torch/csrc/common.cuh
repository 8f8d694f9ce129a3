// Helpers shared by the port's CUDA kernels (compiled for sm_90a).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace otk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major tile with 128-byte rows and the 128-byte
// swizzle (1024-byte aligned): 8-row groups 1024 bytes apart (SBO), the
// leading offset unused. A k step inside the row adds its byte offset to addr.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// keep the compiler from moving register reads or writes across an async
// wgmma (its operands are read and written behind the compiler's back)
template <int R, typename T>
__device__ __forceinline__ void fence_regs(T* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      asm volatile("" : "+f"(d[i])::"memory");
    } else {
      asm volatile("" : "+r"(d[i])::"memory");
    }
  }
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;" ::: "memory");
}

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
