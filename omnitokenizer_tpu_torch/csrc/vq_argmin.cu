// Nearest-code search: out[m] = argmin_k (||e_k||^2 - 2 x_m . e_k), f32.
//
// Replaces omnitokenizer_tpu/ops/pallas/vq_kernel.py:vq_argmin_pallas.
// Bound: compute, M*K*D fused multiply-adds (20480 x 8192 x 8 at the
// flagship serve shape) against reading a few MB once. Design: one thread
// per row with the row in registers; the codebook (256 KB at 8192 x 8 f32,
// more than a block's shared memory) is staged through shared memory in
// 32 KB chunks that every thread of the block reads as broadcasts. Codes
// are scanned in ascending order with a strict `<`, so ties go to the
// lowest index, as torch/jnp argmin do. Pure f32 FMA, never TF32.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunkFloats = 8192;  // 32 KB of codes per pass

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ x, const float* __restrict__ e,
                 const float* __restrict__ esq, int* __restrict__ out, int M, int K) {
  constexpr int kChunk = kChunkFloats / D;
  __shared__ __align__(16) float se[kChunkFloats];
  __shared__ float sq[kChunk];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  float xr[D];
#pragma unroll
  for (int j = 0; j < D; ++j) xr[j] = row < M ? x[(size_t)row * D + j] : 0.f;

  float best = FLT_MAX;
  int best_k = 0;
  for (int base = 0; base < K; base += kChunk) {
    const int n = min(kChunk, K - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * D; i += kThreads) se[i] = e[(size_t)base * D + i];
    for (int i = threadIdx.x; i < n; i += kThreads) sq[i] = esq[base + i];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) dot = fmaf(xr[j], se[k * D + j], dot);
      const float d = fmaf(-2.f, dot, sq[k]);
      if (d < best) {
        best = d;
        best_k = base + k;
      }
    }
  }
  if (row < M) out[row] = best_k;
}

}  // namespace

extern "C" int vq_argmin_launch(const void* x, const void* e, const void* esq, void* out,
                                int M, int K, int D, void* stream) {
  const dim3 grid((M + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(e);
  const float* qp = static_cast<const float*>(esq);
  int* op = static_cast<int*>(out);
  switch (D) {
    case 4: vq_argmin_kernel<4><<<grid, kThreads, 0, s>>>(xp, ep, qp, op, M, K); break;
    case 8: vq_argmin_kernel<8><<<grid, kThreads, 0, s>>>(xp, ep, qp, op, M, K); break;
    case 16: vq_argmin_kernel<16><<<grid, kThreads, 0, s>>>(xp, ep, qp, op, M, K); break;
    case 32: vq_argmin_kernel<32><<<grid, kThreads, 0, s>>>(xp, ep, qp, op, M, K); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
