// Fused feed-forward: out = GEGLU(LN(x; w, b) @ W1^T) @ W2^T, with
//   W1 (2*Ip, D) = [val rows | gate rows], act = gelu_erf(gate) * val,
//   W2 (D, Ip), both in the nn.Linear layout, inner padded to Ip % 64 == 0
//   with zero rows/columns (a zero val column contributes nothing).
// f32 LN statistics, bf16 products with f32 accumulation (wmma 16x16x16),
// f32 GELU, bf16 activations into the second product.
//
// Replaces omnitokenizer_tpu/ops/pallas/geglu_ff.py:geglu_ff (its tanh GELU
// was a Mosaic limitation; this kernel uses erf like the JAX math path).
// Bound: tensor-core compute, 6*M*D*Ip flops (88 GFLOP at M=20480, D=512,
// Ip=1408); the (M, 2*Ip) intermediate would otherwise be 115 MB of bf16
// written and read back. Design: a block owns 32 rows and keeps the full
// 32 x D output accumulator in registers (8 warps x D/64 16x16 tiles). It
// normalizes its rows into shared memory once, then loops over the inner
// dimension in chunks of 64: the val and gate products of the chunk land in
// shared memory, the activated chunk is written there as bf16, and the
// chunk's contribution is added to the output accumulator. Weights are read
// through L2 directly into the fragments; only x and out touch DRAM.
#include "common.cuh"

namespace {

using namespace nvcuda;
using otk::bf16;

constexpr int kRows = 32;
constexpr int kChunk = 64;
constexpr int kWarps = 8;
constexpr int kPad = 8;
constexpr int kLdH = kChunk + 4;  // f32 row stride of the val/gate stage
constexpr int kLdA = kChunk + kPad;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
geglu_ff_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, bf16* __restrict__ out, int M, int Ip) {
  constexpr int ld = D + kPad;
  constexpr int kFrags = D / 64;  // output tiles per warp: 2 row tiles x 4 column groups
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_xn = reinterpret_cast<bf16*>(smem);
  float* s_val = reinterpret_cast<float*>(s_xn + kRows * ld);
  float* s_gate = s_val + kRows * kLdH;
  float* s_stage = s_gate + kRows * kLdH;
  bf16* s_act = reinterpret_cast<bf16*>(s_stage + kWarps * 256);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, M - row0);

  // LayerNorm, one warp per row, f32 statistics
  for (int r = warp; r < kRows; r += kWarps) {
    float v[D / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      v[i] = r < rows_valid ? __bfloat162float(x[(size_t)(row0 + r) * D + lane + 32 * i]) : 0.f;
      s += v[i];
    }
    const float mean = otk::warp_sum(s) / D;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) var += (v[i] - mean) * (v[i] - mean);
    const float rstd = rsqrtf(otk::warp_sum(var) / D + 1e-5f);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      s_xn[r * ld + c] = __float2bfloat16((v[i] - mean) * rstd * ln_w[c] + ln_b[c]);
    }
  }
  __syncthreads();

  const int rt = warp % 2;  // 16-row tile of the warp
  const int ct = warp / 2;  // phase 1: 16-column tile of the chunk; phase 2: column group
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFrags];
#pragma unroll
  for (int f = 0; f < kFrags; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int j0 = 0; j0 < Ip; j0 += kChunk) {
    // phase 1: val and gate tiles of this chunk, (32 x 64) each
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hv, hg;
    wmma::fill_fragment(hv, 0.f);
    wmma::fill_fragment(hg, 0.f);
    const bf16* wv = w1 + (size_t)(j0 + ct * 16) * D;
    const bf16* wg = w1 + (size_t)(Ip + j0 + ct * 16) * D;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bv, bg;
      wmma::load_matrix_sync(a, s_xn + rt * 16 * ld + k0, ld);
      wmma::load_matrix_sync(bv, wv + k0, D);
      wmma::load_matrix_sync(bg, wg + k0, D);
      wmma::mma_sync(hv, a, bv, hv);
      wmma::mma_sync(hg, a, bg, hg);
    }
    wmma::store_matrix_sync(s_val + rt * 16 * kLdH + ct * 16, hv, kLdH, wmma::mem_row_major);
    wmma::store_matrix_sync(s_gate + rt * 16 * kLdH + ct * 16, hg, kLdH, wmma::mem_row_major);
    __syncthreads();

    // exact (erf) GELU gate in f32, activation stored as bf16
    for (int i = threadIdx.x; i < kRows * kChunk; i += kWarps * 32) {
      const int r = i / kChunk, c = i % kChunk;
      const float g = s_gate[r * kLdH + c];
      const float act = 0.5f * g * (1.f + erff(g * 0.70710678118654752f)) * s_val[r * kLdH + c];
      s_act[r * kLdA + c] = __float2bfloat16(act);
    }
    __syncthreads();

    // phase 2: out[rt tile, column group ct] += act (16 x 64) @ W2[:, chunk]^T
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s_act + rt * 16 * kLdA + k0, kLdA);
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w2 + (size_t)(ct * (D / 4) + f * 16) * Ip + j0 + k0, Ip);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();  // s_act and the val/gate stage are rewritten next chunk
  }

  float* stage = s_stage + warp * 256;
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
    otk::store_tile_bf16(acc[f], stage, out + (size_t)(row0 + rt * 16) * D + ct * (D / 4) + f * 16,
                         D, rows_valid - rt * 16);
}

template <int D>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* w2,
           void* out, int M, int Ip, cudaStream_t stream) {
  const size_t smem = (size_t)kRows * (D + kPad) * sizeof(bf16) +
                      (size_t)(2 * kRows * kLdH + kWarps * 256) * sizeof(float) +
                      (size_t)kRows * kLdA * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(geglu_ff_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kRows - 1) / kRows);
  geglu_ff_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(out), M, Ip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int geglu_ff_launch(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                               const void* w2, void* out, int M, int D, int Ip, void* stream) {
  if (Ip % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(x, ln_w, ln_b, w1, w2, out, M, Ip, s);
    case 128: return launch<128>(x, ln_w, ln_b, w1, w2, out, M, Ip, s);
    case 256: return launch<256>(x, ln_w, ln_b, w1, w2, out, M, Ip, s);
    case 512: return launch<512>(x, ln_w, ln_b, w1, w2, out, M, Ip, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
