// Fused gamma-only LayerNorm + q/kv projection:
//   q = LN_gamma(x) @ Wq^T   (f32 statistics, eps 1e-5, biased variance)
//   kv = x @ Wkv^T           (k and v read the PRE-norm x: reference quirk)
// bf16 products with f32 accumulation (wmma 16x16x16), bf16 outputs.
//
// Replaces omnitokenizer_tpu/ops/pallas/ln_qkv.py:ln_qkv.
// Bound: tensor-core compute, 2*M*D*(Dq+Dkv) flops (32 GFLOP at the
// flagship's M=20480, D=512, Dq=512, Dkv=1024), over ~84 MB of activations.
// Design: a block owns 64 rows. It loads the raw x tile into shared memory
// once, normalizes a second copy there for q, then walks the output
// columns in chunks of 64: each chunk's weight rows are staged in shared
// memory and shared by the 8 warps, each warp computes a 16x32 tile, and
// the tile leaves through a per-warp f32 stage as bf16. The LayerNormed x
// never reaches device memory. Weights come in the nn.Linear (out, in)
// layout, which is the col-major B operand of the product.
#include "common.cuh"

namespace {

using namespace nvcuda;
using otk::bf16;

constexpr int kRows = 64;
constexpr int kCols = 64;
constexpr int kWarps = 8;
constexpr int kPad = 8;

__global__ void __launch_bounds__(kWarps * 32)
ln_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const bf16* __restrict__ wq, const bf16* __restrict__ wkv,
              bf16* __restrict__ q, bf16* __restrict__ kv, int M, int D, int Dq, int Dkv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = D + kPad;
  bf16* s_x = reinterpret_cast<bf16*>(smem);
  bf16* s_xn = s_x + kRows * ld;
  bf16* s_w = s_xn + kRows * ld;
  float* s_stage = reinterpret_cast<float*>(s_w + kCols * ld);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, M - row0);

  otk::load_rows_bf16(s_x, ld, x + (size_t)row0 * D, D, kRows, rows_valid, D);
  __syncthreads();

  // LayerNorm statistics in f32, one warp per row
  for (int r = warp; r < kRows; r += kWarps) {
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(s_x[r * ld + c]);
    const float mean = otk::warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(s_x[r * ld + c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(otk::warp_sum(v) / D + 1e-5f);
    for (int c = lane; c < D; c += 32)
      s_xn[r * ld + c] =
          __float2bfloat16((__bfloat162float(s_x[r * ld + c]) - mean) * rstd * gamma[c]);
  }

  const int rt = warp % 4;  // 16-row tile of the warp
  const int cg = warp / 4;  // 32-column half of the chunk
  float* stage = s_stage + warp * 256;
  const int n_chunks = (Dq + Dkv) / kCols;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int col0 = chunk * kCols;
    const bool is_q = col0 < Dq;
    const bf16* w = is_q ? wq + (size_t)col0 * D : wkv + (size_t)(col0 - Dq) * D;
    const bf16* a_src = is_q ? s_xn : s_x;
    bf16* out = is_q ? q + col0 : kv + (col0 - Dq);
    const int ldo = is_q ? Dq : Dkv;

    __syncthreads();  // the previous chunk's weights are consumed (and LN is done)
    otk::load_rows_bf16(s_w, ld, w, D, kCols, kCols, D);
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = 0; k0 < D; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_src + rt * 16 * ld + k0, ld);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, s_w + (cg * 32 + f * 16) * ld + k0, ld);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
      otk::store_tile_bf16(acc[f], stage, out + (size_t)(row0 + rt * 16) * ldo + cg * 32 + f * 16,
                           ldo, rows_valid - rt * 16);
  }
}

}  // namespace

extern "C" int ln_qkv_launch(const void* x, const void* gamma, const void* wq, const void* wkv,
                             void* q, void* kv, int M, int D, int Dq, int Dkv, void* stream) {
  if (D % 16 || D > 512 || Dq % kCols || Dkv % kCols) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(2 * kRows + kCols) * (D + kPad) * sizeof(bf16) +
                      kWarps * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kRows - 1) / kRows);
  ln_qkv_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wkv), static_cast<bf16*>(q), static_cast<bf16*>(kv), M, D, Dq, Dkv);
  return static_cast<int>(cudaGetLastError());
}
