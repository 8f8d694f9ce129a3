// Cosine-similarity multi-head attention over a spatial token grid, per
// (batch, head), non-causal:
//   [2D RoPE on pairs (2p, 2p+1)] -> l2norm * q_scale * scale / l2norm *
//   k_scale -> rounded to bf16 -> softmax(q k^T) in f32 -> @ v.
// q is (B, N, H*Dh); kv is the fused projection (B, N, 2*H*Dh).
//
// Replaces omnitokenizer_tpu/ops/pallas/cosine_mha.py:cosine_mha.
// Bound: tensor-core compute and the exp sweep, 4*B*H*N^2*Dh flops (43
// GFLOP) and B*H*N^2 exps at the flagship's B=20, N=1024, H=8, Dh=64.
// Design: FlashAttention-style. A block owns (batch, head, 64 queries) with
// 4 warps of 16 query rows. It rotates, normalizes and rounds its q tile
// once into shared memory, then loops over 64-key tiles: the k tile gets
// the same treatment as it loads, S = q k^T comes from wmma bf16 products
// in f32, an online softmax keeps the running max and sum per row in
// registers, P is rounded to bf16 and P v accumulates into an f32 output
// tile in shared memory (rescaled by the max correction first). The N x N
// scores never reach device memory. The TPU kernel's bound shift with its
// -80 floor, its ones-column denominator and its pair-swap matmul were
// workarounds for the TPU and are left out.
#include "common.cuh"

namespace {

using namespace nvcuda;
using otk::bf16;

constexpr int kTile = 64;   // queries per block and keys per step
constexpr int kWarps = 4;   // 16 query rows each
constexpr int kPad = 8;
constexpr int kLdS = kTile + 4;     // f32 score row stride
constexpr int kLdP = kTile + kPad;  // bf16 probability row stride

// Rotate (optionally), l2-normalize, scale and round 16 rows of a head's
// q or k into shared memory. One warp, lanes over the Dh/2 pairs.
template <int Dh>
__device__ __forceinline__ void prep_rows(bf16* dst, int ld_dst, const bf16* src, size_t ld_src,
                                          int pos0, const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, bool rope,
                                          const float* __restrict__ dim_scale, float scale) {
  const int lane = threadIdx.x & 31;
  constexpr int kPairs = Dh / 2;
  for (int r = 0; r < 16; ++r) {
    float a[(kPairs + 31) / 32], b[(kPairs + 31) / 32];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < (kPairs + 31) / 32; ++i) {
      const int p = lane + 32 * i;
      a[i] = b[i] = 0.f;
      if (p < kPairs) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src + r * ld_src + 2 * p);
        float x0 = __low2float(v), x1 = __high2float(v);
        if (rope) {
          const float c = cos_t[(pos0 + r) * kPairs + p], s = sin_t[(pos0 + r) * kPairs + p];
          const float y0 = x0 * c - x1 * s, y1 = x0 * s + x1 * c;
          x0 = y0;
          x1 = y1;
        }
        a[i] = x0;
        b[i] = x1;
        ss += x0 * x0 + x1 * x1;
      }
    }
    const float inv = 1.f / fmaxf(sqrtf(otk::warp_sum(ss)), 1e-12f);
#pragma unroll
    for (int i = 0; i < (kPairs + 31) / 32; ++i) {
      const int p = lane + 32 * i;
      if (p < kPairs)
        *reinterpret_cast<__nv_bfloat162*>(dst + r * ld_dst + 2 * p) = __floats2bfloat162_rn(
            a[i] * inv * dim_scale[2 * p] * scale, b[i] * inv * dim_scale[2 * p + 1] * scale);
    }
  }
}

template <int Dh>
__global__ void __launch_bounds__(kWarps * 32)
cosine_mha_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                  const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                  const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                  bf16* __restrict__ out, int N, int H, float scale, int rope) {
  constexpr int ld = Dh + kPad;
  constexpr int kLdO = Dh + 4;
  constexpr int kDf = Dh / 16;  // 16-wide fragments along the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kTile * ld;
  bf16* s_v = s_k + kTile * ld;
  float* s_s = reinterpret_cast<float*>(s_v + kTile * ld);  // per warp 16 x kLdS
  float* s_o = s_s + kWarps * 16 * kLdS;                    // per warp 16 x kLdO
  bf16* s_p = reinterpret_cast<bf16*>(s_o + kWarps * 16 * kLdO);  // per warp 16 x kLdP

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * Dh;
  const bf16* qb = q + (size_t)b * N * HD + h * Dh;
  const bf16* kb = kv + (size_t)b * N * 2 * HD + h * Dh;
  const bf16* vb = kb + HD;
  float* my_s = s_s + warp * 16 * kLdS;
  float* my_o = s_o + warp * 16 * kLdO;
  bf16* my_p = s_p + warp * 16 * kLdP;

  prep_rows<Dh>(s_q + warp * 16 * ld, ld, qb + (size_t)(q0 + warp * 16) * HD, HD,
                q0 + warp * 16, cos_t, sin_t, rope, q_scale, scale);
  for (int i = lane; i < 16 * kLdO; i += 32) my_o[i] = 0.f;
  __syncwarp();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kDf];
#pragma unroll
  for (int f = 0; f < kDf; ++f) wmma::load_matrix_sync(qa[f], s_q + warp * 16 * ld + f * 16, ld);

  // lane -> (row, half): two lanes per query row, 32 score columns each
  const int rr = lane >> 1, half = lane & 1;
  float m_run = -CUDART_INF_F, l_run = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous k/v tile
    prep_rows<Dh>(s_k + warp * 16 * ld, ld, kb + (size_t)(k0 + warp * 16) * 2 * HD, 2 * HD,
                  k0 + warp * 16, cos_t, sin_t, rope, k_scale, 1.f);
    for (int i = threadIdx.x; i < kTile * (Dh / 8); i += kWarps * 32) {
      const int r = i / (Dh / 8), c = (i % (Dh / 8)) * 8;
      *reinterpret_cast<uint4*>(s_v + r * ld + c) =
          *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * 2 * HD + c);
    }
    __syncthreads();

    // S (16 x 64) = q_w k^T
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int f = 0; f < kDf; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb_frag;
        wmma::load_matrix_sync(kb_frag, s_k + n * 16 * ld + f * 16, ld);
        wmma::mma_sync(s, qa[f], kb_frag, s);
      }
      wmma::store_matrix_sync(my_s + n * 16, s, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile's 64 columns of row rr
    const float* srow = my_s + rr * kLdS + half * 32;
    float mt = -CUDART_INF_F;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) mt = fmaxf(mt, srow[c]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    const float alpha = __expf(m_run - m_new);
    float sum = 0.f;
    bf16* prow = my_p + rr * kLdP + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = __expf(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    float* orow = my_o + rr * kLdO + half * (Dh / 2);
    for (int c = 0; c < Dh / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // O (16 x Dh) += P (16 x 64) v
#pragma unroll
    for (int f = 0; f < kDf; ++f) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, my_o + f * 16, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb_frag;
        wmma::load_matrix_sync(pa, my_p + kk, kLdP);
        wmma::load_matrix_sync(vb_frag, s_v + kk * ld + f * 16, ld);
        wmma::mma_sync(o, pa, vb_frag, o);
      }
      wmma::store_matrix_sync(my_o + f * 16, o, kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const float inv = 1.f / l_run;
  bf16* orow_out = out + (size_t)b * N * HD + (size_t)(q0 + warp * 16 + rr) * HD + h * Dh +
                   half * (Dh / 2);
  const float* orow = my_o + rr * kLdO + half * (Dh / 2);
  for (int c = 0; c < Dh / 2; c += 2)
    *reinterpret_cast<__nv_bfloat162*>(orow_out + c) =
        __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
}

template <int Dh>
int launch(const void* q, const void* kv, const void* qs, const void* ks, const void* cos_t,
           const void* sin_t, void* out, int B, int N, int H, float scale, int rope,
           cudaStream_t stream) {
  const size_t smem = (size_t)3 * kTile * (Dh + kPad) * sizeof(bf16) +
                      (size_t)kWarps * 16 * (kLdS + Dh + 4) * sizeof(float) +
                      (size_t)kWarps * 16 * kLdP * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(cosine_mha_kernel<Dh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / kTile, H, B);
  cosine_mha_kernel<Dh><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(out), N, H, scale, rope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cosine_mha_launch(const void* q, const void* kv, const void* q_scale,
                                 const void* k_scale, const void* cos_t, const void* sin_t,
                                 void* out, int B, int N, int H, int Dh, float scale, int rope,
                                 void* stream) {
  if (N % kTile) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return launch<32>(q, kv, q_scale, k_scale, cos_t, sin_t, out, B, N, H, scale, rope, s);
    case 64: return launch<64>(q, kv, q_scale, k_scale, cos_t, sin_t, out, B, N, H, scale, rope, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
