// Cosine attention inside groups of n <= 8 consecutive rows (temporal
// stack): per (group, head)
//   q_i = l2norm(q_i) * q_scale, k_j = l2norm(k_j) * k_scale,
//   o_i = sum_j softmax_j(scale * q_i . k_j [j <= i if causal]) v_j,
// all in f32 on bf16 inputs. q is (R, n, H*Dh); kv is the fused projection
// (R, n, 2*H*Dh) with k in the first H*Dh lanes of a row and v in the next.
//
// Replaces omnitokenizer_tpu/ops/pallas/small_attn.py:small_n_attention and
// small_n_attention_flat (the same memory in this layout). Bound: memory,
// ~8 flops per byte: q, kv read once and o written once (84 MB at the
// flagship's R=4096, n=5, H=8, Dh=64). Design: one warp per (group, head);
// each lane holds Dh/32 dims of every q, k, v row of the group in
// registers, the per-row norms and the n x n dot products are warp
// reductions, and the softmax runs in registers. The TPU kernel's
// block-indicator matmuls (a lane-segmented reduction on the MXU) have no
// counterpart: warp shuffles do that here.
#include "common.cuh"

namespace {

using otk::bf16;

constexpr int kMaxN = 8;
constexpr int kWarps = 8;

template <int DPL>  // dims per lane: Dh / 32
__global__ void __launch_bounds__(kWarps * 32)
small_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                  const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                  bf16* __restrict__ out, int R, int n, int H, float scale, int causal) {
  constexpr int Dh = DPL * 32;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= R * H) return;
  const int g = task / H, h = task % H;
  const int HD = H * Dh;
  const bf16* qp = q + (size_t)g * n * HD + h * Dh + lane * DPL;
  const bf16* kp = kv + (size_t)g * n * 2 * HD + h * Dh + lane * DPL;
  bf16* op = out + (size_t)g * n * HD + h * Dh + lane * DPL;

  float qs[DPL], ks[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) {
    qs[d] = q_scale[lane * DPL + d];
    ks[d] = k_scale[lane * DPL + d];
  }

  float qv[kMaxN][DPL], kk[kMaxN][DPL], vv[kMaxN][DPL];
#pragma unroll
  for (int t = 0; t < kMaxN; ++t) {
    if (t < n) {
      float sq = 0.f, sk = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        qv[t][d] = __bfloat162float(qp[(size_t)t * HD + d]);
        kk[t][d] = __bfloat162float(kp[(size_t)t * 2 * HD + d]);
        vv[t][d] = __bfloat162float(kp[(size_t)t * 2 * HD + HD + d]);
        sq += qv[t][d] * qv[t][d];
        sk += kk[t][d] * kk[t][d];
      }
      // F.normalize: x / max(||x||, 1e-12)
      const float iq = 1.f / fmaxf(sqrtf(otk::warp_sum(sq)), 1e-12f);
      const float ik = 1.f / fmaxf(sqrtf(otk::warp_sum(sk)), 1e-12f);
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        qv[t][d] *= iq * qs[d];
        kk[t][d] *= ik * ks[d];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < n) {
      float s[kMaxN];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        s[j] = -CUDART_INF_F;
        if (j < n && !(causal && j > i)) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) dot += qv[i][d] * kk[j][d];
          s[j] = otk::warp_sum(dot) * scale;
          m = fmaxf(m, s[j]);
        }
      }
      float denom = 0.f, o[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) o[d] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < n && !(causal && j > i)) {
          const float p = __expf(s[j] - m);
          denom += p;
#pragma unroll
          for (int d = 0; d < DPL; ++d) o[d] += p * vv[j][d];
        }
      }
      const float inv = 1.f / denom;
#pragma unroll
      for (int d = 0; d < DPL; ++d) op[(size_t)i * HD + d] = __float2bfloat16(o[d] * inv);
    }
  }
}

}  // namespace

extern "C" int small_attn_launch(const void* q, const void* kv, const void* q_scale,
                                 const void* k_scale, void* out, int R, int n, int H, int Dh,
                                 float scale, int causal, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R * H + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(kv);
  const float* qs = static_cast<const float*>(q_scale);
  const float* ks = static_cast<const float*>(k_scale);
  bf16* op = static_cast<bf16*>(out);
  switch (Dh) {
    case 32: small_attn_kernel<1><<<grid, kWarps * 32, 0, s>>>(qp, kp, qs, ks, op, R, n, H, scale, causal); break;
    case 64: small_attn_kernel<2><<<grid, kWarps * 32, 0, s>>>(qp, kp, qs, ks, op, R, n, H, scale, causal); break;
    case 128: small_attn_kernel<4><<<grid, kWarps * 32, 0, s>>>(qp, kp, qs, ks, op, R, n, H, scale, causal); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
