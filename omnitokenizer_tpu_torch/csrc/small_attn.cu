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
// flagship's R=4096, n=5, H=8, Dh=64; 25 us at 3.35 TB/s). Design: the
// staged small-group core of small_group.cuh, one task per (group, head):
// cp.async brings whole groups (n rows of q and of kv, contiguous) into a
// 3-stage shared-memory ring of a persistent block; a team of Dh/16 lanes
// (rounded up to a power of two; Dh any multiple of 16 up to 128) owns a
// query row, with 16-byte vectors, 2-step shuffle reductions at
// Dh = 64 and the inverse norms of every row computed once a stage. The TPU
// kernel's block-indicator matmuls (a lane-segmented reduction on the MXU)
// have no counterpart: team shuffles do that here.
#include "small_group.cuh"

namespace {

using otk::bf16;
namespace sg = otk::small_group;

constexpr int kMaxN = 8;

}  // namespace

extern "C" int small_attn_launch(const void* q, const void* kv, const void* q_scale,
                                 const void* k_scale, void* out, int R, int n, int H, int Dh,
                                 float scale, int causal, void* stream) {
  if (R < 1 || H < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const long long HD = (long long)H * Dh;
  sg::Problem p;
  p.q = q;
  p.k = kv;
  p.v = static_cast<const bf16*>(kv) + HD;
  p.out = out;
  p.sq = p.so = {n * HD, Dh, HD};        // task (group, head), row stride H*Dh
  p.sk = p.sv = {n * 2 * HD, Dh, 2 * HD};
  p.H = H;
  p.N = n;
  p.tasks = R * H;
  p.scale = scale;
  p.causal = causal;
  p.q_scale = static_cast<const float*>(q_scale);
  p.k_scale = static_cast<const float*>(k_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return sg::launch<bf16, 16, kMaxN, sg::Mode::Cosine>(p, s);
    case 32: return sg::launch<bf16, 32, kMaxN, sg::Mode::Cosine>(p, s);
    case 48: return sg::launch<bf16, 48, kMaxN, sg::Mode::Cosine>(p, s);
    case 64: return sg::launch<bf16, 64, kMaxN, sg::Mode::Cosine>(p, s);
    case 80: return sg::launch<bf16, 80, kMaxN, sg::Mode::Cosine>(p, s);
    case 96: return sg::launch<bf16, 96, kMaxN, sg::Mode::Cosine>(p, s);
    case 112: return sg::launch<bf16, 112, kMaxN, sg::Mode::Cosine>(p, s);
    case 128: return sg::launch<bf16, 128, kMaxN, sg::Mode::Cosine>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
