// Feed-forward: out = GEGLU(LN(x; w, b) @ W1^T) @ W2^T, with
//   W1 (2*Ip, D) = [val rows | gate rows], act = gelu_erf(gate) * val,
//   W2 (D, Ip), both in the nn.Linear layout, inner padded to Ip % 64 == 0
//   with zero rows/columns (a zero val column contributes nothing).
// f32 LN statistics, bf16 products with f32 accumulation, f32 erf GELU,
// activations rounded to bf16 before the second product.
//
// Replaces omnitokenizer_tpu/ops/pallas/geglu_ff.py:geglu_ff (its tanh GELU
// was a Mosaic limitation; this kernel uses erf like the JAX math path).
// Bound: tensor-core compute, 6*M*D*Ip flops (88 GFLOP at M=20480, D=512,
// Ip=1408; 0.09 ms at 989 TFLOP/s bf16). Design: three kernels behind one
// call, the intermediates in buffers the wrapper allocates:
//   1. LN, a warp per row: x -> xn (M x D bf16);
//   2. GEMM1 on wgmma: a block owns 128 rows x 64 inner columns and reads 64
//      val rows [j, j+64) and 64 gate rows [Ip+j, Ip+j+64) of W1 as two TMA
//      boxes into one 128-row B tile, so val column c and gate column c lie
//      in the same thread's accumulators (c and c + 64 of an m64n128 tile):
//      the GEGLU epilogue runs in registers and writes act (M x Ip bf16);
//   3. GEMM2 on wgmma: act @ W2^T -> out (M x D bf16).
// Both GEMMs are the warp-specialized TMA/wgmma GEMM of sm90_gemm.cuh (a
// 3-stage TMA ring, a producer warp, two consumer warpgroups), and the LN is
// its LN pass. Weights are read once per 128 rows from shared memory; xn and
// act add ~160 MB of device traffic at M=20480 (~0.05 ms). The (M, 2*Ip) f32
// pre-activation never reaches device memory.
#include "sm90_gemm.cuh"

namespace {

using otk::bf16;

template <int D>
int launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w1, const bf16* w2,
           bf16* xn, bf16* act, bf16* out, int M, int Ip, cudaStream_t stream) {
  using namespace otk;
  constexpr int BN2 = D >= 128 ? 128 : 64;  // GEMM2's output columns per block
  int rc = launch_ln(x, ln_w, ln_b, xn, M, D, stream);
  if (rc != 0) return rc;
  GemmPart g1{}, g2{};
  if (!make_map(&g1.a, xn, M, D, kBM) || !weight_map(&g1.b, w1, 2 * Ip, D, 64) ||
      !make_map(&g2.a, act, M, Ip, kBM) || !weight_map(&g2.b, w2, D, Ip, BN2))
    return static_cast<int>(cudaErrorInvalidValue);
  g1.out = act, g1.ldo = Ip, g1.tiles = Ip / 64;
  g2.out = out, g2.ldo = D, g2.tiles = D / BN2;
  rc = launch_gemm<128, true>(g1, M, D, Ip, stream);
  if (rc != 0) return rc;
  return launch_gemm<BN2, false>(g2, M, Ip, 0, stream);
}

}  // namespace

// xn (M, D) and act (M, Ip) are the wrapper's scratch buffers
extern "C" int geglu_ff_launch(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                               const void* w2, void* xn, void* act, void* out, int M, int D,
                               int Ip, void* stream) {
  if (M < 1 || Ip < 64 || Ip % 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1),
             *w2b = static_cast<const bf16*>(w2);
  const float *lw = static_cast<const float*>(ln_w), *lb = static_cast<const float*>(ln_b);
  bf16 *xnb = static_cast<bf16*>(xn), *actb = static_cast<bf16*>(act), *ob = static_cast<bf16*>(out);
  switch (D) {
    case 64: return launch<64>(xb, lw, lb, w1b, w2b, xnb, actb, ob, M, Ip, s);
    case 128: return launch<128>(xb, lw, lb, w1b, w2b, xnb, actb, ob, M, Ip, s);
    case 256: return launch<256>(xb, lw, lb, w1b, w2b, xnb, actb, ob, M, Ip, s);
    case 512: return launch<512>(xb, lw, lb, w1b, w2b, xnb, actb, ob, M, Ip, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
