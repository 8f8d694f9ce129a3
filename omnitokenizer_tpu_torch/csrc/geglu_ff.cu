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

// xn (M, D) and act (M, Ip) are the wrapper's scratch buffers. D is any
// multiple of 64 up to the LN pass's 2048; GEMM2 writes 128 output columns a
// block where D allows it, else 64
extern "C" int geglu_ff_launch(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                               const void* w2, void* xn, void* act, void* out, int M, int D,
                               int Ip, void* stream) {
  using namespace otk;
  if (M < 1 || D < 64 || D % 64 || D > kMaxLnDim || Ip < 64 || Ip % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16 *xnb = static_cast<bf16*>(xn), *actb = static_cast<bf16*>(act);
  int rc = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
                     static_cast<const float*>(ln_b), xnb, M, D, s);
  if (rc != 0) return rc;
  const int bn2 = D % 128 == 0 ? 128 : 64;  // GEMM2's output columns a block
  GemmPart g1{}, g2{};
  if (!make_map(&g1.a, xn, M, D, kBM) || !weight_map(&g1.b, w1, 2 * Ip, D, 64) ||
      !make_map(&g2.a, act, M, Ip, kBM) || !weight_map(&g2.b, w2, D, Ip, bn2))
    return static_cast<int>(cudaErrorInvalidValue);
  g1.out = actb, g1.ldo = Ip, g1.tiles = Ip / 64;
  g2.out = static_cast<bf16*>(out), g2.ldo = D, g2.tiles = D / bn2;
  rc = launch_gemm<128, true>(g1, M, D, Ip, s);
  if (rc != 0) return rc;
  return bn2 == 128 ? launch_gemm<128, false>(g2, M, Ip, 0, s)
                    : launch_gemm<64, false>(g2, M, Ip, 0, s);
}
