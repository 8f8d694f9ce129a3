// Fused gamma-only LayerNorm + q/kv projection:
//   q = LN_gamma(x) @ Wq^T   (f32 statistics, eps 1e-5, biased variance)
//   kv = x @ Wkv^T           (k and v read the PRE-norm x: reference quirk)
// LN(x) rounded to bf16 before its product, bf16 products with f32
// accumulation, bf16 outputs.
//
// Replaces omnitokenizer_tpu/ops/pallas/ln_qkv.py:ln_qkv.
// Bound: tensor-core compute, 2*M*D*(Dq+Dkv) flops (32 GFLOP at the
// flagship's M=20480, D=512, Dq=512, Dkv=1024; 0.033 ms at 989 TFLOP/s
// bf16), over ~84 MB of activations and weights (0.025 ms at 3.35 TB/s).
// Design: two kernels behind one call, the normed rows in a buffer the
// wrapper allocates:
//   1. the LN pass of sm90_gemm.cuh, a warp a row, gamma only: x -> xn
//      (M x D bf16; 21 MB at the flagship, ~0.006 ms each way);
//   2. one launch of the TMA/wgmma GEMM of sm90_gemm.cuh over all Dq + Dkv
//      output columns in two parts: column tiles in [0, Dq) read A = xn and
//      write q, tiles in [Dq, Dq + Dkv) read A = x and write kv (12 x 160
//      blocks of 128 rows x 128 columns at the flagship). Wq and Wkv arrive
//      by TMA; their tensor maps are cached by pointer and shape.
// BN is 128 where Dq and Dkv allow it, else 64. Weights come in the
// nn.Linear (out, in) layout, which is the K-major B operand.
#include "sm90_gemm.cuh"

extern "C" int ln_qkv_launch(const void* x, const void* gamma, const void* wq, const void* wkv,
                             void* xn, void* q, void* kv, int M, int D, int Dq, int Dkv,
                             void* stream) {
  using namespace otk;
  if (M < 1 || D % 64 || D > 512 || Dq < 64 || Dq % 64 || Dkv < 64 || Dkv % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = launch_ln(static_cast<const bf16*>(x), static_cast<const float*>(gamma), nullptr,
                     static_cast<bf16*>(xn), M, D, s);
  if (rc != 0) return rc;
  const int bn = Dq % 128 == 0 && Dkv % 128 == 0 ? 128 : 64;
  GemmPart pq{}, pkv{};
  if (!make_map(&pq.a, xn, M, D, kBM) || !weight_map(&pq.b, wq, Dq, D, bn) ||
      !make_map(&pkv.a, x, M, D, kBM) || !weight_map(&pkv.b, wkv, Dkv, D, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  pq.out = static_cast<bf16*>(q), pq.ldo = Dq, pq.tiles = Dq / bn;
  pkv.out = static_cast<bf16*>(kv), pkv.ldo = Dkv, pkv.tiles = Dkv / bn;
  return bn == 128 ? launch_gemm<128, false>(pq, pkv, M, D, 0, s)
                   : launch_gemm<64, false>(pq, pkv, M, D, 0, s);
}
