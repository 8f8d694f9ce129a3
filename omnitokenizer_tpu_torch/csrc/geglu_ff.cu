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
// The GEMMs share one kernel: A and B tiles (64 wide in k, 128-byte rows)
// arrive by TMA with the 128-byte swizzle into a 3-stage ring guarded by
// mbarriers; a producer warp issues the copies, two consumer warpgroups
// (64 rows each) run wgmma m64nBNk16 from shared memory. Two blocks fit an
// SM, so one block's epilogue overlaps the other's loads. Weights are read
// once per 128 rows from shared memory; xn and act add ~160 MB of device
// traffic at M=20480 (~0.05 ms). Ragged M: TMA fills rows past M with zeros
// and the epilogue masks its stores. The (M, 2*Ip) f32 pre-activation never
// reaches device memory.
#include <cuda.h>

#include <cstdint>
#include <mutex>
#include <vector>

#include "common.cuh"

namespace {

using otk::bf16;
using otk::fence_regs;
using otk::smem_u32;
using otk::sw128_desc;

constexpr float kEps = 1e-5f;
constexpr int kBM = 128;                 // rows per GEMM block
constexpr int kBK = 64;                  // k per stage: one 128-byte row of bf16
constexpr int kStages = 3;
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRowBytes = kBK * 2;       // 128
constexpr int kTileA = kBM * kRowBytes;  // 16 KB
constexpr int kLnWarps = 8;

// ------------------------------------------------------------------ LN
template <int D>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_kernel(const bf16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
          bf16* __restrict__ xn, int M) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kPer = (kChunks + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* src = x + (size_t)row * D;
  float v[kPer][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (c < kChunks) u = *reinterpret_cast<const uint4*>(src + 8 * c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[i][2 * e] = f.x;
      v[i][2 * e + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mean = otk::warp_sum(s) / D;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (lane + 32 * i < kChunks)
#pragma unroll
      for (int e = 0; e < 8; ++e) var += (v[i][e] - mean) * (v[i][e] - mean);
  const float rstd = rsqrtf(otk::warp_sum(var) / D + kEps);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c >= kChunks) continue;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16((v[i][e] - mean) * rstd * w[8 * c + e] + b[8 * c + e]);
    *reinterpret_cast<uint4*>(xn + (size_t)row * D + 8 * c) = *reinterpret_cast<const uint4*>(o);
  }
}

// ------------------------------------------------- barriers, TMA, wgmma
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a (box) tile at column c0, row c1 of the tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// d (64 x BN, f32, the warpgroup's fragment) += A (64 x 16) B (BN x 16)^T
template <int BN>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

constexpr size_t gemm_smem(int bn) {
  return (size_t)kStages * (kTileA + bn * kRowBytes) + 1024 + 2 * kStages * sizeof(uint64_t);
}

// ------------------------------------------------------------------ GEMM
// out[m, n] = sum_k A[m, k] B[n, k] over K (both K-major bf16, by TMA).
// kGeglu: the B tile is W1's rows [n0, n0+64) and [gate_row+n0, ...+64), and
// out[m, n0 + c] = bf16(gelu(h[m, 64 + c]) * h[m, c]); else the B tile is
// rows [n0, n0 + BN) and out[m, n0 + c] = bf16(h[m, c]). Row stride of out:
// ldo. Block (x, y) owns columns x of the n tiling and rows [128 y, 128 y + 128).
template <int BN, bool kGeglu>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
            bf16* __restrict__ out, int M, int ldo, int K, int gate_row) {
  constexpr int kTileB = BN * kRowBytes;
  constexpr uint32_t kStageBytes = kTileA + kTileB;
  constexpr int kOutCols = kGeglu ? BN / 2 : BN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle wants 1024-byte aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t tiles = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kOutCols, m0 = blockIdx.y * kBM;
  const int k_iters = K / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int k = 0; k < k_iters; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(empty0 + 8 * s, ((k / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s, a = tiles + s * kStageBytes, b = a + kTileA;
        mbar_expect_tx(full, kStageBytes);
        tma_load(a, &tma_a, full, k * kBK, m0);
        if constexpr (kGeglu) {
          tma_load(b, &tma_b, full, k * kBK, n0);
          tma_load(b + kTileB / 2, &tma_b, full, k * kBK, gate_row + n0);
        } else {
          tma_load(b, &tma_b, full, k * kBK, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the block
  const int wg = tid >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < k_iters; ++k) {
    const int s = k % kStages;
    mbar_wait(full0 + 8 * s, (k / kStages) & 1);
    const uint32_t a = tiles + s * kStageBytes + wg * 64 * kRowBytes;
    const uint32_t b = tiles + s * kStageBytes + kTileA;
    fence_regs<BN / 2>(acc);
    otk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
    otk::wgmma_commit_wait();
    fence_regs<BN / 2>(acc);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * s);
  }

  // accumulator fragment: acc[4i + 2h + e] is row 16 w + g + 8 h, column 8 i + 2 t + e
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= M) continue;
    bf16* dst = out + (size_t)row * ldo + n0 + 2 * t;
#pragma unroll
    for (int i = 0; i < kOutCols / 8; ++i) {
      float x0 = acc[4 * i + 2 * h], x1 = acc[4 * i + 2 * h + 1];
      if constexpr (kGeglu) {  // val columns i < 8, gate columns i + 8
        x0 *= gelu_erf(acc[4 * (i + 8) + 2 * h]);
        x1 *= gelu_erf(acc[4 * (i + 8) + 2 * h + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ----------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess && p
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows x cols) bf16 matrix, read in (box_rows x 64) boxes with
// the 128-byte swizzle; rows past the end read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_map for a weight, cached: a map holds nothing but the pointer, the
// shape and the box, so the one kept for those is exact, and the weights are
// the same tensors call after call (the activations' maps are made per call)
bool weight_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  struct Entry {
    const void* ptr;
    int rows, cols, box_rows;
    CUtensorMap map;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  if (!make_map(map, ptr, rows, cols, box_rows)) return false;
  if (cache.size() >= 256) cache.clear();
  cache.push_back({ptr, rows, cols, box_rows, *map});
  return true;
}

template <int BN, bool kGeglu>
int launch_gemm(const CUtensorMap& a, const CUtensorMap& b, bf16* out, int M, int ldo, int K,
                int n_tiles, int gate_row, cudaStream_t stream) {
  const size_t smem = gemm_smem(BN);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BN, kGeglu>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (M + kBM - 1) / kBM);
  gemm_kernel<BN, kGeglu><<<grid, kThreads, smem, stream>>>(a, b, out, M, ldo, K, gate_row);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w1, const bf16* w2,
           bf16* xn, bf16* act, bf16* out, int M, int Ip, cudaStream_t stream) {
  constexpr int BN2 = D >= 128 ? 128 : 64;  // GEMM2's output columns per block
  ln_kernel<D><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(x, ln_w, ln_b, xn, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap a1, b1, a2, b2;
  if (!make_map(&a1, xn, M, D, kBM) || !weight_map(&b1, w1, 2 * Ip, D, 64) ||
      !make_map(&a2, act, M, Ip, kBM) || !weight_map(&b2, w2, D, Ip, BN2))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_gemm<128, true>(a1, b1, act, M, Ip, D, Ip / 64, Ip, stream);
  if (rc != 0) return rc;
  return launch_gemm<BN2, false>(a2, b2, out, M, D, Ip, D / BN2, 0, stream);
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
