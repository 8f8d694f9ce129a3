// Hopper building blocks shared by the bf16 kernels (sm_90a): mbarriers,
// TMA tile loads and their tensor maps, bf16 wgmma from shared memory, a
// LayerNorm pass (a warp a row) and one warp-specialized TMA/wgmma GEMM.
//
// The GEMM computes out[m, n] = sum_k A[m, k] B[n, k] (both K-major bf16,
// f32 accumulation, bf16 out). A and B tiles (64 wide in k, 128-byte rows)
// arrive by TMA with the 128-byte swizzle into a 3-stage ring guarded by
// mbarriers; a producer warp issues the copies, two consumer warpgroups (64
// rows each) run wgmma m64nBNk16 from shared memory. Two blocks fit an SM,
// so one block's epilogue overlaps the other's loads. A launch covers up to
// two parts that share M and K but not A, B or the output (ln_qkv's q and kv
// columns). Ragged M: TMA fills rows past M with zeros and the epilogue
// masks its stores.
#pragma once

#include <cuda.h>

#include <cstdint>
#include <mutex>
#include <vector>

#include "common.cuh"

namespace otk {

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
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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

// the same for a map of three dimensions (make_map with batches > 0)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (64 x BN, f32, the warpgroup's fragment) += A (64 x 16) B (BN x 16)^T,
// both K-major in shared memory (descriptors)
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

// ------------------------------------------------------------ tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
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

// a row-major (rows x cols) bf16 matrix, read in (box_rows x box_cols) boxes
// with the swizzle of the box's row width (128, 64 or 32 bytes); rows past the
// end read as zeros. batches > 0: that many such matrices one after another,
// a map of three dimensions (col, row, batch) whose boxes stay inside one
// matrix, so rows past the end of the box's own matrix read as zeros
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                     int box_cols = 64, int batches = 0) {
  EncodeTiled encode = encode_fn();
  if (!encode || (box_cols != 64 && box_cols != 32 && box_cols != 16) || batches < 0)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * sizeof(bf16),
                                 (cuuint64_t)rows * cols * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, batches > 0 ? 3 : 2,
                const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_map for a weight, cached: a map holds nothing but the pointer, the
// shape and the box, so the one kept for those is exact, and the weights are
// the same tensors call after call (the activations' maps are made per call)
inline bool weight_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
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

namespace {  // kernels: each translation unit keeps its own instances

// ------------------------------------------------------------------ LN
constexpr int kLnWarps = 8;
constexpr int kMaxLnDim = 2048;

// xn = bf16(LN(x) * w [+ b]) per row, f32 statistics, eps 1e-5, biased
// variance; b may be null (gamma only). A warp a row, 16-byte chunks of the
// row spread over the lanes, kPer chunks a lane: D <= 256 kPer, D % 8 == 0.
// The row lives in the warp's registers (8 kPer floats a lane), which is
// what bounds D: 2048 at kPer = 8.
template <int kPer>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_kernel(const bf16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
          bf16* __restrict__ xn, int M, int D) {
  const int chunks = D / 8;
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
    if (c < chunks) u = *reinterpret_cast<const uint4*>(src + 8 * c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[i][2 * e] = f.x;
      v[i][2 * e + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / D;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (lane + 32 * i < chunks)
#pragma unroll
      for (int e = 0; e < 8; ++e) var += (v[i][e] - mean) * (v[i][e] - mean);
  const float rstd = rsqrtf(warp_sum(var) / D + 1e-5f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c >= chunks) continue;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __float2bfloat16((v[i][e] - mean) * rstd * w[8 * c + e] + (b ? b[8 * c + e] : 0.f));
    *reinterpret_cast<uint4*>(xn + (size_t)row * D + 8 * c) = *reinterpret_cast<const uint4*>(o);
  }
}

inline int launch_ln(const bf16* x, const float* w, const float* b, bf16* xn, int M, int D,
                     cudaStream_t stream) {
  if (D % 8 || D > kMaxLnDim) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kLnWarps - 1) / kLnWarps);
  if (D <= 256)
    ln_kernel<1><<<grid, kLnWarps * 32, 0, stream>>>(x, w, b, xn, M, D);
  else if (D <= 512)
    ln_kernel<2><<<grid, kLnWarps * 32, 0, stream>>>(x, w, b, xn, M, D);
  else if (D <= 1024)
    ln_kernel<4><<<grid, kLnWarps * 32, 0, stream>>>(x, w, b, xn, M, D);
  else
    ln_kernel<8><<<grid, kLnWarps * 32, 0, stream>>>(x, w, b, xn, M, D);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ GEMM
constexpr int kBM = 128;                 // rows per GEMM block
constexpr int kBK = 64;                  // k per stage: one 128-byte row of bf16
constexpr int kStages = 3;
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRowBytes = kBK * 2;       // 128
constexpr int kTileA = kBM * kRowBytes;  // 16 KB

constexpr size_t gemm_smem(int bn) {
  return (size_t)kStages * (kTileA + bn * kRowBytes) + 1024 + 2 * kStages * sizeof(uint64_t);
}

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// One part of a GEMM launch: A (M x K) and B (n x K) maps, the output and
// its row stride, and the number of column tiles (blocks along x) it takes.
struct GemmPart {
  CUtensorMap a, b;
  bf16* out;
  int ldo, tiles;
};

// Block (x, y) owns rows [128 y, 128 y + 128) and column tile x of part 0,
// or column tile x - p0.tiles of part 1. kGeglu: the B tile is W1's rows
// [n0, n0+64) and [gate_row+n0, ...+64), and out[m, n0 + c] =
// bf16(gelu(h[m, 64 + c]) * h[m, c]); else the B tile is rows [n0, n0 + BN)
// and out[m, n0 + c] = bf16(h[m, c]).
template <int BN, bool kGeglu>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const __grid_constant__ GemmPart p0, const __grid_constant__ GemmPart p1, int M, int K,
            int gate_row) {
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
  const bool second = (int)blockIdx.x >= p0.tiles;
  const GemmPart& p = second ? p1 : p0;
  const int n0 = (second ? blockIdx.x - p0.tiles : blockIdx.x) * kOutCols, m0 = blockIdx.y * kBM;
  const int k_iters = K / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int k = 0; k < k_iters; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(empty0 + 8 * s, ((k / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s, a = tiles + s * kStageBytes, b = a + kTileA;
        mbar_expect_tx(full, kStageBytes);
        tma_load(a, &p.a, full, k * kBK, m0);
        if constexpr (kGeglu) {
          tma_load(b, &p.b, full, k * kBK, n0);
          tma_load(b + kTileB / 2, &p.b, full, k * kBK, gate_row + n0);
        } else {
          tma_load(b, &p.b, full, k * kBK, n0);
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
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
    wgmma_commit_wait();
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
    bf16* dst = p.out + (size_t)row * p.ldo + n0 + 2 * t;
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

// one launch over p0's column tiles, then p1's (p1.tiles may be 0)
template <int BN, bool kGeglu>
int launch_gemm(const GemmPart& p0, const GemmPart& p1, int M, int K, int gate_row,
                cudaStream_t stream) {
  const size_t smem = gemm_smem(BN);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BN, kGeglu>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p0.tiles + p1.tiles, (M + kBM - 1) / kBM);
  gemm_kernel<BN, kGeglu><<<grid, kThreads, smem, stream>>>(p0, p1, M, K, gate_row);
  return static_cast<int>(cudaGetLastError());
}

// a launch of one part
template <int BN, bool kGeglu>
int launch_gemm(const GemmPart& p, int M, int K, int gate_row, cudaStream_t stream) {
  GemmPart none = p;
  none.tiles = 0;
  return launch_gemm<BN, kGeglu>(p, none, M, K, gate_row, stream);
}

}  // namespace
}  // namespace otk
