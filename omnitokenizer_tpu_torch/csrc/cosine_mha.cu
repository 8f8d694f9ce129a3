// Cosine-similarity multi-head attention over a spatial token grid, per
// (batch, head), non-causal:
//   [2D RoPE on pairs (2p, 2p+1)] -> l2norm * q_scale * scale / l2norm *
//   k_scale -> rounded to bf16 -> softmax(q k^T) in f32 -> @ v.
// q is (B, N, H*Dh); kv is the fused projection (B, N, 2*H*Dh).
//
// Replaces omnitokenizer_tpu/ops/pallas/cosine_mha.py:cosine_mha.
// Bound: tensor-core compute, 4*B*H*N^2*Dh flops (43 GFLOP at the flagship's
// B=20, N=1024, H=8, Dh=64: 0.043 ms at 989 TFLOP/s bf16). The B*H*N^2
// exponentials (168 M there) cost about as much on the SFUs (~16 a clock an
// SM: ~0.043 ms); past roughly half the bound a kernel has to overlap the
// softmax of one tile with the products of another (FA3's two-warpgroup
// ping-pong), which this one does not.
// Design: two kernels behind one call, q-hat and k-hat in buffers the
// wrapper allocates:
//   1. prep, one pass over q and the k half of kv: a thread rotates (when
//      RoPE is on), l2-normalizes (its head's Dh/8 threads add the squares
//      with shuffles), scales and rounds 8 dims of a row to bf16: q-hat and
//      k-hat (B, N, H*Dh). Every key is prepped once per call (84 MB of
//      traffic at the flagship, ~0.025 ms at 3.35 TB/s);
//   2. FlashAttention-2 on wgmma: a block owns (b, h, 128 queries): two
//      consumer warpgroups of 64 query rows and one producer warp. TMA
//      brings the q-hat tile once, then k-hat and v tiles of 64 keys into a
//      4-stage ring guarded by mbarriers (v read straight from kv, at column
//      H*Dh + h*Dh, through a map of one matrix a batch). S = q-hat
//      k-hat^T runs on wgmma m64n64k16 from shared memory into f32
//      registers; the online softmax runs on that fragment
//      in registers (row max and sum over the thread quad, exp2 with log2(e)
//      folded in, f32 running max and sum); P is rounded to bf16 and, as the
//      f32 m64nNk16 accumulator layout is the bf16 A-fragment layout, it is
//      P V's register A operand with no data movement; O += P V runs on
//      wgmma with B = the v tile read MN-major (tnspB = 1). O stays in
//      registers (Dh/2 f32 a thread) and is rescaled there; the epilogue
//      divides by the row sum and writes bf16 at column h*Dh of out.
// Dh is 16, 32, 64 or 128. Tiles carry the swizzle of their row width: 32,
// 64 or 128 bytes at Dh = 16, 32, 64; at Dh = 128 a tile is two boxes of 64
// columns, each 128-byte swizzled, with the K-major descriptor stepped from
// one box to the next and the MN-major one's LBO set to the box stride. The
// N x N scores never reach device memory. The TPU kernel's bound
// shift with its -80 floor, its ones-column denominator and its pair-swap
// matmul were workarounds for the TPU and are left out. N is any square in
// [16, 2048] (the JAX gate): rows of a 128-query block past N are computed on
// the next batch's rows or TMA's zeros and not stored, and the last key tile
// may be partial (N < 64 is one partial tile): its keys past N score -inf,
// and their v rows are TMA's zeros (v's map holds each batch apart), so they
// add exactly 0 whatever the next batch holds.
#include "sm90_gemm.cuh"

namespace {

using otk::bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;  // queries a block: two consumer warpgroups of 64
constexpr int kBN = 64;   // keys a tile
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kPrepThreads = 256;

// ------------------------------------------------------------------ prep
// blockIdx.y 0: q-hat = bf16(rope(q) / max(|rope(q)|, 1e-12) * q_scale * scale)
// blockIdx.y 1: k-hat = bf16(rope(k) / max(|rope(k)|, 1e-12) * k_scale)
// A thread owns 8 consecutive dims (4 pairs) of one row of one head.
template <int Dh>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
            const float* __restrict__ q_scale, const float* __restrict__ k_scale,
            const float* __restrict__ cos_t, const float* __restrict__ sin_t,
            bf16* __restrict__ q_hat, bf16* __restrict__ k_hat, int rows, int N, int HD,
            float scale, int rope) {
  constexpr int kLanes = Dh / 8;  // threads of a head: aligned groups inside a warp
  const int chunks = HD / 8;
  const long long idx = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  // every lane takes part in the shuffles; one past the end works on row 0
  const bool active = idx < (long long)rows * chunks;
  const int r = active ? (int)(idx / chunks) : 0, c = active ? (int)(idx % chunks) : 0;
  const bool is_k = blockIdx.y != 0;
  const int d0 = (c % kLanes) * 8;  // first dim inside the head
  const bf16* src = is_k ? kv + (size_t)r * 2 * HD + 8 * c : q + (size_t)r * HD + 8 * c;
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  float x[8];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 f = __bfloat1622float2(h2[p]);
    x[2 * p] = f.x;
    x[2 * p + 1] = f.y;
  }
  if (rope) {
    const size_t at = (size_t)(r % N) * (Dh / 2) + d0 / 2;
    const float4 cs = *reinterpret_cast<const float4*>(cos_t + at);
    const float4 sn = *reinterpret_cast<const float4*>(sin_t + at);
    const float cv[4] = {cs.x, cs.y, cs.z, cs.w}, sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float a = x[2 * p], b = x[2 * p + 1];
      x[2 * p] = a * cv[p] - b * sv[p];
      x[2 * p + 1] = a * sv[p] + b * cv[p];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss += x[e] * x[e];
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = 1.f / fmaxf(sqrtf(ss), 1e-12f);
  const float* dim_scale = (is_k ? k_scale : q_scale) + d0;
  const float mul = is_k ? 1.f : scale;
  __align__(16) bf16 y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) y[e] = __float2bfloat16(x[e] * inv * (dim_scale[e] * mul));
  if (active)
    *reinterpret_cast<uint4*>((is_k ? k_hat : q_hat) + (size_t)r * HD + 8 * c) =
        *reinterpret_cast<const uint4*>(y);
}

// ------------------------------------------------------------------ flash
// A tile of 64 rows (queries, keys or v rows) x Dh lies in shared memory as
// kBoxes column boxes of kBoxCols, each as TMA wrote it with the swizzle of
// its row width: 32, 64 or 128 bytes at Dh = 16, 32, 64; two 128-byte boxes
// at Dh = 128 (a 256-byte row is wider than any swizzle).
template <int Dh>
struct Box {
  static constexpr int kCols = Dh < 64 ? Dh : 64;
  static constexpr int kCount = Dh / kCols;
  static constexpr uint32_t kRowBytes = 2 * kCols;
  static constexpr uint32_t kBytes = 64 * kRowBytes;  // one box of a 64-row tile
  static constexpr int kSteps = kCols / 16;           // k steps of 16 inside a box
};

// wgmma descriptor of such a tile; 8-row groups lie 8 box rows apart (SBO).
// K-major (q-hat, k-hat: rows are queries or keys): a k step adds its byte
// offset inside the box, or steps to the next box; the leading offset is
// unused. MN-major (v as P V's B: rows are keys, the k dimension): the Dh
// output columns are the MN dimension, one swizzle row a box, and LBO is the
// stride from one box to the next (unused with one box; set like SBO).
template <int Dh, bool kMN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  using Bx = Box<Dh>;
  constexpr uint64_t kGroup = 8 * Bx::kRowBytes;
  constexpr uint64_t kLayout = Bx::kRowBytes == 128 ? 1 : Bx::kRowBytes == 64 ? 2 : 3;
  constexpr uint64_t kLbo = !kMN ? 16 : Bx::kCount > 1 ? Bx::kBytes : kGroup;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((kLbo >> 4) << 16) | ((kGroup >> 4) << 32) |
         (kLayout << 62);
}

// the K-major descriptor of k step kk of a 64-row tile at addr
template <int Dh>
__device__ __forceinline__ uint64_t kstep_desc(uint32_t addr, int kk) {
  using Bx = Box<Dh>;
  return tile_desc<Dh, false>(addr + (kk / Bx::kSteps) * Bx::kBytes + 32 * (kk % Bx::kSteps));
}

// TMA: the boxes of a 64-row tile at column c0, rows (c1[, batch]) of a map
template <int Dh>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1) {
  using Bx = Box<Dh>;
#pragma unroll
  for (int b = 0; b < Bx::kCount; ++b)
    otk::tma_load(dst + b * Bx::kBytes, map, bar, c0 + b * Bx::kCols, c1);
}
template <int Dh>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  using Bx = Box<Dh>;
#pragma unroll
  for (int b = 0; b < Bx::kCount; ++b)
    otk::tma_load(dst + b * Bx::kBytes, map, bar, c0 + b * Bx::kCols, c1, c2);
}

// d (64 x Dh f32) += A (64 x 16, bf16 registers: the m16n8k16 A fragment of
// each warp's 16 rows) B, B (16 keys x Dh) MN-major in shared memory
template <int Dh>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int Dh>
constexpr size_t flash_smem() {
  return 1024 + (size_t)(kBQ + kStages * 2 * kBN) * 2 * Dh + (1 + 2 * kStages) * sizeof(uint64_t);
}

// kRagged: N % 64 != 0, the last key tile is partial; an instance of its
// own, so the full tiles of the other one carry no mask. At Dh = 128 O takes
// 64 registers a thread and a block 161 KB of shared memory: one block an SM
template <int Dh, bool kRagged>
__global__ void __launch_bounds__(kThreads, Dh == 128 ? 1 : 2)
flash_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int N, int H) {
  constexpr uint32_t kRowBytes = 2 * Dh;
  constexpr uint32_t kQBytes = kBQ * kRowBytes;
  constexpr uint32_t kTileBytes = kBN * kRowBytes;  // a k-hat or a v tile
  constexpr uint32_t kStageBytes = 2 * kTileBytes;
  constexpr int kSteps = Dh / 16;  // k steps of S
  constexpr int kPSteps = kBN / 16;  // k steps of P V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (otk::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = otk::smem_u32(smem), kv_s = q_s + kQBytes;
  const uint32_t q_bar = kv_s + kStages * kStageBytes;
  const uint32_t full0 = q_bar + 8, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y;
  const int row_base = blockIdx.z * N;  // the batch's first row in q-hat's and k-hat's maps
  const int n_tiles = (N + kBN - 1) / kBN;  // the last one may be partial

  if (tid == 0) {
    otk::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      otk::mbar_init(full0 + 8 * s, 1);                 // the producer's expect_tx
      otk::mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    otk::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      otk::mbar_expect_tx(q_bar, kQBytes);
      load_tile<Dh>(q_s, &tq, q_bar, h * Dh, row_base + q0);
      load_tile<Dh>(q_s + kQBytes / 2, &tq, q_bar, h * Dh, row_base + q0 + 64);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) otk::mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s, k_dst = kv_s + s * kStageBytes;
        otk::mbar_expect_tx(full, kStageBytes);
        load_tile<Dh>(k_dst, &tk, full, h * Dh, row_base + it * kBN);
        load_tile<Dh>(k_dst + kTileBytes, &tv, full, (H + h) * Dh, it * kBN, blockIdx.z);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64); a
  // fragment's element 4i + 2e + c is row 16 w + g + 8 e, column 8 i + 2 t + c
  const int wg = tid >> 7, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t qa = q_s + wg * (kQBytes / 2);
  float o[Dh / 2], m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) o[i] = 0.f;
  otk::mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    otk::mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t kt = kv_s + s * kStageBytes, vt = kt + kTileBytes;

    // S (64 queries x 64 keys) = q-hat k-hat^T
    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    otk::fence_regs<kBN / 2>(sc);
    otk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      otk::wgmma<kBN>(sc, kstep_desc<Dh>(qa, kk), kstep_desc<Dh>(kt, kk));
    otk::wgmma_commit_wait();
    otk::fence_regs<kBN / 2>(sc);

    // keys of a partial last tile past N (the next batch's k-hat rows, or
    // TMA's zeros past the end) score -inf: P is exactly 0 there, and their
    // v rows are TMA's zeros, so they add exactly 0
    if (kRagged && it == n_tiles - 1) {
      const int valid = N - it * kBN;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        if (8 * (i >> 2) + 2 * t + (i & 1) >= valid) sc[i] = -CUDART_INF_F;
    }

    // online softmax in the log2 domain; rows g (e = 0) and g + 8 (e = 1)
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      sc[i] *= kLog2e;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 1));
      mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 2));
      const float m_new = fmaxf(m_run[e], mt[e]);
      alpha[e] = exp2f(m_run[e] - m_new);
      m_run[e] = m_new;
      l_run[e] *= alpha[e];  // a per-thread partial sum; the quad adds up at the end
    }
    // P in bf16 as the A fragments of P V's k steps: keys 16 j + [0, 8) are
    // accumulator tile 2 j, keys 16 j + [8, 16) tile 2 j + 1; registers
    // {row g, row g + 8} of the first, then of the second
    uint32_t pa[kPSteps][4];
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* si = sc + 4 * (2 * j + half);
        const float p0 = exp2f(si[0] - m_run[0]), p1 = exp2f(si[1] - m_run[0]);
        const float p2 = exp2f(si[2] - m_run[1]), p3 = exp2f(si[3] - m_run[1]);
        l_run[0] += p0 + p1;
        l_run[1] += p2 + p3;
        pa[j][2 * half] = pack_bf16(p0, p1);
        pa[j][2 * half + 1] = pack_bf16(p2, p3);
      }

    // O = O * alpha + P V
#pragma unroll
    for (int i = 0; i < Dh / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    otk::fence_regs<Dh / 2>(o);
    otk::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
      wgmma_pv<Dh>(o, pa[j], tile_desc<Dh, true>(vt + j * 16 * Box<Dh>::kRowBytes));
    otk::wgmma_commit_wait();
    otk::fence_regs<Dh / 2>(o);
    otk::fence_regs<4 * kPSteps>(&pa[0][0]);
    __syncwarp();
    if (lane == 0) otk::mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 1);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 2);
  }
  const int row0 = q0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + 8 * e;
    if (row >= N) continue;
    const float inv = 1.f / l_run[e];
    bf16* dst = out + (size_t)(row_base + row) * H * Dh + h * Dh + 2 * t;
#pragma unroll
    for (int i = 0; i < Dh / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * e] * inv, o[4 * i + 2 * e + 1] * inv);
  }
}

template <int Dh>
int launch(const void* q, const void* kv, const void* qs, const void* ks, const void* cos_t,
           const void* sin_t, void* q_hat, void* k_hat, void* out, int B, int N, int H,
           float scale, int rope, cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  const long long threads = (long long)rows * (HD / 8);
  const dim3 pgrid((unsigned)((threads + kPrepThreads - 1) / kPrepThreads), 2);
  prep_kernel<Dh><<<pgrid, kPrepThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(q_hat), static_cast<bf16*>(k_hat),
      rows, N, HD, scale, rope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap tq, tk, tv;
  constexpr int kBox = Box<Dh>::kCols;
  if (!otk::make_map(&tq, q_hat, rows, HD, 64, kBox) ||
      !otk::make_map(&tk, k_hat, rows, HD, 64, kBox) ||
      !otk::make_map(&tv, kv, N, 2 * HD, 64, kBox, B))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = flash_smem<Dh>();
  auto kernel = N % kBN ? flash_kernel<Dh, true> : flash_kernel<Dh, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(out), N, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_hat and k_hat (B, N, H*Dh) are the wrapper's scratch buffers
extern "C" int cosine_mha_launch(const void* q, const void* kv, const void* q_scale,
                                 const void* k_scale, const void* cos_t, const void* sin_t,
                                 void* q_hat, void* k_hat, void* out, int B, int N, int H, int Dh,
                                 float scale, int rope, void* stream) {
  if (B < 1 || H < 1 || N < 16 || N > 2048) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16:
      return launch<16>(q, kv, q_scale, k_scale, cos_t, sin_t, q_hat, k_hat, out, B, N, H, scale,
                        rope, s);
    case 32:
      return launch<32>(q, kv, q_scale, k_scale, cos_t, sin_t, q_hat, k_hat, out, B, N, H, scale,
                        rope, s);
    case 64:
      return launch<64>(q, kv, q_scale, k_scale, cos_t, sin_t, q_hat, k_hat, out, B, N, H, scale,
                        rope, s);
    case 128:
      return launch<128>(q, kv, q_scale, k_scale, cos_t, sin_t, q_hat, k_hat, out, B, N, H, scale,
                         rope, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
