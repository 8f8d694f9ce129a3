// Plain multi-head attention per (batch, head) over (B*H, N, D) rows:
//   o = softmax(q k^T * scale [col > row masked to -1e9]) v
// scores, softmax and both products in f32 on float or bf16 inputs; the
// output is in the input type. The flash branches take contiguous (B*H, N,
// D) tensors; the small branch any (b, h, n) strides with 16-byte rows.
// The wrapper zero-pads any other D % 8 == 0 up to 128 to the flash
// branches' next width; it takes no D above 128 (the registers of O and the
// shared memory of the f32 branch's split tiles).
//
// Replaces omnitokenizer_tpu/ops/pallas/mha.py:mha_pallas. Two regimes reach
// it, and each gets a branch:
//
// * f32 flash branch (any N in [8, 2048], D in {8, 16, 32, 64, 128}): the f32
//   VAE's spatial blocks, BH=160, N=1024, D=64, 4*BH*N^2*D = 43 GFLOP. The f32
//   VAE is the parity path (1e-5 of the plain version), and one TF32 pass
//   keeps only ~1e-3, so the products run as three TF32 tensor-core passes
//   with error compensation (3xTF32: x = hi + lo, both TF32-rounded, and
//   a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b in f32 accumulators; the dropped
//   lo lo term is ~2^-22 relative). Bound: those passes, 3 x 43 GFLOP at the
//   card's 495 TFLOP/s TF32 rate = 0.26 ms (pure f32 FMA would be 0.64 ms at
//   67 TFLOP/s, which is where a SIMT kernel stops); the bytes (168 MB) take
//   0.05 ms. Design: FlashAttention-2 on wgmma. A warpgroup owns 64 queries
//   (a block 128): both products are wgmma m64nNk8 with TF32 operands, the
//   score tile lives in the accumulators, the online softmax (running max
//   and sum per row, quad shuffles) runs in registers, and the scores'
//   accumulator fragment is P's register operand with no data movement (see
//   the index maps below). Splitting is paid once per block, not per warp:
//   Q at the start and each 64-key K/V tile are split into hi/lo operand
//   tiles in shared memory, which a whole warpgroup reads per wgmma. K and V
//   stream through two buffers, a staging one filled by cp.async while the
//   warpgroups multiply the previous tile and the operand one they multiply
//   from. The N x N scores never reach device memory, which is what the TPU
//   kernel kept in VMEM.
//
// * bf16 flash branch (N > 16; no path runs it today): pure f32 FMA from
//   shared memory. A block owns (bh, 64 queries) with 256 threads in a 16 x 16
//   grid; a thread holds 4 query rows x 4 key columns of the score tile and
//   4 rows x D/16 dims of the output in registers; K and V are converted to
//   f32 as they load; P goes through shared memory to the P v product.
//   P is rounded to bf16 before it multiplies v, as in the plain version, but
//   unnormalized: the division by the row sum comes at the end. That moves
//   the rounding point, a bf16-level difference.
//
//   In both flash branches key tiles entirely above the causal diagonal are
//   skipped, padding keys score -inf and padded rows are zero (no NaN), and
//   inside a tile masked scores are set to -1e9 as in the plain version.
//
// * Small branch (N <= 16, D any multiple of 16 up to 128): the stage-1
//   tokenizer's causal temporal blocks, B*H = 32768 problems of 9 x 9 in
//   bf16. Bound: bytes, q,
//   k, v read once and o written once (151 MB, 45 us); the flash tile would
//   leave most of a 64-row block idle. Design: the staged small-group core
//   of small_group.cuh (cp.async ring of whole (b, h) problems in shared
//   memory, a team of D/16 lanes a query row with 16-byte vectors and
//   2-step shuffle reductions at D = 64). It reads q, k and v through their
//   strides: the attention module hands over transposed views of (B, N, H,
//   D) memory, v inside the fused kv projection, and the output is written
//   in q's layout, so no copy is made on either side. P is normalized before
//   its rounding to the input type, exactly as the plain version; masked
//   pairs weigh exactly 0, as the -1e9 fill gives in f32.
#include <cstdint>
#include <type_traits>

#include "small_group.cuh"

namespace {

using otk::bf16;

constexpr int kMaxSmallN = 16;

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// ------------------------------------------------------- bf16 flash branch
constexpr int kBM = 64;        // queries per block
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kLdP = kBN + 4;  // row stride of the P tile (floats)

// rows [0, rows_valid) of a kBM x D tile from global (row stride D) into
// shared f32 (row stride ld); the other rows are zero, so padded keys add
// 0 * 0 to the output and never NaN
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int rows_valid) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kBM * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    float x[8];
    if (r < rows_valid) {
      otk::load8(src + (size_t)r * D + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
    d4[0] = make_float4(x[0], x[1], x[2], x[3]);
    d4[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// n consecutive shared f32 values, as wide as their alignment allows (the
// callers' offsets are multiples of n floats)
template <int n>
__device__ __forceinline__ void load_row(const float* p, float* x) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int e = 0; e < n; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + e);
      x[e] = t.x; x[e + 1] = t.y; x[e + 2] = t.z; x[e + 3] = t.w;
    }
  } else if constexpr (n % 2 == 0) {
#pragma unroll
    for (int e = 0; e < n; e += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + e);
      x[e] = t.x; x[e + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < n; ++e) x[e] = p[e];
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
mha_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int N, float scale, int causal) {
  constexpr int ld = D + 4;                    // row stride of the q/k/v tiles (floats)
  constexpr int kDpt = D >= 16 ? D / 16 : 1;   // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + kBM * ld;
  float* s_v = s_k + kBN * ld;
  float* s_p = s_v + kBN * ld;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBM;
  const size_t base = (size_t)blockIdx.y * N * D;
  const bool d_active = tx * kDpt < D;  // D = 8 leaves half the threads out of P v

  load_tile<T, D>(s_q, ld, q + base + (size_t)q0 * D, N - q0);

  float o[4][kDpt], m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDpt; ++e) o[i][e] = 0.f;
  }

  // key tiles past the block's last query are all masked when causal
  const int k_end = causal ? min(N, q0 + kBM) : N;
  for (int k0 = 0; k0 < k_end; k0 += kBN) {
    __syncthreads();  // the previous tile's P v is done with s_v and s_p
    load_tile<T, D>(s_k, ld, k + base + (size_t)k0 * D, N - k0);
    load_tile<T, D>(s_v, ld, v + base + (size_t)k0 * D, N - k0);
    __syncthreads();

    // S (4 rows x 4 cols per thread): rows ty*4 + i, cols tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(s_q + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(s_k + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax per row; P (rounded to T) into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= N) x = -CUDART_INF_F;                 // padding: no key
        else if (causal && col > row) x = -1e9f;         // the mask of the plain version
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = row_max16(mt);
      const float m_new = fmaxf(m_run[i], mt);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s_p[(ty * 4 + i) * kLdP + tx + 16 * j] = round_to<T>(p);
      }
      l_run[i] = l_run[i] * alpha + row_sum16(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDpt; ++e) o[i][e] *= alpha;
    }
    __syncthreads();

    // O (4 rows x kDpt dims per thread) += P v
    if (d_active) {
#pragma unroll 2
      for (int c = 0; c < kBN; c += 4) {
        float4 p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(s_p + (ty * 4 + i) * kLdP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float vb[kDpt];
          load_row<kDpt>(s_v + (c + cc) * ld + tx * kDpt, vb);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
            for (int e = 0; e < kDpt; ++e) o[i][e] = fmaf(pc, vb[e], o[i][e]);
          }
        }
      }
    }
  }

  if (!d_active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    const float inv = 1.f / l_run[i];
    T* dst = out + base + (size_t)row * D + tx * kDpt;
#pragma unroll
    for (int e = 0; e < kDpt; ++e) dst[e] = from_f32<T>(o[i][e] * inv);
  }
}

// ------------------------------------------------- f32 flash branch (3xTF32)
// A consumer warpgroup owns 64 queries and runs both products on wgmma with
// TF32 operands, in three passes each (lo*hi + hi*lo + hi*hi) on operands
// split once per block as hi = rna(x), lo = rna(x - hi).
// Operand tiles live in shared memory in the K-major layout with the 128-byte
// swizzle (f32 rows cut into 32-element chunks, each chunk a region of
// 128-byte rows): Q hi/lo and K hi/lo as [row][d], V hi/lo transposed as
// [d][key]. S = Q K^T reads both from shared memory; P V takes P from
// registers.
//
// P's operand fragment is the scores' accumulator fragment (g = lane / 4,
// t = lane % 4): the k order inside an 8-wide k step is free as long as A and
// B agree, so key tile j puts key 8j + 2t at k = t and key 8j + 2t + 1 at
// k = t + 4 -- exactly the two score columns this thread holds -- and the
// transposed V tile is written in that key order.
//
// Pipeline per key tile: cp.async brings the raw f32 K and V tiles into a
// staging buffer while the warpgroups multiply the previous tile; then all
// threads split the staged tile into the hi/lo operand tiles.
//
// The tensor core's accumulator adds are not rounded to nearest, so the sums
// kept in accumulators are short:
// * S keeps hi*hi in one accumulator and the two small products in another,
//   added in f32 after the k loop. With all three in one, the big sum takes
//   three times the truncations, and at logits near 200 (N(0, 1) q and k,
//   scale 8) the error from an f64 result came out well above the plain
//   version's; split, it is about the plain version's.
// * Each tile's P V starts from zero and is added to the running output in
//   f32 (o = o * alpha + P V): a 1024-key sum kept in the accumulators drifts
//   to ~1e-5. Splitting P V's accumulator as S's measured no gain.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// four elements split into the 16-byte units at hi and at hi + lo_offset
__device__ __forceinline__ void store_hi_lo(uint8_t* hi, int lo_offset, float a, float b,
                                            float c, float d) {
  uint4 h, l;
  split_tf32(a, h.x, l.x);
  split_tf32(b, h.y, l.y);
  split_tf32(c, h.z, l.z);
  split_tf32(d, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(hi + lo_offset) = l;
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}
// generic-proxy shared stores made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d (64 x N f32, the warpgroup's fragment) += A (64 x 8) B (N x 8)^T, TF32;
// A and B K-major in shared memory (descriptors)
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// the same with A from registers (the m16n8k8 A fragment of each warp's 16 rows)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shapes per head width: two warpgroups (128 queries) and 64-key tiles up to
// D = 64; one warpgroup and 32-key tiles at D = 128, to fit 227 KB
template <int D>
struct Tf32Cfg {
  static constexpr int kGroups = D <= 64 ? 2 : 1;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBM = 64 * kGroups;          // queries per block
  static constexpr int kBN = D <= 64 ? 64 : 32;     // keys per tile
  static constexpr int kLdRaw = D + 4;              // floats a staged row
  static constexpr int kRawRows = 2 * kBN > kBM ? 2 * kBN : kBM;  // K and V, or Q
  static constexpr int kChunks = (D + 31) / 32;     // 128-byte chunks of a d row
  // bytes of one hi or lo operand tile
  static constexpr int kQBytes = kChunks * kBM * 128;
  static constexpr int kKBytes = kChunks * kBN * 128;
  static constexpr int kVBytes = (kBN / 32) * D * 128;
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)(kQBytes + kKBytes + kVBytes) + (size_t)kRawRows * kLdRaw * 4;
};

// byte offset of f32 element (r, k) in a K-major tile of `rows` rows with the
// 128-byte swizzle: 32-element chunks of k are regions of rows x 128 bytes,
// and the 16-byte unit u of row r sits at u ^ (r % 8)
__device__ __forceinline__ uint32_t sw_off(int rows, int r, int k) {
  return (k >> 5) * rows * 128 + r * 128 + ((((k >> 2) & 7) ^ (r & 7)) << 4) + (k & 3) * 4;
}

// cp.async rows [0, rows) of a (rows x D) f32 block into the staging buffer
// (row stride kLdRaw); rows at or past rows_valid are zero-filled
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows,
                                           int rows_valid) {
  using C = Tf32Cfg<D>;
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += C::kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    const bool ok = r < rows_valid;
    otk::cp_async16(dst + r * C::kLdRaw + c, ok ? src + (size_t)r * D + c : src, ok ? 16 : 0);
  }
}

// staged rows [0, rows) -> the hi [row][d] tile at hi, the lo one lo_offset on
template <int D>
__device__ __forceinline__ void split_rows(uint8_t* hi, int lo_offset, const float* raw, int rows) {
  using C = Tf32Cfg<D>;
  for (int i = threadIdx.x; i < rows * (D / 4); i += C::kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * C::kLdRaw + c);
    store_hi_lo(hi + sw_off(rows, r, c), lo_offset, x.x, x.y, x.z, x.w);
  }
}

// staged V rows -> hi/lo [d][key] operand tiles; the 16-byte unit (j, h) of
// row d holds keys 8j + h, 8j + 2 + h, 8j + 4 + h, 8j + 6 + h (k = 4h + q
// <-> key 8j + 2q + h)
template <int D>
__device__ __forceinline__ void split_v(uint8_t* hi, uint8_t* lo, const float* raw) {
  using C = Tf32Cfg<D>;
  for (int i = threadIdx.x; i < D * (C::kBN / 4); i += C::kThreads) {
    const int d = i % D, u = i / D;
    const float* src = raw + (8 * (u >> 1) + (u & 1)) * C::kLdRaw + d;
    store_hi_lo(hi + sw_off(D, d, 4 * u), static_cast<int>(lo - hi), src[0], src[2 * C::kLdRaw],
                src[4 * C::kLdRaw], src[6 * C::kLdRaw]);
  }
}

template <int D>
__global__ void __launch_bounds__(Tf32Cfg<D>::kThreads)
mha_flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int N, float scale,
                      int causal) {
  using C = Tf32Cfg<D>;
  constexpr int kBM = C::kBM, kBN = C::kBN;
  constexpr int kSteps = D / 8;   // k steps of S, 8-column tiles of O
  constexpr int kNT = kBN / 8;    // 8-column tiles of S, k steps of P V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the 128-byte swizzle wants 1024-byte aligned tiles
  uint8_t* sm = smem_raw + ((1024 - (otk::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_hi = sm;  // each lo tile follows its hi tile
  uint8_t* k_hi = q_hi + 2 * C::kQBytes;
  uint8_t* v_hi = k_hi + 2 * C::kKBytes;
  uint8_t* v_lo = v_hi + C::kVBytes;
  float* raw = reinterpret_cast<float*>(v_lo + C::kVBytes);  // staged K then V, or Q
  float* raw_v = raw + kBN * C::kLdRaw;

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBM + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;  // and + 8
  const int q0 = blockIdx.x * kBM;
  const size_t base = (size_t)blockIdx.y * N * D;
  const float* kb = k + base;
  const float* vb = v + base;
  const uint32_t qh_s = otk::smem_u32(q_hi) + wg * 64 * 128, ql_s = qh_s + C::kQBytes;
  const uint32_t kh_s = otk::smem_u32(k_hi), kl_s = kh_s + C::kKBytes;
  const uint32_t vh_s = otk::smem_u32(v_hi), vl_s = otk::smem_u32(v_lo);

  const int k_end = causal ? min(N, q0 + kBM) : N;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  stage_rows<D>(raw, q + base + (size_t)q0 * D, kBM, N - q0);
  cp_async_commit_wait_all();
  __syncthreads();
  split_rows<D>(q_hi, C::kQBytes, raw, kBM);
  fence_proxy_async();
  __syncthreads();
  stage_rows<D>(raw, kb, kBN, N);
  stage_rows<D>(raw_v, vb, kBN, N);
  otk::cp_async_commit();

  float o[D / 2], m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBN;
    cp_async_commit_wait_all();
    __syncthreads();  // the staged tile has landed; every warpgroup is done with the operand tiles
    split_rows<D>(k_hi, C::kKBytes, raw, kBN);
    split_v<D>(v_hi, v_lo, raw_v);
    fence_proxy_async();
    __syncthreads();  // operand tiles ready, staging free
    if (it + 1 < n_tiles) {  // the next tile streams in while this one multiplies
      const int k1 = k0 + kBN;
      stage_rows<D>(raw, kb + (size_t)k1 * D, kBN, N - k1);
      stage_rows<D>(raw_v, vb + (size_t)k1 * D, kBN, N - k1);
    }

    // S (64 x kBN per warpgroup) = Q K^T; s[4i + e]: row g + 8 (e / 2), key 8i + 2t + e % 2
    // the small products in sl, hi*hi in s, added in f32 after the loop
    float s[kBN / 2], sl[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) { s[i] = 0.f; sl[i] = 0.f; }
    otk::fence_regs<kBN / 2>(s);
    otk::fence_regs<kBN / 2>(sl);
    otk::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const uint32_t qo = (ks >> 2) * kBM * 128 + (ks & 3) * 32;
      const uint32_t ko = (ks >> 2) * kBN * 128 + (ks & 3) * 32;
      const uint64_t qh = otk::sw128_desc(qh_s + qo), ql = otk::sw128_desc(ql_s + qo);
      const uint64_t kh = otk::sw128_desc(kh_s + ko), kl = otk::sw128_desc(kl_s + ko);
      wgmma_ss<kBN>(sl, ql, kh);
      wgmma_ss<kBN>(sl, qh, kl);
      wgmma_ss<kBN>(s, qh, kh);
    }
    otk::wgmma_commit_wait();
    otk::fence_regs<kBN / 2>(s);
    otk::fence_regs<kBN / 2>(sl);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] += sl[i];

    // online softmax; this thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      float x = s[i] * scale;
      if (col >= N) x = -CUDART_INF_F;           // padding: no key
      else if (causal && col > row) x = -1e9f;   // the mask of the plain version
      s[i] = x;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m_run[h], mt[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];  // a per-thread partial sum; the quad adds up at the end
    }
    // P, split; the A fragment of key tile j is {s[4j], s[4j + 2], s[4j + 1], s[4j + 3]}
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * j + e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        const int a = (e >> 1) | ((e & 1) << 1);  // C fragment e -> A fragment a
        split_tf32(p, ph[j][a], pl[j][a]);
      }

    // this tile's P V (64 x D per warpgroup); pv[4i + e]: row g + 8 (e / 2), dim 8i + 2t + e % 2
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
    otk::fence_regs<D / 2>(pv);
    otk::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const uint32_t vo = (j >> 2) * D * 128 + (j & 3) * 32;
      const uint64_t vh = otk::sw128_desc(vh_s + vo), vl = otk::sw128_desc(vl_s + vo);
      wgmma_rs<D>(pv, pl[j], vh);
      wgmma_rs<D>(pv, ph[j], vl);
      wgmma_rs<D>(pv, ph[j], vh);
    }
    otk::wgmma_commit_wait();
    otk::fence_regs<D / 2>(pv);
    otk::fence_regs<4 * kNT>(&ph[0][0]);
    otk::fence_regs<4 * kNT>(&pl[0][0]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= N) continue;
    const float inv = 1.f / l_run[h];
    float* dst = out + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
  }
}

template <int D>
int launch_flash_tf32(const void* q, const void* k, const void* v, void* o, int BH, int N,
                      float scale, int causal, cudaStream_t stream) {
  using C = Tf32Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(mha_flash_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + C::kBM - 1) / C::kBM, BH);
  mha_flash_tf32_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), N, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int BH, int N, float scale,
                 int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_flash_tf32<D>(q, k, v, o, BH, N, scale, causal, stream);
  } else {
    const size_t smem =
        ((size_t)(kBM + 2 * kBN) * (D + 4) + (size_t)kBM * kLdP) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(mha_flash_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kBM - 1) / kBM, BH);
    mha_flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), N, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
             int H, int N, int D, float scale, int causal, cudaStream_t s) {
  if (N <= kMaxSmallN && D % 16 == 0 && D >= 16 && D <= 128) {
    namespace sg = otk::small_group;
    sg::Problem p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.out = o;
    p.sq = {st[0], st[1], st[2]};
    p.sk = {st[3], st[4], st[5]};
    p.sv = {st[6], st[7], st[8]};
    p.so = {st[9], st[10], st[11]};
    p.H = H;
    p.N = N;
    p.tasks = B * H;
    p.scale = scale;
    p.causal = causal;
    p.q_scale = p.k_scale = nullptr;
    switch (D) {
      case 16: return sg::launch<T, 16, kMaxSmallN, sg::Mode::Plain>(p, s);
      case 32: return sg::launch<T, 32, kMaxSmallN, sg::Mode::Plain>(p, s);
      case 48: return sg::launch<T, 48, kMaxSmallN, sg::Mode::Plain>(p, s);
      case 64: return sg::launch<T, 64, kMaxSmallN, sg::Mode::Plain>(p, s);
      case 80: return sg::launch<T, 80, kMaxSmallN, sg::Mode::Plain>(p, s);
      case 96: return sg::launch<T, 96, kMaxSmallN, sg::Mode::Plain>(p, s);
      case 112: return sg::launch<T, 112, kMaxSmallN, sg::Mode::Plain>(p, s);
      default: return sg::launch<T, 128, kMaxSmallN, sg::Mode::Plain>(p, s);
    }
  }
  // the flash branches read (B*H, N, D) tensors: refuse any other strides
  // (a dim of size 1 may carry any stride)
  const long long dense[3] = {(long long)H * N * D, (long long)N * D, D}, size[3] = {B, H, N};
  for (int t = 0; t < 12; ++t)
    if (size[t % 3] > 1 && st[t] != dense[t % 3]) return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  switch (D) {
    case 8: return launch_flash<T, 8>(q, k, v, o, BH, N, scale, causal, s);
    case 16: return launch_flash<T, 16>(q, k, v, o, BH, N, scale, causal, s);
    case 32: return launch_flash<T, 32>(q, k, v, o, BH, N, scale, causal, s);
    case 64: return launch_flash<T, 64>(q, k, v, o, BH, N, scale, causal, s);
    case 128: return launch_flash<T, 128>(q, k, v, o, BH, N, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: (b, h, n) in elements of q, k, v and out, read by the small
// branch; the flash branches take contiguous (B*H, N, D) tensors and refuse
// any other strides
extern "C" int mha_launch(const void* q, const void* k, const void* v, void* out,
                          const void* strides, int B, int H, int N, int D, float scale,
                          int causal, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > 2048) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = static_cast<const long long*>(strides);
  return is_bf16 ? dispatch<bf16>(q, k, v, out, st, B, H, N, D, scale, causal, s)
                 : dispatch<float>(q, k, v, out, st, B, H, N, D, scale, causal, s);
}
