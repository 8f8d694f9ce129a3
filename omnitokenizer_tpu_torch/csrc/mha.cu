// Plain multi-head attention per (batch, head) over (B*H, N, D) rows:
//   o = softmax(q k^T * scale [col > row masked to -1e9]) v
// scores, softmax and both products in f32 on float or bf16 inputs; the
// output is in the input type. q, k, v and o are contiguous (B*H, N, D).
//
// Replaces omnitokenizer_tpu/ops/pallas/mha.py:mha_pallas. Two regimes reach
// it, and each gets a branch:
//
// * Flash branch (any N in [8, 2048], D in {8, 16, 32, 64, 128}). Bound: f32
//   arithmetic, 4*BH*N^2*D flops (43 GFLOP for the f32 VAE's spatial blocks,
//   BH=160, N=1024, D=64; 0.64 ms at the card's 67 TFLOP/s f32 rate); the
//   bytes (168 MB) take a twelfth of that. Design: FlashAttention's online
//   softmax. A block owns (bh, 64 queries) with 256 threads in a 16 x 16
//   grid; a thread holds 4 query rows x 4 key columns of the score tile and
//   4 rows x D/16 dims of the output in registers. K and V stream through
//   shared memory in 64-key tiles, converted to f32 as they load; the running
//   row max and sum stay in registers (row reductions are 16-lane shuffles);
//   P goes through shared memory to the P v product. Pure f32 FMA, no TF32:
//   the f32 VAE is the parity path. The N x N scores never reach device
//   memory, which is what the TPU kernel kept in VMEM.
//   For bf16, P is rounded to bf16 before it multiplies v, as in the plain
//   version, but unnormalized: the division by the row sum comes at the end.
//   That moves the rounding point, a bf16-level difference.
//   Key tiles entirely above the causal diagonal are skipped; inside a tile
//   masked scores are set to -1e9 as in the plain version.
//
// * Small branch (N <= 16, D in {32, 64}): the stage-1 tokenizer's causal
//   temporal blocks, BH = 32768 problems of 9 x 9 in bf16. Bound: bytes, q,
//   k, v read once and o written once (151 MB, 45 us); the flash tile would
//   leave most of a 64-row block idle. Design: one warp per (bh), as
//   small_attn.cu: each lane holds D/32 dims of every q, k, v row in
//   registers, the dot products are warp reductions and the softmax runs in
//   registers. P is normalized before its bf16 rounding, exactly as the plain
//   version. Masked pairs are skipped: with the -1e9 fill their
//   probabilities are exactly 0 in f32, and every row keeps its diagonal.
#include "common.cuh"

namespace {

using otk::bf16;

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// x rounded to T and back (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// 8 consecutive elements (16-byte aligned for bf16, 32-byte for float) as f32
__device__ __forceinline__ void load8(const float* src, float* x) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* src, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// ------------------------------------------------------------ flash branch
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
      load8(src + (size_t)r * D + c, x);
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

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int BH, int N, float scale,
                 int causal, cudaStream_t stream) {
  const size_t smem = ((size_t)(kBM + 2 * kBN) * (D + 4) + (size_t)kBM * kLdP) * sizeof(float);
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

// ------------------------------------------------------------ small branch
constexpr int kMaxSmallN = 16;
constexpr int kSmallWarps = 8;

template <typename T, int DPL>  // dims per lane: D / 32
__global__ void __launch_bounds__(kSmallWarps * 32)
mha_small_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int BH, int N, float scale, int causal) {
  constexpr int D = DPL * 32;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kSmallWarps + (threadIdx.x >> 5);
  if (bh >= BH) return;
  const size_t base = (size_t)bh * N * D + lane * DPL;

  float qv[kMaxSmallN][DPL], kk[kMaxSmallN][DPL], vv[kMaxSmallN][DPL];
#pragma unroll
  for (int t = 0; t < kMaxSmallN; ++t) {
    if (t < N) {
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        qv[t][d] = to_f32(q[base + (size_t)t * D + d]);
        kk[t][d] = to_f32(k[base + (size_t)t * D + d]);
        vv[t][d] = to_f32(v[base + (size_t)t * D + d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxSmallN; ++i) {
    if (i < N) {
      float s[kMaxSmallN];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kMaxSmallN; ++j) {
        s[j] = 0.f;
        if (j < N && !(causal && j > i)) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) dot = fmaf(qv[i][d], kk[j][d], dot);
          s[j] = otk::warp_sum(dot) * scale;
          m = fmaxf(m, s[j]);
        }
      }
      float denom = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSmallN; ++j) {
        if (j < N && !(causal && j > i)) {
          s[j] = expf(s[j] - m);
          denom += s[j];
        }
      }
      float o[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) o[d] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSmallN; ++j) {
        if (j < N && !(causal && j > i)) {
          const float p = round_to<T>(s[j] / denom);
#pragma unroll
          for (int d = 0; d < DPL; ++d) o[d] = fmaf(p, vv[j][d], o[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < DPL; ++d) out[base + (size_t)i * D + d] = from_f32<T>(o[d]);
    }
  }
}

template <typename T, int DPL>
int launch_small(const void* q, const void* k, const void* v, void* o, int BH, int N, float scale,
                 int causal, cudaStream_t stream) {
  const dim3 grid((BH + kSmallWarps - 1) / kSmallWarps);
  mha_small_kernel<T, DPL><<<grid, kSmallWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), BH, N, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int N, int D,
             float scale, int causal, cudaStream_t s) {
  if (N <= kMaxSmallN) {
    if (D == 32) return launch_small<T, 1>(q, k, v, o, BH, N, scale, causal, s);
    if (D == 64) return launch_small<T, 2>(q, k, v, o, BH, N, scale, causal, s);
  }
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

extern "C" int mha_launch(const void* q, const void* k, const void* v, void* out, int BH, int N,
                          int D, float scale, int causal, int is_bf16, void* stream) {
  if (BH < 1 || N < 1 || N > 2048) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(q, k, v, out, BH, N, D, scale, causal, s)
                 : dispatch<float>(q, k, v, out, BH, N, D, scale, causal, s);
}
