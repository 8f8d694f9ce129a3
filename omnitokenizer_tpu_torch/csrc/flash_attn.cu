// Causal flash attention over (B, H, T, D), forward and backward:
//   o = softmax(q k^T * scale, key j <= query i) v,  lse = log sum_j exp(s_ij)
// bf16 in and out; both products accumulate in f32 and the online softmax
// runs in f32; lse (B, H, T) f32 is saved for the backward, which computes
//   di = sum_d o * do,  p = exp(s - lse),  dv = p^T do,  dp = do v^T,
//   ds = p * (dp - di),  dq = ds k * scale,  dk = ds^T q * scale.
//
// Replaces JAX's stock TPU kernel (jax/experimental/pallas/ops/tpu/
// flash_attention.py: _flash_attention_impl :758, _flash_attention_bwd_dkv
// :1121, _flash_attention_bwd_dq :1456), which omnitokenizer_tpu/models/
// gpt.py:103-131 runs in every layer of the LM's training forward. Its (l, m)
// pair is folded into lse; its di is a plain pass here as there.
//
// Bound: tensor-core operations. Counted causal, a forward is
// 4 * B * H * T(T+1)/2 * D flops (26 GFLOP a layer at the flagship LM's
// (8, 16, 1025, 96): 0.026 ms at 989 TFLOP/s bf16) and the backward 2.5x that
// (the score product recomputed, then dv, dp, dq, dk).
//
// Design, FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// 4 warps a block, 16 rows a warp, tiles staged in shared memory by cp.async
// (rows padded by 16 bytes, so ldmatrix reads them without bank conflicts),
// the next tile's copies in flight while the current one is computed:
//   forward: a block owns 64 queries of one (b, h); Q's fragments stay in
//     registers; it walks the key tiles of 64 from 0 up to the diagonal, so
//     tiles wholly above it are never read; S = Q K^T, the online softmax in
//     the accumulator fragment (row max and sum over the thread quad, exp2
//     with scale * log2(e) folded in), P rounded to bf16 is P V's A fragment
//     as it sits in registers; O is rescaled in registers and divided by the
//     row sum at the end. The blocks with the longest rows start first.
//   di: one warp a row.
//   dkv: a block owns 64 keys (16 a warp) and walks the query tiles from the
//     diagonal to T, as JAX's dkv kernel does: S^T = K Q^T, P^T from lse,
//     dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - di), dK += dS^T Q.
//   dq: a block owns 64 queries and walks the key tiles up to the diagonal:
//     S, P, dP = dO V^T, dS, dQ += dS K.
// Each output row has one owner, so there are no atomics and the result is
// deterministic. Rows past T are zero-filled by cp.async and never stored; the
// diagonal tile masks key j > query i (which covers the keys past T of every
// stored row), and the dkv kernel also drops queries past T. D is 16, 32, 64,
// 96 or 128 (the wrapper zero-pads other widths up to 128); the tensors are
// read and written through (b, h, t) strides with unit last stride, so the
// LM's (B, T, H, D) projections go in as they are.
#include "common.cuh"

namespace {

using otk::bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // queries a block (forward, dq); keys a block (dkv)
constexpr int kBN = 64;        // keys a tile (forward, dq)
constexpr int kPad = 8;        // elements of padding a shared-memory row

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(otk::smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(otk::smem_u32(p))
               : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addressing (lane = thread % 32). An m16n8k16 A fragment is four
// 8 x 8 matrices: rows 0-7 / 8-15 by columns 0-7 / 8-15, in the order
// (0-7, 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
// A 16 x 16 A fragment of a row-major tile (rows = M, columns = K).
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int ld, int row0, int col0,
                                              int lane) {
  return tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
// Two n8 B fragments (b0, b1 of n-tile 0, then of n-tile 1) of B = X^T for a
// row-major tile X whose rows are N and columns K (K in the score product,
// V in dP = dO V^T): plain ldmatrix.
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int ld, int n0, int k0,
                                               int lane) {
  const int m = lane >> 3;
  return tile + (n0 + (m >> 1) * 8 + (lane & 7)) * ld + k0 + (m & 1) * 8;
}
// Two n8 B fragments of B = X for a row-major tile X whose rows are K and
// columns N (V in P V, dO in dV, Q in dK, K in dQ): ldmatrix.trans.
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int ld, int k0, int n0,
                                              int lane) {
  const int m = lane >> 3;
  return tile + (k0 + (m & 1) * 8 + (lane & 7)) * ld + n0 + (m >> 1) * 8;
}

// rows [row0, row0 + ROWS) of a (T, D) slice with row stride `ld` into a
// shared tile of row stride D + kPad; rows past T are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int row0,
                                          int T) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c - r * kChunks;
    const bool ok = row0 + r < T;
    const bf16* g = ok ? src + (long long)(row0 + r) * ld + cc * 8 : src;
    otk::cp_async16(dst + r * (D + kPad) + cc * 8, g, ok ? 16 : 0);
  }
}

// S (16 x NT*8 per warp) = A rows (16 x D) times B^T, B a row-major tile of
// NT*8 rows; A's fragments are in registers (`a_frag`, D / 16 of them)
template <int D, int NT>
__device__ __forceinline__ void score_tile(float (&s)[NT][4], uint32_t (*a_frag)[4],
                                           const bf16* b_tile, int lane) {
  constexpr int ld = D + kPad;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, bt_addr(b_tile, ld, n2 * 16, kd * 16, lane));
      mma(s[2 * n2], a_frag[kd], b[0], b[1]);
      mma(s[2 * n2 + 1], a_frag[kd], b[2], b[3]);
    }
  }
}

// acc (16 x D per warp) += P (16 x NT*8, in accumulator fragments, rounded
// to bf16 here) times B, B a row-major tile of NT*8 rows and D columns
template <int D, int NT>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 8][4], float (&p)[NT][4],
                                        const bf16* b_tile, int lane) {
  constexpr int ld = D + kPad;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t b[4];
      ldsm_x4_t(b, b_addr(b_tile, ld, kk * 16, dd * 16, lane));
      mma(acc[2 * dd], a, b[0], b[1]);
      mma(acc[2 * dd + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* tile,
                                             int row0, int lane) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) ldsm_x4(f[kd], a_addr(tile, D + kPad, row0, kd * 16, lane));
}

// a warp's 16 x D f32 accumulator (times `mul`) as bf16 rows row0 + lane/4
// (+8) of a strided (T, D) slice; rows past T are dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int row0, int T,
                                           float (&acc)[D / 8][4], const float (&mul)[2],
                                           int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + (lane >> 2) + 8 * e;
    if (row >= T) continue;
    bf16* p = dst + (long long)row * ld + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * e] * mul[e], acc[n][2 * e + 1] * mul[e]);
  }
}

struct FwdParams {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;  // (B, H, T) contiguous
  Strides sq, sk, sv, so;
  int H, T;
  float scale_log2;  // scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdParams p) {
  constexpr int ld = D + kPad, NT = kBN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBM * ld;      // two stages
  bf16* sV = sK + 2 * kBN * ld;  // two stages
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* q = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* k = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* v = p.v + b * p.sv.b + h * p.sv.h;
  const int q0 = qt * kBM, T = p.T;

  load_tile<kBM, D>(sQ, q, p.sq.t, q0, T);
  load_tile<kBN, D>(sK, k, p.sk.t, 0, T);
  load_tile<kBN, D>(sV, v, p.sv.t, 0, T);
  otk::cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row_a, row_a + 8

  const int n_tiles = qt + 1;  // kBN == kBM: key tiles 0 .. qt reach the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile<kBN, D>(sK + (st ^ 1) * kBN * ld, k, p.sk.t, (kt + 1) * kBN, T);
      load_tile<kBN, D>(sV + (st ^ 1) * kBN * ld, v, p.sv.t, (kt + 1) * kBN, T);
      otk::cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (kt == 0) load_a_frags<D>(qf, sQ, warp * 16, lane);

    float s[NT][4];
    score_tile<D, NT>(s, qf, sK + st * kBN * ld, lane);
    if (kt == qt) {  // the diagonal tile: key j > query i scores -inf
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = kt * kBN + n * 8 + 2 * (lane & 3) + (r & 1);
          if (col > row_a + 8 * (r >> 1)) s[n][r] = -CUDART_INF_F;
        }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * e], s[n][2 * e + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[e], mx * p.scale_log2);  // finite: the diagonal key
      const float alpha = exp2f(m_run[e] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * e] = exp2f(s[n][2 * e] * p.scale_log2 - m_new);
        s[n][2 * e + 1] = exp2f(s[n][2 * e + 1] * p.scale_log2 - m_new);
        sum += s[n][2 * e] + s[n][2 * e + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[e] = l_run[e] * alpha + sum;
      m_run[e] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * e] *= alpha;
        acc[n][2 * e + 1] *= alpha;
      }
    }
    pv_tile<D, NT>(acc, s, sV + st * kBN * ld, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  bf16* o = p.o + b * p.so.b + h * p.so.h;
  store_rows<D>(o, p.so.t, q0 + warp * 16, T, acc, inv, lane);
  if ((lane & 3) == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * T;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row_a + 8 * e;
      if (row < T) lse[row] = (m_run[e] + log2f(l_run[e])) * (1.f / kLog2e);
    }
  }
}

struct BwdParams {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, T) contiguous
  float* di;         // (B, H, T) contiguous
  bf16 *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, T;
  float scale, scale_log2;
};

// di = sum_d o * do in f32, one warp a row
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_di_kernel(BwdParams p, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int t = row % p.T, bh = row / p.T, h = bh % p.H, b = bh / p.H;
  const bf16* o = p.o + b * p.so.b + h * p.so.h + t * p.so.t;
  const bf16* d = p.dout + b * p.sdo.b + h * p.sdo.h + t * p.sdo.t;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += __bfloat162float(o[c]) * __bfloat162float(d[c]);
  acc = otk::warp_sum(acc);
  if (lane == 0) p.di[row] = acc;
}

template <int D>
struct DkvTile {
  static constexpr int kBQ = D <= 96 ? 64 : 32;  // queries a tile: registers at D = 128
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int ld = D + kPad, BQ = DkvTile<D>::kBQ, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBM * ld;
  bf16* sQ = sV + kBM * ld;       // two stages
  bf16* sDO = sQ + 2 * BQ * ld;   // two stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * BQ * ld);  // lse * log2(e), two stages
  float* sD = sL + 2 * BQ;                                  // di, two stages
  const int kt = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = kt * kBM, T = p.T;
  const bf16* q = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* dout = p.dout + b * p.sdo.b + h * p.sdo.h;
  const float* lse = p.lse + ((long long)b * p.H + h) * T;
  const float* di = p.di + ((long long)b * p.H + h) * T;

  auto stage_q = [&](int qt, int st) {
    load_tile<BQ, D>(sQ + st * BQ * ld, q, p.sq.t, qt * BQ, T);
    load_tile<BQ, D>(sDO + st * BQ * ld, dout, p.sdo.t, qt * BQ, T);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int row = qt * BQ + i;
      sL[st * BQ + i] = row < T ? lse[row] * kLog2e : 0.f;
      sD[st * BQ + i] = row < T ? di[row] : 0.f;
    }
  };

  load_tile<kBM, D>(sK, p.k + b * p.sk.b + h * p.sk.h, p.sk.t, k0, T);
  load_tile<kBM, D>(sV, p.v + b * p.sv.b + h * p.sv.h, p.sv.t, k0, T);
  const int qt0 = k0 / BQ, n_qt = (T + BQ - 1) / BQ;  // query tiles from the diagonal
  stage_q(qt0, 0);
  otk::cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[n][r] = dv[n][r] = 0.f;
  const int key_a = k0 + warp * 16 + (lane >> 2);  // this thread's keys: key_a, key_a + 8

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {
      stage_q(qt + 1, st ^ 1);
      otk::cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const bf16* tq = sQ + st * BQ * ld;
    const bf16* tdo = sDO + st * BQ * ld;
    const float* tl = sL + st * BQ;
    const float* td = sD + st * BQ;

    // P^T = exp(S^T - lse): rows keys, columns queries
    float s[NT][4];
    {
      uint32_t kf[D / 16][4];
      load_a_frags<D>(kf, sK, warp * 16, lane);
      score_tile<D, NT>(s, kf, tq, lane);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = n * 8 + 2 * (lane & 3) + (r & 1), i = qt * BQ + c;
        const int j = key_a + 8 * (r >> 1);
        s[n][r] = (j <= i && i < T) ? exp2f(s[n][r] * p.scale_log2 - tl[c]) : 0.f;
      }
    pv_tile<D, NT>(dv, s, tdo, lane);  // dV += P^T dO

    float dp[NT][4];  // dP^T = V dO^T
    {
      uint32_t vf[D / 16][4];
      load_a_frags<D>(vf, sV, warp * 16, lane);
      score_tile<D, NT>(dp, vf, tdo, lane);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = n * 8 + 2 * (lane & 3) + (r & 1);
        dp[n][r] = s[n][r] * (dp[n][r] - td[c]);  // dS^T
      }
    pv_tile<D, NT>(dk, dp, tq, lane);  // dK += dS^T Q
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f}, scale[2] = {p.scale, p.scale};
  store_rows<D>(p.dk + b * p.sdk.b + h * p.sdk.h, p.sdk.t, k0 + warp * 16, T, dk, scale, lane);
  store_rows<D>(p.dv + b * p.sdv.b + h * p.sdv.h, p.sdv.t, k0 + warp * 16, T, dv, one, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int ld = D + kPad, NT = kBN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kBM * ld;
  bf16* sK = sDO + kBM * ld;     // two stages
  bf16* sV = sK + 2 * kBN * ld;  // two stages
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * kBM, T = p.T;
  const bf16* k = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* v = p.v + b * p.sv.b + h * p.sv.h;

  load_tile<kBM, D>(sQ, p.q + b * p.sq.b + h * p.sq.h, p.sq.t, q0, T);
  load_tile<kBM, D>(sDO, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.t, q0, T);
  load_tile<kBN, D>(sK, k, p.sk.t, 0, T);
  load_tile<kBN, D>(sV, v, p.sv.t, 0, T);
  otk::cp_async_commit();

  const int row_a = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dii[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row_a + 8 * e;
    const long long at = ((long long)b * p.H + h) * T + row;
    lse2[e] = row < T ? p.lse[at] * kLog2e : 0.f;
    dii[e] = row < T ? p.di[at] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_tiles = qt + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile<kBN, D>(sK + (st ^ 1) * kBN * ld, k, p.sk.t, (kt + 1) * kBN, T);
      load_tile<kBN, D>(sV + (st ^ 1) * kBN * ld, v, p.sv.t, (kt + 1) * kBN, T);
      otk::cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const bf16* tk = sK + st * kBN * ld;
    const bf16* tv = sV + st * kBN * ld;

    float s[NT][4];
    {
      uint32_t qf[D / 16][4];
      load_a_frags<D>(qf, sQ, warp * 16, lane);
      score_tile<D, NT>(s, qf, tk, lane);
    }
    float dp[NT][4];  // dP = dO V^T
    {
      uint32_t df[D / 16][4];
      load_a_frags<D>(df, sDO, warp * 16, lane);
      score_tile<D, NT>(dp, df, tv, lane);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = r >> 1, j = kt * kBN + n * 8 + 2 * (lane & 3) + (r & 1);
        const float pr = j <= row_a + 8 * e ? exp2f(s[n][r] * p.scale_log2 - lse2[e]) : 0.f;
        dp[n][r] = pr * (dp[n][r] - dii[e]);  // dS
      }
    pv_tile<D, NT>(dq, dp, tk, lane);  // dQ += dS K
    __syncthreads();
  }
  const float scale[2] = {p.scale, p.scale};
  store_rows<D>(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.t, q0 + warp * 16, T, dq, scale, lane);
}

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(kBM + 4 * kBN) * (D + kPad) * sizeof(bf16);
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr int BQ = DkvTile<D>::kBQ;
  return (size_t)(2 * kBM + 4 * BQ) * (D + kPad) * sizeof(bf16) + 4 * BQ * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * kBM + 4 * kBN) * (D + kPad) * sizeof(bf16);
}

Strides strides_at(const long long* st, int i) { return {st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_fwd(const FwdParams& p, int B, cudaStream_t s) {
  cudaError_t err = set_smem(flash_fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + kBM - 1) / kBM, p.H, B);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const BwdParams& p, int B, cudaStream_t s) {
  const int rows = B * p.H * p.T;
  flash_bwd_di_kernel<D><<<(rows + 3) / 4, kThreads, 0, s>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = set_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>())) != cudaSuccess ||
      (err = set_smem(flash_bwd_dq_kernel<D>, dq_smem<D>())) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid((p.T + kBM - 1) / kBM, p.H, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int H, int T) {
  return B >= 1 && H >= 1 && T >= 1 && B <= 65535 && H <= 65535;
}

}  // namespace

// strides: (b, h, t) in elements of q, k, v and o (unit last stride, rows
// 16-byte aligned); lse (B, H, T) f32 contiguous
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                     void* lse, const void* strides, int B, int H, int T, int D,
                                     float scale, void* stream) {
  if (!shape_ok(B, H, T)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = static_cast<const long long*>(strides);
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.sq = strides_at(st, 0);
  p.sk = strides_at(st, 1);
  p.sv = strides_at(st, 2);
  p.so = strides_at(st, 3);
  p.H = H;
  p.T = T;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(p, B, s);
    case 32: return launch_fwd<32>(p, B, s);
    case 64: return launch_fwd<64>(p, B, s);
    case 96: return launch_fwd<96>(p, B, s);
    case 128: return launch_fwd<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: (b, h, t) of q, k, v, o, do, dq, dk, dv; lse and di (the scratch
// the wrapper allocates) (B, H, T) f32 contiguous
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* di, void* dq,
                                     void* dk, void* dv, const void* strides, int B, int H, int T,
                                     int D, float scale, void* stream) {
  if (!shape_ok(B, H, T)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = static_cast<const long long*>(strides);
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<float*>(di);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.sq = strides_at(st, 0);
  p.sk = strides_at(st, 1);
  p.sv = strides_at(st, 2);
  p.so = strides_at(st, 3);
  p.sdo = strides_at(st, 4);
  p.sdq = strides_at(st, 5);
  p.sdk = strides_at(st, 6);
  p.sdv = strides_at(st, 7);
  p.H = H;
  p.T = T;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bwd<16>(p, B, s);
    case 32: return launch_bwd<32>(p, B, s);
    case 64: return launch_bwd<64>(p, B, s);
    case 96: return launch_bwd<96>(p, B, s);
    case 128: return launch_bwd<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
