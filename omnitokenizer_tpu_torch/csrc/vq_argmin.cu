// Nearest-code search: out[m] = argmin_k (||e_k||^2 - 2 x_m . e_k), f32,
// ties to the lowest index (as torch/jnp argmin).
//
// Replaces omnitokenizer_tpu/ops/pallas/vq_kernel.py:vq_argmin_pallas.
// Bound: operations. 2*M*K*D flops (2.7 GFLOP at the flagship's 20480 x
// 8192 x 8: 0.040 ms at 67 TFLOP/s f32; 17.2 GFLOP at the CNN VQGAN's 16384
// x 2048 x 256: 0.256 ms) against a few MB read once. Pure f32 FMA, never
// TF32 and no tensor cores: the JAX distance matmul pins Precision.HIGHEST.
// Every path runs one chain a (row, code) pair, the spec of the distances:
// d = ||e_k||^2 + sum_j (-2 x_j) e_kj, fmaf over j ascending, with
// ||e_k||^2 itself fmaf over j ascending from 0. The -2 is folded into x
// (exact). The code slices of a grid merge by a 64-bit atomicMin on (order-
// preserving bits of the distance) << 32 | index, a lexicographic minimum
// that is deterministic in any order, into a buffer filled with all-ones; a
// last small kernel writes the indices. The grid is (row tiles) x (code
// slices), sized from the SM count and the occupancy so that one wave fills
// the card; one slice writes the indices directly.
//
// Code dims <= 32 (the tokenizer's 8). The floor that binds is instruction
// issue: a pair needs at least D FFMA and one min, ~1.5 G lane-instructions
// at the flagship, ~0.045 ms over 132 SMs x 128 lanes at ~1.98 GHz.
//   * Rows in registers, codes broadcast from shared memory: a thread holds
//     R = 64 / D rows (8 at D = 8, 128 registers; 4 blocks of 128 threads an
//     SM), so one 16-byte load of a code feeds R pairs; a block stages its
//     slice of the codebook once and sums its norms as it stages them.
//   * Chunk minimum, then a rescan: over each chunk of 4 codes a row keeps
//     only fminf of the distances, compared with its running best by strict
//     `<` once a chunk. At the end the winning chunk is recomputed with the
//     identical instruction sequence, and the first code whose distance
//     equals the best is taken: the distances are bit-identical, so ties go
//     to the lowest index. Against a strict `<` a pair with no rescan
//     (kernel_ab.py on the H100, PERF.md PR 6) it is 1% slower at the
//     flagship's 20480 rows and 4.6% faster at 36864.
//   * Instances at D in {4, 8, 16, 32}; another D <= 32 is zero-padded to
//     the next one in registers and shared memory (a zero term changes
//     neither a dot product nor ||e||^2).
//
// Code dims > 32 (the CNN VQGAN's 256): a tiled distance GEMM whose
// epilogue keeps each row's (distance, index) minimum; the distance matrix
// never leaves registers.
//   * A small pre-pass sums ||e_k||^2 once a code into a K-float scratch.
//   * A block takes 128 rows against its slice's codes, 256 at a time; 256
//     threads, each with an 8 x 16 tile of chains in registers. Steps of 16
//     dims: each thread loads its share of the next step's rows and codes
//     into registers (16-byte loads, or 4-byte ones where D % 4 or an
//     input's alignment forbids them) while the current step computes, then
//     stores them dim-major, -2 x folded in, into the other of two shared
//     buffers. Every dim a thread reads two float4 of rows and four of
//     codes for 128 FFMA; a warp's read is 4 or 8 distinct 16-byte words.
//   * Zero fill past M, past the slice's codes (whose chains start at +inf:
//     they never win) and past D (a zero term changes nothing), so any M,
//     K and D run.
//   * After a tile's last step each thread compares its 128 distances with
//     its rows' running bests, codes ascending, by strict `<`; the 16
//     threads of a row then merge by the minimum of (order-preserving
//     distance bits, index), -0 as +0: 8 lanes by shuffles, two warps in
//     shared memory. No chunk minimum or rescan: a compare a pair is < 1%
//     of the D FFMA it costs at these widths.
//   * At the CNN VQGAN's shape on the H100 (kernel_ab.py; PERF.md §6):
//     a ring of cp.async copies of the row-major tiles, read as a float4 a
//     row and a code every 4 dims (16 LDS.128 for 256 FFMA), 0.55 ms; this
//     layout at 8 x 8 a thread 0.49, at 8 x 16 0.45.
#include <mutex>
#include <vector>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 4;               // codes a chunk, the rescan's length
constexpr int kRowFloats = 64;          // R * D: the x values a thread holds
constexpr int kSliceBytes = 32 * 1024;  // a block's staged codes and norms

// unsigned order of the result = float order of d, then index order; -0 is
// +0, so that a zero-distance tie across slices goes to the lower index
__device__ __forceinline__ unsigned long long pack(float d, int k) {
  unsigned u = __float_as_uint(d);
  u = u == 0x80000000u ? 0u : u;
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)k;
}

// stage codes [k0, k0 + n) of e (K x Dr) into n_pad rows of DP floats,
// zero-padded, and their squared norms (j ascending), +inf past n (a
// padding code never wins)
template <int DP>
__device__ __forceinline__ void stage(const float* __restrict__ e, float* se, float* sq, int k0,
                                      int n, int n_pad, int Dr) {
  for (int i = threadIdx.x; i < n_pad * DP; i += kThreads) {
    const int k = i / DP, j = i - k * DP;
    se[i] = k < n && j < Dr ? e[(size_t)(k0 + k) * Dr + j] : 0.f;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_pad; k += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) s = fmaf(se[k * DP + j], se[k * DP + j], s);
    sq[k] = k < n ? s : CUDART_INF_F;
  }
  __syncthreads();
}

__device__ __forceinline__ void emit(unsigned long long* part, int* out, int row, float best,
                                     int k) {
  if (part)
    atomicMin(part + row, pack(best, k));
  else
    out[row] = k;
}

// distances of code ek (D floats, 16-byte aligned) to the R rows of xs
template <int D, int R>
__device__ __forceinline__ void dists(const float (&xs)[R][D], const float* ek, float sq,
                                      float (&d)[R]) {
  float ev[D];
#pragma unroll
  for (int j = 0; j < D; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(ek + j);
    ev[j] = v.x, ev[j + 1] = v.y, ev[j + 2] = v.z, ev[j + 3] = v.w;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) d[r] = sq;
#pragma unroll
  for (int j = 0; j < D; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) d[r] = fmaf(xs[r][j], ev[j], d[r]);
}

// one row's distance to code ek: the instruction sequence of that row in
// dists, so the two give bit-identical results
template <int D>
__device__ __forceinline__ float dist1(const float (&xr)[D], const float* ek, float sq) {
  float ev[D];
#pragma unroll
  for (int j = 0; j < D; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(ek + j);
    ev[j] = v.x, ev[j + 1] = v.y, ev[j + 2] = v.z, ev[j + 3] = v.w;
  }
  float d = sq;
#pragma unroll
  for (int j = 0; j < D; ++j) d = fmaf(xr[j], ev[j], d);
  return d;
}

// Block (x, y): rows [x * kThreads * R, ...) against codes [y * ks, y * ks +
// ks). Thread t holds rows base + r * kThreads + t. part null: one slice,
// the index goes straight to out.
template <int D>
__global__ void __launch_bounds__(kThreads, 4)
vq_kernel(const float* __restrict__ x, const float* __restrict__ e,
          unsigned long long* __restrict__ part, int* __restrict__ out, int M, int K, int Dr,
          int ks) {
  constexpr int R = kRowFloats / D;
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.y * ks, n = min(ks, K - k0);
  const int n_pad = (n + kChunk - 1) / kChunk * kChunk;
  float* se = smem;
  float* sq = smem + n_pad * D;
  const int base = blockIdx.x * kThreads * R + threadIdx.x;

  float xs[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = base + r * kThreads;
#pragma unroll
    for (int j = 0; j < D; ++j)
      xs[r][j] = row < M && j < Dr ? -2.f * x[(size_t)row * Dr + j] : 0.f;
  }
  stage<D>(e, se, sq, k0, n, n_pad, Dr);

  float best[R];
  int chunk[R];
#pragma unroll
  for (int r = 0; r < R; ++r) best[r] = CUDART_INF_F, chunk[r] = 0;
  for (int c = 0; c < n_pad; c += kChunk) {
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int k = c + i;
      float d[R];
      dists<D, R>(xs, se + k * D, sq[k], d);
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = fminf(m[r], d[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (m[r] < best[r]) best[r] = m[r], chunk[r] = c;
  }

  // the rescan: the winning chunk's distances again, the first equal one
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int idx = chunk[r];
    for (int k = chunk[r] + kChunk - 1; k >= chunk[r]; --k) {
      idx = dist1<D>(xs[r], se + k * D, sq[k]) == best[r] ? k : idx;
    }
    const int row = base + r * kThreads;
    if (row < M) emit(part, out, row, best[r], k0 + min(idx, n - 1));
  }
}

// ---- D > 32: a tiled f32 distance GEMM, the argmin in its epilogue ----
constexpr int kTileRows = 128;                // rows a block, 8 a thread
constexpr int kCodeGroups = 4;                // groups of 4 codes a thread, 64 codes apart
constexpr int kTileCodes = 64 * kCodeGroups;  // codes a tile
constexpr int kThreadCodes = 4 * kCodeGroups;
constexpr int kTileThreads = 256;             // 16 x 16 threads
constexpr int kBK = 16;                       // code dims a step
constexpr int kLdRows = kTileRows + 4;        // floats a staged dim of the rows
constexpr int kLdCodes = kTileCodes + 4;      // and of the codes
// a buffer: kBK dims of the rows and of the tile's codes, and the tile's norms
constexpr int kBufFloats = kBK * (kLdRows + kLdCodes) + kTileCodes;
constexpr int kTiledSmem = 2 * kBufFloats * (int)sizeof(float);

// ||e_k||^2 once a code, fmaf over j ascending (the staged kernel's sum)
__global__ void code_norms_kernel(const float* __restrict__ e, float* __restrict__ sq, int K,
                                  int D) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float* ek = e + (size_t)k * D;
  float s = 0.f;
#pragma unroll 8
  for (int j = 0; j < D; ++j) {
    const float v = __ldg(ek + j);
    s = fmaf(v, v, s);
  }
  sq[k] = s;
}

// 4 floats of row p from dim j, zero past D: one 16-byte load (VEC 4: D %
// 4 == 0 and 16-byte rows) or four 4-byte ones
template <int VEC>
__device__ __forceinline__ float4 load4(const float* p, int j, int D, bool ok) {
  if constexpr (VEC == 4) {
    return ok && j < D ? __ldg(reinterpret_cast<const float4*>(p + j))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = ok && j + u < D ? __ldg(p + j + u) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Block (x, y): rows [x * 128, +128) against the codes of slice y, [y * ks,
// y * ks + ks), kTileCodes at a time, in steps of kBK dims. A step's rows
// and codes are loaded into registers (zero past M, the slice's end and
// D), -2 x folded in, and stored to shared memory dim-major, one buffer
// while the other is read. Thread (ty, tx) runs the chains of rows ty * 4 +
// i and 64 + ty * 4 + i (i < 4) and codes 64 q + tx * 4 + j (j < 4, q <
// kCodeGroups): every dim it reads two float4 of rows and kCodeGroups of
// codes. A warp is 4 ty x 8 tx, so a read is 4 or 8 distinct 16-byte words
// in distinct banks.
template <int VEC>
__global__ void __launch_bounds__(kTileThreads)
vq_kernel_tiled(const float* __restrict__ x, const float* __restrict__ e,
                const float* __restrict__ sq, unsigned long long* __restrict__ part,
                int* __restrict__ out, int M, int K, int D, int ks) {
  constexpr int kQuads = kBK / 4;                                  // float4 a row a step
  constexpr int kRowLoads = kTileRows * kQuads / kTileThreads;     // a thread's a step
  constexpr int kCodeLoads = kTileCodes * kQuads / kTileThreads;
  static_assert(kTileCodes <= kTileThreads, "one norm a thread at most");
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long red[2][kTileRows];
  const int row0 = blockIdx.x * kTileRows;
  const int k0 = blockIdx.y * ks, kend = min(k0 + ks, K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const int dsteps = (D + kBK - 1) / kBK;
  const int tiles = (kend - k0 + kTileCodes - 1) / kTileCodes;
  const int steps = tiles * dsteps;

  float4 rx[kRowLoads], re[kCodeLoads];
  float rn = CUDART_INF_F;  // a tile's norm, +inf past the slice (never the best)
  auto fetch = [&](int s) {
    const int t = s / dsteps, j0 = (s - t * dsteps) * kBK, c0 = k0 + t * kTileCodes;
#pragma unroll
    for (int l = 0; l < kRowLoads; ++l) {
      const int i = l * kTileThreads + threadIdx.x, r = i / kQuads;
      rx[l] = load4<VEC>(x + (size_t)min(row0 + r, M - 1) * D, j0 + (i - r * kQuads) * 4, D,
                         row0 + r < M);
    }
#pragma unroll
    for (int l = 0; l < kCodeLoads; ++l) {
      const int i = l * kTileThreads + threadIdx.x, r = i / kQuads;
      re[l] = load4<VEC>(e + (size_t)min(c0 + r, kend - 1) * D, j0 + (i - r * kQuads) * 4, D,
                         c0 + r < kend);
    }
    if (j0 == 0 && threadIdx.x < kTileCodes)
      rn = c0 + (int)threadIdx.x < kend ? __ldg(sq + c0 + threadIdx.x) : CUDART_INF_F;
  };
  auto store = [&](int s) {
    float* sa = smem + (s & 1) * kBufFloats;
    float* sb = sa + kBK * kLdRows;
#pragma unroll
    for (int l = 0; l < kRowLoads; ++l) {
      const int i = l * kTileThreads + threadIdx.x, r = i / kQuads, j = (i - r * kQuads) * 4;
      sa[j * kLdRows + r] = -2.f * rx[l].x, sa[(j + 1) * kLdRows + r] = -2.f * rx[l].y;
      sa[(j + 2) * kLdRows + r] = -2.f * rx[l].z, sa[(j + 3) * kLdRows + r] = -2.f * rx[l].w;
    }
#pragma unroll
    for (int l = 0; l < kCodeLoads; ++l) {
      const int i = l * kTileThreads + threadIdx.x, r = i / kQuads, j = (i - r * kQuads) * 4;
      sb[j * kLdCodes + r] = re[l].x, sb[(j + 1) * kLdCodes + r] = re[l].y;
      sb[(j + 2) * kLdCodes + r] = re[l].z, sb[(j + 3) * kLdCodes + r] = re[l].w;
    }
    if (s % dsteps == 0 && threadIdx.x < kTileCodes) sb[kBK * kLdCodes + threadIdx.x] = rn;
  };

  float acc[8][kThreadCodes], best[8];
  int bidx[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) best[r] = CUDART_INF_F, bidx[r] = k0;
  fetch(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int t = s / dsteps;
    const float* sa = smem + (s & 1) * kBufFloats;
    const float* sb = sa + kBK * kLdRows;
    if (s == t * dsteps) {  // a tile's first step: the chains start at ||e_k||^2
#pragma unroll
      for (int q = 0; q < kCodeGroups; ++q) {
        const float4 n = *reinterpret_cast<const float4*>(sb + kBK * kLdCodes + 64 * q + tx * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][4 * q] = n.x, acc[r][4 * q + 1] = n.y;
          acc[r][4 * q + 2] = n.z, acc[r][4 * q + 3] = n.w;
        }
      }
    }
    if (s + 1 < steps) fetch(s + 1);  // in flight while this step computes
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + j * kLdRows + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + j * kLdRows + 64 + ty * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[kThreadCodes];
#pragma unroll
      for (int q = 0; q < kCodeGroups; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(sb + j * kLdCodes + 64 * q + tx * 4);
        b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z, b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < kThreadCodes; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    if (s == (t + 1) * dsteps - 1) {  // the tile's epilogue: codes ascending, strict <
      const int cb = k0 + t * kTileCodes + tx * 4;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < kThreadCodes; ++c)
          if (acc[r][c] < best[r]) best[r] = acc[r][c], bidx[r] = cb + 64 * (c >> 2) + (c & 3);
    }
    if (s + 1 < steps) store(s + 1);  // the other buffer, read last at step s - 1
    __syncthreads();
  }

  // the 16 threads of a row: 8 lanes of a warp by shuffles, then its two warps
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    unsigned long long key = pack(best[r], bidx[r]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
      key = other < key ? other : key;
    }
    if ((lane & 7) == 0) red[warp & 1][(r < 4 ? 0 : 64 - 4) + ty * 4 + r] = key;
  }
  __syncthreads();
  const int i = threadIdx.x, row = row0 + i;
  if (i < kTileRows && row < M) {
    const unsigned long long key = red[0][i] < red[1][i] ? red[0][i] : red[1][i];
    if (part)
      atomicMin(part + row, key);
    else
      out[row] = static_cast<int>(key & 0xffffffffull);
  }
}

__global__ void finish_kernel(const unsigned long long* __restrict__ part, int* __restrict__ out,
                              int M) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row < M) out[row] = static_cast<int>(part[row] & 0xffffffffull);
}

// resident blocks an SM at this shared-memory size, kept per device, kernel
// and size (the occupancy query costs host time on every call otherwise)
int blocks_per_sm(const void* kernel, int threads, int smem, int* sms) {
  struct Entry {
    int dev;
    const void* kernel;
    int smem, sms, per_sm;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache)
    if (c.dev == dev && c.kernel == kernel && c.smem == smem) {
      *sms = c.sms;
      return c.per_sm;
    }
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  cache.push_back({dev, kernel, smem, *sms, per_sm});
  return per_sm;
}

// code slices of the grid (row tiles) x (slices): as many as one wave of
// `wave` resident blocks holds beside the row tiles, at least what a slice's
// limit of ks_max codes forces, at most one a granule; *ks: codes a slice, a
// multiple of the granule
int plan_slices(int wave, int row_tiles, int K, int granule, int ks_max, int* ks) {
  const int granules = (K + granule - 1) / granule;
  int slices = wave / row_tiles;
  slices = slices < 1 ? 1 : slices > granules ? granules : slices;
  const int forced = (K + ks_max - 1) / ks_max;
  if (slices < forced) slices = forced;
  *ks = ((K + slices - 1) / slices + granule - 1) / granule * granule;
  return (K + *ks - 1) / *ks;
}

// one slice: the kernel writes the indices; more: they merge into part,
// filled with all-ones first, and a last small kernel writes the indices
template <typename Launch>
int run_slices(int slices, unsigned long long* part, int* out, int M, cudaStream_t stream,
               Launch launch_grid) {
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (slices > 1 &&
      (err = cudaMemsetAsync(part, 0xff, (size_t)M * sizeof(unsigned long long), stream)) !=
          cudaSuccess)
    return static_cast<int>(err);
  launch_grid(slices > 1 ? part : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess || slices == 1) return static_cast<int>(err);
  finish_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, out, M);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_staged(const float* x, const float* e, unsigned long long* part, int* out, int M,
                  int K, int Dr, cudaStream_t stream) {
  // a staged code takes its floats and its norm; a slice at most what
  // kSliceBytes holds
  const int code_bytes = (D + 1) * (int)sizeof(float);
  const int ks_max = kSliceBytes / code_bytes / kChunk * kChunk;
  int sms = 0, ks = 0;
  const int per_sm = blocks_per_sm(reinterpret_cast<const void*>(vq_kernel<D>), kThreads,
                                   ks_max * code_bytes, &sms);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rows = kThreads * kRowFloats / D;
  const int row_tiles = (M + rows - 1) / rows;
  const int slices = plan_slices(sms * per_sm, row_tiles, K, kChunk, ks_max, &ks);
  return run_slices(slices, part, out, M, stream, [&](unsigned long long* p) {
    vq_kernel<D><<<dim3(row_tiles, slices), kThreads, ks * code_bytes, stream>>>(x, e, p, out, M,
                                                                                 K, Dr, ks);
  });
}

template <int VEC>
int launch_tiled(const float* x, const float* e, float* sq, unsigned long long* part, int* out,
                 int M, int K, int D, cudaStream_t stream) {
  int sms = 0, ks = 0;
  const int per_sm = blocks_per_sm(reinterpret_cast<const void*>(vq_kernel_tiled<VEC>),
                                   kTileThreads, kTiledSmem, &sms);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int row_tiles = (M + kTileRows - 1) / kTileRows;
  const int slices = plan_slices(sms * per_sm, row_tiles, K, kTileCodes, K, &ks);
  code_norms_kernel<<<(K + 63) / 64, 64, 0, stream>>>(e, sq, K, D);
  return run_slices(slices, part, out, M, stream, [&](unsigned long long* p) {
    vq_kernel_tiled<VEC><<<dim3(row_tiles, slices), kTileThreads, kTiledSmem, stream>>>(
        x, e, sq, p, out, M, K, D, ks);
  });
}

}  // namespace

// x (M, D) rows and e (K, D) codes, f32; part (M,) 64-bit scratch and, for
// D > 32, sq (K,) f32 scratch the wrapper allocates; out (M,) int32
extern "C" int vq_argmin_launch(const void* x, const void* e, void* part, void* sq, void* out,
                                int M, int K, int D, void* stream) {
  if (M < 1 || K < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xp = static_cast<const float*>(x), *ep = static_cast<const float*>(e);
  auto* pp = static_cast<unsigned long long*>(part);
  int* op = static_cast<int*>(out);
  if (D <= 4) return launch_staged<4>(xp, ep, pp, op, M, K, D, s);
  if (D <= 8) return launch_staged<8>(xp, ep, pp, op, M, K, D, s);
  if (D <= 16) return launch_staged<16>(xp, ep, pp, op, M, K, D, s);
  if (D <= 32) return launch_staged<32>(xp, ep, pp, op, M, K, D, s);
  if (!sq) return static_cast<int>(cudaErrorInvalidValue);
  float* qp = static_cast<float*>(sq);
  // 16-byte loads where every row starts on 16 bytes, else 4-byte ones
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e) % 16 == 0;
  return vec ? launch_tiled<4>(xp, ep, qp, pp, op, M, K, D, s)
             : launch_tiled<1>(xp, ep, qp, pp, op, M, K, D, s);
}
