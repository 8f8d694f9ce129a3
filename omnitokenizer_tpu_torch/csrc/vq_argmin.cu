// Nearest-code search: out[m] = argmin_k (||e_k||^2 - 2 x_m . e_k), f32,
// ties to the lowest index (as torch/jnp argmin).
//
// Replaces omnitokenizer_tpu/ops/pallas/vq_kernel.py:vq_argmin_pallas.
// Bound: operations. 2*M*K*D flops (2.7 GFLOP at the flagship's 20480 x
// 8192 x 8: 0.040 ms at 67 TFLOP/s f32) against a few MB read once. The
// floor that binds is instruction issue: a (row, code) pair needs at least D
// FFMA and one min, ~1.5 G lane-instructions at the flagship, ~0.045 ms over
// 132 SMs x 128 lanes at ~1.98 GHz. Pure f32 FMA, never TF32: the JAX
// distance matmul pins Precision.HIGHEST.
// Design, so that a pair costs little more than those D + 1 instructions:
//   * The -2 is folded into x (exact) and the chain starts at ||e_k||^2:
//     d = ||e_k||^2 + sum_j (-2 x_j) e_kj, D FFMA a pair. A block sums its
//     slice's norms as it stages the codes, so no launch or cache makes them.
//   * Rows in registers, codes broadcast from shared memory: a thread holds
//     R = 64 / D rows (8 at D = 8, 128 registers; 4 blocks of 128 threads an
//     SM), so one 16-byte load of a code feeds R pairs; a block stages its
//     slice of the codebook once.
//   * Chunk minimum, then a rescan: over each chunk of 4 codes a row keeps
//     only fminf of the distances, compared with its running best by strict
//     `<` once a chunk. At the end the winning chunk is recomputed with the
//     identical instruction sequence, and the first code whose distance
//     equals the best is taken: the distances are bit-identical, so ties go
//     to the lowest index. Against a strict `<` a pair with no rescan
//     (kernel_ab.py on the H100, PERF.md PR 6) it is 1% slower at the
//     flagship's 20480 rows and 4.6% faster at 36864.
//   * The codes split across blocks: the grid is (row tiles) x (code slices),
//     sized from the SM count and the occupancy so that one wave fills the
//     card. The slices merge by a 64-bit atomicMin on (order-preserving bits
//     of the distance) << 32 | index, a lexicographic minimum that is
//     deterministic in any order, into a buffer filled with all-ones; a last
//     small kernel writes the indices.
//   * Any code dim: instances at D in {4, 8, 16, 32}; another D <= 32 is
//     zero-padded to the next one in registers and shared memory (a zero
//     term changes neither a dot product nor ||e||^2); above 32 a kernel with
//     a runtime-D loop, one row a thread, x and the codes read through the
//     cache (no shared memory, so no limit on D).
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

// D > 32: one row a thread, the row and the code read through the cache as
// the loop goes (a warp's lanes read one code: a broadcast); ||e||^2 summed
// beside the dot product; the same chunk minimum and rescan
__device__ __forceinline__ float dist_any(const float* __restrict__ xr,
                                          const float* __restrict__ ek, int Dr) {
  float sq = 0.f, dot = 0.f;
  for (int j = 0; j < Dr; ++j) {
    const float v = __ldg(ek + j);
    sq = fmaf(v, v, sq);
    dot = fmaf(-2.f * __ldg(xr + j), v, dot);
  }
  return sq + dot;
}

__global__ void __launch_bounds__(kThreads)
vq_kernel_any(const float* __restrict__ x, const float* __restrict__ e,
              unsigned long long* __restrict__ part, int* __restrict__ out, int M, int K, int Dr,
              int ks) {
  const int k0 = blockIdx.y * ks, n = min(ks, K - k0);
  const int n_pad = (n + kChunk - 1) / kChunk * kChunk;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const float* xr = x + (size_t)min(row, M - 1) * Dr;
  const float* ep = e + (size_t)k0 * Dr;
  float best = CUDART_INF_F;
  int chunk = 0;
  for (int c = 0; c < n_pad; c += kChunk) {
    float m = CUDART_INF_F;
    for (int k = c; k < c + kChunk; ++k)
      m = fminf(m, k < n ? dist_any(xr, ep + (size_t)k * Dr, Dr) : CUDART_INF_F);
    if (m < best) best = m, chunk = c;
  }
  int idx = chunk;
  for (int k = min(chunk + kChunk, n) - 1; k >= chunk; --k)
    idx = dist_any(xr, ep + (size_t)k * Dr, Dr) == best ? k : idx;
  if (row < M) emit(part, out, row, best, k0 + idx);
}

__global__ void finish_kernel(const unsigned long long* __restrict__ part, int* __restrict__ out,
                              int M) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row < M) out[row] = static_cast<int>(part[row] & 0xffffffffull);
}

// resident blocks an SM at this shared-memory size, kept per device, kernel
// and size (the occupancy query costs host time on every call otherwise)
int blocks_per_sm(const void* kernel, int smem, int* sms) {
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
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess)
    return 0;
  cache.push_back({dev, kernel, smem, *sms, per_sm});
  return per_sm;
}

// code_bytes: shared memory a staged code takes (its floats and its norm),
// 0 for the kernel that reads the codes through the cache
template <typename Kernel>
int launch(Kernel kernel, int rows_per_block, int code_bytes, const float* x, const float* e,
           unsigned long long* part, int* out, int M, int K, int Dr, cudaStream_t stream) {
  // codes a slice at most: what kSliceBytes holds where the codes are staged
  const int ks_max = code_bytes ? kSliceBytes / code_bytes / kChunk * kChunk : K;
  int sms = 0;
  const int per_sm =
      blocks_per_sm(reinterpret_cast<const void*>(kernel), ks_max * code_bytes, &sms);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // slices: as many as one wave of resident blocks holds beside the row
  // tiles, at least what shared memory forces, at most one a chunk
  const int row_tiles = (M + rows_per_block - 1) / rows_per_block;
  const int chunks = (K + kChunk - 1) / kChunk;
  int slices = sms * per_sm / row_tiles;
  slices = slices < 1 ? 1 : slices > chunks ? chunks : slices;
  const int forced = (K + ks_max - 1) / ks_max;
  if (slices < forced) slices = forced;
  const int ks = ((K + slices - 1) / slices + kChunk - 1) / kChunk * kChunk;
  slices = (K + ks - 1) / ks;
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (slices > 1 &&
      (err = cudaMemsetAsync(part, 0xff, (size_t)M * sizeof(unsigned long long), stream)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid(row_tiles, slices);
  kernel<<<grid, kThreads, ks * code_bytes, stream>>>(x, e, slices > 1 ? part : nullptr, out, M,
                                                      K, Dr, ks);
  if ((err = cudaGetLastError()) != cudaSuccess || slices == 1) return static_cast<int>(err);
  finish_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, out, M);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_staged(const float* x, const float* e, unsigned long long* part, int* out, int M,
                  int K, int Dr, cudaStream_t stream) {
  return launch(vq_kernel<D>, kThreads * kRowFloats / D, (D + 1) * (int)sizeof(float), x, e,
                part, out, M, K, Dr, stream);
}

}  // namespace

// x (M, D) rows and e (K, D) codes, f32; part (M,) 64-bit scratch the
// wrapper allocates; out (M,) int32
extern "C" int vq_argmin_launch(const void* x, const void* e, void* part, void* out, int M, int K,
                                int D, void* stream) {
  if (M < 1 || K < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xp = static_cast<const float*>(x), *ep = static_cast<const float*>(e);
  auto* pp = static_cast<unsigned long long*>(part);
  int* op = static_cast<int*>(out);
  if (D <= 4) return launch_staged<4>(xp, ep, pp, op, M, K, D, s);
  if (D <= 8) return launch_staged<8>(xp, ep, pp, op, M, K, D, s);
  if (D <= 16) return launch_staged<16>(xp, ep, pp, op, M, K, D, s);
  if (D <= 32) return launch_staged<32>(xp, ep, pp, op, M, K, D, s);
  return launch(vq_kernel_any, kThreads, 0, xp, ep, pp, op, M, K, D, s);
}
