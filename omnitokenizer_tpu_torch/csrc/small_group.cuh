// Attention inside many tiny groups (n <= 16 rows, head width 16-128), the
// core under two entry points: small_attn.cu (cosine attention in groups of
// n <= 8, the temporal stack) and mha.cu's small branch (plain softmax
// attention at N <= 16, the stage-1 tokenizer's causal temporal blocks).
//
// A task is one (b, h) problem: N rows of q, k and v, each row D contiguous
// elements at b * s.b + h * s.h + n * s.n of its tensor (any strides whose
// rows are 16-byte aligned), and N rows of output laid out the same way.
//
// Bound: bytes. About 8 flops a byte, so the tensor cores do not matter: the
// only gain is many wide loads in flight and each byte touched once.
// Design:
//   * Staging. A block owns G consecutive tasks a stage (G chosen at launch
//     so that a stage is ~24 KB and its G * N query rows fill the block's
//     teams evenly). 16-byte cp.async copies bring the stage's q, k and v rows
//     into shared memory; a persistent block walks its stages through a
//     3-stage ring, so the loads of the next two stages are in flight while
//     this one is computed. For (B, N, H, D) memory, consecutive tasks are
//     neighbouring heads of one row: the copies read whole lines. A stage's
//     task offsets are computed once a task into a table beside the ring:
//     with the loads wide the kernel is bound by instruction issue, and
//     runtime integer divisions on every 16-byte copy were ~40% of a
//     stage's instructions, counted from the code.
//   * Compute. A team of D/16 lanes, rounded up to a power of two (lanes
//     past D hold zeros: one of 4 at D = 48), owns one (task, query row); a
//     lane holds 16 dims (two 16-byte vectors of bf16). Dots and norms reduce
//     over the team in log2 of its size shuffle steps (2 at D = 64): fewer
//     instructions a pair than 8 dims a lane, measured faster on the H100. Keys go in pairs
//     between two branches, so two loads and dot chains overlap. Query rows
//     are numbered row major over the stage's tasks, so the teams of a warp
//     mostly share their row index and with it the causal loop bound. k_j
//     and v_j are read from shared memory by every query row of their task;
//     the softmax over j <= n runs in registers, in the log2 domain; the
//     output leaves in 16-byte stores.
// The arithmetic of each entry point is its plain version's (see Mode).
#pragma once

#include <mutex>
#include <vector>

#include "common.cuh"

namespace otk {
namespace small_group {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kStageBytes = 24 * 1024;  // about what one stage may hold
constexpr int kDimsPerLane = 16;        // two 16-byte vectors of bf16 a lane
constexpr int kKeysAtOnce = 2;          // keys a team takes between two branches

// lanes of a team: D / 16 rounded up to a power of two, for the shuffles
__host__ __device__ constexpr int team_lanes(int D) {
  int l = 1;
  while (l * kDimsPerLane < D) l *= 2;
  return l;
}

struct Strides {
  long long b, h, n;  // elements
};

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  Strides sq, sk, sv, so;
  int H, N, tasks;  // tasks = B * H
  float scale;
  int causal;
  const float* q_scale;  // Cosine mode only
  const float* k_scale;
};

// Cosine (small_n_attention): l2norm(q) * q_scale . l2norm(k) * k_scale *
//   scale, F.normalize's max(||x||, 1e-12); the causal mask as -inf; softmax
//   and P v in f32; bf16 out.
// Plain (mha): q . k * scale in f32, the causal mask (col > row) filled with
//   -1e9; softmax in f32; P normalized and then rounded to the input type
//   before P v, which accumulates in f32; out in the input type.
enum class Mode { Cosine, Plain };

namespace {  // kernels: each translation unit keeps its own instances

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// 8 f32 as consecutive elements (16-byte aligned)
__device__ __forceinline__ void store8(bf16* p, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// V consecutive elements (a multiple of 8, 16-byte aligned) as f32, or
// zeros where the lane holds no dims; and back
template <int V, typename T>
__device__ __forceinline__ void load_row(const T* p, float* x, bool dims) {
#pragma unroll
  for (int u = 0; u < V; u += 8) {
    if (dims) {
      load8(p + u, x + u);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[u + e] = 0.f;
    }
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_row(T* p, const float* x) {
#pragma unroll
  for (int u = 0; u < V; u += 8) store8(p + u, x + u);
}

// x rounded to T and back (identity for float)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// sum over the L lanes of a team (aligned groups of L lanes in a warp)
template <int L>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D, int kMaxN, Mode kMode>
__global__ void __launch_bounds__(kThreads)
small_group_kernel(const Problem p, int G) {
  constexpr int V = kDimsPerLane;
  constexpr int L = team_lanes(D);         // lanes of a team
  constexpr int kTeams = kThreads / L;
  constexpr int kVec = 16 / sizeof(T);     // elements a copy
  constexpr int kChunks = D / kVec;        // copies a row
  constexpr bool kCosine = kMode == Mode::Cosine;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) uint8_t smem[];
  const int N = p.N, H = p.H;
  const int rows = G * N;                  // rows of one tensor in a stage
  const int stage_elems = 3 * rows * D;    // q, k, v
  T* ring = reinterpret_cast<T*>(smem);
  float* inv_q = reinterpret_cast<float*>(smem + (size_t)kStages * stage_elems * sizeof(T));
  float* inv_k = inv_q + rows;             // Cosine: 1 / max(||x||, 1e-12) a row
  // a slot's task offsets b * s.b + h * s.h in q, k, v and out (-1: past the end)
  long long* offs = reinterpret_cast<long long*>(inv_k + rows);
  const int n_stages = (p.tasks + G - 1) / G;
  const float s_log2 = p.scale * kLog2e;   // scores in the log2 domain
  // small quotients (r < 2^12, divisor <= 2^12) by a float reciprocal: exact,
  // as (r + 0.5) / d lies at least 1 / (2 d) from an integer
  const float inv_n = 1.f / N, inv_g = 1.f / G;

  // a stage's copies, in a ring slot: the task offsets once a task, then
  // this thread copies chunk c of its rows; rows of tasks past the end are
  // zero-filled. Called by the whole block (it holds a barrier)
  const int c = threadIdx.x % kChunks;
  auto issue = [&](int st, int slot) {
    long long* off = offs + slot * 4 * G;
    for (int i = threadIdx.x; i < 4 * G; i += kThreads) {
      const int which = i / G, task = st * G + i - which * G;
      long long o = -1;
      if (task < p.tasks) {
        const int b = task / H, h = task - b * H;
        const Strides s = which == 0 ? p.sq : which == 1 ? p.sk : which == 2 ? p.sv : p.so;
        o = b * s.b + h * s.h;
      }
      off[i] = o;
    }
    __syncthreads();
    // threads past a whole number of rows' copies (D = 48: 252 of 256) issue none
    if (threadIdx.x >= kThreads / kChunks * kChunks) return;
    T* dst = ring + (size_t)slot * stage_elems + c * kVec;
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const T* src = static_cast<const T*>(which == 0 ? p.q : which == 1 ? p.k : p.v) + c * kVec;
      const long long sn = which == 0 ? p.sq.n : which == 1 ? p.sk.n : p.sv.n;
      for (int r = threadIdx.x / kChunks; r < rows; r += kThreads / kChunks) {
        const int tl = static_cast<int>((r + 0.5f) * inv_n), n = r - tl * N;
        const long long o = off[which * G + tl];
        cp_async16(dst + (size_t)(which * rows + r) * D, o < 0 ? src : src + o + n * sn,
                   o < 0 ? 0 : 16);
      }
    }
  };

  const int lane = threadIdx.x & 31, team = threadIdx.x / L;
  const int d0 = (lane & (L - 1)) * V;  // this lane's dims
  const bool dims = d0 < D;             // a lane past D holds zeros
  float qks[V];                         // Cosine: q_scale * k_scale of those dims
  if constexpr (kCosine) {
#pragma unroll
    for (int e = 0; e < V; ++e) qks[e] = dims ? p.q_scale[d0 + e] * p.k_scale[d0 + e] : 0.f;
  }
  // a team owns one query row of a task; rows are numbered row major
  // (item = i * G + task in the stage), so the teams of a warp mostly share
  // their row and their causal loop bound

  const int first = blockIdx.x, step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (first + s * step < n_stages) issue(first + s * step, s);
    cp_async_commit();
  }
  int it = 0;
  for (int st = first; st < n_stages; st += step, ++it) {
    const int ahead = st + (kStages - 1) * step;
    if (ahead < n_stages) issue(ahead, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this stage's copies have landed
    __syncthreads();
    const T* sq = ring + (size_t)(it % kStages) * stage_elems;
    const T* sk = sq + rows * D;
    const T* sv = sk + rows * D;

    if constexpr (kCosine) {  // the inverse norms of every q and k row of the stage
      for (int base = 0; base < rows; base += kTeams) {
        const int r = min(base + team, rows - 1);
        float x[V], y[V], sxx = 0.f, syy = 0.f;
        load_row<V>(sq + r * D + d0, x, dims);
        load_row<V>(sk + r * D + d0, y, dims);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sxx = fmaf(x[e], x[e], sxx);
          syy = fmaf(y[e], y[e], syy);
        }
        sxx = team_sum<L>(sxx);
        syy = team_sum<L>(syy);
        if (base + team < rows && d0 == 0) {
          inv_q[r] = 1.f / fmaxf(sqrtf(sxx), 1e-12f);
          inv_k[r] = 1.f / fmaxf(sqrtf(syy), 1e-12f);
        }
      }
      __syncthreads();
    }

    for (int base = 0; base < rows; base += kTeams) {
      const int item = min(base + team, rows - 1);
      const int i = static_cast<int>((item + 0.5f) * inv_g), tl = item - i * G;
      float a[V];
      load_row<V>(sq + (tl * N + i) * D + d0, a, dims);
      if constexpr (kCosine) {
        const float iq = inv_q[tl * N + i];
#pragma unroll
        for (int e = 0; e < V; ++e) a[e] *= iq * qks[e];
      }
      const int jend = p.causal ? i + 1 : N;
      const int jw = __reduce_max_sync(0xffffffffu, jend);  // the warp's bound
      const T* kr = sk + tl * N * D + d0;
      const T* vr = sv + tl * N * D + d0;
      // keys in chunks of J, one branch a chunk: the J loads and dot chains
      // of a chunk overlap. Keys past N repeat row N - 1 and are masked
      constexpr int J = kKeysAtOnce;
      float s[kMaxN], m = -CUDART_INF_F;
#pragma unroll
      for (int j0 = 0; j0 < kMaxN; j0 += J) {
        if (j0 < jw) {
          float kk[J][V], dot[J];
#pragma unroll
          for (int u = 0; u < J; ++u) load_row<V>(kr + min(j0 + u, N - 1) * D, kk[u], dims);
#pragma unroll
          for (int u = 0; u < J; ++u) {
            float d2[2] = {0.f, 0.f};  // two chains of V / 2 products
#pragma unroll
            for (int e = 0; e < V; ++e) d2[e & 1] = fmaf(a[e], kk[u][e], d2[e & 1]);
            dot[u] = d2[0] + d2[1];
          }
#pragma unroll
          for (int u = 0; u < J; ++u) dot[u] = team_sum<L>(dot[u]);
#pragma unroll
          for (int u = 0; u < J; ++u) {
            const int j = j0 + u;
            const float cj = kCosine ? inv_k[tl * N + min(j, N - 1)] * s_log2 : s_log2;
            // masked pairs weigh exactly 0: -inf, or the plain version's -1e9,
            // whose exp underflows to 0 in f32 (a row keeps its diagonal)
            s[j] = j < jend ? dot[u] * cj : -CUDART_INF_F;
            m = fmaxf(m, s[j]);
          }
        }
      }
      float denom = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j - j % J < jw) {
          s[j] = exp2f(s[j] - m);
          denom += s[j];
        }
      }
      const float inv = 1.f / denom;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < kMaxN; j0 += J) {
        if (j0 < jw) {
          float vv[J][V];
#pragma unroll
          for (int u = 0; u < J; ++u) load_row<V>(vr + min(j0 + u, N - 1) * D, vv[u], dims);
#pragma unroll
          for (int u = 0; u < J; ++u) {
            // Plain: P normalized, then rounded to T
            const float pj = kCosine ? s[j0 + u] : round_to(s[j0 + u] * inv, vr);
#pragma unroll
            for (int e = 0; e < V; ++e) o[e] = fmaf(pj, vv[u][e], o[e]);
          }
        }
      }
      const long long o_off = offs[(it % kStages) * 4 * G + 3 * G + tl];
      if (base + team < rows && o_off >= 0 && dims) {
        if constexpr (kCosine) {
#pragma unroll
          for (int e = 0; e < V; ++e) o[e] *= inv;
        }
        store_row<V>(static_cast<T*>(p.out) + o_off + i * p.so.n + d0, o);
      }
    }
    __syncthreads();  // the slot is refilled two stages on
  }
  cp_async_wait<0>();
}

}  // namespace

// tasks a stage: up to kStageBytes of q, k and v rows, chosen so that the
// stage's query rows fill the block's teams as evenly as possible (the
// larger count at equal fill)
inline int stage_tasks(int N, int D, int elem_bytes, int tasks) {
  const int teams = kThreads / team_lanes(D);
  const int task_bytes = 3 * N * D * elem_bytes;
  int g_max = kStageBytes / task_bytes;
  if (g_max < 1) g_max = 1;
  if (g_max > tasks) g_max = tasks;
  int best = 1;
  double best_fill = 0.0;
  for (int g = 1; g <= g_max; ++g) {
    const int items = g * N, rounds = (items + teams - 1) / teams;
    const double fill = (double)items / (rounds * teams);
    if (fill >= best_fill - 1e-9) {
      best = g;
      best_fill = fill;
    }
  }
  return best;
}

template <typename T, int D, int kMaxN, Mode kMode>
int launch(const Problem& p, cudaStream_t stream) {
  if (p.N < 1 || p.N > kMaxN || p.tasks < 1 || p.H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = small_group_kernel<T, D, kMaxN, kMode>;
  const int G = stage_tasks(p.N, D, sizeof(T), p.tasks);
  const size_t smem = (size_t)kStages * 3 * G * p.N * D * sizeof(T) +
                      2 * (size_t)G * p.N * sizeof(float) + (size_t)kStages * 4 * G * sizeof(long long);
  // the grid of a persistent launch, SMs x resident blocks, kept per device
  // and shared-memory size: the queries cost about as much host time as the
  // kernel takes at the paths' shapes
  struct Entry {
    int dev;
    size_t smem;
    long long cap;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long cap = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Entry& e : cache)
      if (e.dev == dev && e.smem == smem) cap = e.cap;
    if (cap == 0) {
      int optin = 0, sms = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
              cudaSuccess ||
          (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      optin)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
              cudaSuccess)
        return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      cap = (long long)sms * per_sm;
      cache.push_back({dev, smem, cap});
    }
  }
  const long long n_stages = (p.tasks + G - 1) / G;
  const int grid = static_cast<int>(n_stages < cap ? n_stages : cap);
  kernel<<<grid, kThreads, smem, stream>>>(p, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace small_group
}  // namespace otk
