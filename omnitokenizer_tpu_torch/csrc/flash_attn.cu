// Causal flash attention over (B, H, T, D), forward and backward:
//   o = softmax(q k^T * scale, key j <= query i) v,  lse = log sum_j exp(s_ij)
// bf16 in and out; every product accumulates in f32 and the online softmax
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
// (8, 16, 1025, 96): 0.026 ms at 989 TFLOP/s bf16, under its 0.030 ms of
// bytes) and the backward 2.5x that (the scores again, then dv, dp, dq, dk);
// at the long-sequence recipes' (4, 16, 5121, 96) 0.32 + 0.81 TFLOP a layer,
// 0.33 + 0.81 ms, far above their bytes.
//
// Design, after FlashAttention-3: every product is a wgmma (64 rows a
// warpgroup, B from shared memory, A from shared memory or, for P and dS,
// from registers: the f32 accumulator layout of m64nNk16 is the bf16 A
// fragment layout, so P is rounded in place); tiles come by TMA through a
// ring of 3 (forward) or 4 (backward) stages guarded by mbarriers (full: the bytes landed; empty: every
// consumer warp is done with the stage). A block is two consumer
// warpgroups and a producer warpgroup of which one thread issues every copy;
// it is a warpgroup and not a warp because setmaxnreg works on whole
// warpgroups: the producer drops to 24 registers, the consumers rise to 240.
// Each kernel is persistent: one block an SM walks work items of 128 rows
// of one (b, h), the longest walks first, and the ring runs on from one
// item into the next, so the next item's tiles load while this one's
// epilogue stores. q, k, v, o, do are read through a 4-D map over
// (d, t, h, b) of their strides (sm90_gemm.cuh make_map_bhtd), so the LM's
// (B, T, H, D) projections go in as they are, and TMA's zeros fill the
// rows past T of each (b, h). Outputs are stored from registers through the
// same strides.
//   forward: an item is 128 queries, 64 a consumer warpgroup. Q comes once
//     (refilled when both warpgroups' last S has landed); K and V tiles of
//     128 keys, each with its own full barrier, from the diagonal tile down
//     to key 0, so tiles above the diagonal are never loaded and only the
//     first tile is masked (the two warpgroups meet the diagonal at
//     different columns; each masks its own rows, and the first computes
//     only the 64 keys it can see there). S = Q K^T, the online softmax in
//     registers (exp2, scale * log2(e) folded in), O += P V with V read
//     MN-major. The exps overlap the products two ways, as in FA3: inside a
//     warpgroup the next tile's S and this tile's P V are issued together
//     and the new S's softmax runs while P V is in flight (O is rescaled
//     after it lands); across the two, named barriers make them take turns
//     to issue (ping-pong), so one's softmax runs under the other's
//     products. At D = 96 a 128 x 128 tile costs the SFUs (16 exp2 a clock
//     an SM) about 60% of its tensor-core time, so both overlaps count.
//   di: a thread a row, o . do in f32, written with lse * log2(e) into a
//     (2, B, H, Tp) f32 scratch padded with zeros to Tp = T rounded up to
//     64, so the dkv kernel bulk-copies 64 of each a tile.
//   dkv: an item is 128 keys (64 a warpgroup); K and V come once, and it
//     walks query tiles of 64 from the diagonal to T, Q, dO, lse and di
//     through the ring: S^T = K Q^T (A = K, B = Q), P^T from lse, dV +=
//     P^T dO (A = P^T in registers), dP^T = V dO^T, dS^T = P^T (dP^T - di),
//     dK += dS^T Q (A in registers). Key block 0 walks longest and goes first.
//   dq: an item is 128 queries (64 a warpgroup); Q and dO come once, and it
//     walks key tiles of 64 up to the diagonal, K and V through the ring:
//     S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
// Each output row has one writer, so there are no atomics and two runs on
// the same inputs are bitwise equal. Rows past T are computed and never
// stored; keys past T are TMA's zeros behind the diagonal's j > i mask, which
// every stored row sees; queries past T are masked in the dkv kernel, where
// lse and di read the scratch's zeros. A warpgroup whose 64 rows all lie past
// T computes nothing (it keeps its turns and releases the stages), and one
// whose rows a tile cannot reach (wholly above the diagonal) skips it but
// still releases it. D is 16, 32, 64, 96 or 128 (the wrapper zero-pads other
// widths up to the next): a tile is stored as TMA wrote it, in column boxes
// of 16, 32 or 64 (32-, 64- or 128-byte swizzle; 96 is three boxes of 32 and
// 128 two of 64), the K-major descriptors stepping box by box, the MN-major
// ones (V, dO, Q, K as B of the register-A products) spanning the boxes with
// LBO = the box stride.
//
// Registers and spills (nvcc 12.9 -Xptxas -v, sm_90a, at D = 16, 32, 64,
// 96 and 128 alike): the forward, dkv and dq kernels report 168 registers a
// thread at launch (384 threads, one block an SM; the consumers' code runs
// under setmaxnreg's 240) and 0 bytes of spill; the di pass 30, no spill.
// No instance has its wgmmas serialized by ptxas (a branch around a wgmma,
// even one uniform over the warpgroup, makes ptxas serialize them all: keep
// every product outside a conditional).
#include "sm90_gemm.cuh"

namespace {

using otk::bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kFwdStages = 3;  // the forward's ring (the backward's: kBwdStages)

// the columns of a tile's box at head width D (see Box)
constexpr int box_cols(int D) { return D % 64 == 0 ? 64 : D < 64 ? D : 32; }

// A tile of R rows x D columns lies in shared memory as kCount column boxes
// of kCols, each R rows of kRowBytes with the swizzle of that width.
template <int D>
struct Box {
  static constexpr int kCols = box_cols(D);
  static constexpr int kCount = D / kCols;
  static constexpr uint32_t kRowBytes = 2 * kCols;
  static constexpr int kSteps = kCols / 16;  // k steps of 16 inside a box
  static_assert(D % kCols == 0 && kCols % 16 == 0, "head width");
};
template <int D, int R>
struct Tile {
  static constexpr uint32_t kBoxBytes = R * Box<D>::kRowBytes;
  static constexpr uint32_t kBytes = Box<D>::kCount * kBoxBytes;
};

// wgmma descriptor: 8-row groups 8 box rows apart (SBO), the swizzle of the
// box width, LBO as given (K-major: unused; MN-major: box to box)
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  constexpr uint32_t rb = Box<D>::kRowBytes;
  constexpr uint64_t kLayout = rb == 128 ? 1 : rb == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)((8 * rb) >> 4) << 32) | (kLayout << 62);
}
// K-major operand (the k dimension is D): 64 (A) or all R (B) rows from
// row0 of an R-row tile, k step kk
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  using Bx = Box<D>;
  return desc<D>(tile + (kk / Bx::kSteps) * Tile<D, R>::kBoxBytes + row0 * Bx::kRowBytes +
                     32 * (kk % Bx::kSteps),
                 16);
}
// MN-major B operand (N = the D columns, the k dimension the tile's rows):
// k step j is rows 16 j .. 16 j + 15 of an R-row tile
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int j) {
  using Bx = Box<D>;
  return desc<D>(tile + 16 * j * Bx::kRowBytes,
                 Bx::kCount > 1 ? Tile<D, R>::kBoxBytes : 8 * Bx::kRowBytes);
}

// TMA: rows [row0, row0 + R) of (b, h) into an R-row tile, 64 rows a copy
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int h, int b) {
  using Bx = Box<D>;
#pragma unroll
  for (int c = 0; c < Bx::kCount; ++c)
#pragma unroll
    for (int r = 0; r < R; r += 64)
      otk::tma_load(dst + c * Tile<D, R>::kBoxBytes + r * Bx::kRowBytes, map, bar, c * Bx::kCols,
                    row0 + r, h, b);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ float exp2_approx(float x) {  // ex2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an m64nNk16 f32 fragment (element 4i + 2e + c is row 16 w + g + 8 e,
// column 8 i + 2 t + c) rounded to bf16 as the A fragments of N / 16 k
// steps: keys 16 j + [0, 8) are tile 2 j, 16 j + [8, 16) tile 2 j + 1
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (*a)[4], const float* f) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* x = f + 4 * (2 * j + half);
      a[j][2 * half] = pack_bf16(x[0], x[1]);
      a[j][2 * half + 1] = pack_bf16(x[2], x[3]);
    }
}

template <int R>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// d (64 x N f32) += A (64 x 16 bf16 in registers) B, B (16 x N) MN-major in
// shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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


// a warpgroup's 64 x D f32 fragment times mul as bf16 rows row0 + 16 w + g
// (+ 8) of a strided (T, D) slice; rows past T are dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int row0, int T,
                                           const float* acc, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_a = row0 + ((threadIdx.x >> 5) & 3) * 16 + g;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row_a + 8 * e;
    if (row >= T) continue;
    bf16* p = dst + (long long)row * ld + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * e] * mul, acc[4 * i + 2 * e + 1] * mul);
  }
}

struct Strides {
  long long b, h, t;
};

// Work items of a persistent kernel: (block of rows, h, b), the longest
// walks first; block x takes items x, x + gridDim.x, ... in that order, so
// one item's loads are in flight while the previous item's epilogue runs.
struct Item {
  int blk, h, b;
};
__device__ __forceinline__ Item item_at(int idx, int H, int BH, int n_blk, bool last_first) {
  const int r = idx % BH, k = idx / BH;
  return {last_first ? n_blk - 1 - k : k, r % H, r / H};
}

// named barriers 1 and 2: the two consumer warpgroups take turns to issue
// their products (FA3's ping-pong), so one's softmax runs under the other's
// products; every round of one warpgroup waits for the other's last
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) otk::mbar_arrive(bar);
}

// -------------------------------------------------------------- forward
constexpr int kFwdBQ = 128;  // queries an item: two warpgroups of 64
constexpr int kFwdBN = 128;  // keys a tile

struct FwdArgs {
  bf16* o;
  float* lse;  // (B, H, T) contiguous
  Strides so;
  int B, H, T, n_items;
  float c;  // scale * log2(e)
};

template <int D>
constexpr size_t fwd_smem() {
  return 1024 + Tile<D, kFwdBQ>::kBytes + (size_t)kFwdStages * 2 * Tile<D, kFwdBN>::kBytes +
         (2 + 3 * kFwdStages) * sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  constexpr uint32_t kQBytes = Tile<D, kFwdBQ>::kBytes, kKV = Tile<D, kFwdBN>::kBytes;
  constexpr int kSSteps = D / 16, kPSteps = kFwdBN / 16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (otk::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = otk::smem_u32(smem), kv_s = q_s + kQBytes;
  const uint32_t q_full = kv_s + kFwdStages * 2 * kKV, q_empty = q_full + 8;
  const uint32_t fullk0 = q_empty + 8, fullv0 = fullk0 + 8 * kFwdStages, empty0 = fullv0 + 8 * kFwdStages;
  const int T = a.T, BH = a.B * a.H, n_blk = (T + kFwdBQ - 1) / kFwdBQ;

  if (threadIdx.x == 0) {
    otk::mbar_init(q_full, 1);
    otk::mbar_init(q_empty, kConsumers / 32);  // one arrival a consumer warp
    for (int s = 0; s < kFwdStages; ++s) {
      otk::mbar_init(fullk0 + 8 * s, 1);
      otk::mbar_init(fullv0 + 8 * s, 1);
      otk::mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    otk::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      int n = 0, base = 0;  // items and key tiles so far
      for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x, ++n) {
        const Item w = item_at(idx, a.H, BH, n_blk, true);
        if (n > 0) otk::mbar_wait(q_empty, (n - 1) & 1);
        otk::mbar_expect_tx(q_full, kQBytes);
        load_tile<D, kFwdBQ>(q_s, &tq, q_full, w.blk * kFwdBQ, w.h, w.b);
        for (int it = 0; it <= w.blk; ++it, ++base) {  // the diagonal tile, then down to 0
          const int s = base % kFwdStages, row0 = (w.blk - it) * kFwdBN;
          if (base >= kFwdStages) otk::mbar_wait(empty0 + 8 * s, ((base / kFwdStages) - 1) & 1);
          const uint32_t k_dst = kv_s + s * 2 * kKV;
          otk::mbar_expect_tx(fullk0 + 8 * s, kKV);
          load_tile<D, kFwdBN>(k_dst, &tk, fullk0 + 8 * s, row0, w.h, w.b);
          otk::mbar_expect_tx(fullv0 + 8 * s, kKV);
          load_tile<D, kFwdBN>(k_dst + kKV, &tv, fullv0 + 8 * s, row0, w.h, w.b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_loc = 64 * wg + ((threadIdx.x >> 5) & 3) * 16 + g;  // rows r_loc, r_loc + 8
  const float c = a.c;
  if (wg == 1) turn_pass(wg);  // the first warpgroup issues first

  // the rows' max of a scaled score tile, the scores turned into exp2(s - m)
  // in place, and the rows' partial sums (this thread's columns)
  auto softmax = [&](float* sc, float (&m_new)[2], float (&sum)[2]) {
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < kFwdBN / 2; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 1));
      mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 2));
      m_new[e] = fmaxf(m_new[e], mt[e]);
      sum[e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kFwdBN / 2; ++i) {
      const int e = (i >> 1) & 1;
      sc[i] = exp2_approx(sc[i] - m_new[e]);
      sum[e] += sc[i];
    }
  };

  int n = 0, base = 0;
  for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x, ++n) {
    const Item w = item_at(idx, a.H, BH, n_blk, true);
    const int q0 = w.blk * kFwdBQ, n_tiles = w.blk + 1;
    otk::mbar_wait(q_full, n & 1);
    if (q0 + 64 * wg >= T) {  // its 64 rows all lie past T: its turns and releases only
      for (int it = 0; it <= n_tiles; ++it) {
        turn_wait(wg);
        turn_pass(wg);
        if (it < n_tiles) {
          const int s = (base + it) % kFwdStages, ph = ((base + it) / kFwdStages) & 1;
          otk::mbar_wait(fullk0 + 8 * s, ph);
          otk::mbar_wait(fullv0 + 8 * s, ph);
          warp_arrive(empty0 + 8 * s);
        }
      }
      warp_arrive(q_empty);
      base += n_tiles;
      continue;
    }

    float o[D / 2], m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2];
    uint32_t pa[kPSteps][4];
    zero<D / 2>(o);
    {  // the diagonal tile: keys q0 + col, this thread's rows q0 + r_loc (+ 8)
      const int s = base % kFwdStages;
      float sc[kFwdBN / 2];
      zero<kFwdBN / 2>(sc);
      otk::mbar_wait(fullk0 + 8 * s, (base / kFwdStages) & 1);
      otk::fence_regs<kFwdBN / 2>(sc);
      otk::wgmma_fence();
      turn_wait(wg);
#pragma unroll
      for (int kk = 0; kk < kSSteps; ++kk)
        otk::wgmma<kFwdBN>(sc, kmajor<D, kFwdBQ>(q_s, 64 * wg, kk),
                           kmajor<D, kFwdBN>(kv_s + s * 2 * kKV, 0, kk));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      otk::fence_regs<kFwdBN / 2>(sc);
#pragma unroll
      for (int i = 0; i < kFwdBN / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * t + (i & 1), row = r_loc + 8 * ((i >> 1) & 1);
        sc[i] = col > row ? -CUDART_INF_F : sc[i] * c;  // key 0 of the tile is every row's
      }
      softmax(sc, m_run, l_run);
      to_a_frags<kFwdBN>(pa, sc);
    }

    for (int it = 1; it < n_tiles; ++it) {
      const int s = (base + it) % kFwdStages, sp = (base + it - 1) % kFwdStages;
      float sc[kFwdBN / 2];
      zero<kFwdBN / 2>(sc);
      otk::mbar_wait(fullk0 + 8 * s, ((base + it) / kFwdStages) & 1);
      otk::mbar_wait(fullv0 + 8 * sp, ((base + it - 1) / kFwdStages) & 1);
      otk::fence_regs<kFwdBN / 2>(sc);
      otk::fence_regs<D / 2>(o);
      otk::fence_regs<4 * kPSteps>(&pa[0][0]);
      otk::wgmma_fence();
      turn_wait(wg);
#pragma unroll
      for (int kk = 0; kk < kSSteps; ++kk)
        otk::wgmma<kFwdBN>(sc, kmajor<D, kFwdBQ>(q_s, 64 * wg, kk),
                           kmajor<D, kFwdBN>(kv_s + s * 2 * kKV, 0, kk));
      wgmma_commit();
      const uint32_t vt = kv_s + sp * 2 * kKV + kKV;
#pragma unroll
      for (int j = 0; j < kPSteps; ++j) wgmma_rs<D>(o, pa[j], mnmajor<D, kFwdBN>(vt, j));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // S has landed; the previous tile's P V is in flight
      otk::fence_regs<kFwdBN / 2>(sc);
#pragma unroll
      for (int i = 0; i < kFwdBN / 2; ++i) sc[i] *= c;  // below the diagonal: no mask
      float m_new[2] = {m_run[0], m_run[1]}, sum[2];
      softmax(sc, m_new, sum);
      wgmma_wait<0>();
      otk::fence_regs<D / 2>(o);
      otk::fence_regs<4 * kPSteps>(&pa[0][0]);
      warp_arrive(empty0 + 8 * sp);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float alpha = exp2_approx(m_run[e] - m_new[e]);
        l_run[e] = l_run[e] * alpha + sum[e];
        m_run[e] = m_new[e];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i + 2 * e] *= alpha;
          o[4 * i + 2 * e + 1] *= alpha;
        }
      }
      to_a_frags<kFwdBN>(pa, sc);
    }
    warp_arrive(q_empty);  // every S of this item has landed: Q may be refilled

    {  // the last tile's P V
      const int sl = (base + n_tiles - 1) % kFwdStages;
      otk::mbar_wait(fullv0 + 8 * sl, ((base + n_tiles - 1) / kFwdStages) & 1);
      otk::fence_regs<D / 2>(o);
      otk::fence_regs<4 * kPSteps>(&pa[0][0]);
      otk::wgmma_fence();
      turn_wait(wg);
      const uint32_t vt = kv_s + sl * 2 * kKV + kKV;
#pragma unroll
      for (int j = 0; j < kPSteps; ++j) wgmma_rs<D>(o, pa[j], mnmajor<D, kFwdBN>(vt, j));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      otk::fence_regs<D / 2>(o);
      warp_arrive(empty0 + 8 * sl);
    }

#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 1);
      l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 2);
    }
    bf16* out = a.o + w.b * a.so.b + w.h * a.so.h;
    float* lse = a.lse + ((long long)w.b * a.H + w.h) * T;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + r_loc + 8 * e;
      if (row >= T) continue;
      const float inv = 1.f / l_run[e];
      bf16* p = out + (long long)row * a.so.t + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2 * e] * inv, o[4 * i + 2 * e + 1] * inv);
      if (t == 0) lse[row] = (m_run[e] + log2f(l_run[e])) * (1.f / kLog2e);
    }
    base += n_tiles;
  }
}

// -------------------------------------------------------------- backward
constexpr int kBwdBlock = 128;  // keys (dkv) or queries (dq) an item
constexpr int kBwdTile = 64;    // queries (dkv) or keys (dq) a tile
// a stage stays held one tile longer while its dK or dQ product finishes, so
// four stages keep two tiles ahead (1.5-2.3% faster than three on H100)
constexpr int kBwdStages = 4;

struct BwdArgs {
  const bf16 *o, *dout;
  const float* lse;  // (B, H, T) contiguous
  float* aux;        // lse * log2(e), then di: (2, B, H, Tp), zeros past T
  bf16 *dq, *dk, *dv;
  Strides so, sdo, sdq, sdk, sdv;
  int B, H, T, Tp, n_items;
  float scale, c;  // c = scale * log2(e)
};

// di = sum_d o * do in f32 and lse * log2(e) into the padded scratch: a
// half-warp a row, a 16-byte chunk a lane (D / 8 <= 16 of them), so a
// row's bytes are read together
constexpr int kPrepRows = 16;  // rows a 256-thread block
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(const BwdArgs a) {
  const long long rows = (long long)a.B * a.H * a.Tp;
  const long long row = (long long)blockIdx.x * kPrepRows + (threadIdx.x >> 4);
  const int c = threadIdx.x & 15;
  if (row >= rows) return;  // whole half-warps
  const int tt = (int)(row % a.Tp);
  const long long bh = row / a.Tp;
  const int h = (int)(bh % a.H), b = (int)(bh / a.H);
  float di = 0.f;
  if (tt < a.T && c < D / 8) {
    float x[8], y[8];
    otk::load8(a.o + b * a.so.b + h * a.so.h + tt * a.so.t + 8 * c, x);
    otk::load8(a.dout + b * a.sdo.b + h * a.sdo.h + tt * a.sdo.t + 8 * c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) di += x[e] * y[e];
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) di += __shfl_xor_sync(0xffffffffu, di, off);
  if (c == 0) {
    a.aux[row] = tt < a.T ? a.lse[bh * a.T + tt] * kLog2e : 0.f;
    a.aux[rows + row] = di;
  }
}

template <int D>
constexpr size_t dkv_smem() {
  return 1024 + 2 * (size_t)Tile<D, kBwdBlock>::kBytes +
         (size_t)kBwdStages * 2 * (Tile<D, kBwdTile>::kBytes + kBwdTile * sizeof(float)) +
         (2 + 2 * kBwdStages) * sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  constexpr uint32_t kKV = Tile<D, kBwdBlock>::kBytes, kQ = Tile<D, kBwdTile>::kBytes;
  constexpr uint32_t kVec = kBwdTile * sizeof(float);
  constexpr uint32_t kStage = 2 * kQ;  // Q and dO; lse2 and di in a ring of their own
  constexpr int kSSteps = D / 16, kPSteps = kBwdTile / 16, kN = kBwdTile / 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (otk::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t k_s = otk::smem_u32(smem), v_s = k_s + kKV, ring = v_s + kKV;
  const uint32_t vecs = ring + kBwdStages * kStage;  // kBwdStages x (lse2, di)
  const uint32_t kv_full = vecs + kBwdStages * 2 * kVec, kv_empty = kv_full + 8;
  const uint32_t full0 = kv_empty + 8, empty0 = full0 + 8 * kBwdStages;
  const int T = a.T, BH = a.B * a.H, n_blk = (T + kBwdBlock - 1) / kBwdBlock;
  const int n_qt = (T + kBwdTile - 1) / kBwdTile;

  if (threadIdx.x == 0) {
    otk::mbar_init(kv_full, 1);
    otk::mbar_init(kv_empty, kConsumers / 32);
    for (int s = 0; s < kBwdStages; ++s) {
      otk::mbar_init(full0 + 8 * s, 1);
      otk::mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    otk::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      int n = 0, base = 0;
      for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x, ++n) {
        const Item w = item_at(idx, a.H, BH, n_blk, false);  // key block 0 walks longest
        const long long bh = (long long)w.b * a.H + w.h;
        const float* lse2 = a.aux + bh * a.Tp;
        const float* dis = a.aux + ((long long)BH + bh) * a.Tp;
        const int qt0 = w.blk * kBwdBlock / kBwdTile;
        if (n > 0) otk::mbar_wait(kv_empty, (n - 1) & 1);
        otk::mbar_expect_tx(kv_full, 2 * kKV);
        load_tile<D, kBwdBlock>(k_s, &tk, kv_full, w.blk * kBwdBlock, w.h, w.b);
        load_tile<D, kBwdBlock>(v_s, &tv, kv_full, w.blk * kBwdBlock, w.h, w.b);
        for (int qt = qt0; qt < n_qt; ++qt, ++base) {
          const int s = base % kBwdStages, row0 = qt * kBwdTile;
          if (base >= kBwdStages) otk::mbar_wait(empty0 + 8 * s, ((base / kBwdStages) - 1) & 1);
          const uint32_t dst = ring + s * kStage, vec = vecs + s * 2 * kVec, full = full0 + 8 * s;
          otk::mbar_expect_tx(full, kStage + 2 * kVec);
          load_tile<D, kBwdTile>(dst, &tq, full, row0, w.h, w.b);
          load_tile<D, kBwdTile>(dst + kQ, &tdo, full, row0, w.h, w.b);
          otk::bulk_load(vec, lse2 + row0, kVec, full);
          otk::bulk_load(vec + kVec, dis + row0, kVec, full);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, t = lane & 3;
  const float c = a.c;
  int n = 0, base = 0;
  for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x, ++n) {
    const Item w = item_at(idx, a.H, BH, n_blk, false);
    const int k0w = w.blk * kBwdBlock + 64 * wg, qt0 = w.blk * kBwdBlock / kBwdTile;
    const int key_a = k0w + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // and key_a + 8
    const bool idle = k0w >= T;  // its 64 keys all lie past T
    float dk[D / 2], dv[D / 2];
    zero<D / 2>(dk);
    zero<D / 2>(dv);
    otk::mbar_wait(kv_full, n & 1);

    uint32_t pa[kPSteps][4];  // P^T, then dS^T: dK's A operand, in flight into the next tile
    int pending = -1;         // the stage that dK still reads
    for (int qt = qt0; qt < n_qt; ++qt, ++base) {
      const int s = base % kBwdStages, i0 = qt * kBwdTile;
      otk::mbar_wait(full0 + 8 * s, (base / kBwdStages) & 1);
      if (idle || i0 + kBwdTile <= k0w) {  // no key of this warpgroup before any query
        warp_arrive(empty0 + 8 * s);
        continue;
      }
      const uint32_t q_t = ring + s * kStage, do_t = q_t + kQ;
      const float* sl = reinterpret_cast<const float*>(smem + (vecs - k_s) + s * 2 * kVec);
      const float* sd = sl + kBwdTile;

      float st[kN], dpt[kN];
      zero<kN>(st);
      zero<kN>(dpt);
      otk::fence_regs<kN>(st);
      otk::fence_regs<kN>(dpt);
      otk::fence_regs<D / 2>(dv);
      otk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSSteps; ++kk)  // S^T = K Q^T
        otk::wgmma<kBwdTile>(st, kmajor<D, kBwdBlock>(k_s, 64 * wg, kk),
                             kmajor<D, kBwdTile>(q_t, 0, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kSSteps; ++kk)  // dP^T = V dO^T
        otk::wgmma<kBwdTile>(dpt, kmajor<D, kBwdBlock>(v_s, 64 * wg, kk),
                             kmajor<D, kBwdTile>(do_t, 0, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's dK and this S^T have landed
      otk::fence_regs<kN>(st);
      otk::fence_regs<D / 2>(dk);
      otk::fence_regs<4 * kPSteps>(&pa[0][0]);
      if (pending >= 0) warp_arrive(empty0 + 8 * pending);

      // P^T = exp2(S^T c - lse2): rows keys, columns queries i0 + col; zero
      // where key > query or query >= T
      const bool edge = i0 < k0w + 64 || i0 + kBwdTile > T;
#pragma unroll
      for (int nn = 0; nn < kBwdTile / 8; ++nn) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * nn + 2 * t);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx4 = 4 * nn + r, i = i0 + 8 * nn + 2 * t + (r & 1), j = key_a + 8 * (r >> 1);
          const float p = exp2_approx(st[idx4] * c - ((r & 1) ? l2.y : l2.x));
          st[idx4] = edge && !(j <= i && i < T) ? 0.f : p;
        }
      }
      to_a_frags<kBwdTile>(pa, st);
      otk::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)  // dV += P^T dO
        wgmma_rs<D>(dv, pa[j], mnmajor<D, kBwdTile>(do_t, j));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T has landed; dV is in flight
      otk::fence_regs<kN>(dpt);
#pragma unroll
      for (int nn = 0; nn < kBwdTile / 8; ++nn) {
        const float2 di = *reinterpret_cast<const float2*>(sd + 8 * nn + 2 * t);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dpt[4 * nn + r] = st[4 * nn + r] * (dpt[4 * nn + r] - ((r & 1) ? di.y : di.x));  // dS^T
      }
      wgmma_wait<0>();  // dV has landed: P^T's registers take dS^T
      otk::fence_regs<D / 2>(dv);
      otk::fence_regs<4 * kPSteps>(&pa[0][0]);
      to_a_frags<kBwdTile>(pa, dpt);
      otk::fence_regs<D / 2>(dk);
      otk::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)  // dK += dS^T Q, waited for in the next tile
        wgmma_rs<D>(dk, pa[j], mnmajor<D, kBwdTile>(q_t, j));
      wgmma_commit();
      pending = s;
    }
    wgmma_wait<0>();
    otk::fence_regs<D / 2>(dk);
    otk::fence_regs<4 * kPSteps>(&pa[0][0]);
    if (pending >= 0) warp_arrive(empty0 + 8 * pending);
    warp_arrive(kv_empty);  // K and V may be refilled
    if (!idle) {
      store_rows<D>(a.dk + w.b * a.sdk.b + w.h * a.sdk.h, a.sdk.t, k0w, T, dk, a.scale);
      store_rows<D>(a.dv + w.b * a.sdv.b + w.h * a.sdv.h, a.sdv.t, k0w, T, dv, 1.f);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return 1024 + 2 * (size_t)Tile<D, kBwdBlock>::kBytes +
         (size_t)kBwdStages * 2 * Tile<D, kBwdTile>::kBytes + (2 + 2 * kBwdStages) * sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  constexpr uint32_t kQ = Tile<D, kBwdBlock>::kBytes, kKV = Tile<D, kBwdTile>::kBytes;
  constexpr uint32_t kStage = 2 * kKV;
  constexpr int kSSteps = D / 16, kPSteps = kBwdTile / 16, kN = kBwdTile / 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (otk::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = otk::smem_u32(smem), do_s = q_s + kQ, ring = do_s + kQ;
  const uint32_t q_full = ring + kBwdStages * kStage, q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * kBwdStages;
  const int T = a.T, BH = a.B * a.H, n_blk = (T + kBwdBlock - 1) / kBwdBlock;

  if (threadIdx.x == 0) {
    otk::mbar_init(q_full, 1);
    otk::mbar_init(q_empty, kConsumers / 32);
    for (int s = 0; s < kBwdStages; ++s) {
      otk::mbar_init(full0 + 8 * s, 1);
      otk::mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    otk::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      int n = 0, base = 0;
      for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x, ++n) {
        const Item w = item_at(idx, a.H, BH, n_blk, true);
        const int q0 = w.blk * kBwdBlock;
        const int n_it = (min(q0 + kBwdBlock, T) - 1) / kBwdTile + 1;  // up to the diagonal
        if (n > 0) otk::mbar_wait(q_empty, (n - 1) & 1);
        otk::mbar_expect_tx(q_full, 2 * kQ);
        load_tile<D, kBwdBlock>(q_s, &tq, q_full, q0, w.h, w.b);
        load_tile<D, kBwdBlock>(do_s, &tdo, q_full, q0, w.h, w.b);
        for (int it = 0; it < n_it; ++it, ++base) {
          const int s = base % kBwdStages;
          if (base >= kBwdStages) otk::mbar_wait(empty0 + 8 * s, ((base / kBwdStages) - 1) & 1);
          const uint32_t dst = ring + s * kStage, full = full0 + 8 * s;
          otk::mbar_expect_tx(full, kStage);
          load_tile<D, kBwdTile>(dst, &tk, full, it * kBwdTile, w.h, w.b);
          load_tile<D, kBwdTile>(dst + kKV, &tv, full, it * kBwdTile, w.h, w.b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, t = lane & 3;
  const float c = a.c;
  int n = 0, base = 0;
  for (int idx = blockIdx.x; idx < a.n_items; idx += gridDim.x, ++n) {
    const Item w = item_at(idx, a.H, BH, n_blk, true);
    const int q0 = w.blk * kBwdBlock, q0w = q0 + 64 * wg;
    const int n_it = (min(q0 + kBwdBlock, T) - 1) / kBwdTile + 1;
    const int row_a = q0w + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // and row_a + 8
    const bool idle = q0w >= T;  // its 64 rows all lie past T
    const long long bh = (long long)w.b * a.H + w.h;
    // rows of a working warpgroup lie before Tp: the scratch holds them (zeros past T)
    float l2[2] = {0.f, 0.f}, di[2] = {0.f, 0.f};
    if (!idle) {
      const float* dis = a.aux + ((long long)BH + bh) * a.Tp;
      l2[0] = a.aux[bh * a.Tp + row_a];
      l2[1] = a.aux[bh * a.Tp + row_a + 8];
      di[0] = dis[row_a];
      di[1] = dis[row_a + 8];
    }
    float dq[D / 2];
    zero<D / 2>(dq);
    otk::mbar_wait(q_full, n & 1);

    uint32_t ds[kPSteps][4];  // dS: dQ's A operand, in flight into the next tile
    int pending = -1;         // the stage that dQ still reads
    for (int it = 0; it < n_it; ++it, ++base) {
      const int s = base % kBwdStages, j0 = it * kBwdTile;
      otk::mbar_wait(full0 + 8 * s, (base / kBwdStages) & 1);
      if (idle || j0 > q0w + 63) {  // every key of the tile after every row of this warpgroup
        warp_arrive(empty0 + 8 * s);
        continue;
      }
      const uint32_t k_t = ring + s * kStage, v_t = k_t + kKV;
      float sc[kN], dp[kN];
      zero<kN>(sc);
      zero<kN>(dp);
      otk::fence_regs<kN>(sc);
      otk::fence_regs<kN>(dp);
      otk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSSteps; ++kk)  // S = Q K^T
        otk::wgmma<kBwdTile>(sc, kmajor<D, kBwdBlock>(q_s, 64 * wg, kk),
                             kmajor<D, kBwdTile>(k_t, 0, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kSSteps; ++kk)  // dP = dO V^T
        otk::wgmma<kBwdTile>(dp, kmajor<D, kBwdBlock>(do_s, 64 * wg, kk),
                             kmajor<D, kBwdTile>(v_t, 0, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's dQ and this S have landed
      otk::fence_regs<kN>(sc);
      otk::fence_regs<D / 2>(dq);
      otk::fence_regs<4 * kPSteps>(&ds[0][0]);
      if (pending >= 0) warp_arrive(empty0 + 8 * pending);
      const bool diag = j0 + kBwdTile - 1 > q0w;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int e = (i >> 1) & 1, j = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const float p = exp2_approx(sc[i] * c - l2[e]);
        sc[i] = diag && j > row_a + 8 * e ? 0.f : p;
      }
      wgmma_wait<0>();
      otk::fence_regs<kN>(dp);
#pragma unroll
      for (int i = 0; i < kN; ++i) dp[i] = sc[i] * (dp[i] - di[(i >> 1) & 1]);  // dS
      to_a_frags<kBwdTile>(ds, dp);
      otk::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)  // dQ += dS K, waited for in the next tile
        wgmma_rs<D>(dq, ds[j], mnmajor<D, kBwdTile>(k_t, j));
      wgmma_commit();
      pending = s;
    }
    wgmma_wait<0>();
    otk::fence_regs<D / 2>(dq);
    otk::fence_regs<4 * kPSteps>(&ds[0][0]);
    if (pending >= 0) warp_arrive(empty0 + 8 * pending);
    warp_arrive(q_empty);  // Q and dO may be refilled
    if (!idle) store_rows<D>(a.dq + w.b * a.sdq.b + w.h * a.sdq.h, a.sdq.t, q0w, T, dq, a.scale);
  }
}

// ----------------------------------------------------------------- host
Strides strides_at(const long long* st, int i) { return {st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// maps of the tensors at strides st + 3 i, in 64-row boxes
bool maps(CUtensorMap* out, const void* const* ptrs, int n, const long long* st, int B, int H,
          int T, int D) {
  for (int i = 0; i < n; ++i)
    if (!otk::make_map_bhtd(out + i, ptrs[i], B, H, T, D, st + 3 * i, 64, box_cols(D)))
      return false;
  return true;
}

// a persistent grid: one block an SM, or one an item where there are fewer
int grid_for(int n_items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n_items < sms ? n_items : sms;
}

template <int D>
int launch_fwd(const CUtensorMap* m, const FwdArgs& a, cudaStream_t s) {
  cudaError_t err = set_smem(flash_fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<D><<<grid_for(a.n_items), kThreads, fwd_smem<D>(), s>>>(m[0], m[1], m[2], a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const CUtensorMap* m, const BwdArgs& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.H * a.Tp;
  flash_bwd_prep_kernel<D><<<(unsigned)((rows + kPrepRows - 1) / kPrepRows), 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = set_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>())) != cudaSuccess ||
      (err = set_smem(flash_bwd_dq_kernel<D>, dq_smem<D>())) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = grid_for(a.n_items);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), s>>>(m[0], m[1], m[2], m[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), s>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

// the items of a launch, B H ceil(T / 128), index a 32-bit int
bool shape_ok(int B, int H, int T) {
  return B >= 1 && H >= 1 && T >= 1 && (long long)B * H * ((T + 127) / 128) < (1ll << 31);
}

}  // namespace

// strides: (b, h, t) in elements of q, k, v and o (unit last stride, 16-byte
// base and strides); lse (B, H, T) f32 contiguous
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                     void* lse, const void* strides, int B, int H, int T, int D,
                                     float scale, void* stream) {
  if (!shape_ok(B, H, T)) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // the calling thread's earlier error is not this launch's
  const long long* st = static_cast<const long long*>(strides);
  const void* ptrs[3] = {q, k, v};
  CUtensorMap m[3];
  if ((D != 16 && D != 32 && D != 64 && D != 96 && D != 128) || !maps(m, ptrs, 3, st, B, H, T, D))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.so = strides_at(st, 3);
  a.B = B;
  a.H = H;
  a.T = T;
  a.n_items = B * H * ((T + kFwdBQ - 1) / kFwdBQ);
  a.c = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(m, a, s);
    case 32: return launch_fwd<32>(m, a, s);
    case 64: return launch_fwd<64>(m, a, s);
    case 96: return launch_fwd<96>(m, a, s);
    default: return launch_fwd<128>(m, a, s);
  }
}

// strides: (b, h, t) of q, k, v, o, do, dq, dk, dv; lse (B, H, T) f32
// contiguous; aux the wrapper's (2, B, H, Tp) f32 scratch, Tp = T rounded
// up to 64
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* aux, void* dq,
                                     void* dk, void* dv, const void* strides, int B, int H, int T,
                                     int D, float scale, void* stream) {
  if (!shape_ok(B, H, T)) return static_cast<int>(cudaErrorInvalidValue);
  // the calling thread's earlier error is not this launch's: autograd's
  // device thread can hold one from before its first backward
  (void)cudaGetLastError();
  const long long* st = static_cast<const long long*>(strides);
  // q, k, v, do: the do map takes do's strides (the fifth set)
  const void* ptrs[4] = {q, k, v, dout};
  const long long map_st[12] = {st[0], st[1], st[2],  st[3],  st[4],  st[5],
                                st[6], st[7], st[8], st[12], st[13], st[14]};
  CUtensorMap m[4];
  if ((D != 16 && D != 32 && D != 64 && D != 96 && D != 128) ||
      !maps(m, ptrs, 4, map_st, B, H, T, D))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.aux = static_cast<float*>(aux);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.so = strides_at(st, 3);
  a.sdo = strides_at(st, 4);
  a.sdq = strides_at(st, 5);
  a.sdk = strides_at(st, 6);
  a.sdv = strides_at(st, 7);
  a.B = B;
  a.H = H;
  a.T = T;
  a.Tp = (T + kBwdTile - 1) / kBwdTile * kBwdTile;  // whole query tiles
  a.n_items = B * H * ((T + kBwdBlock - 1) / kBwdBlock);
  a.scale = scale;
  a.c = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_bwd<16>(m, a, s);
    case 32: return launch_bwd<32>(m, a, s);
    case 64: return launch_bwd<64>(m, a, s);
    case 96: return launch_bwd<96>(m, a, s);
    default: return launch_bwd<128>(m, a, s);
  }
}
