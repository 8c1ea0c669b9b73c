// Hamburger NMF (non-negative matrix factorization by multiplicative
// updates) for GeoCalib's two LightHamHead decoders.
//
// Replaces the TPU kernel geocalib_tpu/ops/nmf_kernel.py (nmf_pallas, body
// _make_kernel). Per sample, with tokens x (N, D) and raw bases (D, R):
//   bt    = column-normalised bases, carried transposed (R, D)
//   coef  = softmax(inv_t * x bt^T)                         (N, R)
//   steps times:  coef <- coef * (x bt^T) / (coef (bt bt^T) + eps)
//                 bt   <- bt * (coef^T x) / ((coef^T coef) bt + eps)
//   a final coef update.
// Every product accumulates in float32 and is rounded to the working type
// (bf16 or f32) where nmf_kernel.py rounds it; each elementwise step rounds
// per operation. The (N, R) and (R, D) products are computed here, never by
// a library; the rank-R reconstruction coef bt is one batched product
// outside.
//
// Design, one launch per stage (bf16 kernel / float32 kernel where they differ):
//   norm   nmf_norm_kernel: column norms of the raw bases -> bt (R, D)
//   gram   nmf_gram_tc_kernel / nmf_gram_tf32_kernel: bt bt^T (R, R)
//   coef   nmf_coef_tc_kernel / nmf_coef_tf32_kernel: tiles of tokens: x bt^T,
//          then softmax (init) or the multiplicative coef update with
//          coef (bt bt^T)
//   stats  nmf_stats_tc_kernel / nmf_stats_tf32_kernel: per-block partials of
//          coef^T x and coef^T coef over chunks of tokens
//   bases  nmf_bases_kernel: sums the partials in a fixed chunk order, then
//          the multiplicative bt update with (coef^T coef) bt
// No atomics, and no block reads what another block of the same launch
// writes: every result is deterministic.
//
// bf16 instance (the serving path): the four products with N in them
// (x bt^T, coef gram, coef^T x, coef^T coef; ~99% of the flops) and bt bt^T
// run on the tensor cores, by mma.sync.m16n8k16 (bf16 in, float32
// accumulators) on operands brought from shared memory by ldmatrix
// (nmf_gram_tc_kernel, nmf_coef_tc_kernel, nmf_stats_tc_kernel). Every
// operand is already a bf16 value (gram holds bf16-rounded values), so the
// tensor cores multiply the same numbers and round at the same places as
// float32 FMA loops would; only the order of the sums differs. Tiles come in
// by 16-byte cp.async through a ring of stages, into rows padded by 16 bytes so
// that ldmatrix hits distinct banks; ragged edges are zero-filled in shared
// memory, and when D or R is not a multiple of 8 (or a pointer is not
// 16-byte aligned) the same kernels load element by element. The epilogues
// (softmax, the multiplicative update with its bf16 roundings) run on the
// accumulator registers, whose layout mma.sync fixes; only the finished
// tiles are staged through shared memory for coalesced stores. The stats
// blocks each take kSCol columns of x and a share of coef^T coef's columns,
// so that every block of the grid carries the same work. Only the column
// norms and (coef^T coef) bt (~1% of the flops) stay on float32 FMA loops.
//
// What bounds it: at request a's shape (2B = 32 samples, N = 8320, D = 512,
// R = 64, 7 steps) the products are ~314 GFLOP, 0.32 ms at the bf16
// tensor-core peak, but the staged design reads x (272.6 MB for all
// samples, more than the 50 MB L2) from device memory on every pass that
// touches it: 9 x bt^T passes and 7 coef^T x passes, 4.36 GB, ~1.3 ms at
// 3.35 TB/s. Bytes bound it. The partials are (B, ceil(N / chunk), R, D + R)
// float32; the wrapper's chunk (ops/nmf.py) sets their size, the stats grid
// and the order of the coef^T x sums. On an H100 the coef and stats passes
// stream x at ~1.9 TB/s (tools/nmf_stage_times.py), against ~2.8 TB/s for a
// plain read of x: each block waits on its own copies, 3 blocks a SM.
// The next design removes the re-reads: x kept in L2 across passes by
// running the samples in groups of ~4 (4 x 8.5 MB), or one persistent
// kernel per sample group that brings x tiles in by TMA and runs wgmma,
// with coef kept in shared memory across the coef and stats halves of a
// step.
//
// float32 instance (GeoCalib(compute_dtype="float32"), float32 evaluation
// and validation): the same five stages, the same products (and bt bt^T) on
// the tensor cores, in TF32 by mma.sync.m16n8k8 (nmf_gram_tf32_kernel,
// nmf_coef_tf32_kernel, nmf_stats_tf32_kernel). One TF32 product would round
// each operand to 11 significant bits (~3 decimal digits). Instead each
// float32 operand a is split into hi = tf32(a) and lo = tf32(a - hi) (the
// subtraction is exact; tf32 rounds to nearest, ties away, as cvt.rna does),
// and a b is accumulated in float32 as lo_a hi_b, then hi_a lo_b, then
// hi_a hi_b, the small terms first. Only lo_a lo_b (below 2^-22 of the
// product) and the bits below lo's 11 are lost: ~21 bits of each product
// against float32's 24, the size of float32's rounding of sums taken in
// another order. Each operand is split once where it is read by one warp,
// and once for all where several read it: x as the coef stage's fragments
// are loaded; bt and gram by the gram stage, which writes them as (hi, lo)
// pairs for the coef stage (gram transposed, so that it too is read along
// rows); each stats stage's x tile once into a pair buffer of the block,
// since 4 warps read each element; coef as the stats stage's fragments are
// loaded. ldmatrix moves 16-bit elements, so fragments come from shared memory
// by 32- and 64-bit loads, with row strides chosen for them: floats read along
// rows 4 mod 32 banks, down columns 8 mod 32; pairs read along rows or down
// columns 4 mod 16 (so the 16 lanes of a 64-bit half-warp hit 32 banks). Coef
// blocks take 128 tokens x 32 columns a stage, stats blocks 32 tokens x 128
// columns: 2 blocks an SM, without spills. Vector copies need D or R a
// multiple of 4.
// What bounds it: at request a's shape, in float32, the products are 313.9
// GFLOP, taken 3 times in TF32; x is 545.3 MB, and its 16 passes move 8.7 GB
// (2.60 ms at 3.35 TB/s). On an NVIDIA H100 80GB HBM3 at 700 W, mma.sync
// issues TF32 at ~320 TFLOP/s, under two thirds of the 495 that wgmma
// reaches, which puts the products at ~2.9 ms. The stages reach neither
// floor: their copies, splits, fragment loads from shared memory and
// products run one after another rather than beside each other (PERF.md
// gives the card's times; tools/nmf_f32_variants.py times the stages with
// each part taken out, tools/nmf_stage_times.py the mma.sync rates).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;      // columns (and ranks) per block tile of the bases stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each in the bases stage
constexpr int kPad = kTile + 1;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bt[r, :] = bases[:, r] / (||bases[:, r]|| + eps), rounded as nmf_kernel.py does.
template <typename T>
__global__ void nmf_norm_kernel(const T* bases, T* bt, int D, int R, float eps) {
  const int r = blockIdx.x, b = blockIdx.y;
  const T* src = bases + static_cast<size_t>(b) * D * R;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = ld(src, static_cast<size_t>(d) * R + r);
    s += v * v;
  }
  __shared__ float red[kThreads / 32];
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) tot += red[i];
  const float denom = rnd<T>(rnd<T>(sqrtf(tot)) + eps);
  T* dst = bt + (static_cast<size_t>(b) * R + r) * D;
  for (int d = threadIdx.x; d < D; d += kThreads)
    st(dst, d, ld(src, static_cast<size_t>(d) * R + r) / denom);
}

// bt <- bt * round(coef^T x) / (round(round(coef^T coef) bt) + eps) for one
// 64-column tile; the chunk partials are summed in chunk order, the chunk loop
// outermost so that each thread's loads of one chunk are in flight together.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nmf_bases_kernel(const float* partial, T* bt, int chunks, int D, int R, float eps) {
  __shared__ float sm[2][kTile][kPad];
  constexpr int kPer = kTile * kTile / kThreads;
  const int c0 = blockIdx.x * kTile, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t stride = static_cast<size_t>(R) * (D + R);
  const float* pb = partial + static_cast<size_t>(b) * chunks * stride;
  T* btb = bt + static_cast<size_t>(b) * R * D;

  float q[kPer] = {};
  for (int c = 0; c < chunks; ++c) {
    const float* pc = pb + c * stride + D;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = threadIdx.x + t * kThreads, i = e / kTile, j = e % kTile;
      if (i < R && j < R) q[t] += pc[static_cast<size_t>(i) * (D + R) + j];
    }
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = threadIdx.x + t * kThreads, i = e / kTile, j = e % kTile;
    sm[0][i][j] = rnd<T>(q[t]);  // 0 outside R x R
    sm[1][i][j] = (i < R && c0 + j < D) ? ld(btb, static_cast<size_t>(i) * D + c0 + j) : 0.f;
  }
  float num[4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    const float* pc = pb + c * stride;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = ty + 16 * i, d = c0 + tx + 16 * k;
        if (r < R && d < D) num[i][k] += pc[static_cast<size_t>(r) * (D + R) + d];
      }
  }
  __syncthreads();
  float den[4][4] = {};
  for (int s = 0; s < R; ++s) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sm[0][ty + 16 * i][s], c[i] = sm[1][s][tx + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) den[i][k] += a[i] * c[k];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 16 * i, d = c0 + tx + 16 * k;
      if (r < R && d < D) {
        const float v = rnd<T>(sm[1][r][tx + 16 * k] * rnd<T>(num[i][k]));
        st(btb, static_cast<size_t>(r) * D + d, v / rnd<T>(rnd<T>(den[i][k]) + eps));
      }
    }
}

// ---- bf16 instance: the products with N in them on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int kTok = 128;          // tokens per coef block: 8 warps x 16 rows
constexpr int kRk = 64;            // ranks, R padded with zeros
constexpr int kDK = 64;            // depth (columns of x or bt) per pipeline stage
constexpr int kLd = kDK + 8;       // bf16 row stride of a [.][64] tile: +16 bytes
constexpr int kSTok = 32;          // tokens per pipeline stage of the stats block
constexpr int kSCol = 128;         // columns of x per stats block
constexpr int kXLd = kSCol + 8;    // bf16 row stride of the stats block's x tile
constexpr int kCoefStages = 2, kStatsStages = 4, kGramStages = 2;

constexpr int kCoefStage = (kTok + kRk) * kLd;      // x and bt tiles, or coef and gram tiles
constexpr int kStatsStage = kSTok * (kLd + kXLd);   // coef tile + x tile, elements
constexpr int kCoefSmem = kCoefStages * kCoefStage * 2;                 // 55,296 bytes
constexpr int kStatsSmem = kStatsStages * kStatsStage * 2;              // 53,248 bytes
constexpr int kGramSmem = kGramStages * kRk * kLd * 2;                  // 18,432 bytes
static_assert(kRk == kDK, "the coef and gram tiles take the shape of an x and bt stage");
static_assert(kRk * kLd * 2 <= kGramSmem, "gram staging must fit in the stages");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix: four 8x8 bf16 matrices, each thread giving one row address
// (lanes 8i..8i+7 the rows of matrix i, which lands in register i).
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// d += a b: a 16x16 (row), b 16x8 (col), d 16x8 float32. With g = lane / 4 and
// t = lane % 4, d holds rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns
// 2t and 2t + 1.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Where each lane points ldmatrix for one operand tile, by how the tile is stored:
//   A 16x16 from [m][k] rows (ldsm):       a_row(lane) * ld + a_col(lane)
//   A 16x16 from [k][m] rows (ldsm_t):     at_row(lane) * ld + at_col(lane)
//   B 16(k)x16(n), two n8 tiles, from [n][k] rows (ldsm): at_row / at_col
//   B 16(k)x16(n), two n8 tiles, from [k][n] rows (ldsm_t): a_row / a_col
// Registers: A gives a[0..3]; B gives b0, b1 of the first n8 tile in r[0], r[1]
// and of the second in r[2], r[3].
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int at_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int at_col(int lane) { return ((lane >> 3) & 1) << 3; }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }

// ROWS x COLS of a bf16, float32 or (hi, lo) pair matrix with row stride `stride` (elements)
// into shared memory with row stride LD; rows >= nr and columns >= nc are zero.
// vec: 16-byte copies are legal (stride and base 16-byte aligned).
template <int ROWS, int COLS, int LD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int stride, int nr, int nc,
                                          bool vec) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kVecs = COLS / kV;
  for (int e = threadIdx.x; e < ROWS * kVecs; e += kThreads) {
    const int i = e / kVecs, j = (e % kVecs) * kV;
    T* d = dst + i * LD + j;
    const T* g = src + static_cast<size_t>(i) * stride + j;
    if (vec && i < nr && j + kV <= nc) {
      cp_async16(d, g);
    } else {
#pragma unroll
      for (int q = 0; q < kV; ++q) d[q] = (i < nr && j + q < nc) ? g[q] : zero<T>();
    }
  }
}

// rows x kRk values of a shared-memory tile (row stride LD) -> rows of R values
// (row stride R) in global memory, the first nr rows; 16-byte stores when vec.
template <int LD = kLd, typename T>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int rows, int nr, int R,
                                           bool vec) {
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kRk / kV); e += kThreads) {
      const int i = e / (kRk / kV), j = (e % (kRk / kV)) * kV;
      if (i < nr && j < R)
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(i) * R + j) =
            *reinterpret_cast<const uint4*>(src + i * LD + j);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kRk; e += kThreads) {
      const int i = e / kRk, j = e % kRk;
      if (i < nr && j < R) dst[static_cast<size_t>(i) * R + j] = src[i * LD + j];
    }
  }
}

__device__ __forceinline__ void st2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
// rnd<bf16> of two values with one packed conversion
__device__ __forceinline__ void rnd2(float& lo, float& hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  lo = __low2float(h);
  hi = __high2float(h);
}

// n stages through a ring of STAGES shared-memory buffers: load(s) issues the
// copies of stage s into buffer s % STAGES, compute(s) consumes it. Groups are
// committed even when empty, so wait_group<STAGES - 1> always means stage s landed.
template <int STAGES, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int n, Load load, Compute compute) {
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    if (s + STAGES - 1 < n) load(s + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    compute(s);
    __syncthreads();
  }
}

// gram[b] = round(bt bt^T), (R, R) bf16 in the gram scratch; warp w owns rows
// 16 (w % 4).. and columns 32 (w / 4)...
__global__ void __launch_bounds__(kThreads)
nmf_gram_tc_kernel(const bf16* bt, bf16* gram, int D, int R, int vec_x, int vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = 16 * (warp % 4), wc = 32 * (warp / 4);
  const bf16* bb = bt + static_cast<size_t>(b) * R * D;
  float acc[4][4] = {};
  pipeline<kGramStages>(
      (D + kDK - 1) / kDK,
      [&](int s) {
        load_tile<kRk, kDK, kLd>(stages + (s % kGramStages) * kRk * kLd, bb + s * kDK, D, R,
                                 D - s * kDK, vec_x);
      },
      [&](int s) {
        const bf16* ts = stages + (s % kGramStages) * kRk * kLd;
#pragma unroll
        for (int k = 0; k < kDK; k += 16) {
          unsigned a[4], bq[4];
          ldsm(a, ts + (wr + a_row(lane)) * kLd + k + a_col(lane));
#pragma unroll
          for (int j = 0; j < 2; ++j) {  // bt[s][d] is B = bt^T stored [n][k]
            ldsm(bq, ts + (wc + 16 * j + at_row(lane)) * kLd + k + at_col(lane));
            mma(acc[2 * j], a, bq[0], bq[1]);
            mma(acc[2 * j + 1], a, bq[2], bq[3]);
          }
        }
      });
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bf16* o = stages + (wr + g) * kLd + wc + 8 * n + 2 * t;
    st2(o, acc[n][0], acc[n][1]);
    st2(o + 8 * kLd, acc[n][2], acc[n][3]);
  }
  __syncthreads();
  store_tile(gram + static_cast<size_t>(b) * R * R, stages, kRk, R, R, vec_c);
}

// One tile of kTok tokens, warp w owning tokens 16w..16w+15 and all 64 ranks.
// INIT: coef = softmax(inv_t * round(x bt^T)).
// Otherwise: coef <- round(coef * round(x bt^T)) / round(round(coef gram) + eps), in place.
// The update's coef and gram tiles come in as one more stage of the ring, in
// the places of the x and bt tiles.
template <bool INIT>
__global__ void __launch_bounds__(kThreads, 3)
nmf_coef_tc_kernel(const bf16* x, const bf16* bt, const bf16* gram, bf16* coef, int N, int D,
                   int R, float inv_t, float eps, int vec_x, int vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);

  const int b = blockIdx.y, n0 = blockIdx.x * kTok;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nr = min(kTok, N - n0);
  const bf16* xb = x + (static_cast<size_t>(b) * N + n0) * D;
  const bf16* bb = bt + static_cast<size_t>(b) * R * D;
  bf16* cb = coef + (static_cast<size_t>(b) * N + n0) * R;
  const int nd = (D + kDK - 1) / kDK;

  float acc[8][4] = {};  // n8 tile n: ranks 8n + 2t, +1 of tokens g and g + 8
  pipeline<kCoefStages>(
      INIT ? nd : nd + 1,
      [&](int s) {
        bf16* xs = stages + (s % kCoefStages) * kCoefStage;
        if (s == nd) {
          load_tile<kTok, kRk, kLd>(xs, cb, R, nr, R, vec_c);
          load_tile<kRk, kRk, kLd>(xs + kTok * kLd, gram + static_cast<size_t>(b) * R * R, R, R,
                                   R, vec_c);
          return;
        }
        const int d0 = s * kDK;
        load_tile<kTok, kDK, kLd>(xs, xb + d0, D, nr, D - d0, vec_x);
        load_tile<kRk, kDK, kLd>(xs + kTok * kLd, bb + d0, D, R, D - d0, vec_x);
      },
      [&](int s) {
        if (s == nd) return;
        const bf16* xs = stages + (s % kCoefStages) * kCoefStage + warp * 16 * kLd;
        const bf16* bs = stages + (s % kCoefStages) * kCoefStage + kTok * kLd;
#pragma unroll
        for (int k = 0; k < kDK; k += 16) {
          unsigned a[4], bq[4];
          ldsm(a, xs + a_row(lane) * kLd + k + a_col(lane));
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // bt[r][d] is B = bt^T stored [n][k]
            ldsm(bq, bs + (16 * j + at_row(lane)) * kLd + k + at_col(lane));
            mma(acc[2 * j], a, bq[0], bq[1]);
            mma(acc[2 * j + 1], a, bq[2], bq[3]);
          }
        }
      });

  // the output tile goes to the slot the last stage did not use
  bf16* tile = stages + ((INIT ? nd : nd + 1) % kCoefStages) * kCoefStage;
  if (INIT) {
    // softmax over the R ranks of rows g and g + 8; a row's values sit in the
    // four lanes of its group, so the max and the sum end in two shuffles
    float mx[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& v0 = acc[n][2 * h];
        float& v1 = acc[n][2 * h + 1];
        rnd2(v0, v1);
        v0 *= inv_t;
        v1 *= inv_t;
        rnd2(v0, v1);
        if (8 * n + 2 * t < R) mx[h] = fmaxf(mx[h], v0);
        if (8 * n + 2 * t + 1 < R) mx[h] = fmaxf(mx[h], v1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      for (int off = 1; off < 4; off *= 2)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = 8 * n + 2 * t + (e & 1) < R ? expf(acc[n][e] - mx[e >> 1]) : 0.f;
        sum[e >> 1] += acc[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      for (int off = 1; off < 4; off *= 2) sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] /= sum[e >> 1];
  } else {
    // denominator coef gram on the tensor cores, 16 ranks at a time; coef in
    // the product's layout straight from the coef tile
    const bf16* crow = stages + (nd % kCoefStages) * kCoefStage + warp * 16 * kLd;
    const bf16* gtile = stages + (nd % kCoefStages) * kCoefStage + kTok * kLd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float den[2][4] = {};
      for (int k = 0; k < R; k += 16) {
        unsigned a[4], bq[4];
        ldsm(a, crow + a_row(lane) * kLd + k + a_col(lane));
        ldsm_t(bq, gtile + (k + a_row(lane)) * kLd + 16 * j + a_col(lane));  // gram stored [k][n]
        mma(den[0], a, bq[0], bq[1]);
        mma(den[1], a, bq[2], bq[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * j + i;
          const __nv_bfloat162 c2 =
              *reinterpret_cast<const __nv_bfloat162*>(crow + (g + 8 * h) * kLd + 8 * n + 2 * t);
          float& v0 = acc[n][2 * h];
          float& v1 = acc[n][2 * h + 1];
          float d0 = den[i][2 * h], d1 = den[i][2 * h + 1];
          rnd2(v0, v1);
          v0 *= __low2float(c2);
          v1 *= __high2float(c2);
          rnd2(v0, v1);
          rnd2(d0, d1);
          d0 += eps;
          d1 += eps;
          rnd2(d0, d1);
          v0 /= d0;
          v1 /= d1;
        }
    }
  }
  bf16* out = tile + warp * 16 * kLd;  // this warp's rows of the output tile
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    st2(out + g * kLd + 8 * n + 2 * t, acc[n][0], acc[n][1]);
    st2(out + (g + 8) * kLd + 8 * n + 2 * t, acc[n][2], acc[n][3]);
  }
  __syncthreads();
  store_tile(cb, tile, kTok, nr, R, vec_c);
}

// Partials over one chunk of tokens for kSCol columns of x: coef^T x, and
// the block's share of the columns of coef^T coef (16-column groups g with
// g % column tiles == blockIdx.x), so that all blocks carry the same work.
// Output: the (B, chunks, R, D + R) float32 layout that nmf_bases_kernel sums.
// Warp w owns ranks 16 (w % 4).. and columns 64 (w / 4).. of coef^T x, and
// the groups g of its block with (g / tiles) % 2 == w / 4 of coef^T coef.
__global__ void __launch_bounds__(kThreads, 3)
nmf_stats_tc_kernel(const bf16* x, const bf16* coef, float* partial, int N, int D, int R,
                    int chunk, int vec_x, int vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const int tiles = gridDim.x;
  const int c0 = blockIdx.x * kSCol, ch = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp % 4), wc = 64 * (warp / 4);
  // this warp's groups of coef^T coef: blockIdx.x + tiles * (warp / 4 + 2 i), i = 0, 1
  const int gs[2] = {static_cast<int>(blockIdx.x) + tiles * (warp / 4),
                     static_cast<int>(blockIdx.x) + tiles * (warp / 4 + 2)};
  const bf16* xb = x + static_cast<size_t>(b) * N * D;
  const bf16* cb = coef + static_cast<size_t>(b) * N * R;
  const int nbeg = ch * chunk, nend = min(N, nbeg + chunk);

  float acc[8][4] = {}, accg[2][2][4] = {};
  pipeline<kStatsStages>(
      (nend - nbeg + kSTok - 1) / kSTok,
      [&](int s) {
        bf16* cs = stages + (s % kStatsStages) * kStatsStage;
        const int t0 = nbeg + s * kSTok;
        load_tile<kSTok, kRk, kLd>(cs, cb + static_cast<size_t>(t0) * R, R, nend - t0, R, vec_c);
        load_tile<kSTok, kSCol, kXLd>(cs + kSTok * kLd, xb + static_cast<size_t>(t0) * D + c0, D,
                                      nend - t0, D - c0, vec_x);
      },
      [&](int s) {
        const bf16* cs = stages + (s % kStatsStages) * kStatsStage;
        const bf16* xs = cs + kSTok * kLd;
#pragma unroll
        for (int k = 0; k < kSTok; k += 16) {
          unsigned a[4], bq[4];
          ldsm_t(a, cs + (k + at_row(lane)) * kLd + wr + at_col(lane));  // coef^T, stored [k][m]
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // x stored [k][n]
            ldsm_t(bq, xs + (k + a_row(lane)) * kXLd + wc + 16 * j + a_col(lane));
            mma(acc[2 * j], a, bq[0], bq[1]);
            mma(acc[2 * j + 1], a, bq[2], bq[3]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (gs[i] < kRk / 16) {  // coef stored [k][n]
              ldsm_t(bq, cs + (k + a_row(lane)) * kLd + 16 * gs[i] + a_col(lane));
              mma(accg[i][0], a, bq[0], bq[1]);
              mma(accg[i][1], a, bq[2], bq[3]);
            }
        }
      });

  // straight from the accumulators: rows wr + g and wr + g + 8, column pairs
  // 2t, 2t + 1 (8-byte stores where the row stride and the column are even:
  // coef^T coef's columns start at D, which may be odd)
  float* out = partial + (static_cast<size_t>(b) * gridDim.y + ch) * R * (D + R);
  const bool pairs = (D + R) % 2 == 0;
  auto put = [&](int col, int ncol, const float (&d)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr + g + 8 * h;
      if (row >= R) continue;
      float* o = out + static_cast<size_t>(row) * (D + R) + col;
      if (pairs && col % 2 == 0 && col + 1 < ncol) {
        *reinterpret_cast<float2*>(o) = make_float2(d[2 * h], d[2 * h + 1]);
      } else {
        if (col < ncol) o[0] = d[2 * h];
        if (col + 1 < ncol) o[1] = d[2 * h + 1];
      }
    }
  };
#pragma unroll
  for (int n = 0; n < 8; ++n) put(c0 + wc + 8 * n + 2 * t, D, acc[n]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (gs[i] < kRk / 16) {
      put(D + 16 * gs[i] + 2 * t, D + R, accg[i][0]);
      put(D + 16 * gs[i] + 8 + 2 * t, D + R, accg[i][1]);
    }
}

// ---- float32 instance: the same products on TF32 tensor cores, three products each ----

constexpr int kFDK = 32;           // depth (columns of x and bt) per coef pipeline stage
constexpr int kFLd = kFDK + 4;     // coef block's x tile, floats, read along rows: 4 mod 32 banks
constexpr int kF2Ld = kFDK + 4;    // coef block's bt tile, (hi, lo) pairs, read along rows: 4 mod 16
constexpr int kFULd = kRk + 4;     // the update's coef (floats) and gram (pairs) tiles, read along rows
constexpr int kFTLd = kRk + 8;     // stats block's coef tile, floats, read down columns: 8 mod 32
constexpr int kFX2Ld = kSCol + 4;  // stats block's x tile as pairs, read down columns: 4 mod 16
constexpr int kFGDK = 64;          // depth per gram pipeline stage
constexpr int kFGLd = kFGDK + 4;   // gram block's bt tile, floats, read along rows
constexpr int kFMT = 1;             // m16 tiles of tokens a coef warp
constexpr int kFTok = 8 * 16 * kFMT;  // tokens per coef block
constexpr int kFCoefBlocks = 2;      // coef blocks an SM (3 would cap registers at 80: spills)
constexpr int kFCoefStages = 2, kFStatsStages = 3, kFGramStages = 2;

constexpr int kFCoefStage = kFTok * kFLd + 2 * kRk * kF2Ld;  // floats: x tile, bt pair tile
constexpr int kFStatsStage = kSTok * (kFTLd + kSCol);        // floats: coef tile, x tile as read
constexpr int kFCoefSmem = kFCoefStages * kFCoefStage * 4;                            // 73,728
constexpr int kFStatsSmem = kFStatsStages * kFStatsStage * 4 + kSTok * kFX2Ld * 8;  // 110,592
constexpr int kFGramSmem = kFGramStages * kRk * kFGLd * 4;                            // 34,816
static_assert((kFTok + 2 * kRk) * kFULd * 4 <= kFCoefSmem,
              "the update's coef and gram tiles fit in the ring");
static_assert(kFLd % 32 == 4 && kFTLd % 32 == 8 && kFGLd % 32 == 4 && kFULd % 32 == 4 &&
                  kF2Ld % 16 == 4 && kFX2Ld % 16 == 4,
              "row strides chosen for conflict-free fragment loads");
static_assert(kFCoefBlocks * (kFCoefSmem + 1024) <= 233472 && 2 * (kFStatsSmem + 1024) <= 233472,
              "kFCoefBlocks coef or two stats blocks fit in an SM's shared memory");

// tf32(a): a rounded to 10 mantissa bits, to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds. On sm_90a that instruction compiles to 4 SASS
// instructions (a guard for NaN and infinity among them); this form is 2 and
// gives the same bits for every finite a (tools/nmf_f32_variants.py, cvt_rna).
__device__ __forceinline__ unsigned tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
// a = hi + lo: hi = tf32(a), lo = tf32(a - hi); a - hi is exact in float32.
__device__ __forceinline__ void split(float a, unsigned& hi, unsigned& lo) {
  hi = tf32(a);
  lo = tf32(a - __uint_as_float(hi));
}
__device__ __forceinline__ float2 split2(float a) {
  unsigned hi, lo;
  split(a, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// An m16n8k8 operand held as its hi and lo parts: A gives 4 registers, B 2.
template <int K>
struct Frag {
  unsigned hi[K], lo[K];
};
// A 16x8 at p, floats stored [m][k] with row stride LD, split as it is loaded.
// With g = lane / 4, t = lane % 4, a[0..3] hold (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4).
template <int LD>
__device__ __forceinline__ Frag<4> frag_a_mk(const float* p, int g, int t) {
  Frag<4> f;
  split(p[g * LD + t], f.hi[0], f.lo[0]);
  split(p[(g + 8) * LD + t], f.hi[1], f.lo[1]);
  split(p[g * LD + t + 4], f.hi[2], f.lo[2]);
  split(p[(g + 8) * LD + t + 4], f.hi[3], f.lo[3]);
  return f;
}
// A 16x8 at p, floats stored [k][m]
template <int LD>
__device__ __forceinline__ Frag<4> frag_a_km(const float* p, int g, int t) {
  Frag<4> f;
  split(p[t * LD + g], f.hi[0], f.lo[0]);
  split(p[t * LD + g + 8], f.hi[1], f.lo[1]);
  split(p[(t + 4) * LD + g], f.hi[2], f.lo[2]);
  split(p[(t + 4) * LD + g + 8], f.hi[3], f.lo[3]);
  return f;
}
// B 8(k)x8(n) at p, floats stored [n][k]: b[0], b[1] hold (k = t, n = g), (t + 4, g)
template <int LD>
__device__ __forceinline__ Frag<2> frag_b_nk(const float* p, int g, int t) {
  Frag<2> f;
  split(p[g * LD + t], f.hi[0], f.lo[0]);
  split(p[g * LD + t + 4], f.hi[1], f.lo[1]);
  return f;
}
// B 8(k)x8(n) at p, floats stored [k][n]
template <int LD>
__device__ __forceinline__ Frag<2> frag_b_kn(const float* p, int g, int t) {
  Frag<2> f;
  split(p[t * LD + g], f.hi[0], f.lo[0]);
  split(p[(t + 4) * LD + g], f.hi[1], f.lo[1]);
  return f;
}
// B 8(k)x8(n) at p, (hi, lo) pairs already split, stored [n][k] (row stride LD pairs)
template <int LD>
__device__ __forceinline__ Frag<2> frag_b_nk2(const float2* p, int g, int t) {
  const float2 v0 = p[g * LD + t], v1 = p[g * LD + t + 4];
  return {{__float_as_uint(v0.x), __float_as_uint(v1.x)},
          {__float_as_uint(v0.y), __float_as_uint(v1.y)}};
}
// B 8(k)x8(n) at p, (hi, lo) pairs stored [k][n]
template <int LD>
__device__ __forceinline__ Frag<2> frag_b_kn2(const float2* p, int g, int t) {
  const float2 v0 = p[t * LD + g], v1 = p[(t + 4) * LD + g];
  return {{__float_as_uint(v0.x), __float_as_uint(v1.x)},
          {__float_as_uint(v0.y), __float_as_uint(v1.y)}};
}

// d += a b, a 16x8 (row), b 8x8 (col), TF32 in, float32 accumulators laid out
// as for mma() above.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b at float32 accuracy: the three products, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ void st2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// gram = bt bt^T, and the operands the coef stage reads from this step's bt,
// split once here rather than by each coef block: bt2 (R, D) and gram2 (R, R)
// as (hi, lo) pairs, gram2 transposed (row r holds column r of bt bt^T) so
// that the coef stage reads it along rows. One block a sample; warp w owns
// rows 16 (w % 4).. and columns 32 (w / 4).. of bt bt^T.
__global__ void __launch_bounds__(kThreads)
nmf_gram_tf32_kernel(const float* bt, float2* bt2, float2* gram2, int D, int R, int vec_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp % 4), wc = 32 * (warp / 4);
  const float* bb = bt + static_cast<size_t>(b) * R * D;
  float2* b2 = bt2 + static_cast<size_t>(b) * R * D;
  float acc[4][4] = {};
  pipeline<kFGramStages>(
      (D + kFGDK - 1) / kFGDK,
      [&](int s) {
        load_tile<kRk, kFGDK, kFGLd>(stages + (s % kFGramStages) * kRk * kFGLd, bb + s * kFGDK,
                                     D, R, D - s * kFGDK, vec_x);
      },
      [&](int s) {
        const float* ts = stages + (s % kFGramStages) * kRk * kFGLd;
        for (int e = threadIdx.x; e < kRk * kFGDK; e += kThreads) {
          const int i = e / kFGDK, j = e % kFGDK, d = s * kFGDK + j;
          if (i < R && d < D) b2[static_cast<size_t>(i) * D + d] = split2(ts[i * kFGLd + j]);
        }
#pragma unroll
        for (int k = 0; k < kFGDK; k += 8) {
          const Frag<4> a = frag_a_mk<kFGLd>(ts + wr * kFGLd + k, g, t);
#pragma unroll
          for (int n = 0; n < 4; ++n)  // B = bt^T, stored [n][k] as bt's rows
            mma3(acc[n], a, frag_b_nk<kFGLd>(ts + (wc + 8 * n) * kFGLd + k, g, t));
        }
      });
  float2* g2 = gram2 + static_cast<size_t>(b) * R * R;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // element (row, col) of bt bt^T goes to gram2[col][row]
      const int row = wr + g + 8 * (e >> 1), col = wc + 8 * n + 2 * t + (e & 1);
      if (row < R && col < R) g2[col * R + row] = split2(acc[n][e]);
    }
}

// One tile of kFTok tokens, warp w owning kFMT m16 tiles of tokens from
// 16 kFMT w (each bt fragment loaded serves kFMT products) and all 64 ranks.
// INIT: coef = softmax(inv_t * x bt^T).
// Otherwise: coef <- coef * (x bt^T) / (coef gram + eps), in place.
// x comes in as floats and is split as its fragments are loaded (each element
// is read by one warp); bt as the gram stage's (hi, lo) pairs. After the ring,
// the update's coef tile and gram pairs take its place; the output tile is
// written over the coef tile, each warp over its own rows.
template <bool INIT>
__global__ void __launch_bounds__(kThreads, kFCoefBlocks)
nmf_coef_tf32_kernel(const float* x, const float2* bt2, const float2* gram2, float* coef, int N,
                     int D, int R, float inv_t, float eps, int vec_x, int vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);

  const int b = blockIdx.y, n0 = blockIdx.x * kFTok;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nr = min(kFTok, N - n0);
  const float* xb = x + (static_cast<size_t>(b) * N + n0) * D;
  const float2* bb = bt2 + static_cast<size_t>(b) * R * D;
  float* cb = coef + (static_cast<size_t>(b) * N + n0) * R;

  // m16 tile m, n8 tile n: ranks 8n + 2t, +1 of tokens 16 (kFMT w + m) + g and + 8
  float acc[kFMT][8][4] = {};
  pipeline<kFCoefStages>(
      (D + kFDK - 1) / kFDK,
      [&](int s) {
        float* xs = stages + (s % kFCoefStages) * kFCoefStage;
        const int d0 = s * kFDK;
        load_tile<kFTok, kFDK, kFLd>(xs, xb + d0, D, nr, D - d0, vec_x);
        load_tile<kRk, kFDK, kF2Ld>(reinterpret_cast<float2*>(xs + kFTok * kFLd), bb + d0, D, R,
                                    D - d0, vec_x);
      },
      [&](int s) {
        const float* xs = stages + (s % kFCoefStages) * kFCoefStage + warp * 16 * kFMT * kFLd;
        const float2* bs = reinterpret_cast<const float2*>(
            stages + (s % kFCoefStages) * kFCoefStage + kFTok * kFLd);
#pragma unroll
        for (int k = 0; k < kFDK; k += 8) {
          Frag<4> a[kFMT];
#pragma unroll
          for (int m = 0; m < kFMT; ++m) a[m] = frag_a_mk<kFLd>(xs + 16 * m * kFLd + k, g, t);
#pragma unroll
          for (int n = 0; n < 8; ++n) {  // B = bt^T, stored [n][k] as bt's rows
            const Frag<2> bq = frag_b_nk2<kF2Ld>(bs + 8 * n * kF2Ld + k, g, t);
#pragma unroll
            for (int m = 0; m < kFMT; ++m) mma3(acc[m][n], a[m], bq);
          }
        }
      });

  float* ct = stages;                                              // coef tile [token][s]
  float2* gt = reinterpret_cast<float2*>(stages + kFTok * kFULd);  // gram pairs [r][s]
  float* rows = ct + warp * 16 * kFMT * kFULd;  // this warp's rows of the coef and output tiles
  if (INIT) {
    // softmax over the R ranks of rows g and g + 8 of each m16 tile, whose
    // values sit in the four lanes of a group: the max and the sum end in two shuffles
#pragma unroll
    for (int m = 0; m < kFMT; ++m) {
      float mx[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][n][e] *= inv_t;
          if (8 * n + 2 * t + (e & 1) < R) mx[e >> 1] = fmaxf(mx[e >> 1], acc[m][n][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        for (int off = 1; off < 4; off *= 2)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][n][e] = 8 * n + 2 * t + (e & 1) < R ? expf(acc[m][n][e] - mx[e >> 1]) : 0.f;
          sum[e >> 1] += acc[m][n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        for (int off = 1; off < 4; off *= 2) sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] /= sum[e >> 1];
    }
  } else {
    load_tile<kFTok, kRk, kFULd>(ct, cb, R, nr, R, vec_c);
    load_tile<kRk, kRk, kFULd>(gt, gram2 + static_cast<size_t>(b) * R * R, R, R, R, vec_c);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // denominator coef gram on the tensor cores, 16 tokens and 16 ranks at a time
#pragma unroll
    for (int m = 0; m < kFMT; ++m) {
      const float* crow = rows + 16 * m * kFULd;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float den[2][4] = {};
        for (int k = 0; k < R; k += 8) {
          const Frag<4> a = frag_a_mk<kFULd>(crow + k, g, t);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma3(den[i], a, frag_b_nk2<kFULd>(gt + (16 * j + 8 * i) * kFULd + k, g, t));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = 2 * j + i;
            const float2 c2 =
                *reinterpret_cast<const float2*>(crow + (g + 8 * h) * kFULd + 8 * n + 2 * t);
            acc[m][n][2 * h] = c2.x * acc[m][n][2 * h] / (den[i][2 * h] + eps);
            acc[m][n][2 * h + 1] = c2.y * acc[m][n][2 * h + 1] / (den[i][2 * h + 1] + eps);
          }
      }
    }
    __syncwarp();  // the warp's reads of its coef rows end before they are overwritten
  }
#pragma unroll
  for (int m = 0; m < kFMT; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st2(rows + (16 * m + g) * kFULd + 8 * n + 2 * t, acc[m][n][0], acc[m][n][1]);
      st2(rows + (16 * m + g + 8) * kFULd + 8 * n + 2 * t, acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
  store_tile<kFULd>(cb, ct, kFTok, nr, R, vec_c);
}

// Partials over one chunk of tokens for kSCol columns of x, laid out and shared
// among the warps and blocks as in nmf_stats_tc_kernel: coef^T x, and the
// block's share of the 16-column groups of coef^T coef. Each x element is read
// by 4 warps, so each stage's x tile is split once into (hi, lo) pairs in a
// buffer of its own before the products; coef is split as it is loaded.
__global__ void __launch_bounds__(kThreads, 2)
nmf_stats_tf32_kernel(const float* x, const float* coef, float* partial, int N, int D, int R,
                      int chunk, int vec_x, int vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float2* x2 = reinterpret_cast<float2*>(stages + kFStatsStages * kFStatsStage);
  const int tiles = gridDim.x;
  const int c0 = blockIdx.x * kSCol, ch = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp % 4), wc = 64 * (warp / 4);
  const int gs[2] = {static_cast<int>(blockIdx.x) + tiles * (warp / 4),
                     static_cast<int>(blockIdx.x) + tiles * (warp / 4 + 2)};
  const float* xb = x + static_cast<size_t>(b) * N * D;
  const float* cb = coef + static_cast<size_t>(b) * N * R;
  const int nbeg = ch * chunk, nend = min(N, nbeg + chunk);

  float acc[8][4] = {}, accg[2][2][4] = {};
  pipeline<kFStatsStages>(
      (nend - nbeg + kSTok - 1) / kSTok,
      [&](int s) {
        float* cs = stages + (s % kFStatsStages) * kFStatsStage;
        const int t0 = nbeg + s * kSTok;
        load_tile<kSTok, kRk, kFTLd>(cs, cb + static_cast<size_t>(t0) * R, R, nend - t0, R,
                                     vec_c);
        load_tile<kSTok, kSCol, kSCol>(cs + kSTok * kFTLd, xb + static_cast<size_t>(t0) * D + c0,
                                       D, nend - t0, D - c0, vec_x);
      },
      [&](int s) {
        const float* cs = stages + (s % kFStatsStages) * kFStatsStage;
        const float* xs = cs + kSTok * kFTLd;
        for (int e = threadIdx.x; e < kSTok * kSCol / 4; e += kThreads) {
          const int k = e / (kSCol / 4), n = (e % (kSCol / 4)) * 4;
          const float4 v = *reinterpret_cast<const float4*>(xs + k * kSCol + n);
          const float2 p0 = split2(v.x), p1 = split2(v.y), p2 = split2(v.z), p3 = split2(v.w);
          float4* d = reinterpret_cast<float4*>(x2 + k * kFX2Ld + n);
          d[0] = make_float4(p0.x, p0.y, p1.x, p1.y);
          d[1] = make_float4(p2.x, p2.y, p3.x, p3.y);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kSTok; k += 8) {
          const Frag<4> a = frag_a_km<kFTLd>(cs + k * kFTLd + wr, g, t);  // coef^T, stored [k][m]
#pragma unroll
          for (int n = 0; n < 8; ++n)  // x stored [k][n]
            mma3(acc[n], a, frag_b_kn2<kFX2Ld>(x2 + k * kFX2Ld + wc + 8 * n, g, t));
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (gs[i] < kRk / 16) {  // coef stored [k][n]
#pragma unroll
              for (int q = 0; q < 2; ++q)
                mma3(accg[i][q], a, frag_b_kn<kFTLd>(cs + k * kFTLd + 16 * gs[i] + 8 * q, g, t));
            }
        }
      });

  float* out = partial + (static_cast<size_t>(b) * gridDim.y + ch) * R * (D + R);
  const bool pairs = (D + R) % 2 == 0;
  auto put = [&](int col, int ncol, const float (&d)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr + g + 8 * h;
      if (row >= R) continue;
      float* o = out + static_cast<size_t>(row) * (D + R) + col;
      if (pairs && col % 2 == 0 && col + 1 < ncol) {
        *reinterpret_cast<float2*>(o) = make_float2(d[2 * h], d[2 * h + 1]);
      } else {
        if (col < ncol) o[0] = d[2 * h];
        if (col + 1 < ncol) o[1] = d[2 * h + 1];
      }
    }
  };
#pragma unroll
  for (int n = 0; n < 8; ++n) put(c0 + wc + 8 * n + 2 * t, D, acc[n]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (gs[i] < kRk / 16) {
      put(D + 16 * gs[i] + 2 * t, D + R, accg[i][0]);
      put(D + 16 * gs[i] + 8 + 2 * t, D + R, accg[i][1]);
    }
}

// Lets the tensor-core stages use more than 48 KB of shared memory; once per process.
int tc_smem_attributes() {
  static const int code = [] {
    cudaFuncSetAttribute(nmf_coef_tc_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kCoefSmem);
    cudaFuncSetAttribute(nmf_coef_tc_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kCoefSmem);
    cudaFuncSetAttribute(nmf_stats_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kStatsSmem);
    cudaFuncSetAttribute(nmf_coef_tf32_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kFCoefSmem);
    cudaFuncSetAttribute(nmf_coef_tf32_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kFCoefSmem);
    cudaFuncSetAttribute(nmf_stats_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kFStatsSmem);
    return static_cast<int>(cudaGetLastError());
  }();
  return code;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int run(const void* xv, const void* basesv, void* coefv, void* btv, float* gram, float* partial,
        int B, int N, int D, int R, int steps, float inv_t, float eps, int chunk,
        cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* coef = static_cast<T*>(coefv);
  T* bt = static_cast<T*>(btv);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte copy
  int code = tc_smem_attributes();
  if (code != 0) return code;
  constexpr int kTokens = kBf16 ? kTok : kFTok;  // tokens per coef block
  const int ntiles = (N + kTokens - 1) / kTokens, stiles = (D + kSCol - 1) / kSCol;
  const int dtiles = (D + kTile - 1) / kTile, chunks = (N + chunk - 1) / chunk;
  // the bf16 instance keeps gram as bf16 (B, R, R) in the scratch; the float32
  // instance keeps bt and gram there as (hi, lo) pairs, (B, R, D) then (B, R, R)
  auto gram_tc = reinterpret_cast<bf16*>(gram);
  auto bt2 = reinterpret_cast<float2*>(gram);
  auto gram2 = bt2 + static_cast<size_t>(B) * R * D;
  const int vec_x = D % kV == 0 && aligned16(x) && aligned16(bt) && (kBf16 || aligned16(bt2));
  const int vec_c = R % kV == 0 && aligned16(coef) &&
                    aligned16(kBf16 ? static_cast<const void*>(gram) : gram2);
  // one stage after another, each launch checked before the next
  auto failed = [&] { return (code = static_cast<int>(cudaGetLastError())) != 0; };
  auto gram_stage = [&] {
    if constexpr (kBf16)
      nmf_gram_tc_kernel<<<B, kThreads, kGramSmem, s>>>(bt, gram_tc, D, R, vec_x, vec_c);
    else
      nmf_gram_tf32_kernel<<<B, kThreads, kFGramSmem, s>>>(bt, bt2, gram2, D, R, vec_x);
  };
  auto coef_stage = [&](auto init) {
    constexpr bool kInit = decltype(init)::value;
    if constexpr (kBf16)
      nmf_coef_tc_kernel<kInit><<<dim3(ntiles, B), kThreads, kCoefSmem, s>>>(
          x, bt, gram_tc, coef, N, D, R, inv_t, eps, vec_x, vec_c);
    else
      nmf_coef_tf32_kernel<kInit><<<dim3(ntiles, B), kThreads, kFCoefSmem, s>>>(
          x, bt2, gram2, coef, N, D, R, inv_t, eps, vec_x, vec_c);
  };
  nmf_norm_kernel<T><<<dim3(R, B), kThreads, 0, s>>>(static_cast<const T*>(basesv), bt, D, R, eps);
  if (failed()) return code;
  if (!kBf16) {  // the float32 init reads bt as the gram stage's pairs
    gram_stage();
    if (failed()) return code;
  }
  coef_stage(std::true_type{});
  if (failed()) return code;
  for (int it = 0; it <= steps; ++it) {
    if (kBf16 || it > 0) {  // bt has not changed since the float32 init's gram stage
      gram_stage();
      if (failed()) return code;
    }
    coef_stage(std::false_type{});
    if (failed() || it == steps) return code;  // it == steps: the final coef refresh
    if constexpr (kBf16)
      nmf_stats_tc_kernel<<<dim3(stiles, chunks, B), kThreads, kStatsSmem, s>>>(
          x, coef, partial, N, D, R, chunk, vec_x, vec_c);
    else
      nmf_stats_tf32_kernel<<<dim3(stiles, chunks, B), kThreads, kFStatsSmem, s>>>(
          x, coef, partial, N, D, R, chunk, vec_x, vec_c);
    if (failed()) return code;
    nmf_bases_kernel<T><<<dim3(dtiles, B), kThreads, 0, s>>>(partial, bt, chunks, D, R, eps);
    if (failed()) return code;
  }
  return code;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x (B, N, D), bases (B, D, R) raw; outputs
// coef (B, N, R) and bt (B, R, D) in the same type. Scratch: gram, B R R
// floats for bf16 (bf16 values in its first half), 2 B R (D + R) floats for
// float32 (bt and (bt bt^T)^T as (hi, lo) pairs), and
// partial (B, ceil(N / chunk), R, D + R) float32. R <= 64.
extern "C" int gc_nmf(int dtype, const void* x, const void* bases, void* coef, void* bt,
                      float* gram, float* partial, int B, int N, int D, int R, int steps,
                      float inv_t, float eps, int chunk, void* stream) {
  cudaGetLastError();
  if (B <= 0 || N <= 0 || D <= 0 || R <= 0 || R > kTile || steps < 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, bases, coef, bt, gram, partial, B, N, D, R, steps, inv_t, eps, chunk, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, bases, coef, bt, gram, partial, B, N, D, R, steps, inv_t, eps,
                              chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
