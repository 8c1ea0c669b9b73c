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
// Design, one launch per stage (float32 kernel / bf16 kernel where they differ):
//   norm   nmf_norm_kernel: column norms of the raw bases -> bt (R, D)
//   gram   nmf_gram_kernel / nmf_gram_tc_kernel: bt bt^T (R, R)
//   coef   nmf_coef_kernel / nmf_coef_tc_kernel: tiles of tokens: x bt^T,
//          then softmax (init) or the multiplicative coef update with
//          coef (bt bt^T)
//   stats  nmf_stats_kernel / nmf_stats_tc_kernel: per-block partials of
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
// the FMA loops; only the order of the sums differs. Tiles come in by
// 16-byte cp.async through a ring of stages, into rows padded by 16 bytes so
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
// float32 instance (not on the serving path, which runs the network in
// bf16): the five stages on float32 FMA loops. TF32 tensor cores would
// round the operands to 10 bits of mantissa and change its numbers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;      // tokens (or ranks, or columns) per block tile
constexpr int kK = 32;         // depth of one shared-memory step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
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

// gram[b] = round(bt bt^T), (R, R) in float32 holding working-type values.
template <typename T>
__global__ void __launch_bounds__(kThreads) nmf_gram_kernel(const T* bt, float* gram, int D, int R) {
  __shared__ float sm[kTile][kK + 1];
  const int b = blockIdx.x, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* src = bt + static_cast<size_t>(b) * R * D;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < D; d0 += kK) {
    for (int e = threadIdx.x; e < kTile * kK; e += kThreads) {
      const int i = e / kK, j = e % kK;
      sm[i][j] = (i < R && d0 + j < D) ? ld(src, static_cast<size_t>(i) * D + d0 + j) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kK; ++j) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm[ty + 16 * i][j], c[i] = sm[tx + 16 * i][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] += a[i] * c[k];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 16 * i, s = tx + 16 * k;
      if (r < R && s < R) gram[(static_cast<size_t>(b) * R + r) * R + s] = rnd<T>(acc[i][k]);
    }
}

// One tile of 64 tokens. INIT: coef = softmax(inv_t * round(x bt^T)).
// Otherwise: coef <- coef * round(x bt^T) / (round(coef gram) + eps), in place.
template <typename T, bool INIT>
__global__ void __launch_bounds__(kThreads)
nmf_coef_kernel(const T* x, const T* bt, const float* gram, T* coef, int N, int D, int R,
                float inv_t, float eps) {
  __shared__ float sm[2][kTile][kPad];
  const int b = blockIdx.y, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* xb = x + static_cast<size_t>(b) * N * D;
  const T* bb = bt + static_cast<size_t>(b) * R * D;
  T* cb = coef + static_cast<size_t>(b) * N * R;

  float acc[4][4] = {};
  for (int d0 = 0; d0 < D; d0 += kK) {
    for (int e = threadIdx.x; e < kTile * kK; e += kThreads) {
      const int i = e / kK, j = e % kK, d = d0 + j;
      sm[0][i][j] = (n0 + i < N && d < D) ? ld(xb, static_cast<size_t>(n0 + i) * D + d) : 0.f;
      sm[1][i][j] = (i < R && d < D) ? ld(bb, static_cast<size_t>(i) * D + d) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kK; ++j) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm[0][ty + 16 * i][j], c[i] = sm[1][tx + 16 * i][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] += a[i] * c[k];
    }
    __syncthreads();
  }

  if (INIT) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) sm[0][ty + 16 * i][tx + 16 * k] = rnd<T>(inv_t * rnd<T>(acc[i][k]));
    __syncthreads();
    if (threadIdx.x < kTile && n0 + threadIdx.x < N) {
      const float* row = sm[0][threadIdx.x];
      float mx = -FLT_MAX;
      for (int r = 0; r < R; ++r) mx = fmaxf(mx, row[r]);
      float sum = 0.f;
      for (int r = 0; r < R; ++r) sum += expf(row[r] - mx);
      const size_t o = static_cast<size_t>(n0 + threadIdx.x) * R;
      for (int r = 0; r < R; ++r) st(cb, o + r, expf(row[r] - mx) / sum);
    }
    return;
  }

  // coef tile and the gram matrix into shared memory
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    sm[0][i][j] = (n0 + i < N && j < R) ? ld(cb, static_cast<size_t>(n0 + i) * R + j) : 0.f;
    sm[1][i][j] = (i < R && j < R) ? gram[(static_cast<size_t>(b) * R + i) * R + j] : 0.f;
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
      const int n = n0 + ty + 16 * i, r = tx + 16 * k;
      if (n < N && r < R) {
        const float c = sm[0][ty + 16 * i][r];
        const float num = rnd<T>(c * rnd<T>(acc[i][k]));
        st(cb, static_cast<size_t>(n) * R + r, num / rnd<T>(rnd<T>(den[i][k]) + eps));
      }
    }
}

// Partials over one chunk of tokens: coef^T x for a 64-column tile of x
// (blockIdx.x < column tiles), or coef^T coef (the last blockIdx.x).
// partial is (B, chunks, R, D + R) float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nmf_stats_kernel(const T* x, const T* coef, float* partial, int N, int D, int R, int chunk) {
  __shared__ float sm[2][kK][kPad];
  const int tiles = (D + kTile - 1) / kTile;
  const bool gram = blockIdx.x == tiles;
  const int c0 = blockIdx.x * kTile, ch = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* xb = x + static_cast<size_t>(b) * N * D;
  const T* cb = coef + static_cast<size_t>(b) * N * R;
  const int nbeg = ch * chunk, nend = min(N, nbeg + chunk);
  const int ncol = gram ? R : D;

  float acc[4][4] = {};
  for (int t0 = nbeg; t0 < nend; t0 += kK) {
    for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
      const int k = e / kTile, j = e % kTile, n = t0 + k;
      const bool ok = n < nend;
      sm[0][k][j] = (ok && j < R) ? ld(cb, static_cast<size_t>(n) * R + j) : 0.f;
      float v = 0.f;
      if (ok) {
        if (gram)
          v = j < R ? ld(cb, static_cast<size_t>(n) * R + j) : 0.f;
        else
          v = c0 + j < D ? ld(xb, static_cast<size_t>(n) * D + c0 + j) : 0.f;
      }
      sm[1][k][j] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm[0][k][ty + 16 * i], c[i] = sm[1][k][tx + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += a[i] * c[q];
    }
    __syncthreads();
  }
  const int chunks = gridDim.y;
  float* out = partial + (static_cast<size_t>(b) * chunks + ch) * R * (D + R);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = ty + 16 * i, col = (gram ? 0 : c0) + tx + 16 * q;
      if (r < R && col < ncol)
        out[static_cast<size_t>(r) * (D + R) + (gram ? D : 0) + col] = acc[i][q];
    }
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

// ROWS x COLS of a bf16 matrix with row stride `stride` (elements) into
// shared memory with row stride LD; rows >= nr and columns >= nc are zero.
// vec: 16-byte copies are legal (stride and base 16-byte aligned).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int stride, int nr, int nc,
                                          bool vec) {
  constexpr int kVecs = COLS / 8;
  for (int e = threadIdx.x; e < ROWS * kVecs; e += kThreads) {
    const int i = e / kVecs, j = (e % kVecs) * 8;
    bf16* d = dst + i * LD + j;
    const bf16* g = src + static_cast<size_t>(i) * stride + j;
    if (vec && i < nr && j + 8 <= nc) {
      cp_async16(d, g);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) d[q] = (i < nr && j + q < nc) ? g[q] : __float2bfloat16(0.f);
    }
  }
}

// rows x kRk bf16 of a shared-memory tile (row stride kLd) -> rows of R values
// (row stride R) in global memory, the first nr rows; 16-byte stores when vec.
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* src, int rows, int nr, int R,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kRk / 8); e += kThreads) {
      const int i = e / (kRk / 8), j = (e % (kRk / 8)) * 8;
      if (i < nr && j < R)
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(i) * R + j) =
            *reinterpret_cast<const uint4*>(src + i * kLd + j);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kRk; e += kThreads) {
      const int i = e / kRk, j = e % kRk;
      if (i < nr && j < R) dst[static_cast<size_t>(i) * R + j] = src[i * kLd + j];
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

// Lets the tensor-core stages use more than 48 KB of shared memory; once per process.
int tc_smem_attributes() {
  static const int code = [] {
    cudaFuncSetAttribute(nmf_coef_tc_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kCoefSmem);
    cudaFuncSetAttribute(nmf_coef_tc_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kCoefSmem);
    cudaFuncSetAttribute(nmf_stats_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kStatsSmem);
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
  const int dtiles = (D + kTile - 1) / kTile;
  const int chunks = (N + chunk - 1) / chunk;
  constexpr bool tc = std::is_same<T, bf16>::value;
  int ntiles = (N + kTile - 1) / kTile, stiles = dtiles, vec_x = 0, vec_c = 0;
  if (tc) {
    const int code = tc_smem_attributes();
    if (code != 0) return code;
    ntiles = (N + kTok - 1) / kTok;
    stiles = (D + kSCol - 1) / kSCol;
    vec_x = D % 8 == 0 && aligned16(x) && aligned16(bt);
    vec_c = R % 8 == 0 && aligned16(coef) && aligned16(gram);
  }
  // the bf16 instance keeps gram as bf16 (B, R, R) in the float32 scratch
  auto gram_tc = reinterpret_cast<bf16*>(gram);
  // one stage after another, each launch checked before the next
  int code = 0;
  auto failed = [&] { return (code = static_cast<int>(cudaGetLastError())) != 0; };
  auto coef_stage = [&](auto init) {
    constexpr bool kInit = decltype(init)::value;
    if constexpr (tc)
      nmf_coef_tc_kernel<kInit><<<dim3(ntiles, B), kThreads, kCoefSmem, s>>>(
          x, bt, gram_tc, coef, N, D, R, inv_t, eps, vec_x, vec_c);
    else
      nmf_coef_kernel<T, kInit><<<dim3(ntiles, B), kThreads, 0, s>>>(x, bt, gram, coef, N, D, R,
                                                                     inv_t, eps);
  };
  nmf_norm_kernel<T><<<dim3(R, B), kThreads, 0, s>>>(static_cast<const T*>(basesv), bt, D, R, eps);
  if (failed()) return code;
  coef_stage(std::true_type{});
  if (failed()) return code;
  for (int it = 0; it <= steps; ++it) {
    if constexpr (tc)
      nmf_gram_tc_kernel<<<B, kThreads, kGramSmem, s>>>(bt, gram_tc, D, R, vec_x, vec_c);
    else
      nmf_gram_kernel<T><<<B, kThreads, 0, s>>>(bt, gram, D, R);
    if (failed()) return code;
    coef_stage(std::false_type{});
    if (failed() || it == steps) return code;  // it == steps: the final coef refresh
    if constexpr (tc)
      nmf_stats_tc_kernel<<<dim3(stiles, chunks, B), kThreads, kStatsSmem, s>>>(
          x, coef, partial, N, D, R, chunk, vec_x, vec_c);
    else
      nmf_stats_kernel<T><<<dim3(stiles + 1, chunks, B), kThreads, 0, s>>>(x, coef, partial, N, D,
                                                                          R, chunk);
    if (failed()) return code;
    nmf_bases_kernel<T><<<dim3(dtiles, B), kThreads, 0, s>>>(partial, bt, chunks, D, R, eps);
    if (failed()) return code;
  }
  return code;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x (B, N, D), bases (B, D, R) raw; outputs
// coef (B, N, R) and bt (B, R, D) in the same type. Scratch: gram (B, R, R)
// float32 (the bf16 instance keeps bf16 values in its first half) and
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
