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
// What bounds it: at serving shapes (2B = 32 samples, N = 6400, D = 512,
// R = 64, 7 steps) the products are about 215 GFLOP, against about 3.4 GB
// of x traffic if every pass reads x from device memory. That is ~63 flops
// per byte, below the H100's bf16 tensor-core balance (~295) but above its
// float32 CUDA-core balance (~20): with the plain float32 FMA loops used
// here, operations bound it. The TPU version keeps one sample's x (6.5 MB)
// resident in VMEM; that does not fit in shared memory (227 KB per block),
// but it does fit in the 50 MB L2, so here each stage streams x through
// shared memory in tiles and lets L2 absorb the re-reads.
//
// Design, one launch per stage:
//   nmf_norm_kernel   column norms of the raw bases -> bt (R, D)
//   nmf_gram_kernel   bt bt^T (R, R)
//   nmf_coef_kernel   tiles of 64 tokens: x bt^T, then softmax (init) or the
//                     multiplicative coef update with coef (bt bt^T)
//   nmf_stats_kernel  per-block partials of coef^T x and coef^T coef over
//                     chunks of tokens
//   nmf_bases_kernel  sums the partials in a fixed chunk order, then the
//                     multiplicative bt update with (coef^T coef) bt
// No atomics and no block waits on another: every result is deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>

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
// 64-column tile; the chunk partials are summed in chunk order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nmf_bases_kernel(const float* partial, T* bt, int chunks, int D, int R, float eps) {
  __shared__ float sm[2][kTile][kPad];
  const int c0 = blockIdx.x * kTile, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t stride = static_cast<size_t>(R) * (D + R);
  const float* pb = partial + static_cast<size_t>(b) * chunks * stride;
  T* btb = bt + static_cast<size_t>(b) * R * D;

  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    float q = 0.f;
    if (i < R && j < R) {
      for (int c = 0; c < chunks; ++c) q += pb[c * stride + static_cast<size_t>(i) * (D + R) + D + j];
      q = rnd<T>(q);
    }
    sm[0][i][j] = q;
    sm[1][i][j] = (i < R && c0 + j < D) ? ld(btb, static_cast<size_t>(i) * D + c0 + j) : 0.f;
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
        float num = 0.f;
        for (int c = 0; c < chunks; ++c) num += pb[c * stride + static_cast<size_t>(r) * (D + R) + d];
        const float v = rnd<T>(sm[1][r][tx + 16 * k] * rnd<T>(num));
        st(btb, static_cast<size_t>(r) * D + d, v / rnd<T>(rnd<T>(den[i][k]) + eps));
      }
    }
}

template <typename T>
int run(const void* xv, const void* basesv, void* coefv, void* btv, float* gram, float* partial,
        int B, int N, int D, int R, int steps, float inv_t, float eps, int chunk,
        cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* coef = static_cast<T*>(coefv);
  T* bt = static_cast<T*>(btv);
  const int ntiles = (N + kTile - 1) / kTile;
  const int dtiles = (D + kTile - 1) / kTile;
  const int chunks = (N + chunk - 1) / chunk;
  nmf_norm_kernel<T><<<dim3(R, B), kThreads, 0, s>>>(static_cast<const T*>(basesv), bt, D, R, eps);
  nmf_coef_kernel<T, true><<<dim3(ntiles, B), kThreads, 0, s>>>(x, bt, gram, coef, N, D, R, inv_t, eps);
  for (int it = 0; it <= steps; ++it) {
    nmf_gram_kernel<T><<<B, kThreads, 0, s>>>(bt, gram, D, R);
    nmf_coef_kernel<T, false><<<dim3(ntiles, B), kThreads, 0, s>>>(x, bt, gram, coef, N, D, R, inv_t, eps);
    if (it == steps) break;  // the final coef refresh
    nmf_stats_kernel<T><<<dim3(dtiles + 1, chunks, B), kThreads, 0, s>>>(x, coef, partial, N, D, R, chunk);
    nmf_bases_kernel<T><<<dim3(dtiles, B), kThreads, 0, s>>>(partial, bt, chunks, D, R, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x (B, N, D), bases (B, D, R) raw; outputs
// coef (B, N, R) and bt (B, R, D) in the same type. Scratch: gram (B, R, R)
// and partial (B, ceil(N / chunk), R, D + R), both float32. R <= 64.
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
