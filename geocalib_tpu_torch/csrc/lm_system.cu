// LM normal equations for GeoCalib's Levenberg-Marquardt solver, one pass
// over the pixels.
//
// Replaces the TPU kernel geocalib_tpu/ops/lm_kernel.py (_forward_pallas,
// body _make_kernel/_tile_system). For every batch lane it evaluates, per
// pixel, the predicted up vector and sin(latitude), the residuals against the
// network's fields, the robust IRLS weights times the confidences and the
// P = 3 + K Jacobian columns (gravity tangent, focal, distortion), and sums
//     G = sum w J r  (P),  H = sum w J J^T  (P x P),  cost = mean rho(r) conf
// without writing J to memory. The math is geometry/planar_fields.py of the
// port, transcribed line for line, for all four camera models.
//
// What bounds it: memory, or nearly as much the float32 operations. It reads
// the five observation planes once, 5 x 4 bytes x B x N (32.8 MB at B = 16,
// N = 320 x 320, about 10 us at the H100's 3.35 TB/s), and does 237 to 440
// flops per pixel by camera model (LM_FLOPS_PER_PIXEL in chip_smoke.py),
// 6 to 11 us at 67 TFLOP/s. The design therefore keeps everything else in
// registers: the camera, gravity and manifold basis are loaded once per
// thread, the pixel grid is computed from the pixel index (no xx/yy planes),
// and each thread streams its pixels with coalesced loads.
//
// Reduction without inter-block waiting: the TPU kernel carries its sums
// across a sequential grid. Here blocks run in parallel, so each block
// reduces its threads' sums (warp shuffles, then shared memory, in a fixed
// order) and writes one row of partials to a scratch tensor
// (B, blocks, P + P(P+1)/2 + 1); a second small kernel sums those rows in a
// fixed order and fills H's lower triangle. No atomics, no block waits on
// another, and the result is deterministic, which the solver's per-lane
// early stop relies on.
//
// The camera model (0: pinhole, 1: simple_radial, 2: radial,
// 3: simple_divisional) and the set of observation planes present are
// template parameters; the parameter mask, the manifold (given as the basis
// M), log-focal and the loss are arguments. Each model is a struct of scalar
// functions of (k1, k2, r2), copied from the distortion specs of
// geometry/camera.py (_DIST_SPECS); the Jacobian blocks are written once over
// them, in the general form of planar_fields.J_up_planes / J_lat_planes.
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStats = 32;
constexpr int kNumModels = 4;

enum : int { kUp = 1, kLat = 2, kUpConf = 4, kLatConf = 8 };

struct LMArgs {
  const float* up_x;
  const float* up_y;
  const float* lat_sin;
  const float* up_conf;
  const float* lat_conf;
  const float* cam;   // (B, 8): w, h, fx, fy, cx, cy, k1, k2
  const float* grav;  // (B, 3)
  const float* M;     // (B, 6): manifold basis J_abc2delta, row-major (3, 2)
  float* partial;     // (B, blocks, S)
  float* G;           // (B, P)
  float* H;           // (B, P, P)
  float* cost;        // (B,)
  int N, w, loss_id, mask_bits, log_focal;
  float up_a2, lat_a2;
};

// ---------------------------------------------------------------------------
// Distortion models: s (distort scale), phi with offset = phi * uv, dphi/dr2,
// ds/dk and dphi/dk, su (undistort scale), dsu/dr2 and dsu/dk, all scalar
// functions of k1, k2 and r2. K is the number of distortion parameters.
// ---------------------------------------------------------------------------

template <int MODEL>
struct Dist;

template <>
struct Dist<0> {  // pinhole
  static constexpr int K = 0;
  __device__ static float s(float, float, float) { return 1.f; }
  __device__ static float phi(float, float, float) { return 0.f; }
  __device__ static float dphi_dr2(float, float, float) { return 0.f; }
  __device__ static void ds_dk(float, float, float, float*) {}
  __device__ static void dphi_dk(float, float, float, float*) {}
  __device__ static float su(float, float, float) { return 1.f; }
  __device__ static float dsu_dr2(float, float, float) { return 0.f; }
  __device__ static void dsu_dk(float, float, float, float*) {}
};

template <>
struct Dist<1> {  // simple_radial: s = 1 + k1 r2, su = 1 - k1 r2
  static constexpr int K = 1;
  __device__ static float s(float k1, float, float r2) { return 1.f + k1 * r2; }
  __device__ static float phi(float k1, float, float) { return 2.f * k1; }
  __device__ static float dphi_dr2(float, float, float) { return 0.f; }
  __device__ static void ds_dk(float, float, float r2, float* o) { o[0] = r2; }
  __device__ static void dphi_dk(float, float, float, float* o) { o[0] = 2.f; }
  __device__ static float su(float k1, float, float r2) { return 1.f - k1 * r2; }
  __device__ static float dsu_dr2(float k1, float, float) { return -k1; }
  __device__ static void dsu_dk(float, float, float r2, float* o) { o[0] = -r2; }
};

template <>
struct Dist<2> {  // radial: s = 1 + k1 r2 + k2 r2^2, su = 1 - k1 r2 + (3 k1^2 - k2) r2^2
  static constexpr int K = 2;
  __device__ static float s(float k1, float k2, float r2) { return 1.f + r2 * (k1 + k2 * r2); }
  __device__ static float phi(float k1, float k2, float r2) { return 2.f * k1 + 4.f * k2 * r2; }
  __device__ static float dphi_dr2(float, float k2, float) { return 4.f * k2; }
  __device__ static void ds_dk(float, float, float r2, float* o) {
    o[0] = r2;
    o[1] = r2 * r2;
  }
  __device__ static void dphi_dk(float, float, float r2, float* o) {
    o[0] = 2.f;
    o[1] = 4.f * r2;
  }
  __device__ static float su(float k1, float k2, float r2) {
    return 1.f + r2 * (-k1 + (3.f * k1 * k1 - k2) * r2);
  }
  __device__ static float dsu_dr2(float k1, float k2, float r2) {
    return -k1 + 2.f * (3.f * k1 * k1 - k2) * r2;
  }
  __device__ static void dsu_dk(float k1, float, float r2, float* o) {
    o[0] = 6.f * k1 * (r2 * r2) - r2;
    o[1] = -(r2 * r2);
  }
};

// simple_divisional, through sigma(t) = 2 / (1 + q), q = sqrt(1 - 4t), t = k1 r2.
// The guards are the reference's, taken with the same roundings as the plain
// version (no contraction into an FMA): the argument of the square root is
// clipped at 1e-6, and a denominator that is exactly 0 is replaced by 1e6.
template <>
struct Dist<3> {
  static constexpr int K = 1;
  __device__ static float q(float k1, float r2) {
    return sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(__fmul_rn(4.f, k1), r2)), 1e-6f));
  }
  __device__ static float sigma1(float k1, float r2) {  // 4 / (q (1+q)^2)
    const float qq = q(k1, r2), a = 1.f + qq;
    return 4.f / (qq * (a * a));
  }
  __device__ static float sigma2(float k1, float r2) {  // 8 (1/(q^3 (1+q)^2) + 2/(q^2 (1+q)^3))
    const float qq = q(k1, r2), a = 1.f + qq;
    return 8.f * (1.f / (qq * qq * qq * (a * a)) + 2.f / (qq * qq * (a * a * a)));
  }
  __device__ static float guard(float d) { return d == 0.f ? 1e6f : d; }
  __device__ static float den(float k1, float r2) { return __fadd_rn(1.f, __fmul_rn(k1, r2)); }
  __device__ static float s(float k1, float, float r2) { return 2.f / (1.f + q(k1, r2)); }
  __device__ static float phi(float k1, float, float r2) { return 2.f * k1 * sigma1(k1, r2); }
  __device__ static float dphi_dr2(float k1, float, float r2) {
    return 2.f * (k1 * k1) * sigma2(k1, r2);
  }
  __device__ static void ds_dk(float k1, float, float r2, float* o) { o[0] = sigma1(k1, r2) * r2; }
  __device__ static void dphi_dk(float k1, float, float r2, float* o) {
    o[0] = 2.f * sigma1(k1, r2) + 2.f * k1 * r2 * sigma2(k1, r2);
  }
  __device__ static float su(float k1, float, float r2) { return 1.f / guard(den(k1, r2)); }
  __device__ static float dsu_dr2(float k1, float, float r2) {
    const float d = den(k1, r2);
    return -k1 / guard(__fmul_rn(d, d));
  }
  __device__ static void dsu_dk(float k1, float, float r2, float* o) {
    const float d = den(k1, r2);
    o[0] = -r2 / guard(__fmul_rn(d, d));
  }
};

// Robust loss on x = r^2 / a^2: value rho and IRLS weight rho' (losses.py).
__device__ __forceinline__ void robust(float x, int loss_id, float& rho, float& wgt) {
  if (loss_id == 0) {  // squared
    rho = x;
    wgt = 1.f;
  } else if (loss_id == 1) {  // huber
    const float sx = sqrtf(x + 1e-8f);
    const float isx = fmaxf(FLT_EPSILON, 1.f / sx);
    const bool inl = x <= 1.f;
    rho = inl ? x : 2.f * sx - 1.f;
    wgt = inl ? 1.f : isx;
  } else {  // barron, alpha = 1, c = 1
    const float base = x + 1.f;
    rho = sqrtf(base) - 1.f;
    wgt = 0.5f * rsqrtf(base);
  }
}

template <int P>
__device__ __forceinline__ void accumulate(float* acc, const float* J, float r, float wgt,
                                           const float* mask) {
  float Jm[P];
#pragma unroll
  for (int p = 0; p < P; ++p) Jm[p] = J[p] * mask[p];
  const float wr = r * wgt;
  int k = P;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    acc[p] += Jm[p] * wr;
    const float Jw = Jm[p] * wgt;
#pragma unroll
    for (int q = p; q < P; ++q) acc[k++] += Jw * Jm[q];
  }
}

template <int MODEL, int F>
__global__ void __launch_bounds__(kThreads) lm_partial_kernel(LMArgs a) {
  using D = Dist<MODEL>;
  constexpr int K = D::K;
  constexpr int KA = K > 0 ? K : 1;  // array extent
  constexpr bool kDist = K > 0;
  constexpr int P = 3 + K;
  constexpr int S = P + P * (P + 1) / 2 + 1;
  const int b = blockIdx.y;
  const float* cb = a.cam + b * 8;
  const float fx = cb[2], fy = cb[3], cx = cb[4], cy = cb[5], k1 = cb[6], k2 = cb[7];
  const float ga = a.grav[b * 3], gb = a.grav[b * 3 + 1], gc = a.grav[b * 3 + 2];
  float m[3][2];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int d = 0; d < 2; ++d) m[k][d] = a.M[b * 6 + 2 * k + d];
  float mask[P];
#pragma unroll
  for (int p = 0; p < P; ++p) mask[p] = ((a.mask_bits >> p) & 1) ? 1.f : 0.f;

  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = 0.f;

  const int per_block = (a.N + gridDim.x - 1) / gridDim.x;
  const int start = blockIdx.x * per_block;
  const int end = min(a.N, start + per_block);
  const size_t lane = static_cast<size_t>(b) * a.N;

  for (int n = start + threadIdx.x; n < end; n += kThreads) {
    const float u = (static_cast<float>(n % a.w) - cx) / fx;
    const float v = (static_cast<float>(n / a.w) - cy) / fy;
    const float gx = a.log_focal ? -u : -u / fx;
    const float gy = a.log_focal ? -v : -v / fy;
    const float r2 = __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v));

    if (F & kUp) {
      const float px = ga - gc * u, py = gb - gc * v;
      float tx = px, ty = py;
      float s = 1.f, phi = 0.f, dphi = 0.f, inner = 0.f;
      float D11 = 1.f, D12 = 0.f, D22 = 1.f;
      if constexpr (kDist) {
        s = D::s(k1, k2, r2);
        phi = D::phi(k1, k2, r2);
        dphi = D::dphi_dr2(k1, k2, r2);
        inner = u * px + v * py;
        D11 = s + phi * u * u;
        D12 = phi * u * v;
        D22 = s + phi * v * v;
        tx = s * px + phi * u * inner;
        ty = s * py + phi * v * inner;
      }
      const float inv = 1.f / fmaxf(sqrtf(tx * tx + ty * ty), 1e-12f);
      const float rx = a.up_x[lane + n] - tx * inv;
      const float ry = a.up_y[lane + n] - ty * inv;
      float rho, wgt;
      robust((rx * rx + ry * ry) / a.up_a2, a.loss_id, rho, wgt);
      rho *= a.up_a2;
      if (F & kUpConf) {
        const float c = a.up_conf[lane + n];
        rho *= c;
        wgt *= c;
      }
      acc[S - 1] += rho;

      const float inv3 = inv * inv * inv;
      const float n11 = inv - tx * tx * inv3;
      const float n12 = -tx * ty * inv3;
      const float n22 = inv - ty * ty * inv3;
      float J0[P], J1[P];
      // gravity block: D @ [[1, 0, -u], [0, 1, -v]] @ M
      const float t02 = -(D11 * u + D12 * v), t12 = -(D12 * u + D22 * v);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float td0 = D11 * m[0][d] + D12 * m[1][d] + t02 * m[2][d];
        const float td1 = D12 * m[0][d] + D22 * m[1][d] + t12 * m[2][d];
        J0[d] = n11 * td0 + n12 * td1;
        J1[d] = n12 * td0 + n22 * td1;
      }
      // focal block: J_t2uv @ d(u, v)/d(focal step)
      float tf0 = -gc * gx, tf1 = -gc * gy;
      if constexpr (kDist) {
        const float ox = phi * u, oy = phi * v;
        const float J00 = px * ox + inner * (phi + 2.f * dphi * u * u) + ox * px - gc * D11;
        const float J01 = px * oy + inner * (2.f * dphi * u * v) + ox * py - gc * D12;
        const float J10 = py * ox + inner * (2.f * dphi * v * u) + oy * px - gc * D12;
        const float J11 = py * oy + inner * (phi + 2.f * dphi * v * v) + oy * py - gc * D22;
        tf0 = J00 * gx + J01 * gy;
        tf1 = J10 * gx + J11 * gy;
      }
      J0[2] = n11 * tf0 + n12 * tf1;
      J1[2] = n12 * tf0 + n22 * tf1;
      // distortion block
      if constexpr (kDist) {
        float dk[KA], dpk[KA];
        D::ds_dk(k1, k2, r2, dk);
        D::dphi_dk(k1, k2, r2, dpk);
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float pre0 = px * dk[i] + dpk[i] * inner * u;
          const float pre1 = py * dk[i] + dpk[i] * inner * v;
          J0[3 + i] = n11 * pre0 + n12 * pre1;
          J1[3 + i] = n12 * pre0 + n22 * pre1;
        }
      }
      accumulate<P>(acc, J0, rx, wgt, mask);
      accumulate<P>(acc, J1, ry, wgt, mask);
    }

    if (F & kLat) {
      const float su = D::su(k1, k2, r2);
      const float dsu = D::dsu_dr2(k1, k2, r2);
      const float ud = su * u, vd = su * v;
      const float inv = 1.f / sqrtf(ud * ud + vd * vd + 1.f);
      const float gw = ga * ud + gb * vd + gc;
      const float rl = a.lat_sin[lane + n] - gw * inv;
      float rho, wgt;
      robust(rl * rl / a.lat_a2, a.loss_id, rho, wgt);
      rho *= a.lat_a2;
      if (F & kLatConf) {
        const float c = a.lat_conf[lane + n];
        rho *= c;
        wgt *= c;
      }
      acc[S - 1] += rho;

      const float inv3 = inv * inv * inv;
      const float e0 = ga * inv - ud * gw * inv3;
      const float e1 = gb * inv - vd * gw * inv3;
      float J[P];
#pragma unroll
      for (int d = 0; d < 2; ++d) J[d] = (ud * m[0][d] + vd * m[1][d] + m[2][d]) * inv;
      const float dot = u * gx + v * gy;
      const float jw0 = su * gx + 2.f * dsu * u * dot;
      const float jw1 = su * gy + 2.f * dsu * v * dot;
      J[2] = e0 * jw0 + e1 * jw1;
      if constexpr (kDist) {
        float gam[KA];
        D::dsu_dk(k1, k2, r2, gam);
        const float ev = e0 * u + e1 * v;
#pragma unroll
        for (int i = 0; i < K; ++i) J[3 + i] = gam[i] * ev;
      }
      accumulate<P>(acc, J, rl, wgt, mask);
    }
  }

  // block reduction in a fixed order: warp shuffles, then warps in order
  __shared__ float red[kWarps][kMaxStats];
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float s = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lid == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < S) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][threadIdx.x];
    a.partial[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * S + threadIdx.x] = s;
  }
}

// Sums the per-block rows of one lane in block order; fills G, H (both
// triangles) and the mean cost.
template <int P>
__global__ void lm_reduce_kernel(LMArgs a, int blocks) {
  constexpr int S = P + P * (P + 1) / 2 + 1;
  __shared__ float st[kMaxStats];
  const int b = blockIdx.x;
  if (threadIdx.x < S) {
    double s = 0.0;
    for (int j = 0; j < blocks; ++j)
      s += a.partial[(static_cast<size_t>(b) * blocks + j) * S + threadIdx.x];
    st[threadIdx.x] = threadIdx.x == S - 1 ? static_cast<float>(s / a.N)
                                           : static_cast<float>(s);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = P;
    for (int p = 0; p < P; ++p) {
      a.G[b * P + p] = st[p];
      for (int q = p; q < P; ++q) {
        a.H[(b * P + p) * P + q] = st[k];
        a.H[(b * P + q) * P + p] = st[k];
        ++k;
      }
    }
    a.cost[b] = st[S - 1];
  }
}

template <int MODEL, int F>
void launch(const LMArgs& a, int B, int blocks, cudaStream_t stream) {
  lm_partial_kernel<MODEL, F><<<dim3(blocks, B), kThreads, 0, stream>>>(a);
  lm_reduce_kernel<3 + Dist<MODEL>::K><<<B, 32, 0, stream>>>(a, blocks);
}

// Launches the instance for one plane set; false for a set with no instance.
template <int MODEL>
bool dispatch_flags(const LMArgs& a, int flags, int B, int blocks, cudaStream_t s) {
  switch (flags) {
#define GC_CASE(F)                    \
  case F:                             \
    launch<MODEL, F>(a, B, blocks, s); \
    return true;
    // the plane sets the C entry can form: confidences only beside their field
    GC_CASE(1) GC_CASE(2) GC_CASE(3) GC_CASE(5) GC_CASE(7) GC_CASE(10) GC_CASE(11) GC_CASE(15)
#undef GC_CASE
    default:
      return false;
  }
}

constexpr int kNumParams[kNumModels] = {3 + Dist<0>::K, 3 + Dist<1>::K, 3 + Dist<2>::K,
                                        3 + Dist<3>::K};

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue, and launches nothing, for a
// model id outside 0-3, a P that is not the model's, a plane set without an
// instance, or an empty shape.
extern "C" int gc_lm_system(const float* up_x, const float* up_y, const float* lat_sin,
                            const float* up_conf, const float* lat_conf, const float* cam,
                            const float* grav, const float* M, float* partial, float* G,
                            float* H, float* cost, int B, int N, int w, int blocks, int model,
                            int P, int loss_id, float up_scale, float lat_scale, int mask_bits,
                            int log_focal, void* stream) {
  // clear a stale error so the return value speaks of this launch only
  cudaGetLastError();
  const int flags = (up_x && up_y ? kUp : 0) | (lat_sin ? kLat : 0) |
                    (up_x && up_conf ? kUpConf : 0) | (lat_sin && lat_conf ? kLatConf : 0);
  if (!(flags & (kUp | kLat)) || B <= 0 || N <= 0 || w <= 0 || blocks <= 0 || model < 0 ||
      model >= kNumModels || P != kNumParams[model])
    return static_cast<int>(cudaErrorInvalidValue);
  LMArgs a{up_x, up_y, lat_sin, up_conf, lat_conf, cam, grav, M, partial, G, H, cost,
           N, w, loss_id, mask_bits, log_focal, up_scale * up_scale, lat_scale * lat_scale};
  auto s = static_cast<cudaStream_t>(stream);
  bool launched = false;
  switch (model) {
    case 0: launched = dispatch_flags<0>(a, flags, B, blocks, s); break;
    case 1: launched = dispatch_flags<1>(a, flags, B, blocks, s); break;
    case 2: launched = dispatch_flags<2>(a, flags, B, blocks, s); break;
    default: launched = dispatch_flags<3>(a, flags, B, blocks, s); break;
  }
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
