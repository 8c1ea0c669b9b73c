// LM normal equations for GeoCalib's Levenberg-Marquardt solver: one launch,
// one pass over the pixels.
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
// What bounds it: it reads the five observation planes once, 5 x 4 bytes x
// B x N (42.6 MB at request a's B = 16, N = 320 x 416: 12.7 us at the H100's
// 3.35 TB/s), but its pixel loop holds 320 to 560 SASS instructions per pixel
// by camera model (tools/lm_kernel_sweep.py), so it is bound by the SMs'
// issue rate, not by memory: 320 x 2.13 M pixels take 20 us to issue at 132
// SMs x 128 lanes x 1.98 GHz. The design therefore spends few instructions
// per pixel and keeps every SM busy:
// - One launch per call, a grid of (kCluster, B) blocks in which the
//   kCluster = 16 blocks of a lane form one thread-block cluster (a
//   non-portable size). Block r of a lane streams the contiguous pixel range
//   [r per, (r + 1) per), per a multiple of 4 that depends on N only, so a
//   lane's sums are the same bits at any B. At 256 threads and at most 80
//   registers three blocks fit an SM, so the card holds 21 clusters at once:
//   request a's 16 lanes run in one wave, about two blocks per SM (8 blocks
//   of 512 threads fit only 15 clusters, and B = 16 took two waves).
// - Each thread takes 4 adjacent pixels at a time, with one 16-byte load per
//   plane when the planes are 16-byte aligned and N % 4 == 0 (element loads
//   otherwise). Row and column follow from loop counters; u and d(u)/d(focal)
//   come from a per-block table of the columns, v is divided out once per
//   row. No prefetch into registers: it cost registers, hence spills, and
//   was slower than the other warps hiding the latency.
// - The loss and the normalisations use rsqrtf and a reciprocal of the loss
//   scale instead of IEEE divisions and square roots (a few ulps from the
//   plain version, well inside the 1e-4 the checks hold it to); the
//   divisional model's guards keep their exact roundings.
// - Deterministic reduction without atomics or scratch memory: each block sums
//   its threads in a fixed order (warp shuffles, then warps in order); block 0
//   of the cluster then reads the other blocks' sums through distributed
//   shared memory in rank order, adds them in double, and writes G, both
//   triangles of H and the mean cost.
//
// The camera model (0: pinhole, 1: simple_radial, 2: radial,
// 3: simple_divisional) and the set of observation planes present are
// template parameters; the parameter mask, the manifold (given as the basis
// M), log-focal and the loss are arguments. Each model is a struct of scalar
// functions of (k1, k2, r2), copied from the distortion specs of
// geometry/camera.py (_DIST_SPECS); the Jacobian blocks are written once over
// them, in the general form of planar_fields.J_up_planes / J_lat_planes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// The launch geometry (tools/lm_kernel_sweep.py times other values on a patched copy)
constexpr int kThreads = 256;
constexpr int kCluster = 16;   // blocks per lane; above 8 is a non-portable size
constexpr int kMinBlocks = 3;  // blocks per SM the register budget must allow
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                  // adjacent pixels a thread takes at a time
constexpr int kTableW = 4096;            // columns whose u and gx a block keeps in shared memory
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
  float* G;           // (B, P)
  float* H;           // (B, P, P)
  float* cost;        // (B,)
  int N, w, per, loss_id, mask_bits, log_focal, vec;
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

// Robust loss on x = r^2 / a^2: value rho and IRLS weight rho' (losses.py);
// the huber square root and its reciprocal come from one rsqrtf.
__device__ __forceinline__ void robust(float x, int loss_id, float& rho, float& wgt) {
  if (loss_id == 0) {  // squared
    rho = x;
    wgt = 1.f;
  } else if (loss_id == 1) {  // huber
    const float rs = rsqrtf(x + 1e-8f);
    const float sx = (x + 1e-8f) * rs;
    const float isx = fmaxf(FLT_EPSILON, rs);
    const bool inl = x <= 1.f;
    rho = inl ? x : 2.f * sx - 1.f;
    wgt = inl ? 1.f : isx;
  } else {  // barron, alpha = 1, c = 1
    const float base = x + 1.f;
    rho = sqrtf(base) - 1.f;
    wgt = 0.5f * rsqrtf(base);
  }
}

// Adds w J r to G's sums and w J J^T to H's upper triangle. The parameter mask
// is applied to the lane's sums at the end: a 0/1 factor of a column commutes
// with the sum.
template <int P>
__device__ __forceinline__ void accumulate(float* acc, const float* J, float r, float wgt) {
  const float wr = r * wgt;
  int k = P;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    acc[p] += J[p] * wr;
    const float Jw = J[p] * wgt;
#pragma unroll
    for (int q = p; q < P; ++q) acc[k++] += Jw * J[q];
  }
}

// One lane's constants, loaded once per thread.
struct Lane {
  float fx, fy, cx, cy, k1, k2, ga, gb, gc, inv_up_a2, inv_lat_a2;
  float m[3][2];
};

// One pixel's observations.
struct Obs {
  float ux, uy, ls, uc, lc;
};

// Adds one pixel at normalised (u, v), with gx, gy = d(u, v)/d(focal step), to acc.
template <int MODEL, int F, int P, int S>
__device__ __forceinline__ void pixel(float* acc, const Lane& l, const LMArgs& a, float u,
                                      float v, float gx, float gy, const Obs& o) {
  using D = Dist<MODEL>;
  constexpr int K = D::K;
  constexpr int KA = K > 0 ? K : 1;  // array extent
  constexpr bool kDist = K > 0;
  const float k1 = l.k1, k2 = l.k2, ga = l.ga, gb = l.gb, gc = l.gc;
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
    const float inv = fminf(rsqrtf(tx * tx + ty * ty), 1e12f);
    const float rx = o.ux - tx * inv;
    const float ry = o.uy - ty * inv;
    float rho, wgt;
    robust((rx * rx + ry * ry) * l.inv_up_a2, a.loss_id, rho, wgt);
    rho *= a.up_a2;
    if (F & kUpConf) {
      rho *= o.uc;
      wgt *= o.uc;
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
      const float td0 = D11 * l.m[0][d] + D12 * l.m[1][d] + t02 * l.m[2][d];
      const float td1 = D12 * l.m[0][d] + D22 * l.m[1][d] + t12 * l.m[2][d];
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
    accumulate<P>(acc, J0, rx, wgt);
    accumulate<P>(acc, J1, ry, wgt);
  }

  if (F & kLat) {
    const float su = D::su(k1, k2, r2);
    const float dsu = D::dsu_dr2(k1, k2, r2);
    const float ud = su * u, vd = su * v;
    const float inv = rsqrtf(ud * ud + vd * vd + 1.f);
    const float gw = ga * ud + gb * vd + gc;
    const float rl = o.ls - gw * inv;
    float rho, wgt;
    robust(rl * rl * l.inv_lat_a2, a.loss_id, rho, wgt);
    rho *= a.lat_a2;
    if (F & kLatConf) {
      rho *= o.lc;
      wgt *= o.lc;
    }
    acc[S - 1] += rho;

    const float inv3 = inv * inv * inv;
    const float e0 = ga * inv - ud * gw * inv3;
    const float e1 = gb * inv - vd * gw * inv3;
    float J[P];
#pragma unroll
    for (int d = 0; d < 2; ++d) J[d] = (ud * l.m[0][d] + vd * l.m[1][d] + l.m[2][d]) * inv;
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
    accumulate<P>(acc, J, rl, wgt);
  }
}

// The kVec pixels of one plane from index i on: one 16-byte load when vec,
// else element loads of the `valid` ones (the rest read as 0).
__device__ __forceinline__ void load_vec(const float* p, size_t i, bool vec, int valid, float* o) {
  if (vec && valid == kVec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = j < valid ? __ldg(p + i + j) : 0.f;
  }
}

template <int F>
struct Planes {
  float ux[kVec], uy[kVec], ls[kVec], uc[kVec], lc[kVec];
  __device__ __forceinline__ void load(const LMArgs& a, size_t i, int valid) {
    const bool vec = a.vec;
    if (F & kUp) {
      load_vec(a.up_x, i, vec, valid, ux);
      load_vec(a.up_y, i, vec, valid, uy);
    }
    if (F & kUpConf) load_vec(a.up_conf, i, vec, valid, uc);
    if (F & kLat) load_vec(a.lat_sin, i, vec, valid, ls);
    if (F & kLatConf) load_vec(a.lat_conf, i, vec, valid, lc);
  }
  __device__ __forceinline__ Obs at(int j) const {
    Obs o{0.f, 0.f, 0.f, 0.f, 0.f};
    if (F & kUp) {
      o.ux = ux[j];
      o.uy = uy[j];
    }
    if (F & kUpConf) o.uc = uc[j];
    if (F & kLat) o.ls = ls[j];
    if (F & kLatConf) o.lc = lc[j];
    return o;
  }
};

template <int MODEL, int F>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lm_system_kernel(LMArgs a) {
  constexpr int P = 3 + Dist<MODEL>::K;
  constexpr int S = P + P * (P + 1) / 2 + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;

  Lane l;
  const float* cb = a.cam + b * 8;
  l.fx = cb[2];
  l.fy = cb[3];
  l.cx = cb[4];
  l.cy = cb[5];
  l.k1 = cb[6];
  l.k2 = cb[7];
  l.ga = a.grav[b * 3];
  l.gb = a.grav[b * 3 + 1];
  l.gc = a.grav[b * 3 + 2];
  l.inv_up_a2 = 1.f / a.up_a2;
  l.inv_lat_a2 = 1.f / a.lat_a2;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int d = 0; d < 2; ++d) l.m[k][d] = a.M[b * 6 + 2 * k + d];

  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = 0.f;

  const int start = min(a.N, rank * a.per);
  const int end = min(a.N, start + a.per);
  const int count = end - start;
  const size_t lane = static_cast<size_t>(b) * a.N;
  // thread t takes pixels start + kVec (t + k kThreads) ... + kVec - 1, k = 0, 1, ...
  const int groups = (count + kVec - 1) / kVec;
  const int step = kVec * kThreads, dq = step / a.w, dr = step - dq * a.w;
  int n = start + kVec * static_cast<int>(threadIdx.x);
  int row = n / a.w, col = n - row * a.w;

  // u and gx of the first table_w columns, divided out once per block
  extern __shared__ float cols[];
  const int table_w = min(a.w, kTableW);
  for (int c = threadIdx.x; c < table_w; c += kThreads) {
    const float u = (static_cast<float>(c) - l.cx) / l.fx;
    cols[c] = u;
    cols[table_w + c] = a.log_focal ? -u : -u / l.fx;
  }
  __syncthreads();

  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const int valid = min(kVec, end - n);
    Planes<F> obs;
    obs.load(a, lane + n, valid);
    int c = col, r = row;
    float v = (static_cast<float>(r) - l.cy) / l.fy;
    float gy = a.log_focal ? -v : -v / l.fy;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j < valid) {
        float u, gx;
        if (c < table_w) {
          u = cols[c];
          gx = cols[table_w + c];
        } else {
          u = (static_cast<float>(c) - l.cx) / l.fx;
          gx = a.log_focal ? -u : -u / l.fx;
        }
        pixel<MODEL, F, P, S>(acc, l, a, u, v, gx, gy, obs.at(j));
        if (++c == a.w) {
          c = 0;
          ++r;
          v = (static_cast<float>(r) - l.cy) / l.fy;
          gy = a.log_focal ? -v : -v / l.fy;
        }
      }
    }
    n += step;
    col += dr;
    row += dq;
    if (col >= a.w) {
      col -= a.w;
      ++row;
    }
  }

  // block sum in a fixed order: warp shuffles, then warps in order
  __shared__ float red[kWarps][S];
  __shared__ float block_sum[S];
  __shared__ float total[S];
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
    block_sum[threadIdx.x] = s;
  }
  cluster.sync();  // every block's sum is in its shared memory
  // lane sum: block 0 reads the cluster's blocks in rank order (distributed shared memory)
  if (rank == 0 && threadIdx.x < S) {
    double s = 0.0;
    for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(block_sum, r)[threadIdx.x];
    total[threadIdx.x] = threadIdx.x == S - 1 ? static_cast<float>(s / a.N) : static_cast<float>(s);
  }
  cluster.sync();  // the other blocks keep their shared memory until block 0 has read it
  if (rank == 0 && threadIdx.x == 0) {
    float mask[P];
    for (int p = 0; p < P; ++p) mask[p] = ((a.mask_bits >> p) & 1) ? 1.f : 0.f;
    int k = P;
    for (int p = 0; p < P; ++p) {
      a.G[b * P + p] = total[p] * mask[p];
      for (int q = p; q < P; ++q) {
        a.H[(b * P + p) * P + q] = total[k] * mask[p] * mask[q];
        a.H[(b * P + q) * P + p] = total[k] * mask[p] * mask[q];
        ++k;
      }
    }
    a.cost[b] = total[S - 1];
  }
}

// A non-portable cluster size (above 8) is allowed per kernel, once.
template <int MODEL, int F>
cudaError_t allow_cluster() {
  if (kCluster <= 8) return cudaSuccess;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      lm_system_kernel<MODEL, F>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return allowed;
}

// The launch of B lanes: a grid of (kCluster, B) blocks, one cluster per lane.
cudaLaunchConfig_t launch_config(int B, int w, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * (w < kTableW ? w : kTableW);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MODEL, int F>
cudaError_t launch(const LMArgs& a, int B, cudaStream_t stream) {
  const cudaError_t allowed = allow_cluster<MODEL, F>();
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, a.w, stream, attr);
  return cudaLaunchKernelEx(&cfg, lm_system_kernel<MODEL, F>, a);
}

// Launches the instance for one plane set; cudaErrorInvalidValue for a set with no instance.
template <int MODEL>
cudaError_t dispatch_flags(const LMArgs& a, int flags, int B, cudaStream_t s) {
  switch (flags) {
#define GC_CASE(F) \
  case F:          \
    return launch<MODEL, F>(a, B, s);
    // the plane sets the C entry can form: confidences only beside their field
    GC_CASE(1) GC_CASE(2) GC_CASE(3) GC_CASE(5) GC_CASE(7) GC_CASE(10) GC_CASE(11) GC_CASE(15)
#undef GC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

constexpr int kNumParams[kNumModels] = {3 + Dist<0>::K, 3 + Dist<1>::K, 3 + Dist<2>::K,
                                        3 + Dist<3>::K};

bool aligned16(const float* p) { return !p || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue, and launches nothing, for a
// model id outside 0-3, a P that is not the model's, a plane set without an
// instance, or an empty shape.
extern "C" int gc_lm_system(const float* up_x, const float* up_y, const float* lat_sin,
                            const float* up_conf, const float* lat_conf, const float* cam,
                            const float* grav, const float* M, float* G, float* H, float* cost,
                            int B, int N, int w, int model, int P, int loss_id, float up_scale,
                            float lat_scale, int mask_bits, int log_focal, void* stream) {
  // clear a stale error so the return value speaks of this launch only
  cudaGetLastError();
  const int flags = (up_x && up_y ? kUp : 0) | (lat_sin ? kLat : 0) |
                    (up_x && up_conf ? kUpConf : 0) | (lat_sin && lat_conf ? kLatConf : 0);
  if (!(flags & (kUp | kLat)) || B <= 0 || N <= 0 || w <= 0 || model < 0 ||
      model >= kNumModels || P != kNumParams[model])
    return static_cast<int>(cudaErrorInvalidValue);
  // each block's range: a multiple of kVec pixels, from N alone
  const int per = ((N + kCluster - 1) / kCluster + kVec - 1) / kVec * kVec;
  const int vec = N % kVec == 0 && aligned16(up_x) && aligned16(up_y) && aligned16(lat_sin) &&
                  aligned16(up_conf) && aligned16(lat_conf);
  LMArgs a{up_x, up_y, lat_sin, up_conf, lat_conf, cam, grav, M, G, H, cost,
           N, w, per, loss_id, mask_bits, log_focal, vec, up_scale * up_scale,
           lat_scale * lat_scale};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (model) {
    case 0: err = dispatch_flags<0>(a, flags, B, s); break;
    case 1: err = dispatch_flags<1>(a, flags, B, s); break;
    case 2: err = dispatch_flags<2>(a, flags, B, s); break;
    default: err = dispatch_flags<3>(a, flags, B, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The build's block size and cluster size (blocks per lane), and how many
// clusters of the pinhole all-planes instance the card holds at once at a
// width of w columns.
extern "C" int gc_lm_config(int* threads, int* cluster, int* active_clusters, int w) {
  *threads = kThreads;
  *cluster = kCluster;
  cudaError_t err = allow_cluster<0, 15>();
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, w, nullptr, attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(active_clusters, lm_system_kernel<0, 15>, &cfg);
  return static_cast<int>(err);
}
