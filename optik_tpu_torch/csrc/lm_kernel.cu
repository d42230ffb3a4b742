// Lockstep projected Levenberg-Marquardt IK solve, one thread per lane,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// optik_tpu/ops/pallas/lm_kernel.py:build_kernel_solver (the body `kernel`,
// which runs optik_tpu/solver/lm_soa.py:lm_loop over optik_tpu/ops/soa.py).
// It computes the same function: per lane, FK + SE(3)-log residual + 6xA
// task Jacobian, the damped Gauss-Newton step -J^T (J J^T + lam I)^-1 e by an
// unrolled 6x6 Cholesky, box projection, Nielsen damping, the NLopt-style
// stopping tests, continuous reseeding from the restart seed table, the
// Speed-mode pose freeze, Quality mode (full restart budget, per-lane best
// success by distance to the caller's seed, optional per-pose success cap)
// and the per-axis objective weights.  The plain torch version of the same
// function is optik_tpu_torch/ops/cuda/lm_kernel.py:solve_plain.
//
// What bounds it on this card: FP32 and SFU throughput (a lane-iteration is
// a few thousand dependent FP32 operations, with rsqrt, sqrt and IEEE
// divisions), registers (about 75 live state values per lane plus the FK
// temporaries) and the occupancy they allow.  Every contraction is at most
// 6x7 per lane, so tensor cores and TMA are not the lever; device memory is
// touched only to load the seeds and targets and to store the results.  By
// hand count a 7-DoF lane-iteration is 3,120 FP32 operations (lm_kernel.py:
// fp32_ops_per_lane_iter).  On an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py: 131,072 Panda poses, 8 lanes, 64 restarts) the inputs
// need 37 GFLOP against 79 MB, a bound of 0.56 ms by operations where the
// bytes would take 0.02 ms, and the kernel takes 6.3 ms: warps wait for
// their slowest pose (they run twice the lane-iterations the lanes need)
// and 8 resident warps per SM leave the dependent chains exposed.
//
// Design (not the TPU block layout):
//   * One thread per lane; all state lives in registers.  A pose's S lanes
//     sit in Sp consecutive threads, Sp the next divisor of 32 at or above S
//     (64 for 32 < S <= 64); threads s >= S of a pose are dead lanes that
//     start stopped, are never written out and are not counted as work.
//   * Inputs are SoA: seed component p of lane l = pose * S + s at
//     seeds[p * L + l] (lane-major, L = B * S), target component c of pose b
//     at tgt[c * B + b] (a pose's lanes read one address, a broadcast within
//     the warp).  Loads coalesce when Sp == S.
//   * The seed for restart index k is table[k * A + p]: a plain gather from
//     the (R, A) table.  The TPU kernel's select chain existed only because
//     the TPU cannot gather.
//   * Chain constants travel in a by-value kernel parameter struct.  The
//     DoF, the mode, the weighting and the two-warp pose layout are
//     compile-time (-DOPTIK_DOF, -DOPTIK_QUALITY, -DOPTIK_WEIGHTED,
//     -DOPTIK_WIDE): a library holds one instantiation and is built when a
//     solve first needs it, so the Speed / identity-weights kernel carries
//     none of the other variants' registers.  Static 0/+-1 chain terms are
//     not folded yet.
//   * For Sp <= 32 a pose's lanes are contiguous inside one warp: the
//     Speed-mode group freeze is a __ballot_sync over the pose's lane mask,
//     the Quality cap's group sum a shuffle butterfly over Sp lanes.
//   * For Sp == 64 a pose spans the two warps of a pair.  Uncapped Quality
//     needs no traffic between them.  Speed freeze and the Quality cap
//     (OPTIK_WIDE) exchange one word per warp and iteration through shared
//     memory, double-buffered by iteration parity, around one named barrier
//     per pair (bar.sync id, 64); the pair's exit test is shared, so both
//     warps arrive at every barrier the same number of times.
//   * Each warp leaves its loop on its own once all its lanes have stopped:
//     no lane waits for a straggler in another warp.  The iteration counter
//     is warp-uniform, so "first iteration" keeps its meaning, and stopped
//     lanes hold their state, so every lane's result is the one the
//     block-lockstep schedule gives.  Threads past L stay in the loop as
//     stopped lanes (an early return would deadlock the _sync calls).
//   * Math: the same polynomial atan2 and sincos as the plain version's
//     kernel math mode, rsqrtf in the Cholesky, IEEE division and sqrt (the
//     library is built without --use_fast_math).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DOPTIK_DOF=7 [-DOPTIK_QUALITY=1] [-DOPTIK_WEIGHTED=1]
//        [-DOPTIK_WIDE=1] -o liboptik_lm.so lm_kernel.cu
// The C entry point optik_lm_solve returns cudaGetLastError() after the
// launch (or a negative code for invalid arguments) and is bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef OPTIK_DOF
#error "build with -DOPTIK_DOF=<1..10>"
#endif
#ifndef OPTIK_QUALITY
#define OPTIK_QUALITY 0
#endif
#ifndef OPTIK_WEIGHTED
#define OPTIK_WEIGHTED 0
#endif
#ifndef OPTIK_WIDE
#define OPTIK_WIDE 0
#endif

namespace {

constexpr int kDof = OPTIK_DOF;
constexpr bool kQuality = OPTIK_QUALITY != 0;
constexpr bool kWeighted = OPTIK_WEIGHTED != 0;
constexpr bool kWide = OPTIK_WIDE != 0;
constexpr int kMaxDof = 10;
static_assert(kDof >= 1 && kDof <= kMaxDof, "OPTIK_DOF must be 1..10");
constexpr int kNumOpts = 19;
constexpr int kBlockThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

// Per-joint block of the flat host chain array (floats).
constexpr int kJointFloats = 9 + 3 + 3 + 4 * 9 + 3;
// Tip block: tip_r (9), tip_t (3), has_tip (1).
constexpr int kTipFloats = 13;

constexpr float kEps = 1e-6f;       // Taylor switch (optik_tpu/math/so3.py)
constexpr float kTiny = 1e-30f;
constexpr float kPi = 3.14159265358979323846f;

template <int A>
struct Chain {
  float org_r[A][9];
  float org_t[A][3];
  float axis[A][3];
  // Rodrigues in coefficient form: R = c0 + cos*cc + sin*cs + (1-cos)*c1,
  // entry by entry (see rodrigues below).
  float rc0[A][9], rcc[A][9], rcs[A][9], rc1[A][9];
  float lower[A], upper[A];
  int pris[A];
  float tip_r[9];
  float tip_t[3];
  int has_tip;
};

struct Opts {
  int max_iters;
  float tol_f, tol_df, tol_dx;
  bool f_is_success, df_is_success, dx_is_success, use_dx;
  float lam_init, lam_min, lam_max;
  // Per-axis objective weights (target frame) and whether each triple is
  // the identity; read by the weighted instantiation only.
  float wl[3], wa[3];
  bool lin_id, ang_id;
  // Quality: freeze a pose once its lanes completed this many successful
  // attempts (0 = off).
  int cap;
};

// max / min that propagate a NaN in `a`, as jnp.maximum and torch.clamp do
// (fmaxf would drop it).
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// --- kernel math: polynomial atan2 and sincos (ops/soa.py) -----------------

__device__ __forceinline__ float atan_nonneg(float t) {
  const bool big = t > 2.414213562373095f;
  const bool mid = (t > 0.4142135623730950f) && !big;
  const float x = big ? -1.0f / nmax(t, kTiny) : (mid ? (t - 1.0f) / (t + 1.0f) : t);
  const float y0 = big ? kPi / 2 : (mid ? kPi / 4 : 0.0f);
  const float z = x * x;
  const float p = ((8.05374449538e-2f * z - 1.38776856032e-1f) * z
                   + 1.99777106478e-1f) * z - 3.33329491539e-1f;
  return y0 + p * z * x + x;
}

__device__ __forceinline__ float atan2_nonneg(float y, float x) {
  const float r = atan_nonneg(y / nmax(fabsf(x), kTiny));
  return x < 0.0f ? kPi - r : r;
}

__device__ __forceinline__ void sincos_poly(float x, float& s, float& c) {
  const float k = floorf(x * (float)(2.0 / 3.14159265358979323846) + 0.5f);
  float r = x - k * 1.5703125f;
  r = r - k * 4.837512969970703e-4f;
  r = r - k * 7.549789948768648e-8f;
  const float z = r * r;
  const float sp = r + r * z * (-1.6666654611e-1f
                                + z * (8.3321608736e-3f + z * (-1.9515295891e-4f)));
  const float cp = 1.0f - 0.5f * z + z * z * (
      4.166664568298827e-2f
      + z * (-1.388731625493765e-3f + z * 2.443315711809948e-5f));
  const float j = k - 4.0f * floorf(k * 0.25f);  // k mod 4
  const bool swap = (j == 1.0f) || (j == 3.0f);
  const float s_abs = swap ? cp : sp;
  const float c_abs = swap ? sp : cp;
  s = (j == 2.0f || j == 3.0f) ? -s_abs : s_abs;
  c = (j == 1.0f || j == 2.0f) ? -c_abs : c_abs;
}

// --- small linear algebra ---------------------------------------------------

// c = a * b for row-major 3x3.
__device__ __forceinline__ void mat3_mul(const float* a, const float* b, float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

// y = a * v.
__device__ __forceinline__ void mat3_vec(const float* a, const float* v, float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2];
}

// y = a^T * v.
__device__ __forceinline__ void mat3_tvec(const float* a, const float* v, float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = a[i] * v[0] + a[3 + i] * v[1] + a[6 + i] * v[2];
}

// diag*I + ch*[w]x + ch2*[w]x^2 (ops/soa.py add_hat_terms).
__device__ __forceinline__ void add_hat_terms(float diag, const float* w, float ch,
                                              float ch2, float* m) {
  const float wx = w[0], wy = w[1], wz = w[2];
  const float w11 = wx * wx, w22 = wy * wy, w33 = wz * wz;
  const float w12 = wx * wy, w13 = wx * wz, w23 = wy * wz;
  m[0] = diag + ch2 * (-w22 - w33);
  m[1] = -ch * wz + ch2 * w12;
  m[2] = ch * wy + ch2 * w13;
  m[3] = ch * wz + ch2 * w12;
  m[4] = diag + ch2 * (-w11 - w33);
  m[5] = -ch * wx + ch2 * w23;
  m[6] = -ch * wy + ch2 * w13;
  m[7] = ch * wx + ch2 * w23;
  m[8] = diag + ch2 * (-w11 - w22);
}

// Unrolled 6x6 SPD solve; the factor keeps 1/L_jj on its diagonal.
__device__ __forceinline__ void cholesky_solve6(const float a[6][6], const float* b,
                                                float* x) {
  float l[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - l[j][k] * l[j][k];
    const float inv_d = rsqrtf(nmax(s, kTiny));
    l[j][j] = inv_d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - l[i][k] * l[j][k];
      l[i][j] = t * inv_d;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - l[i][k] * y[k];
    y[i] = s * l[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - l[k][i] * x[k];
    x[i] = s * l[i][i];
  }
}

// --- SO(3) / SE(3) logs and right Jacobians (ops/soa.py) --------------------

struct Trig {
  float theta, theta2, s, c;
};

// Rotation log of r with the exact trig of its angle (rot_log_terms).
__device__ __forceinline__ void rot_log_terms(const float* r, float* w_log, Trig& trig) {
  const float r00 = r[0], r01 = r[1], r02 = r[2];
  const float r10 = r[3], r11 = r[4], r12 = r[5];
  const float r20 = r[6], r21 = r[7], r22 = r[8];
  const float tw = 1.0f + r00 + r11 + r22;
  const float tx = 1.0f + r00 - r11 - r22;
  const float ty = 1.0f - r00 + r11 - r22;
  const float tz = 1.0f - r00 - r11 + r22;
  const float a01 = r01 + r10, a02 = r02 + r20, a12 = r12 + r21;
  const float s21 = r21 - r12, s02 = r02 - r20, s10 = r10 - r01;
  const bool m_w = (tw >= tx) && (tw >= ty) && (tw >= tz);
  const bool m_x = !m_w && (tx >= ty) && (tx >= tz);
  const bool m_y = !m_w && !m_x && (ty >= tz);
  auto pick = [&](float c0, float c1, float c2, float c3) {
    return m_w ? c0 : (m_x ? c1 : (m_y ? c2 : c3));
  };
  float x = pick(s21, tx, a01, a02);
  float y = pick(s02, a01, ty, a12);
  float z = pick(s10, a02, a12, tz);
  float w = pick(tw, s21, s02, s10);
  if (w < 0.0f) {  // double cover: w >= 0
    x = -x; y = -y; z = -z; w = -w;
  }
  const float v2 = x * x + y * y + z * z;
  const float n2 = v2 + w * w;
  const float vn = sqrtf(v2);
  const float half = atan2_nonneg(vn, w);
  const float theta = 2.0f * half;
  const bool small = v2 <= kEps * n2;
  const float inv_w = 1.0f / (small ? nmax(w, kTiny) : w);
  const float u = v2 * inv_w * inv_w;
  const float taylor = inv_w * (1.0f - u / 3.0f + (u * u) / 5.0f);
  const float tt = 2.0f * (small ? taylor : half / (small ? 1.0f : vn));
  w_log[0] = x * tt;
  w_log[1] = y * tt;
  w_log[2] = z * tt;
  const float inv_n2 = 1.0f / n2;
  trig.theta = theta;
  trig.theta2 = theta * theta;
  trig.s = 2.0f * vn * w * inv_n2;
  trig.c = (w * w - v2) * inv_n2;
}

// [v; w] with v = V^-1 t (se3_log_trig).
__device__ __forceinline__ void se3_log_trig(const float* w, const float* t,
                                             const Trig& g, float* e) {
  const bool small = g.theta2 <= kEps;
  const float inv_t2 = 1.0f / (small ? 1.0f : g.theta2);
  const float coef_exact =
      (1.0f - 0.5f * g.theta * g.s / nmax(1.0f - g.c, kTiny)) * inv_t2;
  const float t4 = g.theta2 * g.theta2;
  const float coef_taylor = (float)(1.0 / 12.0) + g.theta2 / 720.0f + t4 / 30240.0f;
  const float coef = small ? coef_taylor : coef_exact;
  float v_inv[9];
  add_hat_terms(1.0f, w, -0.5f, coef, v_inv);
  mat3_vec(v_inv, t, e);
  e[3] = w[0];
  e[4] = w[1];
  e[5] = w[2];
}

// SO(3) right Jacobian from shared trig (so3_right_jacobian_trig).
__device__ __forceinline__ void so3_right_jacobian_trig(const float* w, const Trig& g,
                                                        float* jr) {
  const bool small = g.theta2 <= kEps;
  const float inv_t2 = 1.0f / (small ? 1.0f : g.theta2);
  const float t4 = g.theta2 * g.theta2;
  const float a = small ? 1.0f - g.theta2 / 6.0f + t4 / 120.0f : g.s * g.theta * inv_t2;
  const float b = small ? 0.5f - g.theta2 / 24.0f + t4 / 720.0f : (1.0f - g.c) * inv_t2;
  const float c = small ? (float)(1.0 / 6.0) - g.theta2 / 120.0f + t4 / 5040.0f
                        : (1.0f - a) * inv_t2;
  const float e = (b - 2.0f * c) / (2.0f * a);
  add_hat_terms(1.0f, w, 0.5f, e, jr);
}

// (J_r(w), Q(t, w)) blocks of the SE(3) right Jacobian
// (se3_right_jacobian_blocks_trig).
__device__ __forceinline__ void se3_right_jacobian_blocks(const float* w, const float* t,
                                                          const Trig& g, float* jr,
                                                          float* q) {
  const bool small = g.theta2 <= kEps;
  const float inv_t2 = 1.0f / (small ? 1.0f : g.theta2);
  const float s_t = g.s * g.theta * inv_t2;
  const float inv_1mc = 1.0f / nmax(2.0f * (1.0f - g.c), kTiny);
  const float a_exact = inv_t2 - s_t * inv_1mc;
  const float b_exact = -2.0f * inv_t2 * inv_t2 + (1.0f + s_t) * inv_1mc * inv_t2;
  const float a = small ? (float)(1.0 / 12.0) + g.theta2 / 720.0f : a_exact;
  const float b = small ? (float)(1.0 / 360.0) : b_exact;

  const float d = w[0] * t[0] + w[1] * t[1] + w[2] * t[2];
  const float bd = b * d;
  const float tb = g.theta2 * b + 2.0f * a;
  float cv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) cv[i] = w[i] * bd - t[i] * tb;
  const float da = d * a;
  const float tx = t[0], ty = t[1], tz = t[2];
  const float wx = w[0], wy = w[1], wz = w[2];
  float cm[9];
  cm[0] = cv[0] * wx + a * wx * tx + da;
  cm[1] = -0.5f * tz + cv[0] * wy + a * wx * ty;
  cm[2] = 0.5f * ty + cv[0] * wz + a * wx * tz;
  cm[3] = 0.5f * tz + cv[1] * wx + a * wy * tx;
  cm[4] = cv[1] * wy + a * wy * ty + da;
  cm[5] = -0.5f * tx + cv[1] * wz + a * wy * tz;
  cm[6] = -0.5f * ty + cv[2] * wx + a * wz * tx;
  cm[7] = 0.5f * tx + cv[2] * wy + a * wz * ty;
  cm[8] = cv[2] * wz + a * wz * tz + da;
  so3_right_jacobian_trig(w, g, jr);
  mat3_mul(cm, jr, q);
}

// --- the fused residual + task Jacobian (residual_and_jtask) ----------------

// y = m * v for a row-major 3x3 block, summed left to right as the plain
// version's folded 6x6 product does.
__device__ __forceinline__ void weight3(const float* m, float v0, float v1, float v2,
                                        float& y0, float& y1, float& y2) {
  y0 = (m[0] * v0 + m[1] * v1) + m[2] * v2;
  y1 = (m[3] * v0 + m[4] * v1) + m[5] * v2;
  y2 = (m[6] * v0 + m[7] * v1) + m[8] * v2;
}

// `ml` / `ma` are the lane's weighting blocks R^T D_l R and R^T D_a R
// (weighted instantiation only); `use_l` / `use_a` false leaves that half
// unweighted, exactly as the plain version folds its static identity block.
template <int A, bool WEIGHTED>
__device__ __forceinline__ void residual_and_jtask(const Chain<A>& ch, const float* q,
                                                   const float* tr, const float* tt,
                                                   const float* ml, const float* ma,
                                                   bool use_l, bool use_a,
                                                   float* e, float jt[6][A], float& f) {
  float r[9], t[3];
  float dir_w[A][3], p_j[A][3];
#pragma unroll
  for (int j = 0; j < A; ++j) {
    float lr[9], lt[3];
    if (ch.pris[j]) {
#pragma unroll
      for (int i = 0; i < 9; ++i) lr[i] = ch.org_r[j][i];
      float ax[3] = {ch.axis[j][0] * q[j], ch.axis[j][1] * q[j], ch.axis[j][2] * q[j]};
      float m[3];
      mat3_vec(ch.org_r[j], ax, m);
#pragma unroll
      for (int i = 0; i < 3; ++i) lt[i] = ch.org_t[j][i] + m[i];
    } else {
      float s, c;
      sincos_poly(q[j], s, c);
      const float c1 = 1.0f - c;
      float rod[9];
#pragma unroll
      for (int i = 0; i < 9; ++i)
        rod[i] = ch.rc0[j][i] + c * ch.rcc[j][i] + s * ch.rcs[j][i] + c1 * ch.rc1[j][i];
      mat3_mul(ch.org_r[j], rod, lr);
#pragma unroll
      for (int i = 0; i < 3; ++i) lt[i] = ch.org_t[j][i];
    }
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = lr[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = lt[i];
    } else {
      float m[3], rn[9];
      mat3_vec(r, lt, m);
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = m[i] + t[i];
      mat3_mul(r, lr, rn);
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = rn[i];
    }
    mat3_vec(r, ch.axis[j], dir_w[j]);
#pragma unroll
    for (int i = 0; i < 3; ++i) p_j[j][i] = t[i];
  }
  if (ch.has_tip) {
    float m[3], rn[9];
    mat3_vec(r, ch.tip_t, m);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = m[i] + t[i];
    mat3_mul(r, ch.tip_r, rn);
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = rn[i];
  }

  // X = T_tgt^-1 * T_ee
  float xr[9], xt[3], dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      xr[3 * i + j] = tr[i] * r[j] + tr[3 + i] * r[3 + j] + tr[6 + i] * r[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i) dt[i] = t[i] - tt[i];
  mat3_tvec(tr, dt, xt);

  float w_log[3];
  Trig g;
  rot_log_terms(xr, w_log, g);
  se3_log_trig(w_log, xt, g, e);

  float jr[9], qq[9];
  se3_right_jacobian_blocks(w_log, xt, g, jr, qq);

  // Geometric Jacobian columns in the EE frame, then J_task = [[jr, qq],
  // [0, jr]] @ Jgeo.
#pragma unroll
  for (int j = 0; j < A; ++j) {
    float lin[3], ang[3];
    if (ch.pris[j]) {
      mat3_tvec(r, dir_w[j], lin);
      ang[0] = ang[1] = ang[2] = 0.0f;
    } else {
      const float d0 = t[0] - p_j[j][0], d1 = t[1] - p_j[j][1], d2 = t[2] - p_j[j][2];
      const float* u = dir_w[j];
      const float lw[3] = {u[1] * d2 - u[2] * d1, u[2] * d0 - u[0] * d2,
                           u[0] * d1 - u[1] * d0};
      mat3_tvec(r, lw, lin);
      mat3_tvec(r, dir_w[j], ang);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      jt[i][j] = (jr[3 * i] * lin[0] + jr[3 * i + 1] * lin[1] + jr[3 * i + 2] * lin[2])
               + (qq[3 * i] * ang[0] + qq[3 * i + 1] * ang[1] + qq[3 * i + 2] * ang[2]);
      jt[3 + i][j] = jr[3 * i] * ang[0] + jr[3 * i + 1] * ang[1] + jr[3 * i + 2] * ang[2];
    }
  }
  if constexpr (WEIGHTED) {
    // e <- M e, J <- M J with M = blockdiag(ml, ma): two 3x3 blocks, never a
    // 6x6 product (the off-diagonal blocks are static zeros).
    if (use_l) {
      weight3(ml, e[0], e[1], e[2], e[0], e[1], e[2]);
#pragma unroll
      for (int j = 0; j < A; ++j)
        weight3(ml, jt[0][j], jt[1][j], jt[2][j], jt[0][j], jt[1][j], jt[2][j]);
    }
    if (use_a) {
      weight3(ma, e[3], e[4], e[5], e[3], e[4], e[5]);
#pragma unroll
      for (int j = 0; j < A; ++j)
        weight3(ma, jt[3][j], jt[4][j], jt[5][j], jt[3][j], jt[4][j], jt[5][j]);
    }
  }
  f = e[0] * e[0] + e[1] * e[1] + e[2] * e[2] + e[3] * e[3] + e[4] * e[4] + e[5] * e[5];
}

// --- the solve ----------------------------------------------------------------

// One word per warp between the two warps of a pose pair (OPTIK_WIDE).
__device__ __forceinline__ unsigned pair_exchange(unsigned (*xchg)[2][2], int it,
                                                  unsigned word) {
  const int lane = threadIdx.x & 31;
  const int half = (threadIdx.x >> 5) & 1;
  const int pair = threadIdx.x >> 6;
  volatile unsigned* slot = xchg[pair][it & 1];
  if (lane == 0) slot[half] = word;
  // Named barrier of this pair's 64 threads (id 0 is __syncthreads).  The
  // buffer alternates with the iteration's parity: a warp can only reach
  // its write of iteration it + 2 after its partner has passed the barrier
  // of iteration it + 1, i.e. after the partner's read of iteration it.
  asm volatile("bar.sync %0, 64;" ::"r"(pair + 1) : "memory");
  return slot[half ^ 1];
}

template <int A, bool QUALITY, bool WEIGHTED, bool WIDE>
__global__ void __launch_bounds__(kBlockThreads)
lm_solve_kernel(const __grid_constant__ Chain<A> ch, const Opts o, int n_pose, int s_lanes,
                int s_pad, int total_restarts, int reseed, int freeze, int max_total_iters,
                const float* __restrict__ seeds,   // (A, L), L = n_pose * s_lanes
                const float* __restrict__ tgt,     // (12, B)
                const float* __restrict__ table,   // (R, A)
                const float* __restrict__ qx0,     // (A, B), Quality with reseeding
                float* __restrict__ x_out,         // (A, L)
                float* __restrict__ f_out,         // (L,)
                int8_t* __restrict__ succ_out,     // (L,)
                int* __restrict__ idx_out,         // (L,)
                int* __restrict__ sit_out,         // (L,)
                int* __restrict__ warp_work) {     // (threads / 32,)
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int pose_t = t / s_pad;
  const int seed = t % s_pad;
  const bool live = pose_t < n_pose && seed < s_lanes;
  const int pose = live ? pose_t : 0;
  const int n_lanes = n_pose * s_lanes;
  const int l = pose * s_lanes + seed;   // read only where live
  // The pose's lanes inside this warp; empty when the Speed freeze is off.
  const unsigned group = !freeze ? 0u
      : (s_pad >= 32 ? kFullMask : ((1u << s_pad) - 1u) << ((lane / s_pad) * s_pad));
  // Quality best-tracking runs only when lanes stride a restart budget.
  const bool track_best = QUALITY && reseed;

  float tr[9], tt[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) tr[i] = live ? tgt[i * n_pose + pose] : (i % 4 == 0 ? 1.0f : 0.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) tt[i] = live ? tgt[(9 + i) * n_pose + pose] : 0.0f;

  // Weighting blocks M = R^T D R with R the lane's target rotation, each
  // entry summed as ((R_0i w_0) R_0j + (R_1i w_1) R_1j) + (R_2i w_2) R_2j.
  float ml[WEIGHTED ? 9 : 1], ma[WEIGHTED ? 9 : 1];
  if constexpr (WEIGHTED) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ml[3 * i + j] = ((tr[i] * o.wl[0]) * tr[j] + (tr[3 + i] * o.wl[1]) * tr[3 + j])
                        + (tr[6 + i] * o.wl[2]) * tr[6 + j];
        ma[3 * i + j] = ((tr[i] * o.wa[0]) * tr[j] + (tr[3 + i] * o.wa[1]) * tr[3 + j])
                        + (tr[6 + i] * o.wa[2]) * tr[6 + j];
      }
  }
  const bool use_l = WEIGHTED && !o.lin_id, use_a = WEIGHTED && !o.ang_id;

  float x[A], e[6], jt[6][A];
#pragma unroll
  for (int p = 0; p < A; ++p) x[p] = live ? seeds[p * n_lanes + l] : 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    e[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < A; ++p) jt[i][p] = 0.0f;
  }
  float f = INFINITY, lam = o.lam_init, nu = 2.0f;
  bool stopped = !live, success = false, pending = true;
  int cur_idx = reseed ? seed : 0;
  int it_lane = 0, succ_it = 0;

  // Quality: the caller's seed and the lane's best success so far.
  float q0[QUALITY ? A : 1], bx[QUALITY ? A : 1];
  float bd = INFINITY, bf = INFINITY;
  int bi = 0, succ_cnt = 0;
  if constexpr (QUALITY) {
#pragma unroll
    for (int p = 0; p < A; ++p) {
      q0[p] = (track_best && live) ? qx0[p * n_pose + pose] : 0.0f;
      bx[p] = 0.0f;
    }
  }

  __shared__ unsigned xchg[WIDE ? kBlockThreads / 64 : 1][2][2];
  // WIDE: whether both warps of the pair have stopped (the pair's exit test).
  bool pair_done = pose_t >= n_pose;

  int it = 0;
  for (; it < max_total_iters; ++it) {
    if constexpr (WIDE) {
      if (pair_done) break;
    } else {
      if (__all_sync(kFullMask, stopped)) break;
    }

    // Damped GN step from the carried (e, J):
    // delta = -J^T (J J^T + lam I)^-1 e.
    float jjt[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        float v = jt[i][0] * jt[k][0];
#pragma unroll
        for (int p = 1; p < A; ++p) v = v + jt[i][p] * jt[k][p];
        jjt[i][k] = v;
        jjt[k][i] = v;
      }
      jjt[i][i] = jjt[i][i] + lam;
    }
    float z[6];
    cholesky_solve6(jjt, e, z);

    float xn[A], step[A];
#pragma unroll
    for (int p = 0; p < A; ++p) {
      float d = jt[0][p] * z[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) d = d + jt[i][p] * z[i];
      float v = x[p] + (-d);
      v = v < ch.lower[p] ? ch.lower[p] : v;   // NaN stays NaN, as jnp.clip
      v = v > ch.upper[p] ? ch.upper[p] : v;
      // Pending lanes adopt a point instead of stepping: the initial seed
      // on the very first iteration, or the next stride seed.
      if (pending) v = (reseed && it != 0) ? table[cur_idx * A + p] : x[p];
      xn[p] = v;
      step[p] = v - x[p];
    }

    // ONE fused evaluation: trial cost + the next step's Jacobian.
    float e_new[6], jt_new[6][A], f_new;
    residual_and_jtask<A, WEIGHTED>(ch, xn, tr, tt, ml, ma, use_l, use_a, e_new, jt_new,
                                    f_new);

    const bool finite = isfinite(f_new);
    const bool accept = ((f_new < f) || pending) && finite;

    // Nielsen gain ratio on the projected step.
    float w[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float v = jt[i][0] * step[0];
#pragma unroll
      for (int p = 1; p < A; ++p) v = v + jt[i][p] * step[p];
      w[i] = v;
    }
    float ew = e[0] * w[0], ww = w[0] * w[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      ew = ew + e[i] * w[i];
      ww = ww + w[i] * w[i];
    }
    const float pred = -(2.0f * ew + ww);
    const float rho = (f - f_new) / nmax(pred, kTiny);
    const bool good = accept && (pred > 0.0f) && !pending;
    const float g3 = 2.0f * rho - 1.0f;
    const float shrink = nmax(1.0f - g3 * g3 * g3, (float)(1.0 / 3.0));

    const bool keep = stopped || !accept;
    const float f_old = f;
    if (!keep) {
#pragma unroll
      for (int p = 0; p < A; ++p) x[p] = xn[p];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        e[i] = e_new[i];
#pragma unroll
        for (int p = 0; p < A; ++p) jt[i][p] = jt_new[i][p];
      }
      f = f_new;
    }

    float lam_next = nmin(nmax(good ? lam * shrink : lam * nu, o.lam_min), o.lam_max);
    float nu_next = good ? 2.0f : nmin(nu * 2.0f, 64.0f);
    if (pending && !stopped) {
      lam_next = o.lam_init;
      nu_next = 2.0f;
    }
    if (stopped) {
      lam_next = lam;
      nu_next = nu;
    }

    // --- stopping criteria ---------------------------------------------------
    const bool newly_f = o.f_is_success && (f <= o.tol_f);
    const float df = fabsf(f_old - f);
    const bool newly_df = accept && (df < o.tol_df) && !pending;
    bool newly_dx = false;
    if (o.use_dx) {
      float adx = fabsf(step[0]);
#pragma unroll
      for (int p = 1; p < A; ++p) adx = nmax(adx, fabsf(step[p]));
      newly_dx = accept && (adx < o.tol_dx) && !pending;
    }
    const bool newly_stuck = lam_next >= o.lam_max;

    const bool run = !stopped;
    const bool succ_now = newly_f || (o.df_is_success && newly_df)
                          || (o.dx_is_success && newly_dx);
    const bool first_succ = run && succ_now && !success;
    success = success || (run && succ_now);
    int it_next = (pending && run) ? 1 : it_lane + 1;
    if (first_succ) succ_it = it_next;
    bool attempt_over = newly_f || newly_df || newly_dx || newly_stuck
                        || (it_next > o.max_iters) || (pending && !finite);

    if constexpr (QUALITY) {
      if (track_best) {
        // Record this attempt's solution if it is the lane's best success so
        // far (least distance to the caller's seed), then keep exploring.
        float d2 = (x[0] - q0[0]) * (x[0] - q0[0]);
#pragma unroll
        for (int p = 1; p < A; ++p) d2 = d2 + (x[p] - q0[p]) * (x[p] - q0[p]);
        const float d = sqrtf(d2);
        if (run && succ_now && (d < bd)) {
#pragma unroll
          for (int p = 0; p < A; ++p) bx[p] = x[p];
          bd = d;
          bf = f;
          bi = cur_idx;
        }
      }
    }

    bool pending_next = false;
    if (reseed) {
      const int next_idx = cur_idx + s_lanes;
      const bool can_retry = next_idx < total_restarts;
      if constexpr (QUALITY) {
        // Every finished attempt, success or not, moves on to the next seed
        // while budget remains.
        const bool over = run && attempt_over;
        pending_next = over && can_retry;
        stopped = stopped || (over && !can_retry);
      } else {
        const bool failed_over = run && attempt_over && !succ_now;
        pending_next = failed_over && can_retry;
        stopped = stopped || (run && ((attempt_over && succ_now)
                                      || (failed_over && !can_retry)));
      }
      if (pending_next) {
        cur_idx = next_idx;
        it_next = 0;
      }
    } else {
      stopped = stopped || (run && attempt_over);
    }

    // Group decision.  Speed: once any restart of a pose succeeds, the
    // pose's lanes freeze (winner = earliest success, ties by lowest restart
    // index).  Quality with a cap: the pose freezes once its lanes have
    // completed `cap` successful attempts.  Dead lanes vote 0.
    bool pose_done = false;
    if constexpr (QUALITY) {
      if (o.cap > 0) {
        succ_cnt += (run && succ_now) ? 1 : 0;
        if constexpr (WIDE) {
          unsigned word = (unsigned)__reduce_add_sync(kFullMask, succ_cnt) << 1;
          word |= __all_sync(kFullMask, stopped) ? 1u : 0u;
          const unsigned other = pair_exchange(xchg, it, word);
          pose_done = (int)((word >> 1) + (other >> 1)) >= o.cap;
          pair_done = pose_done || ((word & other & 1u) != 0u);
        } else {
          int cnt = succ_cnt;
          for (int off = (s_pad < 32 ? s_pad : 32) >> 1; off > 0; off >>= 1)
            cnt += __shfl_xor_sync(kFullMask, cnt, off);
          pose_done = cnt >= o.cap;
        }
      }
    } else {
      const unsigned votes = __ballot_sync(kFullMask, success);
      if constexpr (WIDE) {
        unsigned word = votes != 0u ? 2u : 0u;
        word |= __all_sync(kFullMask, stopped) ? 1u : 0u;
        const unsigned other = pair_exchange(xchg, it, word);
        pose_done = ((word | other) & 2u) != 0u;
        pair_done = pose_done || ((word & other & 1u) != 0u);
      } else {
        pose_done = (votes & group) != 0u;
      }
    }
    stopped = stopped || pose_done;
    pending_next = pending_next && !pose_done;

    lam = lam_next;
    nu = nu_next;
    pending = pending_next;
    it_lane = it_next;
  }

  // Work done: the warp's loop count times its live lanes.
  const unsigned alive = __ballot_sync(kFullMask, live);
  if (lane == 0) warp_work[t / 32] = it * __popc(alive);
  if (live) {
    if (track_best) {
#pragma unroll
      for (int p = 0; p < A; ++p) x_out[p * n_lanes + l] = bx[p];
      f_out[l] = bf;
      succ_out[l] = isfinite(bd) ? 1 : 0;
      idx_out[l] = bi;
    } else {
#pragma unroll
      for (int p = 0; p < A; ++p) x_out[p * n_lanes + l] = x[p];
      f_out[l] = f;
      succ_out[l] = success ? 1 : 0;
      idx_out[l] = reseed ? cur_idx : seed;
    }
    sit_out[l] = succ_it;
  }
}

template <int A>
Chain<A> unpack_chain(const float* h) {
  Chain<A> c;
  for (int j = 0; j < A; ++j) {
    const float* b = h + j * kJointFloats;
    for (int i = 0; i < 9; ++i) c.org_r[j][i] = b[i];
    for (int i = 0; i < 3; ++i) c.org_t[j][i] = b[9 + i];
    for (int i = 0; i < 3; ++i) c.axis[j][i] = b[12 + i];
    for (int i = 0; i < 9; ++i) {
      c.rc0[j][i] = b[15 + i];
      c.rcc[j][i] = b[24 + i];
      c.rcs[j][i] = b[33 + i];
      c.rc1[j][i] = b[42 + i];
    }
    c.lower[j] = b[51];
    c.upper[j] = b[52];
    c.pris[j] = b[53] > 0.5f ? 1 : 0;
  }
  const float* tb = h + A * kJointFloats;
  for (int i = 0; i < 9; ++i) c.tip_r[i] = tb[i];
  for (int i = 0; i < 3; ++i) c.tip_t[i] = tb[9 + i];
  c.has_tip = tb[12] > 0.5f ? 1 : 0;
  return c;
}

}  // namespace

extern "C" {

int optik_lm_block_threads() { return kBlockThreads; }
int optik_lm_joint_floats() { return kJointFloats; }
int optik_lm_tip_floats() { return kTipFloats; }
int optik_lm_max_dof() { return kMaxDof; }
int optik_lm_num_opts() { return kNumOpts; }
// This library's instantiation: dof | quality << 8 | weighted << 9 | wide << 10.
int optik_lm_variant() {
  return kDof | (kQuality ? 1 << 8 : 0) | (kWeighted ? 1 << 9 : 0) | (kWide ? 1 << 10 : 0);
}

const char* optik_lm_error_string(int code) {
  if (code == -1) return "invalid argument to optik_lm_solve";
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success) or -1 for invalid arguments.  `chain` and `opts` are host
// arrays (copied into the kernel's parameters); `opts` holds max_iters,
// tol_f, tol_df, tol_dx, f_is_success, df_is_success, dx_is_success,
// lam_init, lam_min, lam_max, linear weights (3), angular weights (3),
// linear-is-identity, angular-is-identity, quality success cap.  Every other
// pointer is device memory.  A pose's `s_lanes` lanes occupy `s_pad` threads
// (a divisor of 32, or 64); `freeze` turns the Speed-mode group stop on.
// `qx0` is read only by the Quality instantiation with reseeding.  The
// kernel writes x_out, f_out, succ_out, idx_out and sit_out for the
// n_pose * s_lanes lanes, and warp_work for every launched warp
// (ceil(n_pose * s_pad / block) * block / 32 entries).
int optik_lm_solve(const float* chain, int chain_len, const float* opts, int n_opts,
                   int n_pose, int s_lanes, int s_pad, int total_restarts, int reseed,
                   int freeze, const float* seeds, const float* tgt, const float* table,
                   const float* qx0, float* x_out, float* f_out, int8_t* succ_out,
                   int* idx_out, int* sit_out, int* warp_work, void* stream) {
  const bool pad_ok = s_pad == 64 || (s_pad >= 1 && s_pad <= 32 && 32 % s_pad == 0);
  if (chain_len != kDof * kJointFloats + kTipFloats || n_opts != kNumOpts || n_pose < 1
      || s_lanes < 1 || !pad_ok || s_lanes > s_pad || total_restarts < s_lanes
      || (long long)n_pose * s_pad * kDof > 0x7fffffffLL)
    return -1;
  Opts o;
  o.max_iters = (int)opts[0];
  o.tol_f = opts[1];
  o.tol_df = opts[2];
  o.tol_dx = opts[3];
  o.f_is_success = opts[4] > 0.5f;
  o.df_is_success = opts[5] > 0.5f;
  o.dx_is_success = opts[6] > 0.5f;
  o.use_dx = opts[3] >= 0.0f;
  o.lam_init = opts[7];
  o.lam_min = opts[8];
  o.lam_max = opts[9];
  for (int i = 0; i < 3; ++i) {
    o.wl[i] = opts[10 + i];
    o.wa[i] = opts[13 + i];
  }
  o.lin_id = opts[16] > 0.5f;
  o.ang_id = opts[17] > 0.5f;
  o.cap = (int)opts[18];
  // What this instantiation cannot run.
  if (!kQuality && o.cap > 0) return -1;
  if (kQuality && (freeze || (reseed && qx0 == nullptr))) return -1;
  if (!kWeighted && !(o.lin_id && o.ang_id)) return -1;
  const bool crosses = s_pad == 64 && (kQuality ? o.cap > 0 : freeze != 0);
  if (crosses != kWide) return -1;
  const int rounds = reseed ? (total_restarts + s_lanes - 1) / s_lanes : 1;
  const int max_total_iters = (o.max_iters + 1) * rounds;
  const Chain<kDof> c = unpack_chain<kDof>(chain);
  const long long threads = (long long)n_pose * s_pad;
  const int blocks = (int)((threads + kBlockThreads - 1) / kBlockThreads);
  lm_solve_kernel<kDof, kQuality, kWeighted, kWide>
      <<<blocks, kBlockThreads, 0, (cudaStream_t)stream>>>(
          c, o, n_pose, s_lanes, s_pad, total_restarts, reseed, freeze, max_total_iters,
          seeds, tgt, table, qx0, x_out, f_out, succ_out, idx_out, sit_out, warp_work);
  return (int)cudaGetLastError();
}

}  // extern "C"
