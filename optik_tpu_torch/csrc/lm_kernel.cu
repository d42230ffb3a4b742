// Projected Levenberg-Marquardt IK solve for NVIDIA Hopper (sm_90a): one
// thread per lane, persistent thread groups that draw poses from a work
// queue, the robot's chain folded into the code when the library is built.
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
// function is optik_tpu_torch/ops/cuda/lm_kernel.py:solve_plain; built with
// --fmad=false this kernel equals it bit for bit in every lane.
//
// What bounds it on this card: FP32 throughput and the latency of one
// lane's dependent chain.  Every contraction is at most 6x7 per lane, so
// tensor cores and TMA are not the lever, and device memory is touched only
// to load a pose's seeds and target and to store its results.  A 7-DoF
// lane-iteration needs 2,015 FP32 operations (lm_kernel.py:
// fp32_ops_per_lane_iter: chain folded, one side of every select).  On an
// NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py: 131,072 Panda poses, 8
// lanes, 64 restarts) the inputs need 91.1 lane-iterations per solve, 24.07
// GFLOP against 79 MB: a bound of 0.360 ms by operations (0.02 ms by bytes).
// The times this design reaches, its registers and its resident warps are
// in PERF.md.
//
// Design (not the TPU block layout):
//   * One thread per lane; all state lives in registers.  A *group* is the
//     Sp consecutive threads that hold one pose's S lanes, Sp the next
//     divisor of 32 at or above S, or 64 (a pair of warps) for 32 < S <= 64.
//     Threads s >= S of a group are padding: they start stopped, are never
//     written out and are not counted as work.
//   * The schedule is a pose work queue.  Only as many blocks are launched
//     as are resident (the occupancy query times the SM count).  A group
//     draws a pose index from a device counter (atomicAdd by its first
//     lane, broadcast by shuffle; a pair through a word of shared memory),
//     runs that pose's lockstep loop with an iteration counter of its own,
//     writes the pose's lanes out, and draws again.  A group that draws an
//     index >= n_pose is dead; a warp leaves when all its groups are dead.
//     So no lane waits for another pose's straggler, inside the warp or
//     inside the block.  A pose's lanes talk only to each other (the Speed
//     ballot under the group's mask, the cap's butterfly over Sp lanes, the
//     pair exchange) and every per-lane value is set anew at a draw, so each
//     lane's result is the lockstep one whatever the packing.
//   * The chain is compile-time.  The wrapper writes the robot's joint
//     constants into optik_chain.h beside the library (they are part of the
//     build key).  FK and the Jacobian columns run on scalars whose kind is
//     part of their type: `Dyn`, a lane's float, or `Stat<E>`, a value known
//     at build time whose E::value() is a constexpr double.  smul / sadd /
//     ssub in the image of ops/soa.py choose with `if constexpr`: a product
//     with a static 0 is dropped, a static +-1 passes through as a copy or
//     a negation, an add of a static 0 is skipped, static with static is
//     folded in double as the plain version folds Python floats.  Vectors
//     and matrices of such scalars are tuples, the walk over the joints a
//     template recursion; only the live float operations are ever emitted,
//     in the plain version's order.  Joint limits, the tip and the options
//     stay run-time (an ee_offset folded into the tip does not rebuild);
//     whether there is a tip is compile-time.
//   * The small-angle series of the rotation log and of the SE(3)
//     coefficients sit behind one branch each: the side a lane does not
//     select (constant divisions) is not executed.
//   * Inputs are SoA: seed component p of lane l = pose * S + s at
//     seeds[p * L + l] (lane-major, L = B * S), target component c of pose b
//     at tgt[c * B + b].  The seed for restart index k is table[k * A + p].
//   * A pair of warps (Sp == 64) draws through shared memory around a named
//     barrier (bar.sync id, 64), so both warps hold the same pose.  Speed
//     freeze and the Quality cap (OPTIK_WIDE) also exchange one word per
//     warp and iteration, double-buffered by iteration parity, and share
//     the "pose is done" test, so both warps reach every barrier the same
//     number of times.
//   * Schedule probe: lane 0 of each warp stores %globaltimer at its start,
//     at its last successful draw and at its exit, and its loop trips; each
//     group stores the iterations its pose ran, times S.
//   * Math: the same polynomial atan2 and sincos as the plain version's
//     kernel math mode, rsqrtf in the Cholesky, IEEE division and sqrt (the
//     library is built without --use_fast_math).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <dir of optik_chain.h> [-DOPTIK_QUALITY=1]
//        [-DOPTIK_WEIGHTED=1] [-DOPTIK_WIDE=1] -o liblm_kernel.so lm_kernel.cu
// The C entry point optik_lm_solve returns cudaGetLastError() after the
// launch (or a negative code for invalid arguments) and is bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "optik_chain.h"

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

constexpr int kDof = optik_chain::kDof;
constexpr bool kHasTip = optik_chain::kHasTip;
constexpr bool kQuality = OPTIK_QUALITY != 0;
constexpr bool kWeighted = OPTIK_WEIGHTED != 0;
constexpr bool kWide = OPTIK_WIDE != 0;
constexpr int kMaxDof = 10;
static_assert(kDof >= 1 && kDof <= kMaxDof, "the chain must have 1..10 joints");
constexpr int kNumOpts = 19;
// A block is one pair of warps, the most threads one pose can take:
// registers are granted per warp, so the smallest block wastes none.
constexpr int kBlockThreads = 64;
constexpr unsigned kFullMask = 0xffffffffu;

// What of the chain stays run-time, as the host array lays it out: tip_r
// (9), tip_t (3), has_tip (1), lower (A), upper (A).
constexpr int kRuntimeFloats = 13 + 2 * kDof;

constexpr float kEps = 1e-6f;       // Taylor switch (optik_tpu/math/so3.py)
constexpr float kTiny = 1e-30f;
constexpr float kPi = 3.14159265358979323846f;

struct Runtime {
  float tip_r[9];
  float tip_t[3];
  float lower[kDof], upper[kDof];
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
  // One division for the three ranges: -1 / t, (t - 1) / (t + 1), t / 1.
  const float num = big ? -1.0f : (mid ? t - 1.0f : t);
  const float den = big ? nmax(t, kTiny) : (mid ? t + 1.0f : 1.0f);
  const float x = num / den;
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

// --- static-sparsity scalars (ops/soa.py smul / sadd / ssub) ----------------

// A scalar of the chain math has one of two kinds of type.  `Dyn` is a
// lane's float.  `Stat<E>` is a value known when the library is built: an
// empty type whose E::value() is a constexpr double, the way the plain
// version keeps a Python float until it meets a tensor.  The kind of every
// intermediate is part of its type, so what folds is decided by
// `if constexpr` when the templates are instantiated, and only the live
// float operations reach the optimiser, in the plain version's order.
struct Dyn {
  float d;
};
template <class E>
struct Stat {
  static __host__ __device__ constexpr double value() { return E::value(); }
};

struct Zero {
  static __host__ __device__ constexpr double value() { return 0.0; }
};
struct One {
  static __host__ __device__ constexpr double value() { return 1.0; }
};
// The chain's constants (optik_chain.h) as static scalars.
template <int J, int I>
struct OrgR {
  static __host__ __device__ constexpr double value() { return optik_chain::org_r(J, I); }
};
template <int J, int I>
struct OrgT {
  static __host__ __device__ constexpr double value() { return optik_chain::org_t(J, I); }
};
template <int J, int I>
struct Axis {
  static __host__ __device__ constexpr double value() { return optik_chain::axis(J, I); }
};
// Static with static folds in double, as Python folds two floats.
template <class A>
struct Neg {
  static __host__ __device__ constexpr double value() { return -A::value(); }
};
template <class A, class B>
struct Mul {
  static __host__ __device__ constexpr double value() { return A::value() * B::value(); }
};
template <class A, class B>
struct Add {
  static __host__ __device__ constexpr double value() { return A::value() + B::value(); }
};
template <class A, class B>
struct Sub {
  static __host__ __device__ constexpr double value() { return A::value() - B::value(); }
};

template <class T>
constexpr bool kIsStat = false;
template <class E>
constexpr bool kIsStat<Stat<E>> = true;

// Whether T is a static scalar equal to v.
template <class T>
__host__ __device__ constexpr bool stat_is(double v) {
  if constexpr (kIsStat<T>) {
    return T::value() == v;
  } else {
    return false;
  }
}

// The value as the lane's float (a static one rounds here, as a Python
// float rounds when it meets a float32 tensor).
__device__ __forceinline__ float val(Dyn a) { return a.d; }
template <class E>
__device__ __forceinline__ float val(Stat<E>) {
  return (float)E::value();
}

__device__ __forceinline__ Dyn sneg(Dyn a) { return Dyn{-a.d}; }
template <class E>
__device__ __forceinline__ Stat<Neg<E>> sneg(Stat<E>) {
  return {};
}

template <class A, class B>
__device__ __forceinline__ auto smul(A a, B b) {
  if constexpr (kIsStat<A> && kIsStat<B>) {
    return Stat<Mul<A, B>>{};
  } else if constexpr (kIsStat<A>) {
    return smul(b, a);
  } else if constexpr (kIsStat<B>) {
    if constexpr (B::value() == 0.0) {
      return Stat<Zero>{};
    } else if constexpr (B::value() == 1.0) {
      return a;
    } else if constexpr (B::value() == -1.0) {
      return Dyn{-a.d};
    } else {
      return Dyn{a.d * (float)B::value()};
    }
  } else {
    return Dyn{a.d * b.d};
  }
}

template <class A, class B>
__device__ __forceinline__ auto sadd(A a, B b) {
  if constexpr (stat_is<A>(0.0)) {
    return b;
  } else if constexpr (stat_is<B>(0.0)) {
    return a;
  } else if constexpr (kIsStat<A> && kIsStat<B>) {
    return Stat<Add<A, B>>{};
  } else {
    return Dyn{val(a) + val(b)};
  }
}

template <class A, class B>
__device__ __forceinline__ auto ssub(A a, B b) {
  if constexpr (stat_is<B>(0.0)) {
    return a;
  } else if constexpr (stat_is<A>(0.0)) {
    return sneg(b);
  } else if constexpr (kIsStat<A> && kIsStat<B>) {
    return Stat<Sub<A, B>>{};
  } else {
    return Dyn{val(a) - val(b)};
  }
}

// a0 b0 + a1 b1 + a2 b2, summed left to right from a static 0 (soa.ssum).
template <class A0, class B0, class A1, class B1, class A2, class B2>
__device__ __forceinline__ auto dot3(A0 a0, B0 b0, A1 a1, B1 b1, A2 a2, B2 b2) {
  return sadd(sadd(sadd(Stat<Zero>{}, smul(a0, b0)), smul(a1, b1)), smul(a2, b2));
}

// Vectors (3) and row-major matrices (9) of such scalars: each entry has a
// type of its own, so they are tuples.
template <class... T>
struct Tup;
template <>
struct Tup<> {};
template <class H, class... T>
struct Tup<H, T...> {
  H head;
  Tup<T...> tail;
};

__device__ __forceinline__ Tup<> tup() { return {}; }
template <class H, class... T>
__device__ __forceinline__ Tup<H, T...> tup(H h, T... t) {
  return Tup<H, T...>{h, tup(t...)};
}

template <int I, class H, class... T>
__device__ __forceinline__ auto get(const Tup<H, T...>& u) {
  if constexpr (I == 0) {
    return u.head;
  } else {
    return get<I - 1>(u.tail);
  }
}

template <class X>
__device__ __forceinline__ Tup<X> append(const Tup<>&, X x) {
  return tup(x);
}
template <class H, class... T, class X>
__device__ __forceinline__ Tup<H, T..., X> append(const Tup<H, T...>& u, X x) {
  return Tup<H, T..., X>{u.head, append(u.tail, x)};
}

__device__ __forceinline__ auto dyn3(const float* v) {
  return tup(Dyn{v[0]}, Dyn{v[1]}, Dyn{v[2]});
}
__device__ __forceinline__ auto dyn9(const float* m) {
  return tup(Dyn{m[0]}, Dyn{m[1]}, Dyn{m[2]}, Dyn{m[3]}, Dyn{m[4]}, Dyn{m[5]}, Dyn{m[6]},
             Dyn{m[7]}, Dyn{m[8]});
}

// Entry (I, J) of a * b, and a * b, for row-major 3x3 (soa.mat_mul).
template <int I, int J, class A, class B>
__device__ __forceinline__ auto mul_entry(const A& a, const B& b) {
  return dot3(get<3 * I>(a), get<J>(b), get<3 * I + 1>(a), get<3 + J>(b),
              get<3 * I + 2>(a), get<6 + J>(b));
}
template <class A, class B>
__device__ __forceinline__ auto vmat_mul(const A& a, const B& b) {
  return tup(mul_entry<0, 0>(a, b), mul_entry<0, 1>(a, b), mul_entry<0, 2>(a, b),
             mul_entry<1, 0>(a, b), mul_entry<1, 1>(a, b), mul_entry<1, 2>(a, b),
             mul_entry<2, 0>(a, b), mul_entry<2, 1>(a, b), mul_entry<2, 2>(a, b));
}

// Entry (I, J) of a^T * b, and a^T * b.
template <int I, int J, class A, class B>
__device__ __forceinline__ auto tmul_entry(const A& a, const B& b) {
  return dot3(get<I>(a), get<J>(b), get<3 + I>(a), get<3 + J>(b), get<6 + I>(a),
              get<6 + J>(b));
}
template <class A, class B>
__device__ __forceinline__ auto vmat_tmul(const A& a, const B& b) {
  return tup(tmul_entry<0, 0>(a, b), tmul_entry<0, 1>(a, b), tmul_entry<0, 2>(a, b),
             tmul_entry<1, 0>(a, b), tmul_entry<1, 1>(a, b), tmul_entry<1, 2>(a, b),
             tmul_entry<2, 0>(a, b), tmul_entry<2, 1>(a, b), tmul_entry<2, 2>(a, b));
}

// Row I of a * v, and y = a * v (soa.mat_vec).
template <int I, class A, class V>
__device__ __forceinline__ auto row_dot(const A& a, const V& v) {
  return dot3(get<3 * I>(a), get<0>(v), get<3 * I + 1>(a), get<1>(v), get<3 * I + 2>(a),
              get<2>(v));
}
template <class A, class V>
__device__ __forceinline__ auto vmat_vec(const A& a, const V& v) {
  return tup(row_dot<0>(a, v), row_dot<1>(a, v), row_dot<2>(a, v));
}

// Column I of a against v, and y = a^T * v (soa.mat_tvec).
template <int I, class A, class V>
__device__ __forceinline__ auto col_dot(const A& a, const V& v) {
  return dot3(get<I>(a), get<0>(v), get<3 + I>(a), get<1>(v), get<6 + I>(a), get<2>(v));
}
template <class A, class V>
__device__ __forceinline__ auto vmat_tvec(const A& a, const V& v) {
  return tup(col_dot<0>(a, v), col_dot<1>(a, v), col_dot<2>(a, v));
}

template <class U, class V>
__device__ __forceinline__ auto vec_add(const U& u, const V& v) {
  return tup(sadd(get<0>(u), get<0>(v)), sadd(get<1>(u), get<1>(v)),
             sadd(get<2>(u), get<2>(v)));
}
template <class U, class V>
__device__ __forceinline__ auto vec_sub(const U& u, const V& v) {
  return tup(ssub(get<0>(u), get<0>(v)), ssub(get<1>(u), get<1>(v)),
             ssub(get<2>(u), get<2>(v)));
}
template <class U, class V>
__device__ __forceinline__ auto vec_cross(const U& u, const V& v) {
  return tup(ssub(smul(get<1>(u), get<2>(v)), smul(get<2>(u), get<1>(v))),
             ssub(smul(get<2>(u), get<0>(v)), smul(get<0>(u), get<2>(v))),
             ssub(smul(get<0>(u), get<1>(v)), smul(get<1>(u), get<0>(v))));
}

// R = I + sin(q) K + (1 - cos(q)) K^2 for the static unit axis k
// (soa.rodrigues).
template <class K>
__device__ __forceinline__ auto rodrigues(const K& k, float q) {
  float sn, cs;
  sincos_poly(q, sn, cs);
  const Dyn s{sn}, c{cs}, c1{1.0f - cs};
  const auto kx = get<0>(k);
  const auto ky = get<1>(k);
  const auto kz = get<2>(k);
  auto diag = [&](auto kk) {  // 1 + c1 * (kk - 1), kk = sum of the squared others
    if constexpr (stat_is<decltype(kk)>(1.0)) {
      return c;  // axis-aligned: 1 - c1
    } else {
      return sadd(Stat<One>{}, smul(c1, sneg(kk)));
    }
  };
  auto off = [&](auto sk, auto ka, auto kb) {  // sk * s + c1 * (ka * kb)
    return sadd(smul(sk, s), smul(smul(ka, kb), c1));
  };
  return tup(diag(sadd(smul(ky, ky), smul(kz, kz))), off(sneg(kz), kx, ky), off(ky, kx, kz),
             off(kz, kx, ky), diag(sadd(smul(kx, kx), smul(kz, kz))), off(sneg(kx), ky, kz),
             off(sneg(ky), kx, kz), off(kx, ky, kz), diag(sadd(smul(kx, kx), smul(ky, ky))));
}

// --- small linear algebra on floats -----------------------------------------

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
  float tt;
  if (v2 <= kEps * n2) {  // small angle: the series in v2 / w^2
    const float inv_w = 1.0f / nmax(w, kTiny);
    const float u = v2 * inv_w * inv_w;
    tt = 2.0f * (inv_w * (1.0f - u / 3.0f + (u * u) / 5.0f));
  } else {
    tt = 2.0f * (half / vn);
  }
  w_log[0] = x * tt;
  w_log[1] = y * tt;
  w_log[2] = z * tt;
  const float inv_n2 = 1.0f / n2;
  trig.theta = theta;
  trig.theta2 = theta * theta;
  trig.s = 2.0f * vn * w * inv_n2;
  trig.c = (w * w - v2) * inv_n2;
}

// The coefficients of se3_log_trig, so3_right_jacobian_trig and
// se3_right_jacobian_blocks_trig that switch to a series at a small angle.
struct Coefs {
  float log_c;   // V^-1's [w]x^2 coefficient
  float jr_e;    // J_r's [w]x^2 coefficient (b - 2c) / (2a)
  float qa, qb;  // the Q block's a and b
};

__device__ __forceinline__ Coefs angle_coefs(const Trig& g) {
  Coefs k;
  float a, b, c;
  if (g.theta2 <= kEps) {
    const float t4 = g.theta2 * g.theta2;
    k.log_c = (float)(1.0 / 12.0) + g.theta2 / 720.0f + t4 / 30240.0f;
    a = 1.0f - g.theta2 / 6.0f + t4 / 120.0f;
    b = 0.5f - g.theta2 / 24.0f + t4 / 720.0f;
    c = (float)(1.0 / 6.0) - g.theta2 / 120.0f + t4 / 5040.0f;
    k.qa = (float)(1.0 / 12.0) + g.theta2 / 720.0f;
    k.qb = (float)(1.0 / 360.0);
  } else {
    const float inv_t2 = 1.0f / g.theta2;
    k.log_c = (1.0f - 0.5f * g.theta * g.s / nmax(1.0f - g.c, kTiny)) * inv_t2;
    a = g.s * g.theta * inv_t2;  // sin(theta) / theta
    b = (1.0f - g.c) * inv_t2;
    c = (1.0f - a) * inv_t2;
    const float inv_1mc = 1.0f / nmax(2.0f * (1.0f - g.c), kTiny);
    k.qa = inv_t2 - a * inv_1mc;
    k.qb = -2.0f * inv_t2 * inv_t2 + (1.0f + a) * inv_1mc * inv_t2;
  }
  k.jr_e = (b - 2.0f * c) / (2.0f * a);
  return k;
}

// [v; w] with v = V^-1 t (se3_log_trig).
__device__ __forceinline__ void se3_log_trig(const float* w, const float* t,
                                             const Coefs& k, float* e) {
  float v_inv[9];
  add_hat_terms(1.0f, w, -0.5f, k.log_c, v_inv);
  mat3_vec(v_inv, t, e);
  e[3] = w[0];
  e[4] = w[1];
  e[5] = w[2];
}

// (J_r(w), Q(t, w)) blocks of the SE(3) right Jacobian
// (se3_right_jacobian_blocks_trig).
__device__ __forceinline__ void se3_right_jacobian_blocks(const float* w, const float* t,
                                                          const Trig& g, const Coefs& k,
                                                          float* jr, float* q) {
  const float a = k.qa, b = k.qb;
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
  add_hat_terms(1.0f, w, 0.5f, k.jr_e, jr);  // so3_right_jacobian_trig
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

// Joint J's constants as static scalars.
template <int J>
__device__ __forceinline__ auto origin_r() {
  return tup(Stat<OrgR<J, 0>>{}, Stat<OrgR<J, 1>>{}, Stat<OrgR<J, 2>>{}, Stat<OrgR<J, 3>>{},
             Stat<OrgR<J, 4>>{}, Stat<OrgR<J, 5>>{}, Stat<OrgR<J, 6>>{}, Stat<OrgR<J, 7>>{},
             Stat<OrgR<J, 8>>{});
}
template <int J>
__device__ __forceinline__ auto origin_t() {
  return tup(Stat<OrgT<J, 0>>{}, Stat<OrgT<J, 1>>{}, Stat<OrgT<J, 2>>{});
}
template <int J>
__device__ __forceinline__ auto joint_axis() {
  return tup(Stat<Axis<J, 0>>{}, Stat<Axis<J, 1>>{}, Stat<Axis<J, 2>>{});
}

// Joint J's local frame (lr, lt) at joint value q (soa.fk_joints).
template <int J>
__device__ __forceinline__ auto local_frame(float q) {
  if constexpr (optik_chain::prismatic(J)) {
    const Dyn qd{q};
    const auto axis = joint_axis<J>();
    const auto ax = tup(smul(get<0>(axis), qd), smul(get<1>(axis), qd), smul(get<2>(axis), qd));
    return tup(origin_r<J>(), vec_add(origin_t<J>(), vmat_vec(origin_r<J>(), ax)));
  } else {
    return tup(vmat_mul(origin_r<J>(), rodrigues(joint_axis<J>(), q)), origin_t<J>());
  }
}

// FK over joints J.. on top of the frame (r, t) after joint J - 1 (an
// identity prefix for J == 0): (r, t, frames) with r, t the frame after the
// last joint and frames one (dir_w, p) per joint, the joint's axis and
// origin in the world (soa.fk_joints, the first half of soa.jacobian_cols).
template <int J, class R, class T, class F>
__device__ __forceinline__ auto fk_chain(const float* q, const R& r, const T& t,
                                         const F& frames) {
  if constexpr (J == kDof) {
    return tup(r, t, frames);
  } else {
    const auto local = local_frame<J>(q[J]);
    const auto lr = get<0>(local);
    const auto lt = get<1>(local);
    if constexpr (J == 0) {
      return fk_chain<1>(q, lr, lt, tup(tup(vmat_vec(lr, joint_axis<0>()), lt)));
    } else {
      const auto tn = vec_add(vmat_vec(r, lt), t);
      const auto rn = vmat_mul(r, lr);
      return fk_chain<J + 1>(q, rn, tn,
                             append(frames, tup(vmat_vec(rn, joint_axis<J>()), tn)));
    }
  }
}

// The end-effector frame: the chain's tip on the last joint's frame.
template <class R, class T>
__device__ __forceinline__ auto apply_tip(const Runtime& rt, const R& r, const T& t) {
  if constexpr (kHasTip) {
    return tup(vmat_mul(r, dyn9(rt.tip_r)), vec_add(vmat_vec(r, dyn3(rt.tip_t)), t));
  } else {
    return tup(r, t);
  }
}

// Column J (and the later ones) of J_task = [[jr, qq], [0, jr]] @ Jgeo, Jgeo
// the geometric Jacobian in the EE frame (soa.jacobian_cols).
template <int J, class F, class R, class T, class JR, class QQ>
__device__ __forceinline__ void task_columns(const F& frames, const R& r, const T& t,
                                             const JR& jr, const QQ& qq,
                                             float jt[6][kDof]) {
  const auto dir_w = get<0>(get<J>(frames));
  const auto p = get<1>(get<J>(frames));
  auto column = [&]() {  // (linear, angular) in the EE frame
    if constexpr (optik_chain::prismatic(J)) {
      return tup(vmat_tvec(r, dir_w), tup(Stat<Zero>{}, Stat<Zero>{}, Stat<Zero>{}));
    } else {
      return tup(vmat_tvec(r, vec_cross(dir_w, vec_sub(t, p))), vmat_tvec(r, dir_w));
    }
  };
  const auto col = column();
  const auto lin = get<0>(col);
  const auto ang = get<1>(col);
  jt[0][J] = val(sadd(row_dot<0>(jr, lin), row_dot<0>(qq, ang)));
  jt[1][J] = val(sadd(row_dot<1>(jr, lin), row_dot<1>(qq, ang)));
  jt[2][J] = val(sadd(row_dot<2>(jr, lin), row_dot<2>(qq, ang)));
  jt[3][J] = val(row_dot<0>(jr, ang));
  jt[4][J] = val(row_dot<1>(jr, ang));
  jt[5][J] = val(row_dot<2>(jr, ang));
  if constexpr (J + 1 < kDof) task_columns<J + 1>(frames, r, t, jr, qq, jt);
}

template <class V>
__device__ __forceinline__ void store3(const V& v, float* out) {
  out[0] = val(get<0>(v));
  out[1] = val(get<1>(v));
  out[2] = val(get<2>(v));
}

// `ml` / `ma` are the lane's weighting blocks R^T D_l R and R^T D_a R
// (weighted instantiation only); `use_l` / `use_a` false leaves that half
// unweighted, exactly as the plain version folds its static identity block.
template <int A, bool WEIGHTED>
__device__ __forceinline__ void residual_and_jtask(const Runtime& rt, const float* q,
                                                   const float* tr, const float* tt,
                                                   const float* ml, const float* ma,
                                                   bool use_l, bool use_a,
                                                   float* e, float jt[6][A], float& f) {
  static_assert(A == kDof, "the chain header fixes the DoF");
  const auto chain = fk_chain<0>(q, Tup<>{}, Tup<>{}, Tup<>{});
  const auto frames = get<2>(chain);
  const auto ee = apply_tip(rt, get<0>(chain), get<1>(chain));
  const auto r = get<0>(ee);
  const auto t = get<1>(ee);

  // X = T_tgt^-1 * T_ee
  const auto vtr = dyn9(tr);
  const auto vxr = vmat_tmul(vtr, r);
  const auto vxt = vmat_tvec(vtr, vec_sub(t, dyn3(tt)));
  float xr[9], xt[3];
  store3(tup(get<0>(vxr), get<1>(vxr), get<2>(vxr)), xr);
  store3(tup(get<3>(vxr), get<4>(vxr), get<5>(vxr)), xr + 3);
  store3(tup(get<6>(vxr), get<7>(vxr), get<8>(vxr)), xr + 6);
  store3(vxt, xt);

  float w_log[3];
  Trig g;
  rot_log_terms(xr, w_log, g);
  const Coefs k = angle_coefs(g);
  se3_log_trig(w_log, xt, k, e);

  float jr[9], qq[9];
  se3_right_jacobian_blocks(w_log, xt, g, k, jr, qq);
  task_columns<0>(frames, r, t, dyn9(jr), dyn9(qq), jt);

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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
  return now;
}

// Named barrier of the block's pair of warps (id 0 is __syncthreads).
__device__ __forceinline__ void pair_barrier() {
  static_assert(kBlockThreads == 64, "the block is one pair");
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// One word per warp between the two warps of a pose pair (OPTIK_WIDE).
__device__ __forceinline__ unsigned pair_exchange(unsigned (*xchg)[2], int it,
                                                  unsigned word) {
  const int lane = threadIdx.x & 31;
  const int half = threadIdx.x >> 5;
  volatile unsigned* slot = xchg[it & 1];
  if (lane == 0) slot[half] = word;
  // The buffer alternates with the iteration's parity: a warp can only reach
  // its write of iteration it + 2 after its partner has passed the barrier
  // of iteration it + 1, i.e. after the partner's read of iteration it.
  pair_barrier();
  return slot[half ^ 1];
}

// The next pose index of a pair: its first thread draws, both warps read.
// The word alternates with the parity of the pair's draws, for the same
// reason.
__device__ __forceinline__ int pair_draw(int* drawn, int parity, int* queue) {
  volatile int* slot = &drawn[parity];
  if (threadIdx.x == 0) *slot = atomicAdd(queue, 1);
  pair_barrier();
  return *slot;
}

template <int A, bool QUALITY, bool WEIGHTED, bool WIDE>
__global__ void __launch_bounds__(kBlockThreads)
lm_solve_kernel(const __grid_constant__ Runtime rt, const Opts o, int n_pose, int s_lanes,
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
                int* __restrict__ queue,           // (1,) next pose index, starts at 0
                int* __restrict__ pose_iters,      // (B, warps of a group): iterations * S
                int* __restrict__ warp_trips,      // (launched warps,)
                unsigned long long* __restrict__ times) {  // (launched warps, 3)
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const bool two_warps = s_pad == 64;
  const int half = two_warps ? threadIdx.x >> 5 : 0;
  // This thread's place in its group, and the group's first lane and its
  // lanes inside this warp.
  const int seed = two_warps ? threadIdx.x : lane % s_pad;
  const int leader = two_warps ? 0 : lane - seed;
  const unsigned gmask = s_pad >= 32 ? kFullMask : ((1u << s_pad) - 1u) << leader;
  const unsigned freeze_mask = freeze ? gmask : 0u;
  const bool has_lane = seed < s_lanes;  // not a padding thread
  const int n_lanes = n_pose * s_lanes;
  // Quality best-tracking runs only when lanes stride a restart budget.
  const bool track_best = QUALITY && reseed;
  const bool use_l = WEIGHTED && !o.lin_id, use_a = WEIGHTED && !o.ang_id;

  if (lane == 0) {
    const unsigned long long now = global_ns();
    times[warp * 3] = now;
    times[warp * 3 + 1] = now;
  }

  // The group's pose (-1: none) and whether the queue has run out for it.
  int pose = -1;
  bool dead = false;
  int l = 0;  // the lane's output slot, read only while it holds a pose

  // Per-lane state; set anew at every draw.
  float tr[9], tt[3];
  float ml[WEIGHTED ? 9 : 1], ma[WEIGHTED ? 9 : 1];
  float x[A], e[6], jt[6][A];
#pragma unroll
  for (int i = 0; i < 9; ++i) tr[i] = i % 4 == 0 ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) tt[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (WEIGHTED ? 9 : 1); ++i) ml[i] = ma[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < A; ++p) x[p] = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    e[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < A; ++p) jt[i][p] = 0.0f;
  }
  float f = INFINITY, lam = o.lam_init, nu = 2.0f;
  bool stopped = true, success = false, pending = true;
  int cur_idx = 0, it_lane = 0, succ_it = 0;
  // Quality: the caller's seed and the lane's best success so far.
  float q0[QUALITY ? A : 1], bx[QUALITY ? A : 1];
#pragma unroll
  for (int p = 0; p < (QUALITY ? A : 1); ++p) q0[p] = bx[p] = 0.0f;
  float bd = INFINITY, bf = INFINITY;
  int bi = 0, succ_cnt = 0;

  __shared__ unsigned xchg[2][2];
  __shared__ int drawn[2];
  // WIDE: whether this pair's pose is done (the pair's shared test).
  bool pair_done = false;
  int draws = 0;   // the pair's draws so far (their parity picks the word)
  int it = 0;      // the group's iteration on its pose
  int trips = 0;   // the warp's loop trips

  for (;;) {
    // A group whose pose is through writes it out and draws the next one.
    bool fin;
    if constexpr (WIDE) {
      fin = pose >= 0 && (pair_done || it >= max_total_iters);
    } else {
      const unsigned halted = __ballot_sync(kFullMask, stopped);
      fin = pose >= 0 && ((halted & gmask) == gmask || it >= max_total_iters);
    }
    const bool refill = fin || (pose < 0 && !dead);
    if (__any_sync(kFullMask, refill)) {
      if (fin) {
        if (seed == half * 32) pose_iters[two_warps ? pose * 2 + half : pose] = it * s_lanes;
        if (has_lane) {
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
      __syncwarp();
      int next;
      if (two_warps) {  // warp-uniform: the whole warp is one group's half
        next = pair_draw(drawn, draws & 1, queue);
        ++draws;
      } else {
        next = (refill && seed == 0) ? atomicAdd(queue, 1) : 0;
        next = __shfl_sync(kFullMask, next, leader);
      }
      if (refill) {
        dead = next >= n_pose;
        pose = dead ? -1 : next;
        const bool live = !dead && has_lane;
        l = pose * s_lanes + seed;
#pragma unroll
        for (int i = 0; i < 9; ++i)
          tr[i] = live ? tgt[i * n_pose + pose] : (i % 4 == 0 ? 1.0f : 0.0f);
#pragma unroll
        for (int i = 0; i < 3; ++i) tt[i] = live ? tgt[(9 + i) * n_pose + pose] : 0.0f;
        // Weighting blocks M = R^T D R with R the lane's target rotation, each
        // entry summed as ((R_0i w_0) R_0j + (R_1i w_1) R_1j) + (R_2i w_2) R_2j.
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
#pragma unroll
        for (int p = 0; p < A; ++p) x[p] = live ? seeds[p * n_lanes + l] : 0.0f;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          e[i] = 0.0f;
#pragma unroll
          for (int p = 0; p < A; ++p) jt[i][p] = 0.0f;
        }
        f = INFINITY;
        lam = o.lam_init;
        nu = 2.0f;
        stopped = !live;
        success = false;
        pending = true;
        cur_idx = reseed ? seed : 0;
        it_lane = 0;
        succ_it = 0;
        if constexpr (QUALITY) {
#pragma unroll
          for (int p = 0; p < A; ++p) {
            q0[p] = (track_best && live) ? qx0[p * n_pose + pose] : 0.0f;
            bx[p] = 0.0f;
          }
          bd = INFINITY;
          bf = INFINITY;
          bi = 0;
          succ_cnt = 0;
        }
        pair_done = false;
        it = 0;
      }
      if (__any_sync(kFullMask, refill && !dead) && lane == 0)
        times[warp * 3 + 1] = global_ns();
      __syncwarp();
    }
    if (__all_sync(kFullMask, dead)) break;

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
      v = v < rt.lower[p] ? rt.lower[p] : v;   // NaN stays NaN, as jnp.clip
      v = v > rt.upper[p] ? rt.upper[p] : v;
      // Pending lanes adopt a point instead of stepping: the initial seed
      // on the pose's first iteration, or the next stride seed.
      if (pending) v = (reseed && it != 0) ? table[cur_idx * A + p] : x[p];
      xn[p] = v;
      step[p] = v - x[p];
    }

    // ONE fused evaluation: trial cost + the next step's Jacobian.
    float e_new[6], jt_new[6][A], f_new;
    residual_and_jtask<A, WEIGHTED>(rt, xn, tr, tt, ml, ma, use_l, use_a, e_new, jt_new,
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
        // The distance is never contracted (__fmul_rn / __fadd_rn): it is
        // bitwise the one the winner selection computes outside the kernel
        // (solver/ik.seed_distance), so a lane's best and the pick among
        // lanes order attempts alike, on one card or split over several.
        const float e0 = x[0] - q0[0];
        float d2 = __fmul_rn(e0, e0);
#pragma unroll
        for (int p = 1; p < A; ++p) {
          const float e = x[p] - q0[p];
          d2 = __fadd_rn(d2, __fmul_rn(e, e));
        }
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
    // completed `cap` successful attempts.  Padding and dead lanes vote 0.
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
        pose_done = (votes & freeze_mask) != 0u;
      }
    }
    stopped = stopped || pose_done;
    pending_next = pending_next && !pose_done;

    lam = lam_next;
    nu = nu_next;
    pending = pending_next;
    it_lane = it_next;
    ++it;
    ++trips;
  }

  if (lane == 0) {
    warp_trips[warp] = trips;
    times[warp * 3 + 2] = global_ns();
  }
}

// Resident blocks of this library's kernel on the current device (blocks
// per SM in *per_sm), queried once; 0 after a failed query.
int resident_blocks(int* per_sm) {
  static int cached_per_sm = 0, cached_sms = 0;
  if (cached_per_sm == 0) {
    int dev = 0, n = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, lm_solve_kernel<kDof, kQuality, kWeighted, kWide>, kBlockThreads, 0)
               != cudaSuccess)
      return 0;
    cached_per_sm = n;
    cached_sms = sms;
  }
  if (per_sm != nullptr) *per_sm = cached_per_sm;
  return cached_per_sm * cached_sms;
}

bool pad_ok(int s_pad) {
  return s_pad == 64 || (s_pad >= 1 && s_pad <= 32 && 32 % s_pad == 0);
}

// Blocks a launch over n_pose poses uses: the resident ones, or fewer when
// fewer hold every pose at once.
int grid_blocks(int n_pose, int s_pad) {
  const long long per_block = s_pad == 64 ? kBlockThreads / 64 : kBlockThreads / s_pad;
  const long long want = (n_pose + per_block - 1) / per_block;
  const long long resident = resident_blocks(nullptr);
  return (int)(want < resident ? want : resident);
}

}  // namespace

extern "C" {

int optik_lm_block_threads() { return kBlockThreads; }
int optik_lm_runtime_floats() { return kRuntimeFloats; }
int optik_lm_num_opts() { return kNumOpts; }
// This library's instantiation: dof | quality << 8 | weighted << 9 |
// wide << 10 | has_tip << 11.
int optik_lm_variant() {
  return kDof | (kQuality ? 1 << 8 : 0) | (kWeighted ? 1 << 9 : 0) | (kWide ? 1 << 10 : 0)
         | (kHasTip ? 1 << 11 : 0);
}
// Resident blocks per SM of the kernel on the current device (0: the query
// failed), and the blocks a launch over n_pose poses uses.
int optik_lm_blocks_per_sm() {
  int per_sm = 0;
  resident_blocks(&per_sm);
  return per_sm;
}
int optik_lm_grid(int n_pose, int s_pad) {
  return (n_pose < 1 || !pad_ok(s_pad)) ? 0 : grid_blocks(n_pose, s_pad);
}

const char* optik_lm_error_string(int code) {
  if (code == -1) return "invalid argument to optik_lm_solve";
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success) or -1 for invalid arguments.  `chain` and `opts` are host
// arrays (copied into the kernel's parameters).  `chain` holds what of the
// chain stays run-time: tip_r (9), tip_t (3), has_tip (1, must match the
// library), lower (A), upper (A).  `opts` holds max_iters, tol_f, tol_df,
// tol_dx, f_is_success, df_is_success, dx_is_success, lam_init, lam_min,
// lam_max, linear weights (3), angular weights (3), linear-is-identity,
// angular-is-identity, quality success cap.  Every other pointer is device
// memory.  A pose's `s_lanes` lanes occupy `s_pad` threads (a divisor of 32,
// or 64); `freeze` turns the Speed-mode group stop on.  `qx0` is read only
// by the Quality instantiation with reseeding.  `queue` is one int, zeroed
// here on `stream` before the launch.  The kernel writes x_out, f_out,
// succ_out, idx_out and sit_out for the n_pose * s_lanes lanes, pose_iters
// for every pose (the iterations its group ran times s_lanes; two entries
// per pose when s_pad is 64, one per warp), and
// warp_trips and times (3 per warp) for the optik_lm_grid(n_pose, s_pad) *
// block / 32 warps it launches.
int optik_lm_solve(const float* chain, int chain_len, const float* opts, int n_opts,
                   int n_pose, int s_lanes, int s_pad, int total_restarts, int reseed,
                   int freeze, const float* seeds, const float* tgt, const float* table,
                   const float* qx0, float* x_out, float* f_out, int8_t* succ_out,
                   int* idx_out, int* sit_out, int* queue, int* pose_iters,
                   int* warp_trips, unsigned long long* times, void* stream) {
  if (chain_len != kRuntimeFloats || n_opts != kNumOpts || n_pose < 1 || s_lanes < 1
      || !pad_ok(s_pad) || s_lanes > s_pad || total_restarts < s_lanes
      || (long long)n_pose * s_pad * kDof > 0x7fffffffLL || (chain[12] > 0.5f) != kHasTip)
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
  Runtime rt;
  for (int i = 0; i < 9; ++i) rt.tip_r[i] = chain[i];
  for (int i = 0; i < 3; ++i) rt.tip_t[i] = chain[9 + i];
  for (int j = 0; j < kDof; ++j) {
    rt.lower[j] = chain[13 + j];
    rt.upper[j] = chain[13 + kDof + j];
  }
  const int blocks = grid_blocks(n_pose, s_pad);
  if (blocks < 1) return (int)cudaErrorUnknown;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t zeroed = cudaMemsetAsync(queue, 0, sizeof(int), st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  lm_solve_kernel<kDof, kQuality, kWeighted, kWide><<<blocks, kBlockThreads, 0, st>>>(
      rt, o, n_pose, s_lanes, s_pad, total_restarts, reseed, freeze, max_total_iters, seeds,
      tgt, table, qx0, x_out, f_out, succ_out, idx_out, sit_out, queue, pose_iters,
      warp_trips, times);
  return (int)cudaGetLastError();
}

}  // extern "C"
