// Projected Levenberg-Marquardt IK solve for NVIDIA Hopper (sm_90a): one
// thread per lane, persistent thread groups that draw poses from a work
// queue, and the robot's chain in one of two forms: folded into the code
// when the library is built (1..32 joints), or read at run time
// (OPTIK_RUNTIME_CHAIN, any number of joints; see "The run-time chain").
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
//   * Quality with no success cap runs a restart queue instead: its
//     restarts talk to nothing (no freeze, no ballot, no exchange), so the
//     unit of work is one restart on one thread, not a pose on a group.
//     Item q = b R + r of B R, pose-major; a thread whose attempt is over
//     writes the attempt's row and takes the next item by its rank in its
//     warp's ballot, from a chunk of kChunk items its warp claimed with one
//     atomicAdd (near the queue's end, only as many as the warp's lanes
//     need at once).  An attempt is a group lane's loop body from a
//     reseed: the pose's target and caller's seed, the seed of restart r
//     (lane b S + r's start point for r < S, table[r] after), lam, nu and
//     the iteration count set anew; every restart's floating-point work is
//     the group schedule's, in the same order.  A row (A + 4 words a
//     restart, field-major over the B R items) holds x, f, the distance to
//     the caller's seed of a success (inf otherwise), the success iteration
//     and the attempt's iterations.  A second kernel, lm_solve_pick_kernel,
//     writes each pose's S lane outputs from its rows as a group lane would
//     (the restarts s, s + S, ... of slot s, the nearest success, the lower
//     r on a tie), so a pose's answer never depends on which thread ran
//     which restart.  So no thread waits for its pose's slowest restart,
//     and the card drains only the last attempts.  A cap counts successes
//     in lockstep order, so capped Quality keeps the pose groups.
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
//     group stores the iterations its pose ran, times S (on the restart
//     queue the pick stores the iterations a pose's restarts ran, and each
//     warp its restarts drawn and its draws that changed pose).  The Quality build
//     also stores, where the wrapper asks for it (lane_busy), the
//     iterations its lanes spent inside an attempt, summed over the group:
//     a lane notes the iteration at which its restarts ran out, and the
//     group sums the notes when its pose is through.  A one-thread
//     kernel (optik_lm_globaltimer) reads the same clock, for the host to
//     put the probe's times on its own clock.
//   * Math: the same polynomial atan2 and sincos as the plain version's
//     kernel math mode, rsqrtf in the Cholesky, IEEE division and sqrt (the
//     library is built without --use_fast_math).
//
// The run-time chain (-DOPTIK_RUNTIME_CHAIN=1), for chains wider than a
// folded library takes.  A folded chain is code: nvcc's time grows with the
// DoF, every robot needs its own build, and every per-lane vector lives in
// registers (x, the step, the carried and the trial Jacobian, 6 x A each),
// which spill from 16 joints on and would need over 1,000 registers a
// thread at 64.  So this family reads the chain as data and keeps the
// per-lane vectors in device memory.  One instantiation file, not a second
// source, because the loop (draws, damped step, Cholesky, Nielsen damping,
// stops, reseeding, the Speed freeze, the Quality best and cap, the pair
// exchange, the schedule probe) is one template over a Lane policy that
// holds the A-long vectors: RegisterLane (folded, registers) or
// ScratchLane (run-time, scratch).  Only the chain walk and the vectors
// differ.
//   * The chain is a float32 array (lm_kernel.py:pack_runtime_chain): a
//     head (tip, has-tip, DoF) that the C entry copies into the kernel's
//     parameters, then per joint its origin rotation and translation, axis,
//     kind, and the products of two constants the plain version folds in
//     double before they meet a lane (Rodrigues' -(k_a^2 + k_b^2) and
//     k_a k_b), each rounded once, then the limits.  The kernel reads it
//     through the read-only cache: every lane of a warp reads the same word.
//   * The walk is a loop over a run-time DoF.  FK keeps one running frame
//     and writes each joint's world axis and origin (6 floats) into the
//     trial Jacobian's column slot; the column pass reads them and
//     overwrites each with its column.  Every constant is a float operand,
//     so a static 0 or +-1 of the plain version is a multiply by 0 or +-1
//     here: the same value (up to the sign of a zero) in the same order.
//     Where the plain version adds or multiplies two constants that come
//     from different joints (a static frame carried over several joints)
//     it rounds once in double and this walk rounds each float operation:
//     bitwise equality with --fmad=false then holds only where no such
//     fold happens (tests/test_torch_kernel_math.py holds the walk on
//     several chains; PERF.md states what the card showed).
//   * The per-lane vectors live in a scratch buffer the wrapper allocates
//     (the kernel allocates nothing): word k of thread g at
//     scratch[k * threads + g], threads the launch's persistent grid, so a
//     warp's 32 lanes touch 32 consecutive words.  Two copies of x (A) and
//     of J (6 A) alternate, the trial writing the copy not in use and an
//     accepted step flipping which is current (no copy); Quality adds the
//     caller's seed and the best x: 14 A words a lane in Speed, 16 A in
//     Quality (3,584 / 4,096 B at 64 joints).  A lane-iteration moves
//     33 A words: J J^T reads J (6 A); the step reads J and x and writes the
//     trial x (8 A), with J step and the largest step entry in the same
//     pass; FK reads the trial x and writes the frames (7 A); the column
//     pass reads the frames and writes J (12 A): 8,448 B at 64 joints.
//     The bound stays the operations the work needs; this design is held
//     back by those bytes, most of which miss the 50 MB L2.
//   * One library per (mode, weighted, two-warp exchange, contraction)
//     serves every chain; optik_lm_variant() does not hold the DoF.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <dir of optik_chain.h> [-DOPTIK_QUALITY=1]
//        [-DOPTIK_WEIGHTED=1] [-DOPTIK_WIDE=1] -o liblm_kernel.so lm_kernel.cu
//        (-DOPTIK_RUNTIME_CHAIN=1 builds the run-time chain: no header)
// The C entry point optik_lm_solve returns cudaGetLastError() after the
// launch (or a negative code for invalid arguments) and is bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef OPTIK_RUNTIME_CHAIN
#define OPTIK_RUNTIME_CHAIN 0
#endif
#if !OPTIK_RUNTIME_CHAIN
#include "optik_chain.h"
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

constexpr bool kQuality = OPTIK_QUALITY != 0;
constexpr bool kWeighted = OPTIK_WEIGHTED != 0;
constexpr bool kWide = OPTIK_WIDE != 0;
#if !OPTIK_RUNTIME_CHAIN
constexpr int kDof = optik_chain::kDof;
constexpr bool kHasTip = optik_chain::kHasTip;
// The widest chain a library is built for (lm_kernel.py:MAX_DOF).  Every
// per-lane vector is kDof long, so nothing else in the kernel changes with
// the width; what grows is nvcc's time (the joints are a template
// recursion that rebuilds the tuple of their frames at every joint) and the
// per-lane state (x, the step, and the carried and trial Jacobians, each
// 6 x kDof), which spills to local memory once it outgrows the 255
// registers of a thread.  Registers, spills and nvcc seconds per DoF are
// in PERF.md.  optik_lm_variant() holds kDof in its low 8 bits.
constexpr int kMaxDof = 32;
static_assert(kDof >= 1 && kDof <= kMaxDof, "the chain must have 1..32 joints");
static_assert(kMaxDof < 256, "optik_lm_variant() holds kDof in 8 bits");

// What of the chain stays run-time, as the host array lays it out: tip_r
// (9), tip_t (3), has_tip (1), lower (A), upper (A).
constexpr int kRuntimeFloats = 13 + 2 * kDof;

struct Runtime {
  float tip_r[9];
  float tip_t[3];
  float lower[kDof], upper[kDof];
};
#else
// The chain array's head: tip_r (9), tip_t (3), has_tip (1), DoF (1); then
// kJointFloats per joint, then lower (A), upper (A).
constexpr int kRuntimeFloats = 14;
// A joint's record: origin rotation (9, row-major), origin translation (3),
// axis (3), kind (bit 0 prismatic; bit 1 + i: Rodrigues' diagonal entry i
// is cos q, the axis lying in the plane of the other two), -(k_a^2 + k_b^2)
// for each diagonal entry (3), kx ky, kx kz, ky kz (3).
enum JointField { kOrgR = 0, kOrgT = 9, kAxis = 12, kKind = 15, kNegKK = 16,
                  kAxisProd = 19, kJointFloats = 22 };

struct Runtime {
  float tip_r[9];
  float tip_t[3];
  int dof;
  bool has_tip;
  const float* joints;  // (dof, kJointFloats), device memory
  const float* lower;   // (dof,)
  const float* upper;   // (dof,)
};

// Scratch words a lane's vectors take (the word map is ScratchLane's).
__host__ __device__ constexpr int lane_words(int dof) {
  return (kQuality ? 16 : 14) * dof;
}
#endif
constexpr int kNumOpts = 19;
// Items a warp claims from the restart queue at once, far from its end:
// one atomicAdd a chunk instead of one a draw, and a chunk's items are
// mostly one pose's restarts, so its lanes read one pose record.
constexpr int kChunk = 32;

// The restart queue reads a pose from one record of its (B, W) pose-major
// array: the target's rotation (9, row-major) and translation (3), the
// caller's seed (A), zero padding to W, a multiple of 4.
__host__ __device__ constexpr int record_words(int dof) { return (12 + dof + 3) & ~3; }
// A block is one pair of warps, the most threads one pose can take:
// registers are granted per warp, so the smallest block wastes none.
constexpr int kBlockThreads = 64;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr float kEps = 1e-6f;       // Taylor switch (optik_tpu/math/so3.py)
constexpr float kTiny = 1e-30f;
constexpr float kPi = 3.14159265358979323846f;

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
#if !OPTIK_RUNTIME_CHAIN
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
#endif
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

template <class V>
__device__ __forceinline__ void store3(const V& v, float* out) {
  out[0] = val(get<0>(v));
  out[1] = val(get<1>(v));
  out[2] = val(get<2>(v));
}

// The pose error of the end-effector frame (r, t) against the target
// (tr, tt): e = log6(T_tgt^-1 T_ee) and the SE(3) right-Jacobian blocks
// (jr, qq) the task Jacobian's columns need (soa.residual_and_jtask).
template <class R, class T>
__device__ __forceinline__ void pose_error(const float* tr, const float* tt, const R& r,
                                           const T& t, float* e, float* jr, float* qq) {
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
  se3_right_jacobian_blocks(w_log, xt, g, k, jr, qq);
}

#if !OPTIK_RUNTIME_CHAIN

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
  float jr[9], qq[9];
  pose_error(tr, tt, r, t, e, jr, qq);
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

#else  // OPTIK_RUNTIME_CHAIN

// A lane's vector in scratch memory: entry k at p[k * stride], the launch's
// threads interleaved (stride = threads of the grid).
struct Strided {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int k) const { return p[k * stride]; }
};

// Joint j's local frame (lr, lt) at joint value q, from its record, in the
// operation order of soa.fk_joints and soa.rodrigues.
__device__ __forceinline__ void local_frame_rt(const float* jc, float q, float* lr, float* lt) {
  const int kind = (int)__ldg(jc + kKind);
  float org[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) org[i] = __ldg(jc + kOrgR + i);
  const float kx = __ldg(jc + kAxis), ky = __ldg(jc + kAxis + 1), kz = __ldg(jc + kAxis + 2);
  if (kind & 1) {  // prismatic: lt = org_t + org_r (axis q)
    const float ax[3] = {q * kx, q * ky, q * kz};
#pragma unroll
    for (int i = 0; i < 9; ++i) lr[i] = org[i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      lt[i] = __ldg(jc + kOrgT + i) + ((org[3 * i] * ax[0] + org[3 * i + 1] * ax[1])
                                        + org[3 * i + 2] * ax[2]);
  } else {  // revolute: lr = org_r R(axis, q), R = I + sin(q) K + (1 - cos q) K^2
    float s, c;
    sincos_poly(q, s, c);
    const float c1 = 1.0f - c;
    const float pxy = __ldg(jc + kAxisProd), pxz = __ldg(jc + kAxisProd + 1),
                pyz = __ldg(jc + kAxisProd + 2);
    auto diag = [&](int i) {
      return (kind >> (1 + i)) & 1 ? c : 1.0f + c1 * __ldg(jc + kNegKK + i);
    };
    const float rot[9] = {diag(0),          -kz * s + pxy * c1, ky * s + pxz * c1,
                          kz * s + pxy * c1, diag(1),           -kx * s + pyz * c1,
                          -ky * s + pxz * c1, kx * s + pyz * c1, diag(2)};
    mat3_mul(org, rot, lr);
#pragma unroll
    for (int i = 0; i < 3; ++i) lt[i] = __ldg(jc + kOrgT + i);
  }
}

// residual_and_jtask over the run-time chain.  FK writes joint j's world
// axis and origin into jt[6 j .. 6 j + 5]; the column pass replaces them
// with column j of J_task (rows 0..5), weighted like the folded form's.
template <bool WEIGHTED>
__device__ __forceinline__ void residual_and_jtask_rt(const Runtime& rt, Strided q,
                                                      const float* tr, const float* tt,
                                                      const float* ml, const float* ma,
                                                      bool use_l, bool use_a, float* e,
                                                      Strided jt, float& f) {
  float r[9], t[3];
  for (int j = 0; j < rt.dof; ++j) {
    const float* jc = rt.joints + j * kJointFloats;
    float lr[9], lt[3];
    local_frame_rt(jc, q[j], lr, lt);
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = lr[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = lt[i];
    } else {
      float tn[3], rn[9];
      mat3_vec(r, lt, tn);
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = tn[i] + t[i];
      mat3_mul(r, lr, rn);
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = rn[i];
    }
    const float axis[3] = {__ldg(jc + kAxis), __ldg(jc + kAxis + 1), __ldg(jc + kAxis + 2)};
    float dir[3];
    mat3_vec(r, axis, dir);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      jt[6 * j + i] = dir[i];
      jt[6 * j + 3 + i] = t[i];
    }
  }
  if (rt.has_tip) {  // the end-effector frame: the tip on the last joint's
    float tn[3], rn[9];
    mat3_vec(r, rt.tip_t, tn);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = tn[i] + t[i];
    mat3_mul(r, rt.tip_r, rn);
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = rn[i];
  }
  float jr[9], qq[9];
  pose_error(tr, tt, dyn9(r), dyn3(t), e, jr, qq);

  for (int j = 0; j < rt.dof; ++j) {
    float dir[3], col[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) dir[i] = jt[6 * j + i];
    float lin[3];  // the column's linear part in the EE frame
    if ((int)__ldg(rt.joints + j * kJointFloats + kKind) & 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) lin[i] = (r[i] * dir[0] + r[3 + i] * dir[1]) + r[6 + i] * dir[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        col[i] = (jr[3 * i] * lin[0] + jr[3 * i + 1] * lin[1]) + jr[3 * i + 2] * lin[2];
        col[3 + i] = 0.0f;
      }
    } else {
      float d[3], lw[3], ang[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) d[i] = t[i] - jt[6 * j + 3 + i];
      lw[0] = dir[1] * d[2] - dir[2] * d[1];
      lw[1] = dir[2] * d[0] - dir[0] * d[2];
      lw[2] = dir[0] * d[1] - dir[1] * d[0];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        lin[i] = (r[i] * lw[0] + r[3 + i] * lw[1]) + r[6 + i] * lw[2];
        ang[i] = (r[i] * dir[0] + r[3 + i] * dir[1]) + r[6 + i] * dir[2];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        col[i] = ((jr[3 * i] * lin[0] + jr[3 * i + 1] * lin[1]) + jr[3 * i + 2] * lin[2])
                 + ((qq[3 * i] * ang[0] + qq[3 * i + 1] * ang[1]) + qq[3 * i + 2] * ang[2]);
        col[3 + i] = (jr[3 * i] * ang[0] + jr[3 * i + 1] * ang[1]) + jr[3 * i + 2] * ang[2];
      }
    }
    if constexpr (WEIGHTED) {
      if (use_l) weight3(ml, col[0], col[1], col[2], col[0], col[1], col[2]);
      if (use_a) weight3(ma, col[3], col[4], col[5], col[3], col[4], col[5]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) jt[6 * j + i] = col[i];
  }
  if constexpr (WEIGHTED) {
    if (use_l) weight3(ml, e[0], e[1], e[2], e[0], e[1], e[2]);
    if (use_a) weight3(ma, e[3], e[4], e[5], e[3], e[4], e[5]);
  }
  f = e[0] * e[0] + e[1] * e[1] + e[2] * e[2] + e[3] * e[3] + e[4] * e[4] + e[5] * e[5];
}

#endif  // OPTIK_RUNTIME_CHAIN

// --- the solve ----------------------------------------------------------------

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
  return now;
}

// One thread stores the card's %globaltimer, the schedule probe's clock, so
// that the host can bracket the reading by its own clock
// (optik_lm_globaltimer).
__global__ void globaltimer_kernel(unsigned long long* out) { *out = global_ns(); }

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

// --- a lane's A-long vectors ---------------------------------------------------
//
// The loop below is written once over a Lane: the policy that runs every
// loop over the joints.  The loop declares its per-lane arrays with the
// Lane's types, where and in the order the folded kernel always declared
// them, and hands them to the Lane's methods: x and the trial point and
// step (Vec), the carried and the trial J (Jac, 6 x A), Quality's seed and
// best x (SeedVec).  For the folded chain these are the register arrays
// themselves and each method is that kernel's code, so its build is the
// one it was; the run-time chain's are empty placeholders (Unused) and its
// vectors live in scratch.
//   clear / clear_best / load / load_seed / store / store_best: the start,
//   the draw and the write-out;  normal: J J^T + lam I;  step: the trial
//   point from z = (J J^T + lam I)^-1 e (box-projected; a pending lane
//   adopts its seed);  trial: residual and J at the trial point;  gain:
//   J (trial - x);  accept: the trial becomes the lane's state;
//   max_abs_step, seed_distance2, keep_best: the stops' and Quality's reads.
//
// The Quality distance is never contracted (__fmul_rn / __fadd_rn): it is
// bitwise the one the winner selection computes outside the kernel
// (solver/ik.seed_distance), so a lane's best and the pick among lanes
// order attempts alike, on one card or split over several.

#if !OPTIK_RUNTIME_CHAIN
// The folded chain: every vector in registers, A fixed at build time.
template <int A, bool QUALITY>
struct RegisterLane {
  using Vec = float[A];
  using Step = float[A];
  using Jac = float[6][A];
  using SeedVec = float[QUALITY ? A : 1];

  __device__ __forceinline__ RegisterLane(const Runtime&, float*) {}

  __device__ __forceinline__ void clear(Vec& x, float* e, Jac& jt) const {
#pragma unroll
    for (int p = 0; p < A; ++p) x[p] = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      e[i] = 0.0f;
#pragma unroll
      for (int p = 0; p < A; ++p) jt[i][p] = 0.0f;
    }
  }
  __device__ __forceinline__ void clear_best(SeedVec& q0, SeedVec& bx) const {
#pragma unroll
    for (int p = 0; p < (QUALITY ? A : 1); ++p) q0[p] = bx[p] = 0.0f;
  }
  __device__ __forceinline__ void load(Vec& x, float* e, Jac& jt, const float* seeds,
                                       int n_lanes, int l, bool live) const {
#pragma unroll
    for (int p = 0; p < A; ++p) x[p] = live ? seeds[p * n_lanes + l] : 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      e[i] = 0.0f;
#pragma unroll
      for (int p = 0; p < A; ++p) jt[i][p] = 0.0f;
    }
  }
  __device__ __forceinline__ void load_seed(SeedVec& q0, SeedVec& bx, const float* qx0,
                                            int n_pose, int pose, bool take) const {
#pragma unroll
    for (int p = 0; p < A; ++p) {
      q0[p] = take ? qx0[p * n_pose + pose] : 0.0f;
      bx[p] = 0.0f;
    }
  }
  __device__ __forceinline__ void store(const Vec& x, float* x_out, int n_lanes,
                                        int l) const {
#pragma unroll
    for (int p = 0; p < A; ++p) x_out[p * n_lanes + l] = x[p];
  }
  __device__ __forceinline__ void store_best(const SeedVec& bx, float* x_out, int n_lanes,
                                             int l) const {
#pragma unroll
    for (int p = 0; p < A; ++p) x_out[p * n_lanes + l] = bx[p];
  }
  __device__ __forceinline__ int dof() const { return A; }
  __device__ __forceinline__ void store_row(const Vec& x, float* row, size_t stride) const {
#pragma unroll
    for (int p = 0; p < A; ++p) row[p * stride] = x[p];
  }
  __device__ __forceinline__ void start(Vec& x, const float* seed) const {
#pragma unroll
    for (int p = 0; p < A; ++p) x[p] = seed[p];
  }
  __device__ __forceinline__ void take_seed(SeedVec& q0, const float* seed) const {
#pragma unroll
    for (int p = 0; p < A; ++p) q0[p] = seed[p];
  }
  __device__ __forceinline__ void normal(const Jac& jt, float jjt[6][6], float lam) const {
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
  }
  __device__ __forceinline__ void step(const Vec& x, const Jac& jt, Vec& xn, Step& step,
                                       const Runtime& rt, const float* z, bool pending,
                                       bool from_table, const float* table,
                                       int cur_idx) const {
#pragma unroll
    for (int p = 0; p < A; ++p) {
      float d = jt[0][p] * z[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) d = d + jt[i][p] * z[i];
      float v = x[p] + (-d);
      v = v < rt.lower[p] ? rt.lower[p] : v;   // NaN stays NaN, as jnp.clip
      v = v > rt.upper[p] ? rt.upper[p] : v;
      if (pending) v = from_table ? table[cur_idx * A + p] : x[p];
      xn[p] = v;
      step[p] = v - x[p];
    }
  }
  template <bool WEIGHTED>
  __device__ __forceinline__ void trial(const Vec& xn, const Runtime& rt, const float* tr,
                                        const float* tt, const float* ml, const float* ma,
                                        bool use_l, bool use_a, float* e_new, Jac& jt_new,
                                        float& f_new) const {
    residual_and_jtask<A, WEIGHTED>(rt, xn, tr, tt, ml, ma, use_l, use_a, e_new, jt_new,
                                    f_new);
  }
  __device__ __forceinline__ void gain(const Jac& jt, const Step& step, float* w) const {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float v = jt[i][0] * step[0];
#pragma unroll
      for (int p = 1; p < A; ++p) v = v + jt[i][p] * step[p];
      w[i] = v;
    }
  }
  __device__ __forceinline__ void accept(Vec& x, const Vec& xn, float* e, const float* e_new,
                                         Jac& jt, const Jac& jt_new) const {
#pragma unroll
    for (int p = 0; p < A; ++p) x[p] = xn[p];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      e[i] = e_new[i];
#pragma unroll
      for (int p = 0; p < A; ++p) jt[i][p] = jt_new[i][p];
    }
  }
  __device__ __forceinline__ float max_abs_step(const Step& step) const {
    float adx = fabsf(step[0]);
#pragma unroll
    for (int p = 1; p < A; ++p) adx = nmax(adx, fabsf(step[p]));
    return adx;
  }
  __device__ __forceinline__ float seed_distance2(const Vec& x, const SeedVec& q0) const {
    const float e0 = x[0] - q0[0];
    float d2 = __fmul_rn(e0, e0);
#pragma unroll
    for (int p = 1; p < A; ++p) {
      const float e = x[p] - q0[p];
      d2 = __fadd_rn(d2, __fmul_rn(e, e));
    }
    return d2;
  }
  __device__ __forceinline__ void keep_best(const Vec& x, SeedVec& bx) const {
#pragma unroll
    for (int p = 0; p < A; ++p) bx[p] = x[p];
  }
};
#else
// The run-time chain: every vector in the scratch buffer, words
//   [c A, c A + A)                 x, copy c (c = 0, 1)
//   [2 A + 6 c A, 2 A + 6 c A + 6 A)  J, copy c: column j at 6 j .. 6 j + 5
//   [14 A, 15 A), [15 A, 16 A)     Quality: the caller's seed, the best x
// of this thread, interleaved with the grid's other threads.  `cur` is the
// copy that holds the lane's state; the trial writes the other and an
// accepted step flips it.  The loop's arrays are placeholders, but for the
// step: step() forms J (trial - x) and the largest step entry there in its
// one pass, and gain() and max_abs_step() read them back.
struct Unused {};

template <bool QUALITY>
struct ScratchLane {
  using Vec = Unused;
  using Jac = Unused;
  using SeedVec = Unused;
  struct Step {
    float w[6], adx;
  };
  float* m;
  int s, a, cur;

  __device__ __forceinline__ ScratchLane(const Runtime& rt, float* scratch)
      : m(scratch + blockIdx.x * blockDim.x + threadIdx.x), s(gridDim.x * blockDim.x),
        a(rt.dof), cur(0) {}

  __device__ __forceinline__ Strided x_copy(int c) const { return {m + c * a * s, s}; }
  __device__ __forceinline__ Strided j_copy(int c) const { return {m + (2 + 6 * c) * a * s, s}; }
  __device__ __forceinline__ Strided q0() const { return {m + 14 * a * s, s}; }
  __device__ __forceinline__ Strided bx() const { return {m + 15 * a * s, s}; }

  __device__ __forceinline__ void clear(Vec&, float* e, Jac&) {
    cur = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = 0.0f;
  }
  __device__ __forceinline__ void clear_best(SeedVec&, SeedVec&) const {}
  __device__ __forceinline__ void load(Vec&, float* e, Jac&, const float* seeds, int n_lanes,
                                       int l, bool live) {
    cur = 0;
    const Strided x = x_copy(0), jt = j_copy(0);
    for (int p = 0; p < a; ++p) x[p] = live ? seeds[p * n_lanes + l] : 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = 0.0f;
    for (int k = 0; k < 6 * a; ++k) jt[k] = 0.0f;
  }
  __device__ __forceinline__ void load_seed(SeedVec&, SeedVec&, const float* qx0, int n_pose,
                                            int pose, bool take) const {
    const Strided q = q0(), b = bx();
    for (int p = 0; p < a; ++p) {
      q[p] = take ? qx0[p * n_pose + pose] : 0.0f;
      b[p] = 0.0f;
    }
  }
  __device__ __forceinline__ void store(const Vec&, float* x_out, int n_lanes, int l) const {
    const Strided x = x_copy(cur);
    for (int p = 0; p < a; ++p) x_out[p * n_lanes + l] = x[p];
  }
  __device__ __forceinline__ void store_best(const SeedVec&, float* x_out, int n_lanes,
                                             int l) const {
    const Strided b = bx();
    for (int p = 0; p < a; ++p) x_out[p * n_lanes + l] = b[p];
  }
  __device__ __forceinline__ int dof() const { return a; }
  __device__ __forceinline__ void store_row(const Vec&, float* row, size_t stride) const {
    const Strided x = x_copy(cur);
    for (int p = 0; p < a; ++p) row[p * stride] = x[p];
  }
  __device__ __forceinline__ void start(Vec&, const float* seed) const {
    const Strided x = x_copy(cur);
    for (int p = 0; p < a; ++p) x[p] = seed[p];
  }
  __device__ __forceinline__ void take_seed(SeedVec&, const float* seed) const {
    const Strided q = q0();
    for (int p = 0; p < a; ++p) q[p] = seed[p];
  }
  // One pass over J: the 21 sums of J J^T side by side, each in p order.
  __device__ __forceinline__ void normal(const Jac&, float jjt[6][6], float lam) const {
    const Strided jt = j_copy(cur);
    float acc[21];
    auto column = [&](int p, bool first) {
      float c[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) c[i] = jt[6 * p + i];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int k = 0; k <= i; ++k) {
          const int n = i * (i + 1) / 2 + k;
          acc[n] = first ? c[i] * c[k] : acc[n] + c[i] * c[k];
        }
    };
    column(0, true);
    for (int p = 1; p < a; ++p) column(p, false);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        jjt[i][k] = acc[i * (i + 1) / 2 + k];
        jjt[k][i] = acc[i * (i + 1) / 2 + k];
      }
      jjt[i][i] = jjt[i][i] + lam;
    }
  }
  __device__ __forceinline__ void step(const Vec&, const Jac&, Vec&, Step& st,
                                       const Runtime& rt, const float* z, bool pending,
                                       bool from_table, const float* table,
                                       int cur_idx) const {
    const Strided jt = j_copy(cur), x = x_copy(cur), xn = x_copy(cur ^ 1);
    auto entry = [&](int p, bool first) {
      float c[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) c[i] = jt[6 * p + i];
      float d = c[0] * z[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) d = d + c[i] * z[i];
      const float xp = x[p];
      const float lo = __ldg(rt.lower + p), hi = __ldg(rt.upper + p);
      float v = xp + (-d);
      v = v < lo ? lo : v;   // NaN stays NaN, as jnp.clip
      v = v > hi ? hi : v;
      if (pending) v = from_table ? table[cur_idx * a + p] : xp;
      xn[p] = v;
      const float dx = v - xp;
#pragma unroll
      for (int i = 0; i < 6; ++i) st.w[i] = first ? c[i] * dx : st.w[i] + c[i] * dx;
      st.adx = first ? fabsf(dx) : nmax(st.adx, fabsf(dx));
    };
    entry(0, true);
    for (int p = 1; p < a; ++p) entry(p, false);
  }
  template <bool WEIGHTED>
  __device__ __forceinline__ void trial(const Vec&, const Runtime& rt, const float* tr,
                                        const float* tt, const float* ml, const float* ma,
                                        bool use_l, bool use_a, float* e_new, Jac&,
                                        float& f_new) const {
    residual_and_jtask_rt<WEIGHTED>(rt, x_copy(cur ^ 1), tr, tt, ml, ma, use_l, use_a, e_new,
                                    j_copy(cur ^ 1), f_new);
  }
  __device__ __forceinline__ void gain(const Jac&, const Step& st, float* w) const {
#pragma unroll
    for (int i = 0; i < 6; ++i) w[i] = st.w[i];
  }
  __device__ __forceinline__ void accept(Vec&, const Vec&, float* e, const float* e_new, Jac&,
                                         const Jac&) {
    cur ^= 1;
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = e_new[i];
  }
  __device__ __forceinline__ float max_abs_step(const Step& st) const { return st.adx; }
  __device__ __forceinline__ float seed_distance2(const Vec&, const SeedVec&) const {
    const Strided x = x_copy(cur), q = q0();
    const float e0 = x[0] - q[0];
    float d2 = __fmul_rn(e0, e0);
    for (int p = 1; p < a; ++p) {
      const float e = x[p] - q[p];
      d2 = __fadd_rn(d2, __fmul_rn(e, e));
    }
    return d2;
  }
  __device__ __forceinline__ void keep_best(const Vec&, SeedVec&) const {
    const Strided x = x_copy(cur), b = bx();
    for (int p = 0; p < a; ++p) b[p] = x[p];
  }
};
#endif

#if !OPTIK_RUNTIME_CHAIN
using KernelLane = RegisterLane<kDof, kQuality>;
#else
using KernelLane = ScratchLane<kQuality>;
#endif

// Weighting blocks M = R^T D R with R the lane's target rotation, each
// entry summed as ((R_0i w_0) R_0j + (R_1i w_1) R_1j) + (R_2i w_2) R_2j.
__device__ __forceinline__ void weight_blocks(const Opts& o, const float* tr, float* ml,
                                              float* ma) {
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

// The loop: one thread per lane, thread groups drawing poses, or each lane
// drawing restarts (see the head of this file).
// The run-time chain's Quality build is held to 8 resident blocks (16
// warps) an SM: the restart queue's bookkeeping would take it to 146
// registers and 12 warps, which ran the 48-joint arm 4.5% slower than
// 128 registers and 16 bytes of spill (PERF.md).
#if OPTIK_RUNTIME_CHAIN && OPTIK_QUALITY
#define OPTIK_LM_BOUNDS __launch_bounds__(kBlockThreads, 8)
#else
#define OPTIK_LM_BOUNDS __launch_bounds__(kBlockThreads)
#endif
template <class Lane, bool QUALITY, bool WEIGHTED, bool WIDE>
__global__ void OPTIK_LM_BOUNDS
lm_solve_kernel(const __grid_constant__ Runtime rt, const Opts o, int n_pose, int s_lanes,
                int s_pad, int total_restarts, int reseed, int freeze, int max_total_iters,
                const float* __restrict__ seeds,   // (A, L), L = n_pose * s_lanes; queue (L, A)
                const float* __restrict__ tgt,     // (12, B); queue (B, record_words(A))
                const float* __restrict__ table,   // (R, A)
                const float* __restrict__ qx0,     // (A, B), Quality with reseeding
                float* __restrict__ x_out,         // (A, L)
                float* __restrict__ f_out,         // (L,)
                int8_t* __restrict__ succ_out,     // (L,)
                int* __restrict__ idx_out,         // (L,)
                int* __restrict__ sit_out,         // (L,)
                int* __restrict__ queue,           // (1,) next pose index, starts at 0
                int* __restrict__ pose_iters,      // (B, warps of a group): iterations * S
                int* __restrict__ lane_busy,       // (B, warps of a group) or null, Quality
                int* __restrict__ warp_trips,      // (launched warps,)
                unsigned long long* __restrict__ times,  // (launched warps, 3)
                float* __restrict__ scratch,   // ScratchLane's words (run-time chain)
                float* __restrict__ rows,      // (A + 4, B * R) or null: the restart queue
                int* __restrict__ draw_counts) {  // (launched warps, 2), the restart queue
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
  // Quality with no success cap: every lane draws (pose, restart) items
  // from the restart queue on its own, and writes each restart's row.
  const bool queued = QUALITY && !WIDE && rows != nullptr;
  const int n_items = n_pose * total_restarts;
  // Quality best-tracking runs only when pose groups stride a restart budget.
  const bool track_best = QUALITY && reseed && !queued;
  // Quality: the lanes' busy iterations, where the wrapper asks for them.
  const bool track_busy = QUALITY && lane_busy != nullptr;
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

  // Per-lane state; set anew at every draw.  The A-long vectors have the
  // Lane's types (see above).
  Lane vec(rt, scratch);
  const int pose_words = record_words(vec.dof());  // the restart queue's pose records
  float tr[9], tt[3];
  float ml[WEIGHTED ? 9 : 1], ma[WEIGHTED ? 9 : 1];
  typename Lane::Vec x;
  float e[6];
  typename Lane::Jac jt;
#pragma unroll
  for (int i = 0; i < 9; ++i) tr[i] = i % 4 == 0 ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) tt[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (WEIGHTED ? 9 : 1); ++i) ml[i] = ma[i] = 0.0f;
  vec.clear(x, e, jt);
  float f = INFINITY, lam = o.lam_init, nu = 2.0f;
  bool stopped = true, success = false, pending = true;
  int cur_idx = 0, it_lane = 0, succ_it = 0;
  // Quality: the caller's seed and the lane's best success so far.
  typename Lane::SeedVec q0, bx;
  vec.clear_best(q0, bx);
  float bd = INFINITY, bf = INFINITY;
  int bi = 0, succ_cnt = 0;
  // Quality: the group iteration by whose end this lane's restarts had run
  // out (-1: not yet), for lane_busy.
  int busy_end = -1;

  __shared__ unsigned xchg[2][2];
  __shared__ int drawn[2];
  // WIDE: whether this pair's pose is done (the pair's shared test).
  bool pair_done = false;
  int draws = 0;   // the pair's draws so far (their parity picks the word)
  int it = 0;      // the group's iteration on its pose
  int trips = 0;   // the warp's loop trips
  // The restart queue: (lane 0) the warp's restarts drawn and the draws
  // that changed a lane's pose.
  int n_draws = 0, n_switches = 0;
  // The warp's chunk of claimed items not yet handed out: [chunk_next, chunk_end).
  int chunk_next = 0, chunk_end = 0;

  for (;;) {
    // The restart queue's draw is compiled into the Quality builds alone.
    bool groups = true;
    if constexpr (QUALITY && !WIDE) {
      if (queued) {
        groups = false;
        // A lane whose attempt is over writes its restart's row and takes
        // the next item.
        const bool over = stopped && !dead;
        if (__any_sync(kFullMask, over)) {
          if (over && pose >= 0) {
            const size_t stride = (size_t)n_items;
            const size_t q = (size_t)pose * total_restarts + cur_idx;
            vec.store_row(x, rows + q, stride);
            float* tail = rows + (size_t)vec.dof() * stride + q;
            tail[0] = f;
            tail[stride] = reseed && success ? sqrtf(vec.seed_distance2(x, q0)) : INFINITY;
            tail[2 * stride] = __int_as_float(succ_it);
            tail[3 * stride] = __int_as_float(it_lane);
          }
          // Each lane takes the next item by its rank in the warp's ballot:
          // from the warp's chunk of items claimed earlier while it lasts,
          // the rest from one atomicAdd by lane 0, broadcast by a shuffle.
          // Far from the queue's end a warp claims kChunk items at a time;
          // near it, only what its lanes need now.
          const unsigned want = __ballot_sync(kFullMask, over);
          const int need = __popc(want);
          const int rank = __popc(want & ((1u << lane) - 1u));
          const int avail = chunk_end - chunk_next;
          int q = chunk_next + rank;
          if (need > avail) {
            const int ask = chunk_end < n_items - 2 * (int)(gridDim.x * blockDim.x) ? kChunk
                                                                                   : need - avail;
            int base = 0;
            if (lane == 0) base = atomicAdd(queue, ask);
            base = __shfl_sync(kFullMask, base, 0);
            if (rank >= avail) q = base + rank - avail;
            chunk_next = base + need - avail;
            chunk_end = base + ask;
          } else {
            chunk_next += need;
          }
          const int prev = pose;
          bool late = false;
          if (over) {
            dead = q >= n_items;
            late = !dead && q >= n_items - (int)(gridDim.x * blockDim.x);
            pose = dead ? -1 : q / total_restarts;
            cur_idx = dead ? 0 : q - pose * total_restarts;
            // The pose's record (target, caller's seed) and the restart's
            // seed: restarts below S start from their lane's seed, the rest
            // from the table, as a pose group's lanes do.  The loads are
            // unconditional (a dead lane reads pose 0 and never runs), so
            // their wait falls where the step first reads them.  e and J
            // stay as they were: a pending iteration reads neither into its
            // result.
            const int b = dead ? 0 : pose;
            const float* rec = tgt + (size_t)b * pose_words;
#pragma unroll
            for (int i = 0; i < 9; ++i) tr[i] = rec[i];
#pragma unroll
            for (int i = 0; i < 3; ++i) tt[i] = rec[9 + i];
            if constexpr (WEIGHTED) weight_blocks(o, tr, ml, ma);
            const int r = dead ? 0 : cur_idx;
            vec.start(x, r < s_lanes ? seeds + ((size_t)b * s_lanes + r) * vec.dof()
                                     : table + (size_t)r * vec.dof());
            if (reseed) vec.take_seed(q0, rec + 12);
            f = INFINITY;
            lam = o.lam_init;
            nu = 2.0f;
            stopped = dead;
            success = false;
            pending = true;
            it_lane = 0;
            succ_it = 0;
          }
          const unsigned took = __ballot_sync(kFullMask, over && !dead);
          const unsigned moved =
              __ballot_sync(kFullMask, over && !dead && prev >= 0 && prev != pose);
          // The last draw's time: only the last grid's worth of items can
          // hold it.
          const unsigned stamp = __ballot_sync(kFullMask, late);
          if (lane == 0) {
            n_draws += __popc(took);
            n_switches += __popc(moved);
            if (stamp != 0u) times[warp * 3 + 1] = global_ns();
          }
        }
      }
    }
    if (groups) {
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
          if constexpr (QUALITY) {
            if (track_busy) {  // fin is the same for the whole group
              const int busy = has_lane ? (busy_end >= 0 ? busy_end : it) : 0;
              const int sum = (int)__reduce_add_sync(gmask, (unsigned)busy);
              if (seed == half * 32) lane_busy[two_warps ? pose * 2 + half : pose] = sum;
            }
          }
          if (has_lane) {
            if (track_best) {
              vec.store_best(bx, x_out, n_lanes, l);
              f_out[l] = bf;
              succ_out[l] = isfinite(bd) ? 1 : 0;
              idx_out[l] = bi;
            } else {
              vec.store(x, x_out, n_lanes, l);
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
          if constexpr (WEIGHTED) weight_blocks(o, tr, ml, ma);
          vec.load(x, e, jt, seeds, n_lanes, l, live);
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
            vec.load_seed(q0, bx, qx0, n_pose, pose, track_best && live);
            bd = INFINITY;
            bf = INFINITY;
            bi = 0;
            succ_cnt = 0;
            busy_end = -1;
          }
          pair_done = false;
          it = 0;
        }
        if (__any_sync(kFullMask, refill && !dead) && lane == 0)
          times[warp * 3 + 1] = global_ns();
        __syncwarp();
      }
    }
    if (__all_sync(kFullMask, dead)) break;

    // Damped GN step from the carried (e, J):
    // delta = -J^T (J J^T + lam I)^-1 e.
    float jjt[6][6];
    vec.normal(jt, jjt, lam);
    float z[6];
    cholesky_solve6(jjt, e, z);

    // Pending lanes adopt a point instead of stepping: the initial seed on
    // the pose's first iteration, or the next stride seed.
    typename Lane::Vec xn;
    typename Lane::Step step;
    vec.step(x, jt, xn, step, rt, z, pending, !queued && reseed && it != 0, table, cur_idx);

    // ONE fused evaluation: trial cost + the next step's Jacobian.
    float e_new[6];
    typename Lane::Jac jt_new;
    float f_new;
    vec.template trial<WEIGHTED>(xn, rt, tr, tt, ml, ma, use_l, use_a, e_new, jt_new, f_new);

    const bool finite = isfinite(f_new);
    const bool accept = ((f_new < f) || pending) && finite;

    // Nielsen gain ratio on the projected step.
    float w[6];
    vec.gain(jt, step, w);
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
      vec.accept(x, xn, e, e_new, jt, jt_new);
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
      const float adx = vec.max_abs_step(step);
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
        const float d = sqrtf(vec.seed_distance2(x, q0));
        if (run && succ_now && (d < bd)) {
          vec.keep_best(x, bx);
          bd = d;
          bf = f;
          bi = cur_idx;
        }
      }
    }

    bool pending_next = false;
    if (reseed && !queued) {
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
    if constexpr (QUALITY) {
      if (track_busy && stopped && busy_end < 0) busy_end = it + 1;
    }

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
    if (queued) {
      draw_counts[2 * warp] = n_draws;
      draw_counts[2 * warp + 1] = n_switches;
    }
  }
}

#if OPTIK_QUALITY
// The restart queue's second kernel: each pose's lane outputs from its
// restarts' rows, one warp a pose.  Slot s of pose b takes the restarts
// r = s, s + S, ... that a pose group's lane s runs: x, f and the restart
// index of the success nearest the caller's seed, the lower r on a tie (the
// lane's strict d < bd in restart order), success if there is one, the
// iteration of the lowest successful r's success, and where none succeeded
// what that lane writes then (x 0, f inf, index 0).  Without reseeding a
// slot's one restart is written as it ended.  The rows' iterations summed
// over the pose go to pose_iters: on the queue they are also the pose's
// lanes' busy iterations.
constexpr int kPickThreads = 256;

__global__ void __launch_bounds__(kPickThreads)
lm_solve_pick_kernel(const float* __restrict__ rows, int dof, int n_pose, int s_lanes,
                     int total_restarts, int reseed, float* __restrict__ x_out,
                     float* __restrict__ f_out, int8_t* __restrict__ succ_out,
                     int* __restrict__ idx_out, int* __restrict__ sit_out,
                     int* __restrict__ pose_iters) {
  const long long pose = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pose >= n_pose) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const size_t stride = (size_t)n_pose * total_restarts;
  const size_t first = (size_t)pose * total_restarts;
  const float* f_row = rows + (size_t)dof * stride;
  const float* d_row = f_row + stride;
  const int* sit_row = reinterpret_cast<const int*>(d_row + stride);
  const int* len_row = sit_row + stride;
  const int n_lanes = n_pose * s_lanes;
  int iters = 0;
  for (int s = lane; s < s_lanes; s += 32) {
    int best = -1, sit = 0;
    float bd = INFINITY;
    for (int r = s; r < total_restarts; r += s_lanes) {
      iters += len_row[first + r];
      if (sit == 0) sit = sit_row[first + r];
      const float d = d_row[first + r];
      if (d < bd) {
        bd = d;
        best = r;
      }
    }
    const int pick = reseed ? best : s;
    const int l = (int)pose * s_lanes + s;
    for (int p = 0; p < dof; ++p)
      x_out[p * n_lanes + l] = pick >= 0 ? rows[p * stride + first + pick] : 0.0f;
    f_out[l] = pick >= 0 ? f_row[first + pick] : INFINITY;
    succ_out[l] = (reseed ? best >= 0 : sit > 0) ? 1 : 0;
    idx_out[l] = pick >= 0 ? pick : 0;
    sit_out[l] = sit;
  }
  iters = (int)__reduce_add_sync(kFullMask, (unsigned)iters);
  if (lane == 0) pose_iters[pose] = iters;
}
#endif

// Resident blocks of this library's kernel on the current device (blocks
// per SM in *per_sm), queried once; 0 after a failed query.
int resident_blocks(int* per_sm) {
  static int cached_per_sm = 0, cached_sms = 0;
  if (cached_per_sm == 0) {
    int dev = 0, n = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, lm_solve_kernel<KernelLane, kQuality, kWeighted, kWide>, kBlockThreads, 0)
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
// fewer hold every pose at once.  The restart queue's launch over n items
// uses grid_blocks(n, 1): a thread an item.
int grid_blocks(int n_pose, int s_pad) {
  const long long per_block = s_pad == 64 ? kBlockThreads / 64 : kBlockThreads / s_pad;
  const long long want = (n_pose + per_block - 1) / per_block;
  const long long resident = resident_blocks(nullptr);
  return (int)(want < resident ? want : resident);
}

}  // namespace

extern "C" {

int optik_lm_block_threads() { return kBlockThreads; }
// The restart queue's pose record, in floats, for a dof-joint chain.
int optik_lm_record_words(int dof) { return record_words(dof); }
// The host chain array's length: folded 13 + 2 A; run-time chain its head,
// after which come optik_lm_joint_floats() per joint and the limits.
int optik_lm_runtime_floats() { return kRuntimeFloats; }
int optik_lm_num_opts() { return kNumOpts; }
#if !OPTIK_RUNTIME_CHAIN
int optik_lm_joint_floats() { return 0; }
// This library's instantiation: dof | quality << 8 | weighted << 9 |
// wide << 10 | has_tip << 11.
int optik_lm_variant() {
  return kDof | (kQuality ? 1 << 8 : 0) | (kWeighted ? 1 << 9 : 0) | (kWide ? 1 << 10 : 0)
         | (kHasTip ? 1 << 11 : 0);
}
#else
int optik_lm_joint_floats() { return kJointFloats; }
// This library's instantiation: quality << 8 | weighted << 9 | wide << 10 |
// 1 << 12 (the run-time chain: no DoF, no tip).
int optik_lm_variant() {
  return (kQuality ? 1 << 8 : 0) | (kWeighted ? 1 << 9 : 0) | (kWide ? 1 << 10 : 0) | 1 << 12;
}
#endif
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
// The scratch floats a launch over n_pose poses of a dof-joint chain needs:
// the run-time chain's per-lane vectors for every thread of its grid (the
// folded chain needs none: 0); -1 for invalid arguments.
long long optik_lm_scratch_words(int n_pose, int s_pad, int dof) {
  if (n_pose < 1 || !pad_ok(s_pad) || dof < 1) return -1;
#if !OPTIK_RUNTIME_CHAIN
  return 0;
#else
  return (long long)grid_blocks(n_pose, s_pad) * kBlockThreads * lane_words(dof);
#endif
}

// Launches one thread that writes the card's %globaltimer to *out (device
// memory) on `stream`; returns cudaGetLastError().  The telemetry reads the
// schedule probe's times on the host's clock by bracketing this read.
int optik_lm_globaltimer(unsigned long long* out, void* stream) {
  globaltimer_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

const char* optik_lm_error_string(int code) {
  if (code == -1) return "invalid argument to optik_lm_solve";
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success) or -1 for invalid arguments.  `chain` and `opts` are host
// arrays (copied into the kernel's parameters).  `chain` holds what of the
// chain stays run-time: tip_r (9), tip_t (3), has_tip (1, must match the
// folded library), then for the folded chain lower (A), upper (A); for the
// run-time chain the DoF (1), the joints' records (A x
// optik_lm_joint_floats()), lower (A), upper (A), and `dev_chain` is the
// same array in device memory, from which the kernel reads the joints and
// the limits.  `opts` holds max_iters, tol_f, tol_df,
// tol_dx, f_is_success, df_is_success, dx_is_success, lam_init, lam_min,
// lam_max, linear weights (3), angular weights (3), linear-is-identity,
// angular-is-identity, quality success cap.  Every other pointer is device
// memory.  A pose's `s_lanes` lanes occupy `s_pad` threads (a divisor of 32,
// or 64); `freeze` turns the Speed-mode group stop on.  `qx0` is read only
// by the Quality instantiation with reseeding.  `queue` is one int, zeroed
// here on `stream` before the launch.  `scratch` holds `scratch_words`
// floats, at least optik_lm_scratch_words(n_pose, s_pad, A) (the run-time
// chain's per-lane vectors; the folded chain reads neither it nor
// `dev_chain`).  The kernel writes x_out, f_out,
// succ_out, idx_out and sit_out for the n_pose * s_lanes lanes, pose_iters
// for every pose (the iterations its group ran times s_lanes; two entries
// per pose when s_pad is 64, one per warp), lane_busy alike where it is not
// null and the library is the Quality instantiation (the iterations the
// pose's lanes ran before their restarts ran out or the pose ended, summed
// over the lanes of each warp), and warp_trips and times (3 per warp) for
// the optik_lm_grid(n_pose, s_pad) * block / 32 warps it launches.
//
// Quality with no success cap runs the restart queue instead, and then
// needs `rows` (rows_words floats, at least (A + 4) * n_pose *
// total_restarts) and `draw_counts` (2 ints a warp), null otherwise; the
// grid is optik_lm_grid(n_pose * total_restarts, 1), and the scratch
// optik_lm_scratch_words(n_pose * total_restarts, 1, A).  There `seeds` is
// (L, A), lane-major, `tgt` the (B, W) pose records (record_words: the
// target's rotation, row-major, and translation, the caller's seed, zeros;
// W = optik_lm_record_words(A)) and `qx0` is not read.  A second kernel
// picks the lane outputs from the rows; pose_iters holds one entry a pose,
// the iterations its restarts ran, lane_busy is not written; draw_counts
// per warp the restarts it drew and the draws whose pose differs from its
// lane's last.
int optik_lm_solve(const float* chain, int chain_len, const float* opts, int n_opts,
                   int n_pose, int s_lanes, int s_pad, int total_restarts, int reseed,
                   int freeze, const float* seeds, const float* tgt, const float* table,
                   const float* qx0, float* x_out, float* f_out, int8_t* succ_out,
                   int* idx_out, int* sit_out, int* queue, int* pose_iters,
                   int* lane_busy, int* warp_trips, unsigned long long* times,
                   const float* dev_chain,
                   float* scratch, long long scratch_words, float* rows,
                   long long rows_words, int* draw_counts, void* stream) {
#if !OPTIK_RUNTIME_CHAIN
  const int dof = kDof;
  if (chain_len != kRuntimeFloats || (chain[12] > 0.5f) != kHasTip) return -1;
#else
  if (chain_len < kRuntimeFloats) return -1;
  const int dof = (int)chain[13];
  if (dof < 1 || chain_len != kRuntimeFloats + (kJointFloats + 2) * dof
      || dev_chain == nullptr || scratch == nullptr)
    return -1;
#endif
  if (n_opts != kNumOpts || n_pose < 1 || s_lanes < 1
      || !pad_ok(s_pad) || s_lanes > s_pad || total_restarts < s_lanes
      || (long long)n_pose * s_pad * dof > 0x7fffffffLL)
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
  const bool queued = kQuality && o.cap == 0;
  if (kQuality && (freeze || (reseed && !queued && qx0 == nullptr))) return -1;
  if (!kWeighted && !(o.lin_id && o.ang_id)) return -1;
  const bool crosses = s_pad == 64 && (kQuality ? o.cap > 0 : freeze != 0);
  if (crosses != kWide) return -1;
  if (queued != (rows != nullptr) || queued != (draw_counts != nullptr)
      || (queued && !reseed && total_restarts != s_lanes))
    return -1;
  const long long n_items = (long long)n_pose * total_restarts;
  const int rounds = reseed ? (total_restarts + s_lanes - 1) / s_lanes : 1;
  const int max_total_iters = (o.max_iters + 1) * rounds;
  Runtime rt;
  for (int i = 0; i < 9; ++i) rt.tip_r[i] = chain[i];
  for (int i = 0; i < 3; ++i) rt.tip_t[i] = chain[9 + i];
#if !OPTIK_RUNTIME_CHAIN
  for (int j = 0; j < kDof; ++j) {
    rt.lower[j] = chain[13 + j];
    rt.upper[j] = chain[13 + kDof + j];
  }
#else
  rt.dof = dof;
  rt.has_tip = chain[12] > 0.5f;
  rt.joints = dev_chain + kRuntimeFloats;
  rt.lower = rt.joints + kJointFloats * dof;
  rt.upper = rt.lower + dof;
#endif
  if (queued && (2 * n_items + kBlockThreads > 0x7fffffffLL || rows_words < (dof + 4) * n_items))
    return -1;
  const int blocks = queued ? grid_blocks((int)n_items, 1) : grid_blocks(n_pose, s_pad);
  if (blocks < 1) return (int)cudaErrorUnknown;
#if OPTIK_RUNTIME_CHAIN
  // The scratch holds every thread's words, addressed in 32 bits.
  const long long need = (long long)blocks * kBlockThreads * lane_words(dof);
  if (scratch_words < need || need > 0x7fffffffLL) return -1;
#endif
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t zeroed = cudaMemsetAsync(queue, 0, sizeof(int), st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  lm_solve_kernel<KernelLane, kQuality, kWeighted, kWide><<<blocks, kBlockThreads, 0, st>>>(
      rt, o, n_pose, s_lanes, s_pad, total_restarts, reseed, freeze, max_total_iters, seeds,
      tgt, table, qx0, x_out, f_out, succ_out, idx_out, sit_out, queue, pose_iters,
      lane_busy, warp_trips, times, scratch, rows, draw_counts);
#if OPTIK_QUALITY
  if (queued) {
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
    const long long pick_blocks = (32 * (long long)n_pose + kPickThreads - 1) / kPickThreads;
    lm_solve_pick_kernel<<<(unsigned)pick_blocks, kPickThreads, 0, st>>>(
        rows, dof, n_pose, s_lanes, total_restarts, reseed, x_out, f_out, succ_out, idx_out,
        sit_out, pose_iters);
  }
#endif
  return (int)cudaGetLastError();
}

}  // extern "C"
