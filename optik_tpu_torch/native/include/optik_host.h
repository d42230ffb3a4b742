/* optik_host.h — C ABI of the optik_tpu native host runtime.
 *
 * The native counterpart of the reference's C layer
 * (kylc/optik crates/optik-cpp/src/lib.rs:26-183): serial-chain FK, EE-frame
 * geometric Jacobian, random-restart IK (latency path), and the
 * velocity-limited differential-IK step, over an opaque chain handle built
 * either from raw per-joint arrays or directly from URDF.
 *
 * Conventions:
 *  - poses are row-major 4x4 doubles (16 values);
 *  - Jacobians are row-major 6 x n, rows = [linear; angular] in the EE frame;
 *  - `ee_offset` pose pointers may be NULL (identity);
 *  - functions returning int use 1 = success, 0 = failure;
 *  - the caller owns all output buffers (no allocation crosses the ABI).
 */

#ifndef OPTIK_HOST_H_
#define OPTIK_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* --- chain construction -------------------------------------------------- */

/* Build a chain from folded per-joint arrays (n articulated joints):
 * origin_r n*9 row-major rotations, origin_t n*3, axis n*3 unit axes,
 * prismatic n flags, lower/upper n limits (may be +-inf), tip_r 9 / tip_t 3
 * trailing fixed transform.  Never fails; returns an owned handle. */
void* optik_host_chain_new(int n, const double* origin_r,
                           const double* origin_t, const double* axis,
                           const uint8_t* prismatic, const double* lower,
                           const double* upper, const double* tip_r,
                           const double* tip_t);

/* Parse URDF text / file and extract the base->ee chain (fixed joints are
 * folded).  On failure returns NULL and writes a NUL-terminated message into
 * err (truncated to err_len). */
void* optik_host_chain_from_urdf_str(const char* xml, const char* base_link,
                                     const char* ee_link, char* err,
                                     int err_len);
void* optik_host_chain_from_urdf_file(const char* path, const char* base_link,
                                      const char* ee_link, char* err,
                                      int err_len);

void optik_host_chain_free(void* chain);

/* --- introspection --------------------------------------------------------*/

int optik_host_num_positions(const void* chain);
void optik_host_joint_limits(const void* chain, double* lower, double* upper);

/* Uniform draw within the joint limits; deterministic per seed (unbounded
 * joints draw from [-pi, pi]). */
void optik_host_random_configuration(const void* chain, uint64_t seed,
                                     double* out);

/* --- kinematics ------------------------------------------------------------*/

void optik_host_fk(const void* chain, const double* q,
                   const double* ee_offset, double* pose16);
void optik_host_jacobian(const void* chain, const double* q,
                         const double* ee_offset, double* jac6xn);

/* --- solvers ---------------------------------------------------------------*/

/* Full solver configuration, mirroring the reference's repr(C) CSolverConfig
 * (kylc/optik crates/optik-cpp/src/lib.rs:11-20) field-for-field, plus the
 * deterministic budget knobs that replace wall-clock stopping:
 *
 *  - solution_mode: 1 = quality (min ||x - x0|| over all successful
 *    restarts, lib.rs:398-408), 2 = speed (first success, lib.rs:409-412);
 *  - max_time: accepted for layout parity, not a stopping criterion
 *    (budgets are max_restarts x max_iters, deterministic);
 *  - tol_f: success when the squared weighted log-pose error <= tol_f;
 *  - tol_df: |f_k+1 - f_k| < tol_df stops the restart; counts as a success
 *    only when the caller set tol_df >= 0.  When unset (< 0) the stall
 *    heuristic 1e-3 * tol_f still stops it without success (lib.rs:283-293,
 *    376-388);
 *  - tol_dx: max_i |step_i| < tol_dx stops with success when >= 0, else off;
 *  - linear_weight / angular_weight: per-axis world-frame error weights
 *    (crates/optik/src/objective.rs:7-38). */
typedef struct optik_host_solver_config {
  int solution_mode; /* 1 = quality, 2 = speed */
  double max_time;
  int max_restarts;
  double tol_f;
  double tol_df;
  double tol_dx;
  double linear_weight[3];
  double angular_weight[3];
  int max_iters;
  uint64_t rng_seed;
} optik_host_solver_config;

/* Reference defaults (config.rs:52-65): speed, tol_f 1e-6, tol_df/tol_dx
 * unset, unit weights; budget defaults 64 restarts x 64 iterations. */
optik_host_solver_config optik_host_solver_config_default(void);

/* Random-restart damped Gauss-Newton IK with the full config.  Restart 0
 * starts at x0; restart i draws deterministically from stream rng_seed + i.
 * Returns 1 + writes x_out/f_out on success, 0 on failure, and -1 when x0
 * lies outside the joint limits (the reference panics there, lib.rs:251-254;
 * an ABI cannot, so the caller maps -1 to its language's error). */
int optik_host_ik_cfg(const void* chain,
                      const optik_host_solver_config* config,
                      const double* target16, const double* x0,
                      const double* ee_offset, double* x_out, double* f_out);

/* Legacy speed-mode entry (identity weights, tol_df/tol_dx unset); kept for
 * ABI stability.  Equivalent to optik_host_ik_cfg with defaults, except an
 * out-of-limits seed returns 0 rather than -1. */
int optik_host_ik(const void* chain, const double* target16, const double* x0,
                  const double* ee_offset, double tol_f, int max_iters,
                  int max_restarts, uint64_t rng_seed, double* x_out,
                  double* f_out);

/* Velocity-limited differential IK:
 *   max alpha  s.t.  0 <= alpha <= 1, -v_max <= v <= v_max,
 *                    J_W(x0) v = alpha * V_WE
 * v_we is the commanded world-frame spatial velocity [linear; angular]. */
int optik_host_diff_ik(const void* chain, const double* x0,
                       const double* v_we, const double* v_max,
                       const double* ee_offset, double* alpha_out,
                       double* v_out);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* OPTIK_HOST_H_ */
