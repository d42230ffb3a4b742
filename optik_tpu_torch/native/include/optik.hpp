// optik.hpp — C++ RAII wrapper over the optik_tpu native host runtime.
//
// The C++ counterpart of the reference's Eigen wrapper
// (kylc/optik include/optik.hpp:29-105), dependency-free: poses are
// row-major 4x4 std::array<double, 16>, vectors are std::vector<double>.
// Move-only ownership of the underlying chain handle, exceptions for
// construction errors, bool + out-params for solver results (mirroring the
// reference's DoIk/DoDiffIk contract).
//
// Link against liboptik_host_torch (see optik_tpu_torch/native/
// CMakeLists.txt); optik_tpu_torch/examples/example.cpp is the reference
// example.  optik_tpu_torch/native keeps its own copy of this header and of
// optik_host.h beside the copy of the source.

#ifndef OPTIK_HPP_
#define OPTIK_HPP_

#include <array>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "optik_host.h"

namespace optik {

using Pose = std::array<double, 16>;  // row-major 4x4

inline Pose IdentityPose() {
  return {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
}

// Winner selection among successful restarts (config.rs:3-8).
enum class SolutionMode : int { kQuality = 1, kSpeed = 2 };

// Solver parameters for Robot::DoIk: the full reference config surface
// (its SolverConfig counterpart lives at crates/optik-cpp/include/
// optik.hpp:18-27).  The wall-clock max_time is accepted for parity but the
// budgets are the deterministic max_restarts x max_iters; tol_df/tol_dx < 0
// means unset (see include/optik_host.h for the exact stopping semantics).
struct SolverConfig {
  SolutionMode solution_mode = SolutionMode::kSpeed;
  double max_time = 0.1;
  int max_restarts = 64;
  double tol_f = 1e-6;
  double tol_df = -1.0;
  double tol_dx = -1.0;
  std::array<double, 3> linear_weight = {1.0, 1.0, 1.0};
  std::array<double, 3> angular_weight = {1.0, 1.0, 1.0};
  int max_iters = 64;
  uint64_t rng_seed = 42;
};

class Robot {
 public:
  Robot(const Robot&) = delete;
  Robot& operator=(const Robot&) = delete;
  Robot(Robot&& other) noexcept : inner_(other.inner_) {
    other.inner_ = nullptr;
  }
  Robot& operator=(Robot&& other) noexcept {
    if (this != &other) {
      release();
      inner_ = other.inner_;
      other.inner_ = nullptr;
    }
    return *this;
  }
  ~Robot() { release(); }

  // Throws std::runtime_error with the parse/extraction message on failure.
  static Robot FromUrdfFile(const std::string& path,
                            const std::string& base_link,
                            const std::string& ee_link) {
    char err[512] = {0};
    void* ptr = optik_host_chain_from_urdf_file(
        path.c_str(), base_link.c_str(), ee_link.c_str(), err, sizeof(err));
    if (!ptr) throw std::runtime_error(err);
    return Robot(ptr);
  }

  static Robot FromUrdfStr(const std::string& urdf,
                           const std::string& base_link,
                           const std::string& ee_link) {
    char err[512] = {0};
    void* ptr = optik_host_chain_from_urdf_str(
        urdf.c_str(), base_link.c_str(), ee_link.c_str(), err, sizeof(err));
    if (!ptr) throw std::runtime_error(err);
    return Robot(ptr);
  }

  unsigned int num_positions() const noexcept {
    return static_cast<unsigned int>(optik_host_num_positions(inner_));
  }

  // (lower, upper) joint limit vectors; entries may be +-infinity.
  std::pair<std::vector<double>, std::vector<double>> JointLimits() const {
    const unsigned int n = num_positions();
    std::vector<double> lo(n), hi(n);
    optik_host_joint_limits(inner_, lo.data(), hi.data());
    return {std::move(lo), std::move(hi)};
  }

  // Deterministic uniform draw within the joint limits.
  std::vector<double> RandomConfiguration(uint64_t seed = 0) const {
    std::vector<double> q(num_positions());
    optik_host_random_configuration(inner_, seed, q.data());
    return q;
  }

  Pose DoFk(const std::vector<double>& q,
            const Pose* ee_offset = nullptr) const {
    Pose out;
    optik_host_fk(inner_, q.data(), ee_offset ? ee_offset->data() : nullptr,
                  out.data());
    return out;
  }

  // Row-major 6 x n Jacobian in the EE (local) frame, rows [linear; angular].
  std::vector<double> JointJacobian(const std::vector<double>& q,
                                    const Pose* ee_offset = nullptr) const {
    std::vector<double> jac(6 * num_positions());
    optik_host_jacobian(inner_, q.data(),
                        ee_offset ? ee_offset->data() : nullptr, jac.data());
    return jac;
  }

  // Random-restart IK; true + (q_out, cost_out) on success.  Throws
  // std::invalid_argument when the seed lies outside the joint limits
  // (the reference panics there, lib.rs:251-254).
  bool DoIk(const SolverConfig& config, const Pose& target,
            const std::vector<double>& x0, std::vector<double>* q_out,
            double* cost_out, const Pose* ee_offset = nullptr) const {
    q_out->resize(num_positions());
    optik_host_solver_config c = optik_host_solver_config_default();
    c.solution_mode = static_cast<int>(config.solution_mode);
    c.max_time = config.max_time;
    c.max_restarts = config.max_restarts;
    c.tol_f = config.tol_f;
    c.tol_df = config.tol_df;
    c.tol_dx = config.tol_dx;
    for (int i = 0; i < 3; ++i) {
      c.linear_weight[i] = config.linear_weight[i];
      c.angular_weight[i] = config.angular_weight[i];
    }
    c.max_iters = config.max_iters;
    c.rng_seed = config.rng_seed;
    const int r = optik_host_ik_cfg(
        inner_, &c, target.data(), x0.data(),
        ee_offset ? ee_offset->data() : nullptr, q_out->data(), cost_out);
    if (r < 0)
      throw std::invalid_argument(
          "seed joint position outside of joint limits");
    return r != 0;
  }

  // Velocity-limited differential IK; true + (alpha, v) on success.
  bool DoDiffIk(const std::vector<double>& x0,
                const std::array<double, 6>& v_we,
                const std::vector<double>& v_max, double* alpha_out,
                std::vector<double>* v_out,
                const Pose* ee_offset = nullptr) const {
    v_out->resize(num_positions());
    return optik_host_diff_ik(inner_, x0.data(), v_we.data(), v_max.data(),
                              ee_offset ? ee_offset->data() : nullptr,
                              alpha_out, v_out->data()) != 0;
  }

 private:
  explicit Robot(void* inner) : inner_(inner) {}
  void release() {
    if (inner_) {
      optik_host_chain_free(inner_);
      inner_ = nullptr;
    }
  }

  void* inner_ = nullptr;
};

}  // namespace optik

#endif  // OPTIK_HPP_
