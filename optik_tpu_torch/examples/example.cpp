// Native C++ example: random-pose IK benchmark loop.
//
// Same methodology as the reference's examples/example.cpp:10-43 (and
// examples/example.py): for each trial draw a random seed configuration and
// a random *reachable* target (FK of a random configuration), solve IK, and
// report the average solve time and success rate.  This drives the host
// (latency) runtime: single solves on the host CPU, no device round trip;
// the batched path on the card lives in the Python API.
//
// Build with g++ into build/optik_tpu_torch/example-<key>/ from Python
// (optik_tpu_torch.native.host.build_example()), or with CMake (see
// optik_tpu_torch/native/CMakeLists.txt):
//   cmake -S optik_tpu_torch/native -B build/cmake_torch -G Ninja
//   cmake --build build/cmake_torch
//   ./build/cmake_torch/example_cpp <urdf> <base_link> <ee_link>

#include <chrono>
#include <cstdio>
#include <cstdlib>

#include "optik.hpp"

int main(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: %s <urdf> <base_link> <ee_link>\n", argv[0]);
    return 1;
  }

  optik::Robot robot = optik::Robot::FromUrdfFile(argv[1], argv[2], argv[3]);
  const optik::SolverConfig config;

  constexpr int kTrials = 10000;
  long total_us = 0;
  int n_success = 0;
  std::vector<double> q_sol;
  double cost = 0.0;

  for (int i = 0; i < kTrials; ++i) {
    const std::vector<double> x0 = robot.RandomConfiguration(2 * i);
    const std::vector<double> q_target = robot.RandomConfiguration(2 * i + 1);
    const optik::Pose target = robot.DoFk(q_target);

    const auto start = std::chrono::steady_clock::now();
    const bool ok = robot.DoIk(config, target, x0, &q_sol, &cost);
    const auto elapsed = std::chrono::steady_clock::now() - start;
    const long us =
        std::chrono::duration_cast<std::chrono::microseconds>(elapsed).count();

    total_us += us;
    n_success += ok ? 1 : 0;
    if (i % 1000 == 0) std::printf("solve %5d: %ld us\n", i, us);
  }

  std::printf("Successes: %d/%d (%.1f%%)\n", n_success, kTrials,
              100.0 * n_success / kTrials);
  std::printf("Average time per solve: %.1f us\n",
              static_cast<double>(total_us) / kTrials);
  return 0;
}
