// FP32 throughput probe for NVIDIA Hopper (sm_90a): three register-resident
// loops that bracket what dependent elementwise code reaches on the card.
//
// Replaces the Pallas TPU kernels of benchmarks/bench_vpu_peak.py (`go`, which
// runs one of the bodies `ilp8`, `serial`, `mix` n_it times over C = 8 arrays
// per element).  It computes the same function, per element i of C arrays:
//   * ilp8   - C independent x = x * a + b chains (2 C operations per trip):
//              the practical upper bound for packable elementwise code;
//   * serial - one fully dependent chain, 16 deep (32 operations per trip):
//              the latency-bound floor of one thread, which the card hides
//              only with other warps;
//   * mix    - a solver-shaped blend: per array a multiply-add, a neighbour
//              multiply-add, every fourth array a compare + select, and one
//              IEEE division per trip (4 C + 2 (C / 4) + 2 operations).
// A contracted multiply-add is one FFMA instruction and counts as two
// operations.  The plain torch version is
// optik_tpu_torch/benchmarks/bench_fp32_peak.py:plain_body.
//
// What bounds it on this card: FP32 throughput (operations), by design.  The
// C values of an element live in registers for the whole loop; device
// memory is touched once to load them and once to store them.
//
// Design: one thread per element, arrays component-major (x[c * n + i]) so
// loads coalesce; 256 threads per block; the function is shape-free, so the
// caller picks n to fill the card (the TPU shape of 4,096 elements would
// leave 131 of 132 SMs empty).  Built without --use_fast_math: the division
// is IEEE, and with --fmad=false every operation rounds as torch's
// elementwise kernels do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfp32_peak.so fp32_peak.cu

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8;
constexpr int kBlockThreads = 256;
constexpr float kMul = 1.000001f;
constexpr float kAdd = 1e-7f;
constexpr float kNeighbour = 1e-9f;

enum Body { kIlp8 = 0, kSerial = 1, kMix = 2 };

template <int BODY>
__global__ void __launch_bounds__(kBlockThreads)
fp32_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int n_it) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) v[c] = x[c * n + i];
  for (int k = 0; k < n_it; ++k) {
    if constexpr (BODY == kIlp8) {
#pragma unroll
      for (int c = 0; c < kC; ++c) v[c] = v[c] * kMul + kAdd;
    } else if constexpr (BODY == kSerial) {
      float y = v[0];
#pragma unroll
      for (int d = 0; d < 16; ++d) y = y * kMul + kAdd;
      v[0] = y;
    } else {
      float o[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float y = v[c] * kMul + kAdd;
        y = y + v[(c + 1) % kC] * kNeighbour;
        if (c % 4 == 0) y = (y > v[c]) ? y : v[c];
        o[c] = y;
      }
      o[0] = o[0] / (o[1] + 2.0f);
#pragma unroll
      for (int c = 0; c < kC; ++c) v[c] = o[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) out[c * n + i] = v[c];
}

}  // namespace

extern "C" {

int optik_fp32_peak_arrays() { return kC; }

const char* optik_fp32_peak_error_string(int code) {
  if (code == -1) return "invalid argument to optik_fp32_peak";
  return cudaGetErrorString((cudaError_t)code);
}

// Runs body `body` (0 ilp8, 1 serial, 2 mix) n_it times over the (C, n)
// float32 device array `x` into `out` on `stream`; returns
// cudaGetLastError() or -1 for invalid arguments.
int optik_fp32_peak(int body, const float* x, float* out, int n, int n_it, void* stream) {
  if (n < 1 || n_it < 0 || body < 0 || body > 2) return -1;
  const int blocks = (n + kBlockThreads - 1) / kBlockThreads;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body) {
    case kIlp8:
      fp32_peak_kernel<kIlp8><<<blocks, kBlockThreads, 0, st>>>(x, out, n, n_it);
      break;
    case kSerial:
      fp32_peak_kernel<kSerial><<<blocks, kBlockThreads, 0, st>>>(x, out, n, n_it);
      break;
    default:
      fp32_peak_kernel<kMix><<<blocks, kBlockThreads, 0, st>>>(x, out, n, n_it);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
