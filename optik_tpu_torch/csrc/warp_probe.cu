// Primitive probes for NVIDIA Hopper (sm_90a): seven tiny kernels, each
// writing one (8, 256) array.
//
// Replaces the Pallas TPU kernels of benchmarks/exp_mosaic_probe.py (`run`
// with its seven kernel bodies), which asked of the TPU compiler whether a
// primitive lowers at all.  Here each case asks the same of nvcc and checks
// the value it produces:
//   0 iota_dim0            out[r][c] = r
//   1 iota_dim1            out[r][c] = c
//   2 iota_s1_broadcast    an (8, 1) iota broadcast along the row: one thread
//                          of each row produces the value, the row reads it
//                          from shared memory
//   3 zeros_i32            out = 0
//   4 int8_store           out = int8(0.0f > 1.0f)
//   5 while_i32_carry      a 4-trip loop carrying an i32 per element
//   6 while_mask_all_exit  a loop of at most 8 trips that carries a float, an
//                          i32 flag and the trip count, and exits once every
//                          element's flag is set (__syncthreads_and)
// The plain torch versions are
// optik_tpu_torch/benchmarks/exp_warp_probe.py:plain_case.
//
// What bounds it on this card: nothing but the launch and the host path in
// front of it; each case writes 8 KB (2 KB for int8) once.  Design: one
// block of 1,024 threads, two elements per thread (rows r and r + 4), so
// that the all-elements exit test of case 6 is one block-wide vote; and one
// C call that launches a whole list of cases (optik_warp_probe_many), one
// kernel launch per case, so that a caller pays the trip through the
// binding once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwarp_probe.so warp_probe.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 256;
constexpr int kThreads = 1024;
constexpr int kPerThread = kRows * kCols / kThreads;  // 2

template <int CASE>
__global__ void __launch_bounds__(kThreads) probe_kernel(void* out_v) {
  int32_t* out = static_cast<int32_t*>(out_v);
  const int tid = threadIdx.x;
  __shared__ int row_iota[kRows];
  if constexpr (CASE == 2) {
    if (tid < kRows) row_iota[tid] = tid;
    __syncthreads();
  }
  if constexpr (CASE == 6) {
    float x[kPerThread];
    int m[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      x[k] = 0.0f;
      m[k] = 0;
    }
    int it = 0;
    while (it < 8) {
      bool mine = true;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) mine = mine && (m[k] > 0);
      if (__syncthreads_and(mine)) break;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int m2 = m[k] | (x[k] > 2.0f ? 1 : 0);
        x[k] = m2 > 0 ? x[k] : x[k] + 1.0f;
        m[k] = m2;
      }
      ++it;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) out[tid + k * kThreads] = m[k];
    return;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int idx = tid + k * kThreads;
    const int r = idx / kCols, c = idx % kCols;
    if constexpr (CASE == 0) {
      out[idx] = r;
    } else if constexpr (CASE == 1) {
      out[idx] = c;
    } else if constexpr (CASE == 2) {
      out[idx] = row_iota[r];
    } else if constexpr (CASE == 3) {
      out[idx] = 0;
    } else if constexpr (CASE == 4) {
      const float zero = 0.0f * (float)c;  // a value, not a folded constant
      static_cast<int8_t*>(out_v)[idx] = (int8_t)(zero > 1.0f ? 1 : 0);
    } else if constexpr (CASE == 5) {
      int x = 0, it = 0;
      while (it < 4) {
        x = x + 1;
        it = it + 1;
      }
      out[idx] = x;
    }
  }
}

}  // namespace

extern "C" {

int optik_warp_probe_cases() { return 7; }

const char* optik_warp_probe_error_string(int code) {
  if (code == -1) return "invalid argument to optik_warp_probe";
  return cudaGetErrorString((cudaError_t)code);
}

// Runs case `which` (0..6) into the (8, 256) device array `out` (int8 for
// case 4, int32 otherwise) on `stream`; returns cudaGetLastError() or -1.
int optik_warp_probe(int which, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case 0: probe_kernel<0><<<1, kThreads, 0, st>>>(out); break;
    case 1: probe_kernel<1><<<1, kThreads, 0, st>>>(out); break;
    case 2: probe_kernel<2><<<1, kThreads, 0, st>>>(out); break;
    case 3: probe_kernel<3><<<1, kThreads, 0, st>>>(out); break;
    case 4: probe_kernel<4><<<1, kThreads, 0, st>>>(out); break;
    case 5: probe_kernel<5><<<1, kThreads, 0, st>>>(out); break;
    case 6: probe_kernel<6><<<1, kThreads, 0, st>>>(out); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// Runs the `n` cases which[0..n) into outs[0..n), one kernel launch per
// case, on `stream`; returns the first launch's error, or 0.
int optik_warp_probe_many(int n, const int* which, void* const* outs, void* stream) {
  for (int i = 0; i < n; ++i) {
    const int rc = optik_warp_probe(which[i], outs[i], stream);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
