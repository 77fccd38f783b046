// Launch-and-return check: o[i] = 2·x[i] over f32.
//
// Replaces the Pallas TPU kernel benchmarks/pallas_tunnel_repro.py:double
// (body `kernel`), a repro that checks whether a kernel launch comes back at
// all on the platform; it is on no engine path. One thread an element.
//
// Bound: memory, 8 B an element (x read once, o written once); at its 1024
// elements the launch itself (a few microseconds) is the whole time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
double_kernel(const float* __restrict__ x, float* __restrict__ o, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

}  // namespace

// x, o f32[n]. Launches on `stream`; returns cudaGetLastError().
extern "C" int launch_check_double(const void* x, void* o, long long n, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  double_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)o, (int64_t)n);
  return (int)cudaGetLastError();
}
