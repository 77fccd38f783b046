// Low-cardinality groupby sum/count: a shared-memory single-pass accumulator.
//
// Replaces the Pallas TPU kernel cudf_tpu/kernels/onehot_groupby.py:_kernel
// (called through groupby_sum_count), which multiplies a weighted one-hot of
// the group ids by the weighted values on the MXU. This kernel computes the
// same function, not the same matmul:
//
//   out[k, j] = sum_{i : gid[i] == k} w[i] * (w[i] * vals[i, j])   (j < V)
//   out[k, V] = sum_{i : gid[i] == k} w[i] * w[i]
//
// Rows whose gid lies outside [0, K) contribute nothing. Each block takes a
// tile of kRowsPerBlock rows, accumulates it into a [K, V+1] f32 table in
// shared memory with shared atomics (the shape of libcudf's
// compute_single_pass_aggs.cuh), and flushes every nonzero slot to the f64
// output with one global atomicAdd. A tile has far fewer than 2^24 rows, so
// f32 counts are exact inside it; across tiles the sum is f64, so counts stay
// exact for any group size (the TPU kernel keeps f32 across all tiles). No
// TF32 tensor-core product: it would round the inputs.
//
// Bound: memory. It reads every row's gid (4 B) once, and the V values (4V B)
// and the weight (4 B) only of rows whose gid lies in [0, K): 12 B a row at
// V = 1 when all are in range, ~0.8 GB at 2^26 rows, ~0.24 ms at the H100
// SXM's 3.35 TB/s; less when the padding rows carry gid -1, as on the
// groupby lane. Known weakness, left for later: with few groups every
// thread of a block hits the same few shared addresses, and shared atomics to
// one address serialize.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8192;

__global__ void __launch_bounds__(kThreads)
onehot_sum_count_kernel(const int32_t* __restrict__ gid,
                        const float* __restrict__ vals,
                        const float* __restrict__ weight,
                        double* __restrict__ out, int64_t n, int V, int K) {
  extern __shared__ float acc[];
  const int width = V + 1;
  const int slots = K * width;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) acc[s] = 0.f;
  __syncthreads();

  const int64_t begin = (int64_t)blockIdx.x * kRowsPerBlock;
  const int64_t end = begin + kRowsPerBlock < n ? begin + kRowsPerBlock : n;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int g = gid[i];
    if (g < 0 || g >= K) continue;
    const float w = weight[i];
    float* row = acc + g * width;
    for (int j = 0; j < V; ++j) atomicAdd(row + j, (vals[i * V + j] * w) * w);
    atomicAdd(row + V, w * w);
  }
  __syncthreads();

  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const float v = acc[s];
    if (v != 0.f) atomicAdd(out + s, (double)v);  // NaN != 0: flushed too
  }
}

}  // namespace

// gid i32[n], vals f32[n, V] row-major, weight f32[n], out f64[K, V+1]
// zeroed by the caller; K * (V + 1) * 4 B must fit a block's default 48 KB of
// shared memory. Launches on `stream`; returns cudaGetLastError().
extern "C" int onehot_groupby_sum_count(const void* gid, const void* vals,
                                        const void* weight, void* out,
                                        long long n, int V, int K,
                                        void* stream) {
  const size_t smem = (size_t)K * (V + 1) * sizeof(float);
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  onehot_sum_count_kernel<<<(unsigned)blocks, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const float*)vals, (const float*)weight,
      (double*)out, (int64_t)n, V, K);
  return (int)cudaGetLastError();
}
