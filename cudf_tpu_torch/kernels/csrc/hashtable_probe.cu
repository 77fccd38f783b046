// Hash-table probe for distinct-key build sides: one thread per query.
//
// Replaces the Pallas TPU kernel cudf_tpu/kernels/hashtable.py:_probe_kernel
// (called through probe_table), which holds the whole table in VMEM and
// probes a tile of 8192 queries per grid step with vectorized gathers. The
// function is the same: for query (q1, q2) with h = mix(q1, q2), look at
// slots (h + i) & (m - 1) for i < MAX_PROBE; return the payload of the first
// slot whose two key words equal (q1, q2), stop at the first vacant slot
// (payload EMPTY), and return EMPTY when nothing matches. A match that lies
// after a vacant slot is not a match.
//
// The table stays in global memory: at the join's main shape it has 2^24
// slots (~200 MB), far past the 50 MB L2, so shared memory cannot hold it.
// Each thread reads a slot's payload first and its key words only when the
// slot is occupied, in a grid-stride loop over the queries.
//
// Bound: memory. The function must read the table once (12 B a slot: two
// u32 key words and an i32 payload), each query's two words (8 B) and
// write its result (4 B): 12·m + 12·N bytes, ~1.0 GB at m = 2^24 and
// N = 2^26, ~0.30 ms at the H100 SXM's 3.35 TB/s. Known weakness, left for
// later: the three slot arrays sit apart, so one probe touches three random
// 32 B sectors; a 16 B slot layout (tk1, tk2, payload) would need one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxProbe = 16;  // MAX_PROBE of the reference
constexpr int32_t kEmpty = INT32_MIN;

__device__ __forceinline__ uint32_t mix(uint32_t h1, uint32_t h2) {
  uint32_t h = (h1 * 0xCC9E2D51u) ^ (h2 * 0x1B873593u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint32_t* __restrict__ tk1, const uint32_t* __restrict__ tk2,
             const int32_t* __restrict__ payload, const uint32_t* __restrict__ q1,
             const uint32_t* __restrict__ q2, int32_t* __restrict__ out,
             int64_t n, uint32_t mask) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t a = q1[i];
    const uint32_t b = q2[i];
    const uint32_t h = mix(a, b);
    int32_t found = kEmpty;
    for (int p = 0; p < kMaxProbe; ++p) {
      const uint32_t s = (h + (uint32_t)p) & mask;
      const int32_t pay = payload[s];
      if (pay == kEmpty) break;
      if (tk1[s] == a && tk2[s] == b) {
        found = pay;
        break;
      }
    }
    out[i] = found;
  }
}

}  // namespace

// tk1, tk2 u32[m] and payload i32[m] with m a power of two; q1, q2 u32[n];
// out i32[n]. Launches on `stream`; returns cudaGetLastError().
extern "C" int hashtable_probe(const void* tk1, const void* tk2,
                               const void* payload, const void* q1,
                               const void* q2, void* out, long long n,
                               long long m, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks a SM, grid-stride
  probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tk1, (const uint32_t*)tk2, (const int32_t*)payload,
      (const uint32_t*)q1, (const uint32_t*)q2, (int32_t*)out, (int64_t)n,
      (uint32_t)(m - 1));
  return (int)cudaGetLastError();
}
