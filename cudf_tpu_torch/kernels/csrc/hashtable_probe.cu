// Hash-table probe for distinct-key build sides over 16 B slots.
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
// Layout: one int4 per slot, (tk1, tk2, payload, 0), as kernels/hashtable.py
// build_table writes it. A probe step is one 16 B read-only vector load, so
// a probe that ends at its home slot touches one random 32 B sector (two when
// the chain crosses a sector), where three separate arrays cost three.
//
// The table stays in global memory: at the Q3 join's main shape it has 2^25
// slots (512 MB), far past the 50 MB L2, so neither L2 nor shared memory can
// hold it, and every probe is a dependent random read. Each thread takes
// kQueries queries and issues the slot loads of all of them before it looks
// at any, step by step along their chains, so a warp keeps kQueries misses in
// flight instead of one. The grid is a grid-stride loop sized from the SM
// count and the kernel's occupancy, read at run time.
//
// Bound: memory. The function must read the table once (12 B a slot: two u32
// key words and an i32 payload), each query's two words (8 B) and write its
// result (4 B): 12·m + 12·N bytes, 1.21 GB at m = 2^25 and N = 2^26, 0.36 ms
// at the H100 SXM's 3.35 TB/s. What it pays beyond that is the random sector
// per probe step: about 1.1 sectors a query at the Q3 join's 22% load.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 4;     // queries per thread, their loads in flight together
constexpr int kMaxProbe = 16;   // MAX_PROBE of the reference
constexpr int32_t kEmpty = INT32_MIN;

__device__ __forceinline__ uint32_t mix(uint32_t h1, uint32_t h2) {
  uint32_t h = (h1 * 0xCC9E2D51u) ^ (h2 * 0x1B873593u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int4* __restrict__ slots, const uint32_t* __restrict__ q1,
             const uint32_t* __restrict__ q2, int32_t* __restrict__ out,
             int64_t n, uint32_t mask) {
  constexpr int64_t kChunk = (int64_t)kThreads * kQueries;
  for (int64_t base = (int64_t)blockIdx.x * kChunk; base < n;
       base += (int64_t)gridDim.x * kChunk) {
    uint32_t a[kQueries], b[kQueries], h[kQueries];
    int32_t found[kQueries];
    bool live[kQueries];
#pragma unroll
    for (int j = 0; j < kQueries; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;  // coalesced
      live[j] = i < n;
      a[j] = live[j] ? __ldg(q1 + i) : 0u;
      b[j] = live[j] ? __ldg(q2 + i) : 0u;
      h[j] = mix(a[j], b[j]);
      found[j] = kEmpty;
    }
    for (int p = 0; p < kMaxProbe; ++p) {
      int4 s[kQueries];
#pragma unroll
      for (int j = 0; j < kQueries; ++j)  // every live chain's load, before any test
        s[j] = live[j] ? __ldg(slots + ((h[j] + (uint32_t)p) & mask))
                       : make_int4(0, 0, kEmpty, 0);
      bool any = false;
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        if (!live[j]) continue;
        if (s[j].z == kEmpty) {
          live[j] = false;
        } else if ((uint32_t)s[j].x == a[j] && (uint32_t)s[j].y == b[j]) {
          found[j] = s[j].z;
          live[j] = false;
        }
        any |= live[j];
      }
      if (!any) break;
    }
#pragma unroll
    for (int j = 0; j < kQueries; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      if (i < n) out[i] = found[j];
    }
  }
}

}  // namespace

// slots int32[m, 4] row-major and 16 B aligned, (tk1, tk2, payload, pad) a
// row, m a power of two; q1, q2 u32[n]; out i32[n]. Launches on `stream`;
// returns the first CUDA error, or 0.
extern "C" int hashtable_probe(const void* slots, const void* q1, const void* q2,
                               void* out, long long n, long long m, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long chunk = (long long)kThreads * kQueries;
  long long blocks = (n + chunk - 1) / chunk;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)slots, (const uint32_t*)q1, (const uint32_t*)q2, (int32_t*)out,
      (int64_t)n, (uint32_t)(m - 1));
  return (int)cudaGetLastError();
}
