// Hash-table probe for distinct-key build sides over 16 B slots, and the
// insert that builds the table.
//
// The probe replaces the Pallas TPU kernel
// cudf_tpu/kernels/hashtable.py:_probe_kernel (called through probe_table),
// which holds the whole table in VMEM and probes a tile of 8192 queries per
// grid step with vectorized gathers. The function is the same: for query
// (q1, q2) with h = mix(q1, q2), look at slots (h + i) & (m - 1) for
// i < max_probe; return the payload of the first slot whose two key words
// equal (q1, q2), stop at the first vacant slot (payload EMPTY), and return
// EMPTY when nothing matches. A match that lies after a vacant slot is not a
// match. The reference's bound is MAX_PROBE = 16, the launch argument's
// default; a table built by the insert below is probed as far as its longest
// displacement reaches.
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
// Bound: memory. The function reads each query's two words (8 B), writes its
// result (4 B), and moves every 32 B sector its chain touches from HBM, since
// the chain starts at a hashed slot of a table past the L2: 12·N + 32·sectors
// bytes. At the Q3 join's 22% load that is about 1.1 sectors a query, 3.17 GB
// and 0.95 ms at N = 2^26 and the H100 SXM's 3.35 TB/s. Reading the table
// once in order (12·m + 12·N bytes, 0.36 ms at m = 2^25) is a looser limit.
//
// The insert replaces no TPU kernel: the reference builds with rounds of XLA
// scatters, each row bidding for slot (h + i) & (m - 1) in round i, and gives
// up after MAX_PROBE rounds, because its probe ran a fixed 16 steps. Across
// millions of rows at <= 50% load some row almost always lies more than 16
// slots from home, so the rounds failed and the table was built again at
// twice the size. Here one thread a row walks its chain until the key is
// placed, with no cap (a walk of m slots sets an error, which <= 50% load
// cannot reach), and claims a vacant slot with a 32-bit compare-and-swap of
// its payload from EMPTY to kBusy, a value no row id takes; it then writes
// both key words and publishes its row id with a release store. A thread that
// meets kBusy waits for the publish (an acquire load) before it compares
// keys. A thread that meets its own key lowers the payload with atomicMin, so
// a duplicate key keeps its smallest row id, as the rounds give. Each key is
// in the table once: every thread of a key walks the same chain, and a slot
// it passes holds another key for good. Where a key lands depends on the
// schedule; the answers of a probe do not. A 16 B compare-and-swap of the
// whole slot would save the publish, but needs a newer toolkit than every
// one this builds with.
//
// The insert's counts go to a 2-int buffer: the slots claimed (the distinct
// active keys) by a warp-aggregated atomicAdd, and the longest displacement
// by a warp-reduced atomicMax, which the probe of the built table takes as
// max_probe - 1. A fill pass of the same launch sets every slot vacant,
// (0, 0, EMPTY, 0), and zeroes the counts first.
//
// Bound of the build: memory. The fill writes 16·(m + 1) bytes; each active
// row reads its two words and its flag (9 B), and reads and writes one
// random 32 B sector, since the table lies past the L2 at a join's sizes:
// 16·m + 73·n bytes, 1.5 ms for 38.6M rows in 2^27 slots at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 4;     // queries per thread, their loads in flight together
constexpr int32_t kEmpty = INT32_MIN;
constexpr int32_t kBusy = INT32_MIN + 1;  // a claimed slot whose row id is not published yet

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
             int64_t n, uint32_t mask, int max_probe) {
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
    for (int p = 0; p < max_probe; ++p) {
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

__device__ __forceinline__ int32_t load_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t load_relaxed(const int32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int32_t* p, int32_t v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads)
vacant_kernel(int4* __restrict__ slots, int64_t n_slots, int32_t* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_slots; i += stride)
    slots[i] = make_int4(0, 0, kEmpty, 0);
  if (blockIdx.x == 0 && threadIdx.x < 2) counts[threadIdx.x] = 0;
}

// One thread a row over a grid-stride loop; counts[0] += slots claimed,
// counts[1] = max(longest displacement), or m when a row found no slot.
__global__ void __launch_bounds__(kThreads)
insert_kernel(int4* slots, const uint32_t* __restrict__ k1,
              const uint32_t* __restrict__ k2, const uint8_t* __restrict__ valid,
              int64_t n, uint32_t mask, int32_t* __restrict__ counts) {
  uint32_t claimed = 0, longest = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < n; r += stride) {
    if (!valid[r]) continue;
    const uint32_t a = __ldg(k1 + r), b = __ldg(k2 + r), h = mix(a, b);
    const int32_t row = (int32_t)r;
    uint32_t i = 0;
    for (; i <= mask; ++i) {
      int32_t* slot = reinterpret_cast<int32_t*>(slots + ((h + i) & mask));
      int32_t p = load_acquire(slot + 2);
      if (p == kEmpty) {
        if (atomicCAS(slot + 2, kEmpty, kBusy) == kEmpty) {  // keys first, then the row id
          slot[0] = (int32_t)a;
          slot[1] = (int32_t)b;
          store_release(slot + 2, row);
          ++claimed;
          break;
        }
        p = load_acquire(slot + 2);  // taken meanwhile: busy or published, never vacant
      }
      while (p == kBusy) p = load_acquire(slot + 2);
      if (load_relaxed(slot) == a && load_relaxed(slot + 1) == b) {
        if (p > row) atomicMin(slot + 2, row);
        break;
      }
    }
    longest = max(longest, i);  // i = mask + 1 = m: no slot
  }
  claimed = __reduce_add_sync(0xffffffffu, claimed);
  longest = __reduce_max_sync(0xffffffffu, longest);
  if ((threadIdx.x & 31) == 0) {
    if (claimed) atomicAdd(reinterpret_cast<unsigned*>(counts), claimed);
    atomicMax(reinterpret_cast<unsigned*>(counts + 1), longest);
  }
}

cudaError_t grid_for(const void* kernel, long long work, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = work < 1 ? 1 : (work < resident ? work : resident);
  return cudaSuccess;
}

}  // namespace

// slots int32[m, 4] row-major and 16 B aligned, (tk1, tk2, payload, pad) a
// row, m a power of two; q1, q2 u32[n]; out i32[n]; max_probe >= 1 the slots
// a query looks at. Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int hashtable_probe(const void* slots, const void* q1, const void* q2,
                               void* out, long long n, long long m, int max_probe,
                               void* stream) {
  const long long chunk = (long long)kThreads * kQueries;
  long long blocks = 0;
  cudaError_t err = grid_for((const void*)probe_kernel, (n + chunk - 1) / chunk, &blocks);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)slots, (const uint32_t*)q1, (const uint32_t*)q2, (int32_t*)out,
      (int64_t)n, (uint32_t)(m - 1), max_probe);
  return (int)cudaGetLastError();
}

// slots int32[m + 1, 4], 16 B aligned, written whole (every slot vacant, then
// the rows of k1, k2 u32[n] whose flag valid u8[n] is set inserted into the
// first m; the last slot stays vacant); m a power of two <= 2^30; counts
// i32[2] receives (slots claimed, longest displacement), the latter m when a
// row found no slot. Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int hashtable_insert(void* slots, const void* k1, const void* k2,
                                const void* valid, long long n, long long m,
                                void* counts, void* stream) {
  long long fill_blocks = 0, insert_blocks = 0;
  cudaError_t err = grid_for((const void*)vacant_kernel, (m + kThreads) / kThreads,
                             &fill_blocks);
  if (err == cudaSuccess)
    err = grid_for((const void*)insert_kernel, (n + kThreads - 1) / kThreads,
                   &insert_blocks);
  if (err != cudaSuccess) return (int)err;
  vacant_kernel<<<(unsigned)fill_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int4*)slots, (int64_t)(m + 1), (int32_t*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  insert_kernel<<<(unsigned)insert_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int4*)slots, (const uint32_t*)k1, (const uint32_t*)k2, (const uint8_t*)valid,
      (int64_t)n, (uint32_t)(m - 1), (int32_t*)counts);
  return (int)cudaGetLastError();
}
