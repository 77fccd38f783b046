// Low-cardinality groupby sum/count: a single-pass accumulator in two tiers.
//
// Replaces the Pallas TPU kernel cudf_tpu/kernels/onehot_groupby.py:_kernel
// (called through groupby_sum_count), which multiplies a weighted one-hot of
// the group ids by the weighted values on the MXU. This kernel computes the
// same function, not the same matmul:
//
//   out[k, j] = sum_{i : gid[i] == k} w[i] * (w[i] * vals[i, j])   (j < V)
//   out[k, V] = sum_{i : gid[i] == k} w[i] * w[i]
//
// Rows whose gid lies outside [0, K) contribute nothing and have neither
// value nor weight read. Sums are f32 inside a tile of kTile rows and f64
// across tiles, so 0/1 counts stay exact at any group size (the TPU kernel
// keeps f32 across all tiles). No TF32 tensor-core product: it would round
// the inputs.
//
// Register tier, K·(V+1) <= 32 (the README query: K = 16, V = 1). Each
// thread keeps the [K, V+1] accumulator in registers and adds a row with a
// compare-select over every k, unrolled at compile time: the TPU kernel's
// one-hot product on the CUDA cores, with no shared-memory contention and
// no dynamic register index. A select, never a product with the one-hot, so
// a NaN stays in its own group. At the end of a tile a warp sums its threads'
// totals with shuffles into its own f64 row in shared memory.
//
// Shared tier, up to MAX_GROUPS = 2048 and what shared memory holds. Each
// warp keeps its own f32 copy of the accumulator in shared memory;
// __match_any_sync finds the lanes of one gid, shuffles sum them, and one
// lane per distinct gid adds the sum. At the end of a tile the copies join
// a block-wide f64 total in warp order. Where 8 copies do not fit, the block
// runs fewer warps (227 KB opt-in shared memory).
//
// No global atomics: a persistent grid takes tiles round-robin; each block
// writes one f64 partial [K, V+1], and a second small kernel sums the
// partials in block order. The result is the same bits on every run with the
// same input and grid. Rows are read as 16 B vectors, 4 rows a thread a step
// (gid, weight, and the values for V = 1 or in the register tier), after a
// scalar head of up to 3 rows that aligns the bases; a ragged tail, a group
// of 4 with a gid out of range, or bases that cannot be aligned together are
// read one row at a time.
//
// Bound: memory. It reads every row's gid (4 B) once, and the V values (4V B)
// and the weight (4 B) only of rows whose gid lies in [0, K): 0.74 GB for
// the README query's 2^26 rows, 58.8M of them in range, V = 1, 0.22 ms at
// the H100 SXM's 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8192;      // rows summed in f32 before they join the f64 total
constexpr int kRegSlots = 32;    // accumulators a thread of the register tier holds
constexpr int kRegThreads = 256;
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kSumThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const int32_t* gid;
  const float* vals;
  const float* weight;
  int64_t n;
  int64_t head;  // rows [0, head) are read one by one; row head is 16 B-aligned
  bool vec;      // 4-row vector loads from row head on
  int V;
  int K;

  __device__ __forceinline__ bool in(int g) const { return (unsigned)g < (unsigned)K; }
  __device__ __forceinline__ int64_t tiles() const {
    const int64_t t = (n - head + kTile - 1) / kTile;
    return t > 0 ? t : 1;  // tile 0 also flushes the head rows
  }
};

// ------------------------------------------------------------ register tier
template <int W>
__device__ __forceinline__ void reg_row(float (&acc)[kRegSlots / W][W], int g,
                                        const float* v, float w) {
  constexpr int V = W - 1;
  float x[W];
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = (v[j] * w) * w;
  x[V] = w * w;
#pragma unroll
  for (int k = 0; k < kRegSlots / W; ++k) {
    const bool hit = g == k;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[k][j] += hit ? x[j] : 0.f;
  }
}

template <int W>
__device__ __forceinline__ void reg_group(float (&acc)[kRegSlots / W][W],
                                          const Rows& a, int64_t r, int64_t end) {
  constexpr int V = W - 1;
  if (a.vec && r + 4 <= end) {
    const int4 g4 = __ldg(reinterpret_cast<const int4*>(a.gid + r));
    if (a.in(g4.x) && a.in(g4.y) && a.in(g4.z) && a.in(g4.w)) {
      const int g[4] = {g4.x, g4.y, g4.z, g4.w};
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(a.weight + r));
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      float v[4 * V + 1];
#pragma unroll
      for (int c = 0; c < V; ++c) {  // 4 rows of V values: V aligned float4
        const float4 q = __ldg(reinterpret_cast<const float4*>(a.vals + r * V) + c);
        v[4 * c] = q.x;
        v[4 * c + 1] = q.y;
        v[4 * c + 2] = q.z;
        v[4 * c + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) reg_row<W>(acc, g[i], v + i * V, w[i]);
      return;
    }
  }
  // a ragged tail, a gid out of range among the 4, or unaligned bases: row
  // by row (the gid again, from L1), one copy of the row's code
#pragma unroll 1
  for (int64_t i = r; i < end && i < r + 4; ++i) {
    const int g = __ldg(a.gid + i);
    if (a.in(g)) reg_row<W>(acc, g, a.vals + i * V, __ldg(a.weight + i));
  }
}

template <int W>
__global__ void __launch_bounds__(kRegThreads)
reg_kernel(Rows a, double* __restrict__ partials) {
  constexpr int KM = kRegSlots / W;
  constexpr int V = W - 1;
  __shared__ double warp_sum[kRegWarps][kRegSlots];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sum[warp][lane] = 0.0;  // each warp owns its row
  __syncthreads();
  float acc[KM][W];
#pragma unroll
  for (int k = 0; k < KM; ++k)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[k][j] = 0.f;
  if (blockIdx.x == 0 && threadIdx.x < a.head) {
    const int64_t i = threadIdx.x;
    const int g = a.gid[i];
    if (a.in(g)) reg_row<W>(acc, g, a.vals + i * V, a.weight[i]);
  }
  const int64_t tiles = a.tiles();
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t start = a.head + t * kTile;
    const int64_t end = start + kTile < a.n ? start + kTile : a.n;
    for (int64_t r = start + 4 * threadIdx.x; r < end; r += 4 * kRegThreads)
      reg_group<W>(acc, a, r, end);
#pragma unroll
    for (int k = 0; k < KM; ++k)
#pragma unroll
      for (int j = 0; j < W; ++j) {  // the tile's f32 total across the warp
        float v = acc[k][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
        if (lane == 0) warp_sum[warp][k * W + j] += (double)v;
        acc[k][j] = 0.f;
      }
  }
  __syncthreads();
  const int S = a.K * W;
  for (int s = threadIdx.x; s < S; s += kRegThreads) {
    double t = 0.0;
    for (int w = 0; w < kRegWarps; ++w) t += warp_sum[w][s];
    partials[(int64_t)blockIdx.x * S + s] = t;
  }
}

template <int W>
const void* reg_kernel_for(int w) {
  if constexpr (W > kRegSlots) {
    return nullptr;
  } else {
    return w == W ? reinterpret_cast<const void*>(reg_kernel<W>) : reg_kernel_for<W + 1>(w);
  }
}

// -------------------------------------------------------------- shared tier
// Sum of x over the lanes in `peers` (those of one gid), valid in the lowest
// of them: a tree over the peers' ranks, fixed by the lanes' gids alone.
__device__ __forceinline__ float reduce_peers(unsigned peers, float x, int lane) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);
    const float t = __shfl_sync(kFull, x, next > 0 ? next - 1 : lane);
    if (next) x += t;
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  return x;
}

// One row per lane, warp-wide: key is the row's gid, or -1 for a row that
// adds nothing. v1 is the row's value when V = 1 and it was loaded already.
__device__ __forceinline__ void shared_row(float* __restrict__ acc, const Rows& a,
                                           int key, int64_t i, float w, float v1,
                                           bool have_v1, int lane) {
  const int W = a.V + 1;
  const unsigned peers = __match_any_sync(kFull, key);
  const bool leader = lane == __ffs(peers) - 1;
  for (int j = 0; j < W; ++j) {
    float x = 0.f;
    if (key >= 0) {
      if (j == a.V) {
        x = w * w;
      } else {
        const float v = have_v1 ? v1 : __ldg(a.vals + i * a.V + j);
        x = (v * w) * w;
      }
    }
    x = reduce_peers(peers, x, lane);
    if (key >= 0 && leader) atomicAdd(acc + key * W + j, x);  // one lane per gid
  }
}

__global__ void __launch_bounds__(256)
shared_kernel(Rows a, double* __restrict__ partials) {
  extern __shared__ double smem[];
  const int W = a.V + 1, S = a.K * W;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* total = smem;                                  // [S] f64, the block's sum
  float* copies = reinterpret_cast<float*>(smem + S);    // [warps][S] f32, a warp's tile
  float* mine = copies + warp * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) total[s] = 0.0;
  for (int s = threadIdx.x; s < warps * S; s += blockDim.x) copies[s] = 0.f;
  __syncthreads();
  if (blockIdx.x == 0 && warp == 0) {
    const int g = lane < a.head ? a.gid[lane] : -1;
    const int key = a.in(g) ? g : -1;
    shared_row(mine, a, key, lane, key >= 0 ? a.weight[lane] : 0.f, 0.f, false, lane);
  }
  const int64_t tiles = a.tiles();
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t start = a.head + t * kTile;
    const int64_t end = start + kTile < a.n ? start + kTile : a.n;
    for (int64_t base = start; base < end; base += 4 * (int64_t)blockDim.x) {
      const int64_t r = base + 4 * threadIdx.x;  // every lane runs every step
      int g[4] = {-1, -1, -1, -1};
      float w[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f};
      bool have_v = false;
      if (a.vec && r + 4 <= end) {
        const int4 g4 = __ldg(reinterpret_cast<const int4*>(a.gid + r));
        g[0] = g4.x, g[1] = g4.y, g[2] = g4.z, g[3] = g4.w;
        if (a.in(g[0]) && a.in(g[1]) && a.in(g[2]) && a.in(g[3])) {
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(a.weight + r));
          w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
          if (a.V == 1) {
            const float4 v4 = __ldg(reinterpret_cast<const float4*>(a.vals + r));
            v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
            have_v = true;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (a.in(g[i])) w[i] = __ldg(a.weight + r + i);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r + i < end) {
            g[i] = __ldg(a.gid + r + i);
            if (a.in(g[i])) w[i] = __ldg(a.weight + r + i);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        shared_row(mine, a, a.in(g[i]) ? g[i] : -1, r + i, w[i], v[i], have_v, lane);
    }
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {  // copies join the f64 total
      double sum = total[s];
      for (int c = 0; c < warps; ++c) {
        sum += (double)copies[c * S + s];
        copies[c * S + s] = 0.f;
      }
      total[s] = sum;
    }
    __syncthreads();
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    partials[(int64_t)blockIdx.x * S + s] = total[s];
}

// ------------------------------------------------------------ both tiers
// out[s] = sum over blocks b, in a fixed tree, of partials[b, s]; a block a slot.
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const double* __restrict__ partials, double* __restrict__ out,
             int blocks, int S) {
  __shared__ double part[kSumThreads];
  const int s = blockIdx.x;
  double t = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kSumThreads) t += partials[(int64_t)b * S + s];
  part[threadIdx.x] = t;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[s] = part[0];
}

// The tier's kernel (warps == 0: the register tier), its block size and its
// dynamic shared memory, with the opt-in past 48 KB set.
cudaError_t tier(int V, int K, int warps, const void** fn, int* threads, size_t* smem) {
  const size_t S = (size_t)K * (V + 1);
  *fn = warps == 0 ? reg_kernel_for<1>(V + 1) : reinterpret_cast<const void*>(shared_kernel);
  *threads = warps == 0 ? kRegThreads : 32 * warps;
  *smem = warps == 0 ? 0 : S * sizeof(double) + warps * S * sizeof(float);
  if (*fn == nullptr || warps < 0 || warps > 8) return cudaErrorInvalidValue;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

}  // namespace

// The grid of the tier's persistent kernel for n rows: at most the tiles,
// at most the blocks that fit on the card at once. The caller allocates an
// f64 [blocks, K, V+1] partials buffer for it.
extern "C" int onehot_groupby_blocks(long long n, int V, int K, int warps, int* blocks) {
  const void* fn;
  int threads, dev = 0, sms = 0, per_sm = 0;
  size_t smem;
  cudaError_t err = tier(V, K, warps, &fn, &threads, &smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long want = (n + kTile - 1) / kTile;
  if (want < 1) want = 1;
  const long long resident = (long long)sms * per_sm;
  *blocks = (int)(want < resident ? want : resident);
  return 0;
}

// gid i32[n], vals f32[n, V] row-major, weight f32[n]; partials f64
// [blocks, K, V+1] scratch; out f64[K, V+1], written whole. warps is 0 for
// the register tier (K·(V+1) <= 32), else the shared tier's warps a block.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int onehot_groupby_sum_count(const void* gid, const void* vals,
                                        const void* weight, void* partials, void* out,
                                        long long n, int V, int K, int warps,
                                        int blocks, void* stream) {
  const void* fn;
  int threads;
  size_t smem;
  cudaError_t err = tier(V, K, warps, &fn, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  Rows a;
  a.gid = (const int32_t*)gid;
  a.vals = (const float*)vals;
  a.weight = (const float*)weight;
  a.n = n;
  a.V = V;
  a.K = K;
  // rows before the first 16 B-aligned gid are read one by one; the vector
  // loads need the weight and value rows aligned at that same row
  a.head = (int64_t)(((16 - (uintptr_t)gid % 16) % 16) / 4);
  if (a.head > n) a.head = n;
  a.vec = ((uintptr_t)weight + 4 * a.head) % 16 == 0 &&
          (V == 0 || ((uintptr_t)vals + 4 * a.head * V) % 16 == 0);
  if (!a.vec) a.head = 0;
  double* part = (double*)partials;
  void* args[] = {&a, &part};
  err = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3((unsigned)threads), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<(unsigned)(K * (V + 1)), kSumThreads, 0, (cudaStream_t)stream>>>(
      part, (double*)out, blocks, K * (V + 1));
  return (int)cudaGetLastError();
}
