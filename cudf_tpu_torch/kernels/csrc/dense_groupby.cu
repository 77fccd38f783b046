// Dense-slot groupby sums and counts: one pass over the rows, no sort.
//
// Replaces no TPU kernel. The reference sums float64 and integer columns by
// key on its sort lanes (XLA's sort, then segment sums); its one Pallas
// groupby kernel (cudf_tpu/kernels/onehot_groupby.py, here
// csrc/onehot_groupby.cu) takes a single float32 column. This kernel was
// added because keys that pack into at most 11 code bits are dense group
// ids already: the sort lane sorted, gathered and reduced the whole
// capacity to find them (TPC-H Q1: 2^28 slots sorted for 4 groups, five
// float64 columns gathered at the permutation).
//
// Per row i < n (never the capacity) it computes the row's slot from the
// key columns themselves: each key's code is value - vmin, with the NaN
// code and the null code above the range, clamped to the key's width
// (ops/fastgroup.py:_key_code), the first key most significant. Under
// dropna a row with a null key has no slot. Per slot it keeps A
// accumulators of 64 bits:
//
//   kRows:  the row count;
//   kSumF:  a float64 sum of one column (float32 and bfloat16 widened);
//   kSumI:  an int64 sum of one integer or bool column (widened; the sum
//           wraps as two's complement, uint64 as its bits);
//   kCount: the valid count of one nullable column.
//
// A null value adds to neither its sum nor its count, and a value reaches
// only its own slot's accumulators (by the slot's address, never by a
// product with a one-hot): a NaN stays in its own group.
//
// Thread tier, K·A <= kThreadSlots, A <= kThreadMaxA and no integer sum
// (TPC-H Q1: 8 slots, 6 accumulators). Each thread keeps its own [K, A]
// accumulators in float64, its counts too (exact below 2^53), in shared
// memory laid out thread-major: a row adds to its slot at a dynamic address,
// with no bank conflict and no compare over the slots. (Kept in registers,
// one predicated add a slot and accumulator left them on the stack, and a
// select a slot made the adds the bound: 9.7 and 11.3 ms at Q1's shape on
// an H100, against 5.4 ms here. The warp tier, which takes every shape,
// takes 9.0 ms there, and 3.9 against 1.6 ms with one sum.)
//
// Warp tier, up to 2048 slots and what shared memory holds (the
// db-benchmark's q4: 128 slots, 4 accumulators). Each warp keeps its own
// [K, A] copy in shared memory; __match_any_sync finds the lanes of one slot,
// a tree fixed by the lanes' slots alone sums them, and the lowest of them
// adds the sum to its warp's copy.
//
// The same bits on every run: no atomics. A persistent grid, sized from the
// card and the tier alone, hands each thread fixed rows; a block combines its
// threads' (or warps') sums in a fixed order and writes one partial, which a
// second kernel sums in a fixed tree over the blocks.
//
// Bound: memory. It reads each key column, each value column and each
// validity of the n rows once and writes K·A words: TPC-H Q1 at SF30,
// 177M rows of two 4 B keys and five 8 B values, 8.5 GB, 2.5 ms at the
// H100 SXM's 3.35 TB/s. Rows are read one a thread, neighbouring threads on
// neighbouring rows, several rows a thread in flight (thread_unroll,
// kWarpUnroll).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeys = 8;
constexpr int kMaxAccs = 33;     // the row count, then a sum and a count for 16 columns
constexpr int kThreadSlots = 48; // thread tier: K·A accumulators a thread holds
constexpr int kThreadMaxA = 16;
constexpr int kThreadThreads = 256;
constexpr int kThreadWarps = kThreadThreads / 32;
constexpr int kWarpUnroll = 4;
constexpr int kSumThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// the wrapper's dtype codes (kernels/dense_groupby.py:DTYPES)
enum { kBool, kI8, kU8, kI16, kU16, kI32, kU32, kI64, kU64, kBF16, kF32, kF64 };
enum { kRows, kSumF, kSumI, kCount };

struct Key {
  const void* data;
  const unsigned char* valid;  // null: no nulls
  long long vmin;              // integer keys: in the order-preserving int64 domain
  double vminf;                // float keys
  long long nan_code, null_code, top;  // top = 2^width - 1
  int dtype, width;
};

struct Acc {
  const void* data;
  const unsigned char* valid;  // null: no nulls
  int dtype, kind;
};

struct Args {
  Key key[kMaxKeys];
  Acc acc[kMaxAccs];
  unsigned long long fmask;  // bit j: accumulator j sums float64
  long long n;
  int nkeys, A, K, dropna;
};

__host__ __device__ constexpr int thread_unroll(int A) { return A <= 8 ? 4 : 2; }

__device__ __forceinline__ long long load_int(const void* p, int dt, long long i) {
  switch (dt) {
    case kBool:
    case kU8: return __ldg(static_cast<const unsigned char*>(p) + i);
    case kI8: return __ldg(static_cast<const signed char*>(p) + i);
    case kI16: return __ldg(static_cast<const short*>(p) + i);
    case kU16: return __ldg(static_cast<const unsigned short*>(p) + i);
    case kI32: return __ldg(static_cast<const int*>(p) + i);
    case kU32: return __ldg(static_cast<const unsigned int*>(p) + i);
    default: return __ldg(static_cast<const long long*>(p) + i);  // int64, uint64's bits
  }
}

__device__ __forceinline__ double load_float(const void* p, int dt, long long i) {
  switch (dt) {
    case kBF16:
      return __uint_as_float((unsigned)__ldg(static_cast<const unsigned short*>(p) + i) << 16);
    case kF32: return __ldg(static_cast<const float*>(p) + i);
    default: return __ldg(static_cast<const double*>(p) + i);
  }
}

__device__ __forceinline__ long long add(bool f, long long a, long long b) {
  return f ? __double_as_longlong(__longlong_as_double(a) + __longlong_as_double(b)) : a + b;
}

// The row's slot, or -1 when dropna and one of its keys is null.
__device__ __forceinline__ int row_slot(const Args& a, long long i) {
  int slot = 0;
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k) {
    if (k < a.nkeys) {
      const Key& s = a.key[k];
      long long code;
      if (s.valid != nullptr && !__ldg(s.valid + i)) {
        if (a.dropna) return -1;
        code = s.null_code;
      } else if (s.dtype >= kBF16) {
        const double d = load_float(s.data, s.dtype, i);
        code = isnan(d) ? s.nan_code : (long long)(d - s.vminf);
      } else {
        long long x = load_int(s.data, s.dtype, i);
        if (s.dtype == kU64) x ^= (long long)(1ull << 63);  // into signed order
        code = (long long)((unsigned long long)x - (unsigned long long)s.vmin);
      }
      code = code < 0 ? 0 : (code > s.top ? s.top : code);
      slot = (slot << s.width) | (int)code;
    }
  }
  return slot;
}

// What row i adds to one accumulator of the warp tier, as its 64 bits.
__device__ __forceinline__ long long contrib(const Acc& s, long long i) {
  if (s.kind == kRows) return 1;
  const bool ok = s.valid == nullptr || __ldg(s.valid + i);
  if (s.kind == kCount) return ok ? 1 : 0;
  if (!ok) return 0;  // +0.0 as well
  return s.kind == kSumF ? __double_as_longlong(load_float(s.data, s.dtype, i))
                         : load_int(s.data, s.dtype, i);
}

// -------------------------------------------------------------- thread tier
// What row i adds to one accumulator of the thread tier, in float64: its
// counts are exact below 2^53 rows.
__device__ __forceinline__ double term(const Acc& s, long long i) {
  if (s.kind == kRows) return 1.0;
  const bool ok = s.valid == nullptr || __ldg(s.valid + i);
  if (s.kind == kCount) return ok ? 1.0 : 0.0;
  return ok ? load_float(s.data, s.dtype, i) : 0.0;
}

// Every accumulator float64 (no integer sum): each thread's [K, A] in shared
// memory, thread-major, so a row adds to its slot at a dynamic address with
// no bank conflict and no compare over the slots.
template <int A>
__global__ void __launch_bounds__(kThreadThreads)
dense_thread_kernel(const Args a, long long* __restrict__ partials) {
  constexpr int U = thread_unroll(A);
  extern __shared__ double sums[];  // [K·A][kThreadThreads]
  const int S = a.K * A;
  double* mine = sums + threadIdx.x;
  for (int s = 0; s < S; ++s) mine[s * kThreadThreads] = 0.0;
  const long long step = (long long)gridDim.x * kThreadThreads * U;
  for (long long base = (long long)blockIdx.x * kThreadThreads * U + threadIdx.x; base < a.n;
       base += step) {
    int g[U];
    double x[U][A];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load of U rows first
      const long long i = base + (long long)u * kThreadThreads;
      g[u] = i < a.n ? row_slot(a, i) : -1;
#pragma unroll
      for (int j = 0; j < A; ++j) x[u][j] = g[u] >= 0 ? term(a.acc[j], i) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g[u] >= 0) {
        double* at = mine + g[u] * A * kThreadThreads;
#pragma unroll
        for (int j = 0; j < A; ++j) at[j * kThreadThreads] += x[u][j];
      }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < S; s += kThreadWarps) {  // a warp a slot: threads in a fixed order
    double v = 0.0;
    for (int t = lane; t < kThreadThreads; t += 32) v += sums[s * kThreadThreads + t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) partials[(long long)blockIdx.x * S + s] = __double_as_longlong(v);
  }
}

template <int A>
const void* dense_thread_kernel_for(int want) {
  if constexpr (A > kThreadMaxA) {
    return nullptr;
  } else {
    return want == A ? reinterpret_cast<const void*>(dense_thread_kernel<A>) : dense_thread_kernel_for<A + 1>(want);
  }
}

// ---------------------------------------------------------------- warp tier
// Sum of x over the lanes in `peers` (those of one slot), valid in the lowest
// of them: a tree over the peers' ranks, fixed by the lanes' slots alone.
__device__ __forceinline__ long long reduce_peers(unsigned peers, long long x, int lane, bool f) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);
    const long long t = __shfl_sync(kFull, x, next > 0 ? next - 1 : lane);
    if (next) x = add(f, x, t);
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  return x;
}

__global__ void __launch_bounds__(256)
dense_warp_kernel(const Args a, long long* __restrict__ partials) {
  constexpr int U = kWarpUnroll;
  extern __shared__ long long copies[];  // [warps][K][A]: a warp's own sums
  __shared__ Acc accs[kMaxAccs];
  const int A = a.A, S = a.K * A, T = blockDim.x;
  const int warps = T >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long* mine = copies + (long long)warp * S;
#pragma unroll
  for (int j = 0; j < kMaxAccs; ++j)  // a static index into the parameters
    if (j < A && j % T == (int)threadIdx.x) accs[j] = a.acc[j];
  for (int s = threadIdx.x; s < warps * S; s += T) copies[s] = 0;
  __syncthreads();
  const long long step = (long long)gridDim.x * T * U;
  // every lane of the block runs every step (the warp-wide intrinsics)
  for (long long first = (long long)blockIdx.x * T * U; first < a.n; first += step) {
    const long long base = first + threadIdx.x;
    int g[U];
    unsigned peers[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * T;
      g[u] = i < a.n ? row_slot(a, i) : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) peers[u] = __match_any_sync(kFull, g[u]);
    for (int j = 0; j < A; ++j) {
      const Acc s = accs[j];
      const bool f = s.kind == kSumF;
      long long x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = g[u] >= 0 ? contrib(s, base + (long long)u * T) : 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long t = reduce_peers(peers[u], x[u], lane, f);
        if (g[u] >= 0 && lane == __ffs(peers[u]) - 1) {
          long long* at = mine + g[u] * A + j;
          *at = add(f, *at, t);
        }
        __syncwarp();  // the next leader of this slot reads the sum
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += T) {  // the warps' copies, in warp order
    const bool f = (a.fmask >> (s % A)) & 1ull;
    long long t = copies[s];
    for (int w = 1; w < warps; ++w) t = add(f, t, copies[(long long)w * S + s]);
    partials[(long long)blockIdx.x * S + s] = t;
  }
}

// ------------------------------------------------------------ both tiers
// out[s] = the sum over blocks b, in a fixed tree, of partials[b, s]; a block
// a slot. fmask: the accumulators whose partials are float64; cmask: those
// of them that are counts, written out as int64.
__global__ void __launch_bounds__(kSumThreads)
dense_sum_partials(const long long* __restrict__ partials, long long* __restrict__ out, int blocks,
             int S, int A, unsigned long long fmask, unsigned long long cmask) {
  __shared__ long long part[kSumThreads];
  const int s = blockIdx.x;
  const bool f = (fmask >> (s % A)) & 1ull;
  long long t = 0;
  for (int b = threadIdx.x; b < blocks; b += kSumThreads) t = add(f, t, partials[(long long)b * S + s]);
  part[threadIdx.x] = t;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] = add(f, part[threadIdx.x], part[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0)
    out[s] = (cmask >> (s % A)) & 1ull ? (long long)__longlong_as_double(part[0]) : part[0];
}

// The tier's kernel (warps == 0: the thread tier), its block size, its
// dynamic shared memory (with the opt-in past 48 KB set) and its rows a
// thread a step.
cudaError_t tier(int A, int K, int warps, const void** fn, int* threads, size_t* smem,
                 int* unroll) {
  const size_t S = (size_t)K * A;
  *fn = warps == 0 ? dense_thread_kernel_for<1>(A) : reinterpret_cast<const void*>(dense_warp_kernel);
  *threads = warps == 0 ? kThreadThreads : 32 * warps;
  *smem = (warps == 0 ? kThreadThreads : warps) * S * sizeof(long long);
  *unroll = warps == 0 ? thread_unroll(A) : kWarpUnroll;
  if (*fn == nullptr || warps < 0 || warps > 8 || A < 1 || A > kMaxAccs ||
      (warps == 0 && S > (size_t)kThreadSlots))
    return cudaErrorInvalidValue;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

}  // namespace

// The grid of the tier's persistent kernel for n rows: at most one block a
// step of rows, at most the blocks that fit on the card at once. The caller
// allocates an int64 [blocks, K, A] partials buffer for it.
extern "C" int dense_groupby_blocks(long long n, int A, int K, int warps, int* blocks) {
  const void* fn;
  int threads, unroll, dev = 0, sms = 0, per_sm = 0;
  size_t smem;
  cudaError_t err = tier(A, K, warps, &fn, &threads, &smem, &unroll);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long rows = (long long)threads * unroll;
  long long want = (n + rows - 1) / rows;
  if (want < 1) want = 1;
  const long long resident = (long long)sms * per_sm;
  *blocks = (int)(want < resident ? want : resident);
  return 0;
}

// Keys: key_ptrs [nkeys][2] (data, validity or 0), key_ints [nkeys][5]
// (dtype, width, vmin, nan code, null code), key_vminf [nkeys].
// Accumulators: acc_ptrs [A][2] (data, validity or 0; both 0 for the row
// count), acc_ints [A][2] (dtype, kind). partials: int64 [blocks, K, A]
// scratch; out: int64 [K, A] (a float64 sum's bits), written whole. warps is
// 0 for the thread tier (no integer sum), else the warp tier's warps a
// block. Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int dense_groupby_sums(const long long* key_ptrs, const long long* key_ints,
                                  const double* key_vminf, int nkeys,
                                  const long long* acc_ptrs, const int* acc_ints, int A,
                                  long long n, int K, int dropna, int warps, int blocks,
                                  void* partials, void* out, void* stream) {
  if (nkeys < 0 || nkeys > kMaxKeys || A < 1 || A > kMaxAccs || K < 1 || K > 2048)
    return (int)cudaErrorInvalidValue;
  const void* fn;
  int threads, unroll;
  size_t smem;
  cudaError_t err = tier(A, K, warps, &fn, &threads, &smem, &unroll);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  bool int_sums = false;
  for (int k = 0; k < nkeys; ++k) {
    Key& s = a.key[k];
    s.data = reinterpret_cast<const void*>(key_ptrs[2 * k]);
    s.valid = reinterpret_cast<const unsigned char*>(key_ptrs[2 * k + 1]);
    s.dtype = (int)key_ints[5 * k];
    s.width = (int)key_ints[5 * k + 1];
    s.vmin = key_ints[5 * k + 2];
    s.nan_code = key_ints[5 * k + 3];
    s.null_code = key_ints[5 * k + 4];
    s.top = (1ll << s.width) - 1;
    s.vminf = key_vminf[k];
  }
  for (int j = 0; j < A; ++j) {
    Acc& s = a.acc[j];
    s.data = reinterpret_cast<const void*>(acc_ptrs[2 * j]);
    s.valid = reinterpret_cast<const unsigned char*>(acc_ptrs[2 * j + 1]);
    s.dtype = acc_ints[2 * j];
    s.kind = acc_ints[2 * j + 1];
    if (s.kind == kSumF) a.fmask |= 1ull << j;
    if (s.kind == kSumI) int_sums = true;
  }
  a.n = n;
  a.nkeys = nkeys;
  a.A = A;
  a.K = K;
  a.dropna = dropna;
  // the thread tier sums every accumulator in float64, its counts too
  unsigned long long fmask = a.fmask, cmask = 0;
  if (warps == 0) {
    if (int_sums) return (int)cudaErrorInvalidValue;
    fmask = A == 64 ? ~0ull : (1ull << A) - 1;
    cmask = fmask & ~a.fmask;
  }
  long long* part = (long long*)partials;
  void* args[] = {&a, &part};
  err = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3((unsigned)threads), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  dense_sum_partials<<<(unsigned)(K * A), kSumThreads, 0, (cudaStream_t)stream>>>(
      part, (long long*)out, blocks, K * A, A, fmask, cmask);
  return (int)cudaGetLastError();
}
