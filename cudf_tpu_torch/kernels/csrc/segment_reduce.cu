// Per-segment reduction (sum, prod, amin, amax) over non-decreasing int64
// segment ids: a reduce-by-key with no atomics.
//
// Replaces no TPU kernel. The reference reduces segments with XLA's
// segment_sum/segment_min/segment_max (cudf_tpu/ops/sortprim.py), which
// needs no kernel of its own; the port's first form was torch's
// scatter_reduce_, one atomic per row. Every groupby lane calls it over
// key-sorted rows, so consecutive rows hit one address: at 2^27 rows in
// 10,001 segments (the db-benchmark's q6 on the generic engine) an f64 sum
// took 78.8 ms on an H100 where its bytes take 0.64 ms; this kernel 0.73 ms.
//
//   out[s] = init (+) reduce{ vals[i] : seg[i] == s }    (empty: init)
//
// Contract: seg non-decreasing, every id in [0, num_segments); an id outside
// that range writes nothing. The kernel checks the contract as it reads (a
// thread's ids in order, against its left neighbour's last and, for a tile's
// first thread, the row before the tile) and sets *bad to 1 where it breaks:
// the results are then wrong, and the wrapper's reader of the flag says so.
// The wrapper fills out with init; a segment with rows is written once, by
// one thread, as combine(init, total).
//
// Types: the (op, type) pairs the port's callers pass, and no others: sums
// of int64, float and double, products of int64 and double, min and max of
// int8, uint8, int16, int32, int64, float, double and bfloat16.
//
// Bound: memory. Each row's id (8 B) and value (sizeof T) are read once;
// each non-empty segment is written once. At q6's shape (2^27 rows, f64)
// that is 2.15 GB, 0.64 ms at the H100 SXM's 3.35 TB/s.
//
// Design. A block takes a tile of kTile = 256 threads x 16 rows. A thread
// loads its 16 consecutive ids and values with 16 B vector loads and folds
// them in row order, run by run: a run that starts and ends inside the
// thread is a whole segment and is written at once. The threads' last runs
// then join in a segmented inclusive scan over (head, value) pairs: warp
// shuffles, then the warps' totals folded in warp order through shared
// memory. A thread's first run adds the scan's value of the run open before
// it. The segments at the tile's two edges may go on in the neighbouring
// tiles: they go out as carries (id, partial), two a tile, in tile order,
// which is segment order. The same kernel then runs on the carries (a tile
// whose one segment fills it carries the op's identity in its second slot),
// until one tile is left, which writes its edges too: 3 launches at 2^27
// rows, at most 4 below 2^40. A segment of 4 rows or of 60M takes the same
// path.
//
// Results. Integer sums and products wrap as two's complement, and min and
// max are exact, so those equal scatter_reduce_'s bits. min and max give a
// NaN when any operand is a NaN (init included), as torch's safe_max does;
// of -0.0 and +0.0 a tie keeps the earlier in this fixed order, where
// scatter_reduce_ keeps whichever atomic landed first. Float sums and
// products take a fixed order, so the same input gives the same bits on
// every run: within a thread in row order (at most 15 operations), a tile's
// scan (5 shuffle steps, 7 warp totals, 2 joins), per level, and init last.
// A term passes through at most d = 29·L + 1 roundings over L levels
// (d = 88 at 2^27 rows), so |sum - exact| <= d·u·Σ|x| / (1 - d·u), u the
// unit roundoff of the type (2^-53 double, 2^-24 float).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cuda/std/limits>
#include <cuda/std/type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int64_t kTile = (int64_t)kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kAlign = 16;  // elements: each level's carries start 16 B-aligned

enum Op { kSum = 0, kProd = 1, kMin = 2, kMax = 3 };

template <typename T, int OP>
constexpr bool kServed = OP == kMin || OP == kMax || cuda::std::is_same<T, int64_t>::value ||
                         cuda::std::is_same<T, double>::value ||
                         (OP == kSum && cuda::std::is_same<T, float>::value);

// combine(a, b), a the earlier rows; identity() leaves any value unchanged
template <typename T, int OP>
struct Ops {
  static constexpr bool kFloat = cuda::std::is_floating_point<T>::value;
  using U = typename cuda::std::conditional<sizeof(T) == 8, unsigned long long,
                                            unsigned>::type;

  __device__ __forceinline__ static T combine(T a, T b) {
    if constexpr (OP == kSum || OP == kProd) {
      if constexpr (kFloat) {
        return OP == kSum ? a + b : a * b;
      } else {  // two's complement wrap, as torch's integer atomics
        return (T)(OP == kSum ? (U)a + (U)b : (U)a * (U)b);
      }
    } else {
      if constexpr (kFloat) {
        if (a != a) return a;
        if (b != b) return b;
      }
      if constexpr (OP == kMin) return b < a ? b : a;
      else return a < b ? b : a;
    }
  }

  __device__ __forceinline__ static T identity() {
    if constexpr (OP == kSum) return kFloat ? -T(0) : T(0);  // x + -0.0 is x, bit for bit
    else if constexpr (OP == kProd) return T(1);
    else if constexpr (OP == kMin)
      return kFloat ? cuda::std::numeric_limits<T>::infinity()
                    : cuda::std::numeric_limits<T>::max();
    else
      return kFloat ? -cuda::std::numeric_limits<T>::infinity()
                    : cuda::std::numeric_limits<T>::lowest();
  }
};

// bfloat16 (min and max only): compared in float, as torch's bf16 atomics
template <int OP>
struct Ops<__nv_bfloat16, OP> {
  __device__ __forceinline__ static __nv_bfloat16 combine(__nv_bfloat16 a, __nv_bfloat16 b) {
    const float x = __bfloat162float(a), y = __bfloat162float(b);
    if (x != x) return a;
    if (y != y) return b;
    if constexpr (OP == kMin) return y < x ? b : a;
    else return x < y ? b : a;
  }

  __device__ __forceinline__ static __nv_bfloat16 identity() {
    if constexpr (OP == kMin) return __float2bfloat16_rn(__int_as_float(0x7f800000));
    else return __float2bfloat16_rn(__int_as_float((int)0xff800000u));
  }
};

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  if constexpr (sizeof(T) == 8) {
    long long b;
    memcpy(&b, &v, 8);
    b = __shfl_up_sync(kFull, b, d);
    memcpy(&v, &b, 8);
  } else {
    int b = 0;
    memcpy(&b, &v, sizeof(T));
    b = __shfl_up_sync(kFull, b, d);
    memcpy(&v, &b, sizeof(T));
  }
  return v;
}

// kItems consecutive elements from a 16 B-aligned address, as 16 B loads
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&x)[kItems]) {
  constexpr int kVecs = kItems * (int)sizeof(T) / 16;
  using Bits = typename cuda::std::conditional<
      sizeof(T) == 8, uint64_t,
      typename cuda::std::conditional<
          sizeof(T) == 4, uint32_t,
          typename cuda::std::conditional<sizeof(T) == 2, uint16_t, uint8_t>::type>::type>::type;
  union {
    uint4 v[kVecs];
    Bits b[kItems];
  } u;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) u.v[i] = __ldg(q + i);
#pragma unroll
  for (int k = 0; k < kItems; ++k) memcpy(&x[k], &u.b[k], sizeof(T));
}

template <typename T, int OP>
__device__ __forceinline__ void write_out(T* __restrict__ out, int64_t id,
                                          int64_t num_segments, T init, T v) {
  if ((uint64_t)id < (uint64_t)num_segments) out[id] = Ops<T, OP>::combine(init, v);
}

// One tile of rows a block. carry_id == nullptr: the only tile, which writes
// its edge segments too; else slot 2·tile holds the tile's first segment and
// 2·tile + 1 its last (the identity when they are one).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
reduce_tiles(const int64_t* __restrict__ seg, const T* __restrict__ vals, int64_t n,
             int64_t num_segments, T init, T* __restrict__ out,
             int64_t* __restrict__ carry_id, T* __restrict__ carry_val, int* __restrict__ bad,
             bool vec) {
  using O = Ops<T, OP>;
  __shared__ int64_t s_first[kThreads];
  __shared__ int64_t s_last[kThreads];
  __shared__ int s_wflag[kWarps];
  __shared__ T s_wval[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t start = tile * kTile;
  const int64_t rows = n - start < kTile ? n - start : kTile;
  const int64_t base = start + (int64_t)t * kItems;
  const int64_t left = n - base;
  const int cnt = left <= 0 ? 0 : (left < kItems ? (int)left : kItems);

  int64_t id[kItems];
  T v[kItems];
  if (vec && rows == kTile) {
    load_vec(seg + base, id);
    load_vec(vals + base, v);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      id[k] = k < cnt ? seg[base + k] : 0;
      v[k] = k < cnt ? vals[base + k] : O::identity();
    }
  }

  // the thread's runs in row order: the first (a, first), the last (b, acc);
  // those between are whole segments
  int64_t a = id[0], b = id[0];
  T first = v[0], acc = v[0];
  bool multi = false, broken = false;
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    if (k < cnt) {
      if (id[k] == b) {
        acc = O::combine(acc, v[k]);
      } else {
        broken |= id[k] < b;
        if (multi) write_out<T, OP>(out, b, num_segments, init, acc);
        else first = acc;
        multi = true;
        b = id[k];
        acc = v[k];
      }
    }
  }
  if (!multi) first = acc;

  s_first[t] = a;
  s_last[t] = b;
  __syncthreads();
  // threads hold rows in thread order, so t > 0 with rows has a full neighbour
  const bool cont_left = cnt > 0 && t > 0 && s_last[t - 1] == a;
  const bool cont_right = (int64_t)(t + 1) * kItems < rows && s_first[t + 1] == b;
  const int64_t tile_first = s_first[0];
  const int64_t tile_last = s_last[(rows - 1) / kItems];
  if (cnt > 0) {  // in order, a <= every id <= b
    broken |= (uint64_t)a >= (uint64_t)num_segments || (uint64_t)b >= (uint64_t)num_segments;
    broken |= t > 0 ? s_last[t - 1] > a : start > 0 && seg[start - 1] > a;
    if (broken) *bad = 1;
  }

  // segmented inclusive scan of the last runs: a head's run starts in it
  int f = (multi || !cont_left) ? 1 : 0;
  T x = cnt > 0 ? acc : O::identity();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int fo = __shfl_up_sync(kFull, f, d);
    const T xo = shfl_up(x, d);
    if (lane >= d) {
      if (!f) x = O::combine(xo, x);
      f |= fo;
    }
  }
  if (lane == 31) {
    s_wflag[warp] = f;
    s_wval[warp] = x;
  }
  __syncthreads();
  // the run open before this thread: the warps before, in order, then the
  // lanes before in this warp
  int ef = __shfl_up_sync(kFull, f, 1);
  T ex = shfl_up(x, 1);
  if (warp > 0 && (lane == 0 || !ef)) {
    T px = s_wval[0];
    for (int w = 1; w < warp; ++w) px = s_wflag[w] ? s_wval[w] : O::combine(px, s_wval[w]);
    ex = lane == 0 ? px : O::combine(px, ex);
  }

  if (cnt == 0) return;
  const bool edges = carry_id != nullptr;
  const T fv = cont_left ? O::combine(ex, first) : first;
  // the first run ends here unless it is the thread's only run and goes on
  const bool ends[2] = {multi || !cont_right, multi && !cont_right};
  const int64_t ids[2] = {a, b};
  const T tot[2] = {fv, acc};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ends[r]) continue;
    const int64_t s = ids[r];
    if (edges && (s == tile_first || s == tile_last)) {
      if (s == tile_first) {
        carry_id[2 * tile] = s;
        carry_val[2 * tile] = tot[r];
        if (s == tile_last) {
          carry_id[2 * tile + 1] = s;
          carry_val[2 * tile + 1] = O::identity();
        }
      } else {
        carry_id[2 * tile + 1] = s;
        carry_val[2 * tile + 1] = tot[r];
      }
    } else {
      write_out<T, OP>(out, s, num_segments, init, tot[r]);
    }
  }
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

int64_t round_up(int64_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T, int OP>
int run(const int64_t* seg, const T* vals, int64_t n, int64_t num_segments, T init, T* out,
        int64_t* carry_id, T* carry_val, int* bad, cudaStream_t stream) {
  if constexpr (!kServed<T, OP>) {  // no caller passes the pair: not built
    return (int)cudaErrorInvalidValue;
  } else {
    // levels ping-pong between two carry buffers: [0, round_up(c1)) and after it
    int64_t* ids[2] = {carry_id, carry_id + round_up(2 * tiles_of(n))};
    T* cv[2] = {carry_val, carry_val + round_up(2 * tiles_of(n))};
    for (int level = 0;; ++level) {
      const int64_t tiles = tiles_of(n);
      const bool last = tiles == 1;
      int64_t* cid = last ? nullptr : ids[level & 1];
      T* cval = last ? nullptr : cv[level & 1];
      const bool vec = aligned(seg) && aligned(vals);
      reduce_tiles<T, OP><<<(unsigned)tiles, kThreads, 0, stream>>>(
          seg, vals, n, num_segments, init, out, cid, cval, bad, vec);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      if (last) return 0;
      seg = cid;
      vals = cval;
      n = 2 * tiles;
    }
  }
}

template <typename T>
int run_op(int op, const void* seg, const void* vals, long long n, long long num_segments,
           const void* init, void* out, void* carry_id, void* carry_val, int* bad,
           cudaStream_t stream) {
  T i;
  memcpy(&i, init, sizeof(T));
  const int64_t* s = (const int64_t*)seg;
  const T* v = (const T*)vals;
  T* o = (T*)out;
  int64_t* ci = (int64_t*)carry_id;
  T* cv = (T*)carry_val;
  switch (op) {
    case kSum: return run<T, kSum>(s, v, n, num_segments, i, o, ci, cv, bad, stream);
    case kProd: return run<T, kProd>(s, v, n, num_segments, i, o, ci, cv, bad, stream);
    case kMin: return run<T, kMin>(s, v, n, num_segments, i, o, ci, cv, bad, stream);
    case kMax: return run<T, kMax>(s, v, n, num_segments, i, o, ci, cv, bad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Carry slots (int64 ids and values alike) that a call on n rows needs.
extern "C" long long segment_reduce_scratch(long long n) {
  const int64_t t1 = tiles_of(n);
  if (t1 <= 1) return 0;
  return round_up(2 * t1) + 2 * tiles_of(2 * t1);
}

// seg int64[n] non-decreasing; vals[n] of dtype (0 int8, 1 uint8, 2 int16,
// 3 int32, 4 int64, 5 float32, 6 float64, 7 bfloat16); op 0 sum, 1 prod,
// 2 amin, 3 amax; init a host pointer to one value of dtype; out[num_segments]
// already holds init; carry_id int64 and carry_val dtype scratch of
// segment_reduce_scratch(n) slots; bad an int the card can write (pinned host
// memory, through the unified address space), set to 1 where the ids break
// the contract. n >= 1. Launches on `stream`; returns the first
// CUDA error, or 0 (cudaErrorInvalidValue for a pair the kernel is not
// built for).
extern "C" int segment_reduce(const void* seg, const void* vals, long long n,
                              long long num_segments, int dtype, int op, const void* init,
                              void* out, void* carry_id, void* carry_val, void* bad,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* b = (int*)bad;
  switch (dtype) {
    case 0: return run_op<int8_t>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    case 1: return run_op<uint8_t>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    case 2: return run_op<int16_t>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    case 3: return run_op<int32_t>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    case 4: return run_op<int64_t>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    case 5: return run_op<float>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    case 6: return run_op<double>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    case 7: return run_op<__nv_bfloat16>(op, seg, vals, n, num_segments, init, out, carry_id, carry_val, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
