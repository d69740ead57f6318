// K5: the cluster analytics of one snapshot, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/analytics.py _analytics (:104), jitted as
// cluster_analytics (:249), which the telemetry hub launches once a
// committed cycle over the resident snapshot.  From allocatable and
// requested f32[N, R] (their first four columns: cpu, memory, ephemeral,
// pods) and valid bool[N] it writes one sample of 40 32-bit words (the
// layout of ops/analytics.py PACKED_LAYOUT): per resource the mean, max and
// nearest-rank p50/p90/p99 of requested/allocatable over the valid rows,
// the largest free capacity, the cpu and memory stranded on nodes whose
// other resource is exhausted, the fragmentation, the standard deviation
// of each node's dominant share, the pod-occupancy deciles, the valid
// node count and the pods running.
//
// The contract is bit for bit with the reference, so the design pins the
// order of every float operation:
//  - Sums are the reference's pairwise fold (_fold_sum): zero-pad the rows
//    to K = 2^ceil(log2 N), add x[:h] + x[h:] until one row is left.  The
//    indices t + T*m (m = 0..K/T-1) of one thread t form a whole subtree of
//    that fold (the first log2(K/T) levels pair m with m + E/2, ...), so a
//    thread folds its E = K/T rows in registers, and the last log2(T)
//    levels run across threads: through shared memory while h >= 32, then
//    by shuffles in one warp.  The same split lets a later multi-block
//    version give each block a strided subtree and keep the order.
//  - Every multiply that feeds an add (diff*diff before the fold, 0.5*a +
//    0.5*b, q*(count-1)) and every divide, add and sqrt is written with the
//    _rn intrinsics, so nvcc's default -fmad=true contracts nothing here.
//  - Maxima order -0.0 below 0.0 (XLA's max): they reduce 32-bit order
//    keys.
//  - Quantiles: the reference sorts each column stably with -0.0 and 0.0
//    tied (invalid rows as +inf) and gathers index round-half-even(q *
//    (count - 1)).  Here one block a resource sorts 64-bit keys (the value's
//    order key with -0.0 read as 0.0, then the row) by a bitonic sort in
//    shared memory, which gives the stable order, and reads the value back
//    from the row it finds, sign included.
//  - A division is taken only where allocatable > 0 (the reference selects
//    its quotient away elsewhere), so no inf or NaN of a zero capacity
//    enters a sum.  Counts are integers (exact, as the reference's f32 sums
//    of 0/1 are below 2^24).
//
// Work split: one launch of 14 blocks of 1,024 threads, each block one
// independent part of the sample (four quantile sorts, four mean/max
// columns, the largest-free maxima, fragmentation, imbalance, two halves of
// the occupancy deciles, nodes and pods), so no block waits on another.
// Up to 16,384 rows (K*8 bytes of keys in shared memory, E <= 16 rows a
// thread); the wrapper refuses wider snapshots.  Above that, a version
// would give each block a strided subtree of the fold (a second pass adds
// the blocks' partial sums in the fold's order) and select the quantiles
// by a radix select over global memory.
//
// Bound: bytes, far below a launch.  At the live cell's width (N 6,144,
// R 8) the function needs the four columns of the two tables and the mask,
// about 0.2 MB, 0.00006 ms at the card's 3.35 TB/s; so K5 is read against
// its launch floor (an empty launch times its stream operations, one).
// What holds it above the floor is the sort: log2(K)(log2(K)+1)/2 barrier
// stages of compare-exchanges in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 16384;
constexpr int kBlocks = 14;
constexpr int kOccBins = 10;

struct In {
  const float* alloc;
  const float* req;
  const uint8_t* valid;
  int n;  // rows
  int r;  // row stride (columns)
};

__device__ __forceinline__ int okey(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}

__device__ __forceinline__ float kval(int k) {
  return __int_as_float(k < 0 ? (k ^ 0x7fffffff) : k);
}

__device__ __forceinline__ bool row_valid(const In& in, int i) {
  return in.valid[i] != 0;
}

// requested/allocatable of column c where the node allocates any, else 0
__device__ __forceinline__ float util_of(const In& in, int i, int c) {
  const float a = in.alloc[(size_t)i * in.r + c];
  if (!row_valid(in, i) || !(a > 0.f)) return 0.f;
  return __fdiv_rn(in.req[(size_t)i * in.r + c], a);
}

// max(alloc - used, 0) with the reference's maximum (+0.0 for -0.0, a NaN
// kept), 0 on an invalid row
__device__ __forceinline__ float free_of(const In& in, int i, int c) {
  if (!row_valid(in, i)) return 0.f;
  const float d = __fsub_rn(in.alloc[(size_t)i * in.r + c],
                            in.req[(size_t)i * in.r + c]);
  return (d > 0.f || d != d) ? d : 0.f;
}

// the dominant share: the max of the four utilizations in the total order
__device__ __forceinline__ float dom_of(const In& in, int i) {
  int k = okey(util_of(in, i, 0));
  for (int c = 1; c < 4; ++c) k = max(k, okey(util_of(in, i, c)));
  return kval(k);
}

// the occupancy decile of row i, or -1 where it is not counted
__device__ __forceinline__ int decile_of(const In& in, int i) {
  if (!row_valid(in, i) || !(in.alloc[(size_t)i * in.r + 3] > 0.f))
    return -1;
  const float f = floorf(__fmul_rn(util_of(in, i, 3), (float)kOccBins));
  return (int)fminf(fmaxf(f, 0.f), (float)(kOccBins - 1));
}

// The fold of value(i) over rows i < n, zero-padded to K = T*E rows, in the
// reference's order.  s: kThreads floats of shared memory.  All threads
// call it.
template <int E, class F>
__device__ float block_fold(F value, int n, int T, float* s) {
  const int t = threadIdx.x;
  float v = 0.f;
  if (t < T) {
    float x[E];
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int i = t + T * m;
      x[m] = i < n ? value(i) : 0.f;
    }
#pragma unroll
    for (int h = E / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int m = 0; m < h; ++m) x[m] = __fadd_rn(x[m], x[m + h]);
    }
    v = x[0];
  }
  s[t] = v;
  __syncthreads();
  for (int h = T / 2; h >= 32; h >>= 1) {
    if (t < h) s[t] = __fadd_rn(s[t], s[t + h]);
    __syncthreads();
  }
  float w = 0.f;
  if (t < 32) {
    w = t < T ? s[t] : 0.f;
    for (int h = (T < 32 ? T : 32) / 2; h >= 1; h >>= 1) {
      const float o = __shfl_down_sync(0xffffffffu, w, h);
      if (t < h) w = __fadd_rn(w, o);
    }
  }
  __syncthreads();
  if (t == 0) s[0] = w;
  __syncthreads();
  const float out = s[0];
  __syncthreads();
  return out;
}

// The number of valid rows.  All threads call it.
template <int E>
__device__ int block_count(const In& in, int T) {
  const int t = threadIdx.x;
  int c = 0;
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int i = t + T * m;
    c += __syncthreads_count(t < T && i < in.n && row_valid(in, i));
  }
  return c;
}

// The max in the total order of value(i) over the valid rows, -inf read as
// 0 (no valid row).  red: 32 ints of shared memory.  All threads call it.
template <class F>
__device__ float block_masked_max(const In& in, F value, int* red) {
  const int t = threadIdx.x;
  const int neg = okey(-__int_as_float(0x7f800000));
  int k = neg;
  for (int i = t; i < in.n; i += kThreads)
    if (row_valid(in, i)) k = max(k, okey(value(i)));
  k = __reduce_max_sync(0xffffffffu, k);
  if ((t & 31) == 0) red[t >> 5] = k;
  __syncthreads();
  if (t < 32) {
    k = __reduce_max_sync(0xffffffffu, red[t]);
    if (t == 0) red[0] = k;
  }
  __syncthreads();
  k = red[0];
  __syncthreads();
  return k == neg ? 0.f : kval(k);
}

__device__ __forceinline__ unsigned long long sort_key(float v, int row) {
  unsigned b = __float_as_uint(v);
  if ((b & 0x7fffffffu) == 0u) b = 0u;  // -0.0 ties with 0.0
  const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)k << 32) | (unsigned)row;
}

__device__ __forceinline__ void put(int* out, int word, float v) {
  out[word] = __float_as_int(v);
}

template <int E>
__global__ void __launch_bounds__(kThreads, 1)
k5_cluster_analytics(In in, int K, int* out) {
  __shared__ float s[kThreads];
  __shared__ int red[32];
  extern __shared__ unsigned long long keys[];
  const int T = K / E;
  const int t = threadIdx.x;
  const int role = blockIdx.x;
  if (role < 4) {
    // p50 / p90 / p99 of utilization column r
    const int r = role;
    for (int i = t; i < K; i += kThreads) {
      if (i < in.n) {
        const float u = row_valid(in, i) ? util_of(in, i, r)
                                         : __int_as_float(0x7f800000);
        keys[i] = sort_key(u, i);
      } else {
        keys[i] = ~0ull;
      }
    }
    const int count = block_count<E>(in, T);
    __syncthreads();
    for (int k = 2; k <= K; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = t; p < K / 2; p += kThreads) {
          const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const int hi = lo + j;
          const bool up = (lo & k) == 0;
          const unsigned long long a = keys[lo], b = keys[hi];
          if ((a > b) == up) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    if (t < 3) {
      float v = 0.f;
      if (count > 0) {
        const float q = t == 0 ? 0.5f : (t == 1 ? 0.9f : 0.99f);
        const float pos = __fmul_rn(q, __fsub_rn((float)count, 1.f));
        int idx = (int)rintf(pos);
        idx = idx < 0 ? 0 : (idx > in.n - 1 ? in.n - 1 : idx);
        const int row = (int)(keys[idx] & 0xffffffffull);
        v = row_valid(in, row) ? util_of(in, row, r)
                               : __int_as_float(0x7f800000);
      }
      put(out, r * 5 + 2 + t, v);
    }
  } else if (role < 8) {
    // mean and max of utilization column r
    const int r = role - 4;
    const float sum = block_fold<E>(
        [&](int i) { return util_of(in, i, r); }, in.n, T, s);
    const int count = block_count<E>(in, T);
    const float mx = block_masked_max(
        in, [&](int i) { return util_of(in, i, r); }, red);
    if (t == 0) {
      const float denom = count > 0 ? (float)count : 1.f;
      put(out, r * 5, count > 0 ? __fdiv_rn(sum, denom) : 0.f);
      put(out, r * 5 + 1, mx);
    }
  } else if (role == 8) {
    // the largest free capacity a resource
    for (int c = 0; c < 4; ++c) {
      const float mx = block_masked_max(
          in, [&](int i) { return free_of(in, i, c); }, red);
      if (t == 0) put(out, 20 + c, mx);
    }
  } else if (role == 9) {
    // stranded cpu and memory, fragmentation
    const float fc = block_fold<E>(
        [&](int i) { return free_of(in, i, 0); }, in.n, T, s);
    const float fm = block_fold<E>(
        [&](int i) { return free_of(in, i, 1); }, in.n, T, s);
    const float sc = block_fold<E>([&](int i) {
      return row_valid(in, i) && !(free_of(in, i, 1) > 0.f)
                 ? free_of(in, i, 0) : 0.f;
    }, in.n, T, s);
    const float sm = block_fold<E>([&](int i) {
      return row_valid(in, i) && !(free_of(in, i, 0) > 0.f)
                 ? free_of(in, i, 1) : 0.f;
    }, in.n, T, s);
    if (t == 0) {
      const float d0 = fc > 0.f ? __fdiv_rn(sc, fmaxf(fc, 1.f)) : 0.f;
      const float d1 = fm > 0.f ? __fdiv_rn(sm, fmaxf(fm, 1.f)) : 0.f;
      put(out, 24, sc);
      put(out, 25, sm);
      put(out, 26, __fadd_rn(__fmul_rn(0.5f, d0), __fmul_rn(0.5f, d1)));
    }
  } else if (role == 10) {
    // imbalance: the dominant shares' standard deviation (two folds)
    const float sum_dom = block_fold<E>([&](int i) {
      return row_valid(in, i) ? dom_of(in, i) : 0.f;
    }, in.n, T, s);
    const int count = block_count<E>(in, T);
    const float denom = count > 0 ? (float)count : 1.f;
    const float mean = count > 0 ? __fdiv_rn(sum_dom, denom) : 0.f;
    const float var_sum = block_fold<E>([&](int i) {
      if (!row_valid(in, i)) return 0.f;
      const float d = __fsub_rn(dom_of(in, i), mean);
      return __fmul_rn(d, d);
    }, in.n, T, s);
    if (t == 0) {
      const float var = count > 0 ? __fdiv_rn(var_sum, denom) : 0.f;
      put(out, 27, __fsqrt_rn(var));
    }
  } else if (role < 13) {
    // the occupancy deciles, five a block
    const int b0 = (role - 11) * 5;
    for (int b = b0; b < b0 + 5; ++b) {
      const float n = block_fold<E>([&](int i) {
        return decile_of(in, i) == b ? 1.f : 0.f;
      }, in.n, T, s);
      if (t == 0) out[28 + b] = (int)n;
    }
  } else {
    // valid nodes and the pods running on them
    const float pods = block_fold<E>([&](int i) {
      return row_valid(in, i) ? in.req[(size_t)i * in.r + 3] : 0.f;
    }, in.n, T, s);
    const int count = block_count<E>(in, T);
    if (t == 0) {
      out[38] = count;
      put(out, 39, pods);
    }
  }
}

template <int E>
int launch(const In& in, int K, int* out, cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(unsigned long long);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      k5_cluster_analytics<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMaxRows * sizeof(unsigned long long)));
  if (e != cudaSuccess) return (int)e;
  k5_cluster_analytics<E><<<kBlocks, kThreads, smem, stream>>>(in, K, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cluster_analytics_max_rows() { return kMaxRows; }

// K5 over one snapshot: allocatable, requested f32[n, r] (r >= 4, rows
// contiguous), valid bool[n]; out int32[40].  Returns the cudaError_t of
// the launch.
extern "C" int cluster_analytics_launch(const float* alloc, const float* req,
                                        const uint8_t* valid, int n, int r,
                                        int* out, cudaStream_t stream) {
  if (n < 0 || n > kMaxRows || r < 4) return (int)cudaErrorInvalidValue;
  int K = 1;
  while (K < n) K <<= 1;
  const In in{alloc, req, valid, n, r};
  switch (K <= kThreads ? 1 : K / kThreads) {
    case 1: return launch<1>(in, K, out, stream);
    case 2: return launch<2>(in, K, out, stream);
    case 4: return launch<4>(in, K, out, stream);
    case 8: return launch<8>(in, K, out, stream);
    case 16: return launch<16>(in, K, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
