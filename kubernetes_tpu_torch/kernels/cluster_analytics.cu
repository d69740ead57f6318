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
// thread) in that one launch.  Above that, a sequence of launches (below):
// each block folds a strided subtree of the fold, a second pass adds the
// blocks' partial sums in the fold's order, and the quantiles come from a
// radix select over the keys in global memory.
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

// ---------------------------------------------------------------------------
// Above kMaxRows: the multi-block sequence.
//
// Sums: with K = 2^ceil(log2 n) rows and NB = K / (kThreads * kWideE)
// blocks, block b takes the rows b + NB * j (j = 0 .. K/NB - 1): the
// subtree of the reference's fold rooted at position b of its level of NB
// partial sums (that level pairs b with b + NB/2, ..., so the positions
// below it only ever pair rows of one block).  A block folds its subtree
// as block_fold does (a thread's kWideE rows in registers, then across
// threads), writes one partial sum a quantity, and a second pass folds
// the NB partials in the fold's order.  The dominant shares' squared
// deviations need the first pass's mean: a third and fourth pass.
// Counts and maxima are order-free: per-block partials, combined once.
// Quantiles: a radix select over the 64-bit keys (value key with -0.0 read
// as 0.0, then the row), 8 bits a pass over 8 passes; pass p counts, in
// global histograms, the keys that share the bits the earlier passes
// fixed, and every block recovers those bits by replaying the earlier
// passes' histograms.  The value is read back from the selected row.

constexpr int kWideE = 8;      // rows a thread folds in registers
constexpr int kWideQ = 20;     // quantities of the first fold pass
constexpr int kWideI = 9;      // count, four util and four free max keys
constexpr int kSelects = 12;   // 4 columns x p50/p90/p99
constexpr int kBins = 256;
constexpr int kPasses = 8;
constexpr int kHist = kPasses * kSelects * kBins;

struct Wide {
  float* part;     // [kWideQ + 1][NB]
  int* ipart;      // [kWideI][NB]
  float* fin;      // [kWideQ] folded sums
  int* fin_i;      // [kWideI] count, max keys
  unsigned* hist;  // [kPasses][kSelects][kBins]
  int nb;
};

__device__ __forceinline__ float quantity(const In& in, int q, int i) {
  if (q < 4) return util_of(in, i, q);
  if (q < 6) return free_of(in, i, q - 4);
  if (q == 6)
    return row_valid(in, i) && !(free_of(in, i, 1) > 0.f) ? free_of(in, i, 0)
                                                          : 0.f;
  if (q == 7)
    return row_valid(in, i) && !(free_of(in, i, 0) > 0.f) ? free_of(in, i, 1)
                                                          : 0.f;
  if (q == 8) return row_valid(in, i) ? dom_of(in, i) : 0.f;
  if (q == 9) return row_valid(in, i) ? in.req[(size_t)i * in.r + 3] : 0.f;
  return decile_of(in, i) == q - 10 ? 1.f : 0.f;
}

__device__ __forceinline__ int select_rank(float qv, int count, int n) {
  const float pos = __fmul_rn(qv, __fsub_rn((float)count, 1.f));
  const int idx = (int)rintf(pos);
  return idx < 0 ? 0 : (idx > n - 1 ? n - 1 : idx);
}

__device__ __forceinline__ float quantile_q(int s) {
  return s == 0 ? 0.5f : (s == 1 ? 0.9f : 0.99f);
}

// The digit of pass p's histogram that holds rank `rank` (and the rank
// within it), by one warp: lane l scans bins 8l .. 8l + 7.
__device__ __forceinline__ void warp_pick(const unsigned* h, int lane,
                                          int& rank, int& digit) {
  unsigned v[8], sum = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    v[u] = h[lane * 8 + u];
    sum += v[u];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const unsigned excl = incl - sum;
  const bool mine = excl <= (unsigned)rank && (unsigned)rank < incl;
  const unsigned who = __ballot_sync(0xffffffffu, mine);
  const int src = who ? __ffs(who) - 1 : 31;
  int d = 0, r = rank - (int)excl;
  if (mine) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (d == 0 && (unsigned)r < v[u]) d = lane * 8 + u + 1;
      if (d == 0) r -= (int)v[u];
    }
  }
  digit = __shfl_sync(0xffffffffu, d - 1, src);
  rank = __shfl_sync(0xffffffffu, r, src);
}

// The fold of value(t + T*m), m < E (E a power of two), of one thread, in
// _fold_sum's order: the halves pairing (m with m + E/2, ...) taken as a
// neighbour pairing over the bit-reversed sequence, with a stack.
template <class F>
__device__ float thread_fold(F value, int t, int T, int E) {
  float st[32];
  int depth = 0;
  const int lg = 31 - __clz(E);
  for (int j = 0; j < E; ++j) {
    const int m = lg ? (int)(__brev((unsigned)j) >> (32 - lg)) : 0;
    float v = value(t + T * m);
    for (int c = j + 1; (c & 1) == 0; c >>= 1) v = __fadd_rn(st[--depth], v);
    st[depth++] = v;
  }
  return st[0];
}

// thread_fold over T threads (T a power of two <= kThreads), then across
// them in the fold's order.  All threads call it.
template <class F>
__device__ float block_fold_rt(F value, int T, int E, float* s) {
  const int t = threadIdx.x;
  s[t] = t < T ? thread_fold(value, t, T, E) : 0.f;
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

// Pass 1: block (b, q < kWideQ) folds quantity q over its subtree; block
// (b, kWideQ) takes its rows' count and maxima and clears the histograms.
__global__ void __launch_bounds__(kThreads) k5w_partials(In in, Wide w) {
  __shared__ float s[kThreads];
  __shared__ int red[kWideI][32];
  const int b = blockIdx.x, q = blockIdx.y, t = threadIdx.x;
  const int nb = w.nb;
  if (q < kWideQ) {
    const float v = block_fold_rt(
        [&](int j) {
          const long long i = b + (long long)nb * j;
          return i < in.n ? quantity(in, q, (int)i) : 0.f;
        },
        kThreads, kWideE, s);
    if (t == 0) w.part[q * nb + b] = v;
    return;
  }
  for (long long i = (long long)b * kThreads + t; i < kHist;
       i += (long long)nb * kThreads)
    w.hist[i] = 0u;
  const int neg = okey(-__int_as_float(0x7f800000));
  int acc[kWideI];
  acc[0] = 0;
  for (int k = 1; k < kWideI; ++k) acc[k] = neg;
  for (int m = 0; m < kWideE; ++m) {
    const long long i = b + (long long)nb * (t + kThreads * m);
    if (i >= in.n || !row_valid(in, (int)i)) continue;
    acc[0] += 1;
    for (int c = 0; c < 4; ++c) {
      acc[1 + c] = max(acc[1 + c], okey(util_of(in, (int)i, c)));
      acc[5 + c] = max(acc[5 + c], okey(free_of(in, (int)i, c)));
    }
  }
  const int lane = t & 31, warp = t >> 5;
  for (int k = 0; k < kWideI; ++k) {
    const int v = k == 0 ? __reduce_add_sync(0xffffffffu, acc[k])
                         : __reduce_max_sync(0xffffffffu, acc[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (t < kWideI * 32) {
    const int k = t >> 5;
    int v = red[k][lane];
    v = k == 0 ? __reduce_add_sync(0xffffffffu, v)
               : __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) w.ipart[k * nb + b] = v;
  }
}

// Pass 2: block q < kWideQ folds the NB partials of quantity q; block
// kWideQ combines the counts and maxima.
__global__ void __launch_bounds__(kThreads) k5w_reduce(Wide w) {
  __shared__ float s[kThreads];
  const int q = blockIdx.x, t = threadIdx.x, nb = w.nb;
  if (q < kWideQ) {
    const int T = nb < kThreads ? nb : kThreads;
    const float v = block_fold_rt(
        [&](int j) { return w.part[q * nb + j]; }, T, nb / T, s);
    if (t == 0) w.fin[q] = v;
    return;
  }
  if (t < kWideI) {
    int v = w.ipart[t * nb];
    for (int b = 1; b < nb; ++b)
      v = t == 0 ? v + w.ipart[b] : max(v, w.ipart[t * nb + b]);
    w.fin_i[t] = v;
  }
}

__device__ __forceinline__ float mean_dom(const Wide& w) {
  const int count = w.fin_i[0];
  return count > 0 ? __fdiv_rn(w.fin[8], (float)count) : 0.f;
}

// Pass 3: the dominant shares' squared deviations over each block's
// subtree.
__global__ void __launch_bounds__(kThreads) k5w_var(In in, Wide w) {
  __shared__ float s[kThreads];
  const int b = blockIdx.x, nb = w.nb;
  const float mean = mean_dom(w);
  const float v = block_fold_rt(
      [&](int j) {
        const long long i = b + (long long)nb * j;
        if (i >= in.n || !row_valid(in, (int)i)) return 0.f;
        const float d = __fsub_rn(dom_of(in, (int)i), mean);
        return __fmul_rn(d, d);
      },
      kThreads, kWideE, s);
  if (threadIdx.x == 0) w.part[kWideQ * nb + b] = v;
}

// The (prefix of fixed bits, rank left) of select sel after `passes`
// passes, replayed by one warp from the stored histograms.
__device__ void replay(const Wide& w, int sel, int passes, int count, int n,
                       int lane, unsigned long long& prefix, int& rank) {
  prefix = 0ull;
  rank = select_rank(quantile_q(sel % 3), count, n);
  for (int p = 0; p < passes; ++p) {
    int digit;
    warp_pick(w.hist + ((size_t)p * kSelects + sel) * kBins, lane, rank,
              digit);
    prefix |= (unsigned long long)digit << (56 - 8 * p);
  }
}

// Radix pass p over column blockIdx.y: count the digit of every key that
// shares the bits the earlier passes fixed, for the column's 3 selects.
__global__ void __launch_bounds__(kThreads) k5w_hist(In in, Wide w, int p) {
  __shared__ unsigned h[3][kBins];
  __shared__ unsigned long long pre[3];
  const int c = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < 3 * kBins; i += kThreads) (&h[0][0])[i] = 0u;
  if (warp < 3) {
    unsigned long long prefix;
    int rank;
    replay(w, c * 3 + warp, p, w.fin_i[0], in.n, lane, prefix, rank);
    if (lane == 0) pre[warp] = prefix;
  }
  __syncthreads();
  const int shift = 56 - 8 * p;
  for (long long i = (long long)blockIdx.x * kThreads + t; i < in.n;
       i += (long long)gridDim.x * kThreads) {
    const float u = row_valid(in, (int)i) ? util_of(in, (int)i, c)
                                          : __int_as_float(0x7f800000);
    const unsigned long long key = sort_key(u, (int)i);
    const unsigned digit = (unsigned)(key >> shift) & 0xffu;
    for (int s = 0; s < 3; ++s)
      if (p == 0 || (key >> (shift + 8)) == (pre[s] >> (shift + 8)))
        atomicAdd(&h[s][digit], 1u);
  }
  __syncthreads();
  for (int i = t; i < 3 * kBins; i += kThreads) {
    const unsigned v = (&h[0][0])[i];
    if (v)
      atomicAdd(w.hist + ((size_t)p * kSelects + c * 3 + i / kBins) * kBins +
                    i % kBins,
                v);
  }
}

// Last: the variance fold, the quantiles read back from their rows, and
// the 40 words.
__global__ void __launch_bounds__(kThreads) k5w_finish(In in, Wide w,
                                                       int* out) {
  __shared__ float s[kThreads];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nb = w.nb;
  const int count = w.fin_i[0];
  const int T = nb < kThreads ? nb : kThreads;
  const float var_sum = block_fold_rt(
      [&](int j) { return w.part[kWideQ * nb + j]; }, T, nb / T, s);
  if (warp < kSelects) {
    unsigned long long key;
    int rank;
    replay(w, warp, kPasses, count, in.n, lane, key, rank);
    if (lane == 0) {
      const int c = warp / 3, sidx = warp % 3;
      float v = 0.f;
      if (count > 0) {
        const int row = (int)(key & 0xffffffffull);
        v = row_valid(in, row) ? util_of(in, row, c)
                               : __int_as_float(0x7f800000);
      }
      put(out, c * 5 + 2 + sidx, v);
    }
  }
  if (t == 0) {
    const int neg = okey(-__int_as_float(0x7f800000));
    const float denom = count > 0 ? (float)count : 1.f;
    for (int c = 0; c < 4; ++c) {
      put(out, c * 5, count > 0 ? __fdiv_rn(w.fin[c], denom) : 0.f);
      const int ku = w.fin_i[1 + c], kf = w.fin_i[5 + c];
      put(out, c * 5 + 1, ku == neg ? 0.f : kval(ku));
      put(out, 20 + c, kf == neg ? 0.f : kval(kf));
    }
    const float fc = w.fin[4], fm = w.fin[5], sc = w.fin[6], sm = w.fin[7];
    const float d0 = fc > 0.f ? __fdiv_rn(sc, fmaxf(fc, 1.f)) : 0.f;
    const float d1 = fm > 0.f ? __fdiv_rn(sm, fmaxf(fm, 1.f)) : 0.f;
    put(out, 24, sc);
    put(out, 25, sm);
    put(out, 26, __fadd_rn(__fmul_rn(0.5f, d0), __fmul_rn(0.5f, d1)));
    const float var = count > 0 ? __fdiv_rn(var_sum, denom) : 0.f;
    put(out, 27, __fsqrt_rn(var));
    for (int bin = 0; bin < kOccBins; ++bin)
      out[28 + bin] = (int)w.fin[10 + bin];
    out[38] = count;
    put(out, 39, w.fin[9]);
  }
}

// blocks of the sequence's row passes for n rows
__host__ __device__ inline int wide_blocks(int n) {
  long long K = 1;
  while (K < n) K <<= 1;
  return (int)(K / ((long long)kThreads * kWideE));
}

int launch_wide(const In& in, int* out, int* workspace, cudaStream_t stream) {
  const int nb = wide_blocks(in.n);
  Wide w;
  w.nb = nb;
  w.part = reinterpret_cast<float*>(workspace);
  w.ipart = workspace + (size_t)(kWideQ + 1) * nb;
  w.fin = reinterpret_cast<float*>(w.ipart + (size_t)kWideI * nb);
  w.fin_i = reinterpret_cast<int*>(w.fin + kWideQ);
  w.hist = reinterpret_cast<unsigned*>(w.fin_i + kWideI);
  k5w_partials<<<dim3(nb, kWideQ + 1), kThreads, 0, stream>>>(in, w);
  k5w_reduce<<<kWideQ + 1, kThreads, 0, stream>>>(w);
  k5w_var<<<nb, kThreads, 0, stream>>>(in, w);
  const int hb = (in.n + kThreads - 1) / kThreads;
  for (int p = 0; p < kPasses; ++p)
    k5w_hist<<<dim3(hb < 4096 ? hb : 4096, 4), kThreads, 0, stream>>>(in, w,
                                                                        p);
  k5w_finish<<<1, kThreads, 0, stream>>>(in, w, out);
  return (int)cudaGetLastError();
}

}  // namespace

// 32-bit words of workspace cluster_analytics_launch needs for n rows (0 up
// to the one-launch width)
extern "C" int cluster_analytics_workspace_ints(int n) {
  if (n <= kMaxRows) return 0;
  const int nb = wide_blocks(n);
  return (kWideQ + 1 + kWideI) * nb + kWideQ + kWideI + kHist;
}

// rows the one-launch version takes
extern "C" int cluster_analytics_max_rows() { return kMaxRows; }

// K5 over one snapshot: allocatable, requested f32[n, r] (r >= 4, rows
// contiguous), valid bool[n]; out int32[40]; workspace: int32[
// cluster_analytics_workspace_ints(n)] (none up to kMaxRows rows), owned by
// the launches until the stream passes them.  Returns the cudaError_t of
// the launch (one up to kMaxRows rows, the multi-block sequence above).
extern "C" int cluster_analytics_launch(const float* alloc, const float* req,
                                        const uint8_t* valid, int n, int r,
                                        int* out, int* workspace,
                                        cudaStream_t stream) {
  if (n < 0 || r < 4) return (int)cudaErrorInvalidValue;
  const In in{alloc, req, valid, n, r};
  if (n > kMaxRows) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    return launch_wide(in, out, workspace, stream);
  }
  int K = 1;
  while (K < n) K <<= 1;
  switch (K <= kThreads ? 1 : K / kThreads) {
    case 1: return launch<1>(in, K, out, stream);
    case 2: return launch<2>(in, K, out, stream);
    case 4: return launch<4>(in, K, out, stream);
    case 8: return launch<8>(in, K, out, stream);
    case 16: return launch<16>(in, K, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
