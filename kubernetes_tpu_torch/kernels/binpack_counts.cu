// K8: the count-carrying first-fit scan, for Hopper (sm_90a).
//
// Replaces the lax.scan of the JAX package's models/binpack.py
// binpack_ffd_counts (:148-207), which the capacity planner's stage 1
// (runtime/capacity.py :159) and binpack_shapes_compressed (:233, the
// planner's stage 2 and the BASELINE what-if) run.  Lane s packs counts[c]
// items of each class c of reqs f32[C, R] into nb bins, classes taken in
// order[s] (i32[S, C]), loads f32[nb, R] starting at zero.  A step, with
// oi = order[s, k] (a negative index wraps once, then clamps), req_i =
// int(reqs[oi]) (truncation), m = counts[oi], real = any(reqs[oi] > 0):
//   rem_i[b, r] = cap_i[b, r] - int(loads[b, r])
//   a[b]  = clip(min over r with req_i[r] > 0 of floor(rem_i / req_i), 0, m)
//           (2^31 - 1 where no column is requested)
//   c[b]  = exclusive prefix sum of a            (int32, wrapping)
//   n[b]  = clip(m - c[b], 0, a[b]) if real and m > 0, else 0
//   loads[b, r] += float(n[b] * req_i[r])        (int32 product, f32 add)
//   placed[s, k] = real ? sum over b of n[b] : m (int32, wrapping)
// and at the end used[s] = #bins with any load > 0.  Two modes: uniform
// (per_bin 0), every bin of lane s has capacity caps[s] (f32[S, R]);
// per-bin (per_bin 1, S 1), bin b has capacity caps[b] (f32[nb, R]; a zero
// row is a full node).  cap_i is int(cap), truncated.  Optional outputs:
// loads_out f32[S, nb, R] and touched bool[nb] (any load > 0).
//
// Design.  A lane is a chain of C dependent steps, each a prefix over the
// bins; what bounds it is the latency of a step, so the design cuts the
// work a step must wait for.
//  * Held columns.  A column no class requests (int(req) == 0 for every
//    class) keeps a load of +0.0 (the fill adds float(n * 0) = +0.0 to a
//    load that is never -0.0, which leaves it as it is), so only the
//    columns some class requests are held: their loads (and a per-bin
//    lane's remainders) in shared memory, [held][nb], column-major;
//    loads_out writes 0 in the others.  The block finds them itself (the
//    map hcol / hidx).
//  * Chunk summaries.  The bins fall in chunks of 32, a warp's span.  For
//    each chunk and held column the lane keeps the largest remainder
//    cap_i - int(load) over the chunk's bins (the wrapped int32 values
//    the admission reads).  A step tests every chunk's summary against
//    the class's requested columns and walks, in bin order, only chunks
//    where each requested column's largest remainder reaches the request;
//    the warp that fills a chunk recomputes its summary.  Exact: in a
//    skipped chunk some requested column r has rem <= summary < req_i[r]
//    at every bin, so floor(rem / req_i[r]) <= 0 (negative remainders
//    included), every a[b] is 0, every n[b] = clip(m - c, 0, 0) is 0
//    whatever the wrapped prefix c reads, and the prefix does not move.
//    A step no chunk can admit costs the summary test alone.
//  * The class table staged once a block: m, real, req_i of the held
//    columns and each request's division multiplier, in shared memory, so
//    a step's prologue reads only shared memory (past kTableMax bytes the
//    step reads its class and makes its multipliers itself).
//  * Division by the step's divisor without a hardware divide: floor(x /
//    d) for d >= 1 is ~(~x / d) for x < 0, and the unsigned quotient of
//    a 31-bit u is (t + ((u - t) >> s1)) >> s2 with t = umulhi(mag, u),
//    mag = floor(2^32 (2^l - d) / d) + 1, l = ceil(log2 d), s1 = min(l,
//    1), s2 = max(l - 1, 0) (Granlund and Montgomery, 1994, fig. 4.1:
//    exact for every 32-bit dividend).
//  * The step's requests, multipliers and capacities of one to four held
//    columns in registers (Cols<NH>, every column's loads issued together);
//    a bin first compares its remainders with the requests, and only a
//    bin that holds one item in every requested column divides.  A
//    per-bin lane keeps its remainders beside its loads, so an admission
//    reads one word a column.
//  * Two launch shapes (kernels.binpack_counts_paths): a warp a lane, no
//    block barrier in a step, `lanes` lanes a block at once (as many as
//    the shared memory holds, lane s on block s % grid), two candidate
//    chunks at once (their admissions and scans interleaved); or a block
//    a lane (fewer lanes than SMs, and the per-bin stage 1), its warps
//    taking the candidate chunks one a warp a batch (two where the loads
//    lie in the workspace): a block barrier after the summary test (a
//    step no chunk admits ends there), one a batch and one at the step's
//    end; placed is read from the walk's prefix, min(prefix, m), where
//    it stayed below 2^31.
//    Where a lane's loads do not fit shared memory they (tier 1), and
//    past that its summaries too (tier 2), live in the block's slots of a
//    global workspace.  tools/k8_compare.py measured these choices
//    (chunks at once, 128 or 256 threads, the two shapes) on the card.
// The scan runs in 32-bit where a chunk's sum cannot pass 2^32 (m < 2^26),
// else in 64-bit; the step keeps its true 64-bit prefix, so once it
// reaches m and no later prefix can pass 2^31 (the wrapped int32 prefix
// the reference computes stays >= m) every later bin takes nothing and
// the step stops.  The int32 adds and products wrap as the reference's do.
//
// Bound: a chain of C dependent steps a lane.  The bytes (reqs, counts,
// caps and order read once, placed and used written once) are a few MB at
// the BASELINE sweep (S 10,000 lanes, C 256, nb 2,048, R 8); the
// operations a few per (bin, requested column) that a step reaches; a
// step's floor is an empty step (the summary test finds no chunk) times
// the waves of lanes.  No tensor cores and no TMA: there is no matrix
// work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;            // bins a chunk: one a lane of a warp
// chunks a warp takes at once, a warp a lane and a block a lane (the
// best of 1, 2 and 8, and of 1 and 2, on the card); a block a lane takes
// kBatchWork chunks a warp where its loads lie in the workspace (more
// bins a barrier against the longer loads)
constexpr int kBatchWarp = 2;
constexpr int kBatchBlock = 1;
constexpr int kBatchWork = 2;
constexpr int kThreads = 256;         // 8 lanes a block, or a lane's warps
constexpr int kWarps = kThreads / 32;
constexpr int kWorkLanes = 2;         // a block's workspace slots
constexpr int kTableMax = 32 * 1024;  // class table bytes staged at most
constexpr int kSmemBytes = 220 * 1024;  // dynamic shared memory a block

// With -DK8_PHASE_CLOCKS thread 0 of every block adds the SM clock spent
// between the launch's phase marks (K8_MARK) into g_phase_clocks, read
// back with binpack_counts_phase_clocks (tools/k8_compare.py --phases).
// Off by default: the marks compile to nothing.
#ifdef K8_PHASE_CLOCKS
constexpr int kPhases = 5;
__device__ unsigned long long g_phase_clocks[kPhases];
// and counts its steps walked, candidate chunks, chunks where some bin
// admits, chunks filled (K8_COUNT) into g_counts
constexpr int kCounts = 4;
__device__ unsigned long long g_counts[kCounts];
#define K8_COUNT(i, n)                                                \
  if (threadIdx.x == 0) counts_[i] += (n);
#define K8_CLOCKS_START                                               \
  long long clocks_[kPhases] = {};                                    \
  long long counts_[kCounts] = {};                                    \
  long long then_;                                                    \
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(then_) :: "memory");
#define K8_MARK(i)                                                    \
  if (threadIdx.x == 0) {                                             \
    long long now_;                                                   \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(now_) :: "memory"); \
    clocks_[i] += now_ - then_;                                       \
    then_ = now_;                                                     \
  }
#define K8_CLOCKS_END                                                 \
  if (threadIdx.x == 0) {                                             \
    for (int i_ = 0; i_ < kPhases; ++i_)                              \
      atomicAdd(&g_phase_clocks[i_], (unsigned long long)clocks_[i_]); \
    for (int i_ = 0; i_ < kCounts; ++i_)                              \
      atomicAdd(&g_counts[i_], (unsigned long long)counts_[i_]);      \
  }
#else
#define K8_COUNT(i, n)
#define K8_CLOCKS_START
#define K8_MARK(i)
#define K8_CLOCKS_END
#endif

// Where a launch keeps what, in 4-byte words of dynamic shared memory
// (kernels.binpack_counts_paths mirrors it): hcol[R], hidx[R], the class
// table, the block mode's candidate words, each warp's step rows, then
// `lanes` lane slots: cap_u[held] (uniform capacities), then by tier
// (0) the summaries [held][nch], the loads [held][nb] and, per-bin, the
// remainders [held][nb]; (1) the summaries, the rest in the workspace;
// (2) all in the workspace.
struct Layout {
  int held, nch, words;     // held columns, chunks, candidate words
  int staged, lanes, tier;
  long long table, mask, warp0, lane0, lane_words;
};

__host__ __device__ inline long long table_words(int held, int C) {
  const long long w = (2 + 2 * (long long)held) * C;
  return w * 4 <= kTableMax ? w : 0;
}

__host__ __device__ inline Layout make_layout(int nb, int R, int C, int held,
                                              int per_bin, int block,
                                              int threads) {
  Layout l;
  const int warps = threads / 32;
  l.held = held;
  l.nch = (nb + kChunk - 1) / kChunk;
  l.words = (l.nch + 31) / 32;
  l.table = 2 * (long long)R;
  const long long tw = table_words(held, C);
  l.staged = tw != 0;
  l.mask = l.table + tw;
  l.warp0 = l.mask + (block ? l.words : 0);
  l.lane0 = l.warp0 + (long long)warps * 2 * held;
  const long long room = kSmemBytes / 4 - l.lane0;
  const long long most = block ? 1 : warps;
  const long long tiers[3] = {
      held + (long long)held * l.nch
          + (long long)held * nb * (per_bin ? 2 : 1),
      held + (long long)held * l.nch, held};
  l.tier = 2;
  long long fit = 0;
  for (int t = 0; t < 3; ++t) {
    fit = tiers[t] ? room / tiers[t] : most;
    if (fit >= 1) {
      l.tier = t;
      break;
    }
  }
  if (l.tier > 0 && fit > kWorkLanes) fit = kWorkLanes;
  l.lane_words = tiers[l.tier];
  l.lanes = (int)(fit < most ? fit : most);
  return l;
}

// floats of a workspace slot: loads (and per-bin remainders) [R][nb] and
// summaries [R][nch], sized for every column so a slot's place does not
// depend on the held count
__host__ __device__ inline long long slot_floats(int nb, int R,
                                                 int per_bin) {
  return (long long)R * nb * (per_bin ? 2 : 1)
         + (long long)R * ((nb + kChunk - 1) / kChunk);
}

__host__ __device__ inline int row_of(int oi, int C) {
  if (oi < 0) oi += C;
  return oi < 0 ? 0 : (oi >= C ? C - 1 : oi);
}

// floor(x / d) for d >= 1 by the multiplier `mag` of d (magic())
__device__ __forceinline__ int floor_div(int x, int d, unsigned mag) {
  const unsigned u = x < 0 ? ~(unsigned)x : (unsigned)x;
  const int l = 32 - __clz(d - 1);
  const unsigned t = __umulhi(mag, u);
  const unsigned q = (t + ((u - t) >> (l > 0 ? 1 : 0))) >> (l > 1 ? l - 1 : 0);
  return x < 0 ? (int)~q : (int)q;
}

__device__ __forceinline__ unsigned magic(int d) {  // d >= 1
  const int l = 32 - __clz(d - 1);
  return (unsigned)((((unsigned long long)((1ull << l) - (unsigned)d)) << 32)
                    / (unsigned)d + 1);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// K inclusive warp scans of v (each entry <= m), in step: 32-bit where no
// chunk's sum can pass 2^32
template <int K>
__device__ __forceinline__ void warp_scans(long long (&v)[K], bool narrow,
                                           int lane) {
  if (narrow) {
    unsigned u[K];
#pragma unroll
    for (int j = 0; j < K; ++j) u[j] = (unsigned)v[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      unsigned t[K];
#pragma unroll
      for (int j = 0; j < K; ++j) t[j] = __shfl_up_sync(kFull, u[j], d);
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (lane >= d) u[j] += t[j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = (long long)u[j];
    return;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long t[K];
#pragma unroll
    for (int j = 0; j < K; ++j) t[j] = __shfl_up_sync(kFull, v[j], d);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (lane >= d) v[j] += t[j];
  }
}

struct K8Args {
  const float* reqs;
  const int* counts;
  const float* caps;
  const int* order;
  float* work;
  int* used;
  int* placed;
  float* loads_out;
  uint8_t* touched;
  int* path_out;
  int C, R, nb, S, per_bin, block;
};

// One lane's places.
struct Lane {
  float* L;         // [held][nb] loads
  int* rem;         // [held][nb] per-bin remainders cap_i - int(L)
  int* summ;        // [held][nch] a chunk's largest remainder
  int* cap_u;       // [held] uniform capacities
};

// The step's class over the held columns: m, and each column's request,
// multiplier and (uniform) capacity, in registers where the launch holds
// NH columns (NH 1 to 4), else read where they lie (NH 0).
template <int NH>
struct Cols {
  static constexpr int kN = NH > 0 ? NH : 1;
  int rq_[kN];
  unsigned mag_[kN];
  int cap_[kN];
  const int* rqp;
  const unsigned* magp;
  const int* capp;
  int held, m;
  __device__ __forceinline__ int count() const { return NH > 0 ? NH : held; }
  __device__ __forceinline__ int rq(int h) const {
    return NH > 0 ? rq_[h] : rqp[h];
  }
  __device__ __forceinline__ unsigned mag(int h) const {
    return NH > 0 ? mag_[h] : magp[h];
  }
  __device__ __forceinline__ int cap(int h) const {
    return NH > 0 ? cap_[h] : capp[h];
  }
  __device__ __forceinline__ void set(const int* rq, const unsigned* mag,
                                      const int* cap, int n) {
    held = n;
    if constexpr (NH > 0) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        rq_[h] = rq[h];
        mag_[h] = mag[h];
        cap_[h] = cap[h];
      }
    } else {
      rqp = rq;
      magp = mag;
      capp = cap;
    }
  }
};

// bin b's remainder in held column h
template <int NH>
__device__ __forceinline__ int rem_of(const Lane& ln, const Cols<NH>& k,
                                      int per_bin, int h, int b, int nb) {
  const size_t e = (size_t)h * nb + b;
  return per_bin ? ln.rem[e] : wrap_sub(k.cap(h), (int)ln.L[e]);
}

// Can chunk c admit the step's class?  (Every requested column's largest
// remainder reaches the request.)
template <int NH>
__device__ __forceinline__ bool chunk_admits(const Lane& ln,
                                             const Cols<NH>& k, int nch,
                                             int c) {
  bool ok = true;
#pragma unroll
  for (int h = 0; h < k.count(); ++h) {
    const int rq = k.rq(h);
    if (rq > 0) ok &= ln.summ[(size_t)h * nch + c] >= rq;
  }
  return ok;
}

// bin b's admission a[b] (0 past nb).  A bin short of one item in some
// requested column admits none: the compares first, the divisions only
// where every requested column holds one.
template <int NH>
__device__ __forceinline__ int admission(const Lane& ln, const Cols<NH>& k,
                                         int per_bin, int nb, int b) {
  if (b >= nb) return 0;
  if constexpr (NH > 0) {
    int r[NH];
    bool fits = true;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      r[h] = rem_of(ln, k, per_bin, h, b, nb);
      if (k.rq(h) > 0) fits &= r[h] >= k.rq(h);
    }
    if (!fits) return 0;
    int amin = INT_MAX;
#pragma unroll
    for (int h = 0; h < NH; ++h)
      if (k.rq(h) > 0) amin = min(amin, floor_div(r[h], k.rq(h), k.mag(h)));
    return clip(amin, 0, k.m);
  } else {
    for (int h = 0; h < k.count(); ++h) {
      const int rq = k.rq(h);
      if (rq > 0 && rem_of(ln, k, per_bin, h, b, nb) < rq) return 0;
    }
    int amin = INT_MAX;
    for (int h = 0; h < k.count(); ++h) {
      const int rq = k.rq(h);
      if (rq <= 0) continue;
      amin = min(amin,
                 floor_div(rem_of(ln, k, per_bin, h, b, nb), rq, k.mag(h)));
    }
    return clip(amin, 0, k.m);
  }
}

// bin b of chunk c takes n items (n != 0 only below nb); then, where any
// bin of the chunk took some, the chunk's summaries of the changed columns
// again.  A per-bin remainder follows its load: cap_i = rem + int(L)
// (wrapped), so rem' = cap_i - int(L').
template <int NH>
__device__ __forceinline__ void fill(const Lane& ln, const Cols<NH>& k,
                                     int per_bin, int nb, int nch, int c,
                                     int b, int n, int lane) {
  if (__ballot_sync(kFull, n != 0) == 0u) return;
  constexpr int kN = Cols<NH>::kN;
  const bool mine = b < nb;
#pragma unroll
  for (int h0 = 0; h0 < k.count(); h0 += kN) {
    // up to kN columns at a time: their loads together, then the updates
    int v[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int h = h0 + i;
      v[i] = INT_MIN;
      if (h >= k.count() || k.rq(h) == 0 || !mine) continue;
      const size_t e = (size_t)h * nb + b;
      const float old = ln.L[e];
      const int rem0 = per_bin ? ln.rem[e] : 0;
      float now = old;
      if (n != 0) {
        // +0.0 (rq 0) would leave the load as it is
        now = __fadd_rn(old, (float)(int)((unsigned)n * (unsigned)k.rq(h)));
        ln.L[e] = now;
      }
      if (per_bin) {
        v[i] = rem0;
        if (n != 0) {
          v[i] = wrap_sub(wrap_add(rem0, (int)old), (int)now);
          ln.rem[e] = v[i];
        }
      } else {
        v[i] = wrap_sub(k.cap(h), (int)now);
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int h = h0 + i;
      if (h >= k.count() || k.rq(h) == 0) continue;
      const int mx = __reduce_max_sync(kFull, v[i]);
      if (lane == 0) ln.summ[(size_t)h * nch + c] = mx;
    }
  }
}

// May the step stop after its prefix reached `carry` with `left` bins
// after the last one walked?  (Every later admission is at most m.)
__device__ __forceinline__ bool done(long long carry, long long left,
                                     int m) {
  return carry >= m && (left <= 0 || carry + left * (long long)m
                                         < (1LL << 31));
}

// Move (w, bits) past n candidates of the words mask[0, words).
__device__ __forceinline__ void skip(const unsigned* mask, int words, int& w,
                                     unsigned& bits, int n) {
  while (n > 0 && w < words) {
    const int cnt = __popc(bits);
    if (cnt <= n) {
      n -= cnt;
      bits = ++w < words ? mask[w] : 0u;
    } else {
      for (; n > 0; --n) bits &= bits - 1;
    }
  }
}

// The next candidate after (w, bits), or -1; (w, bits) moves past it.
__device__ __forceinline__ int take(const unsigned* mask, int words, int& w,
                                   unsigned& bits) {
  while (bits == 0u && w < words) bits = ++w < words ? mask[w] : 0u;
  if (w >= words) return -1;
  const int c = w * 32 + __ffs(bits) - 1;
  bits &= bits - 1;
  return c;
}

// What the block's prologue made: the held columns and the class table.
struct Shared {
  const int* hcol;
  const int* hidx;
  const int* cls_m;
  const int* cls_real;
  const int* cls_rq;
  const unsigned* cls_mag;
  int* w_rq;          // this warp's step rows when the table is not staged
  unsigned* w_mag;
  unsigned* mask;     // a block a lane: the step's candidate words
  long long (*wt)[kWarps];
  unsigned* s_part;
};

// The lanes of this block (a block a lane) or this warp (a warp a lane),
// with the step's held columns as Cols<NH>, a block a lane taking KB
// chunks a warp.
template <int NH, int KB>
__device__ void run_lanes(const K8Args& a, const Layout& lay,
                          const Shared& sh, long long* clocks_,
                          long long* counts_, long long& then_) {
  (void)clocks_;
  (void)counts_;
  (void)then_;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, warps = T >> 5;
  const int C = a.C, R = a.R, nb = a.nb, per_bin = a.per_bin;
  const int held = lay.held, nch = lay.nch, words = lay.words;
  const int slot = a.block ? 0 : warp;
  const int gthreads = a.block ? T : 32;     // the lane's threads
  const int gt = a.block ? tid : lane;       // this thread among them
  const int gw = a.block ? warp : 0, gws = a.block ? warps : 1;
  int* lane_base = const_cast<int*>(sh.hcol) + lay.lane0 +
                   (size_t)slot * lay.lane_words;
  Lane ln;
  ln.cap_u = lane_base;
  {
    float* w = lay.tier ? a.work + ((size_t)blockIdx.x * kWorkLanes + slot) *
                                       (size_t)slot_floats(nb, R, per_bin)
                        : nullptr;
    float* big = lay.tier == 0
                     ? reinterpret_cast<float*>(lane_base + held +
                                                (size_t)held * nch)
                     : w;
    ln.L = big;
    ln.rem = reinterpret_cast<int*>(big + (size_t)held * nb);
    ln.summ = lay.tier < 2 ? lane_base + held
                           : reinterpret_cast<int*>(
                                 w + (size_t)R * nb * (per_bin ? 2 : 1));
  }
  unsigned* mask = sh.mask;
  for (long long t = slot;; t += lay.lanes) {
    const long long s64 = blockIdx.x + (long long)gridDim.x * t;
    if (s64 >= a.S) break;
    const int s = (int)s64;
    // the lane's prologue: loads zero, remainders int(cap) (a warp a
    // chunk: per-bin, its summaries, the largest remainder, as it goes) or
    // the uniform capacities and summaries
    if (per_bin) {
      // two chunks a warp at once, their capacities' loads together
      constexpr int kN = Cols<NH>::kN;
      for (int c0 = gw; c0 < nch; c0 += 2 * gws) {
        for (int h0 = 0; h0 < held; h0 += kN) {
          int v[2][kN];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int b = (c0 + u * gws) * kChunk + lane;
#pragma unroll
            for (int i = 0; i < kN; ++i)
              v[u][i] = b < nb && h0 + i < held
                            ? (int)a.caps[(size_t)b * R + sh.hcol[h0 + i]]
                            : INT_MIN;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = c0 + u * gws, b = c * kChunk + lane;
            if (c >= nch) continue;
#pragma unroll
            for (int i = 0; i < kN; ++i) {
              const int h = h0 + i;
              if (h >= held) continue;
              if (b < nb) {
                ln.rem[(size_t)h * nb + b] = v[u][i];
                ln.L[(size_t)h * nb + b] = 0.0f;
              }
              const int mx = __reduce_max_sync(kFull, v[u][i]);
              if (lane == 0) ln.summ[(size_t)h * nch + c] = mx;
            }
          }
        }
      }
    } else {
      for (size_t e = gt; e < (size_t)held * nb; e += gthreads)
        ln.L[e] = 0.0f;
      for (int h = 0; h < held; ++h) {
        const int cap = (int)a.caps[(size_t)s * R + sh.hcol[h]];
        if (gt == 0) ln.cap_u[h] = cap;
        for (int c = gt; c < nch; c += gthreads)
          ln.summ[(size_t)h * nch + c] = cap;
      }
    }
    if (a.block) __syncthreads(); else __syncwarp();
    K8_MARK(4);
    int ord = 0;
    int parity = 0;
    for (int k = 0; k < C; ++k) {
      if ((k & 31) == 0)
        ord = k + lane < C ? a.order[(size_t)s * C + k + lane] : 0;
      const int oi = row_of(__shfl_sync(kFull, ord, k & 31), C);
      Cols<NH> kc;
      bool real;
      if (lay.staged) {
        kc.m = sh.cls_m[oi];
        real = sh.cls_real[oi] != 0;
        kc.set(sh.cls_rq + (size_t)oi * held, sh.cls_mag + (size_t)oi * held,
               ln.cap_u, held);
      } else {
        kc.m = a.counts[oi];
        bool pos = false;
        for (int r = lane; r < R; r += 32)
          pos |= a.reqs[(size_t)oi * R + r] > 0.0f;
        real = __any_sync(kFull, pos);
        for (int h = lane; h < held; h += 32) {
          const int rq = (int)a.reqs[(size_t)oi * R + sh.hcol[h]];
          sh.w_rq[h] = rq;
          sh.w_mag[h] = rq > 0 ? magic(rq) : 0u;
        }
        __syncwarp();
        kc.set(sh.w_rq, sh.w_mag, ln.cap_u, held);
      }
      const int m = kc.m;
      if (!real || m <= 0) {
        if (gt == 0) a.placed[(size_t)s * C + k] = real ? 0 : m;
        K8_MARK(0);
        continue;
      }
      K8_MARK(0);
      K8_COUNT(0, 1);
      const bool narrow = m < (1 << 26);
      unsigned nsum = 0u;
      long long carry = 0;
      if (!a.block) {
        // a warp a lane: up to kBatchWarp candidate chunks at once, in
        // bin order, the summary test a word of 32 chunks at a time as the
        // walk reaches it (a fill changes only its own chunk's summary)
        int w = 0;
        unsigned bits = __ballot_sync(
            kFull, lane < nch && chunk_admits(ln, kc, nch, lane));
        for (;;) {
          int cs[kBatchWarp];
#pragma unroll
          for (int j = 0; j < kBatchWarp; ++j) {
            while (bits == 0u && w + 1 < words) {
              ++w;
              const int c0 = w * 32 + lane;
              bits = __ballot_sync(
                  kFull, c0 < nch && chunk_admits(ln, kc, nch, c0));
            }
            cs[j] = -1;
            if (bits) {
              cs[j] = w * 32 + __ffs(bits) - 1;
              bits &= bits - 1;
            }
          }
          K8_MARK(1);
          if (cs[0] < 0) break;
          long long v[kBatchWarp];
          int av[kBatchWarp];
          int anyv = 0, last = cs[0];
#pragma unroll
          for (int j = 0; j < kBatchWarp; ++j) {
            av[j] = cs[j] >= 0
                        ? admission(ln, kc, per_bin, nb, cs[j] * kChunk + lane)
                        : 0;
            v[j] = av[j];
            anyv |= av[j];
            last = cs[j] >= 0 ? cs[j] : last;
          }
          K8_MARK(1);
          const long long left =
              (long long)nb - (long long)(last + 1) * kChunk;
#ifdef K8_PHASE_CLOCKS
#pragma unroll
          for (int j = 0; j < kBatchWarp; ++j) {
            const bool adm = __any_sync(kFull, av[j] != 0);
            K8_COUNT(1, cs[j] >= 0);
            K8_COUNT(2, adm);
          }
#endif
          if (!__any_sync(kFull, anyv != 0)) {
            if (done(carry, left, m)) break;
            continue;            // nothing admitted: the prefix stays
          }
          warp_scans(v, narrow, lane);
          K8_MARK(2);
          long long base = carry;
#pragma unroll
          for (int j = 0; j < kBatchWarp; ++j) {
            const long long c64 = base + v[j] - av[j];
            const int n = clip(
                wrap_sub(m, (int)(unsigned)(unsigned long long)c64), 0,
                av[j]);
#ifdef K8_PHASE_CLOCKS
            const bool filled = __any_sync(kFull, n != 0);
            K8_COUNT(3, filled);
#endif
            if (cs[j] >= 0)
              fill(ln, kc, per_bin, nb, nch, cs[j], cs[j] * kChunk + lane,
                   n, lane);
            nsum += (unsigned)n;
            base += __shfl_sync(kFull, v[j], 31);
          }
          carry = base;
          K8_MARK(3);
          if (done(carry, left, m)) break;
        }
        nsum = __reduce_add_sync(kFull, nsum);
        if (lane == 0) a.placed[(size_t)s * C + k] = (int)nsum;
      } else {
        // a block a lane: every warp tests words of chunks; then the
        // candidates go warps x KB at a time in bin order,
        // KB consecutive ones to a warp
        bool some = false;
        for (int wd = warp; wd < words; wd += warps) {
          const int c0 = wd * 32 + lane;
          const unsigned bits = __ballot_sync(
              kFull, c0 < nch && chunk_admits(ln, kc, nch, c0));
          if (lane == 0) mask[wd] = bits;
          some |= bits != 0u;
        }
        // a step no chunk can admit places nothing and ends at this
        // barrier: no fill changed a summary and no thread reads the
        // candidate words after it, so the next step's test may begin
        if (!__syncthreads_or(some)) {
          if (tid == 0) a.placed[(size_t)s * C + k] = 0;
          K8_MARK(1);
          continue;
        }
        K8_MARK(1);
        int cw = 0;
        unsigned cb = mask[0];
        for (;;) {
          int w = cw;
          unsigned bits = cb;
          skip(mask, words, w, bits, warp * KB);
          int cs[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j)
            cs[j] = take(mask, words, w, bits);
          const int first = take(mask, words, cw, cb);
          if (first < 0) break;
          skip(mask, words, cw, cb, warps * KB - 1);
          long long v[KB];
          int av[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            av[j] = cs[j] >= 0
                        ? admission(ln, kc, per_bin, nb, cs[j] * kChunk + lane)
                        : 0;
            v[j] = av[j];
          }
#ifdef K8_PHASE_CLOCKS
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const bool adm = __any_sync(kFull, av[j] != 0);
            K8_COUNT(1, cs[j] >= 0);
            K8_COUNT(2, adm);
          }
#endif
          K8_MARK(1);
          warp_scans(v, narrow, lane);
          long long tot[KB], mine = 0;
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            tot[j] = __shfl_sync(kFull, v[j], 31);
            mine += tot[j];
          }
          if (lane == 0) sh.wt[parity][warp] = mine;
          __syncthreads();
          long long before = 0, all = 0;
          for (int i = 0; i < warps; ++i) {
            const long long x = sh.wt[parity][i];
            before += i < warp ? x : 0;
            all += x;
          }
          parity ^= 1;
          K8_MARK(2);
          long long base = carry + before;
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const long long c64 = base + v[j] - av[j];
            const int n = clip(
                wrap_sub(m, (int)(unsigned)(unsigned long long)c64), 0,
                av[j]);
#ifdef K8_PHASE_CLOCKS
            const bool filled = __any_sync(kFull, n != 0);
            K8_COUNT(3, filled);
#endif
            if (cs[j] >= 0)
              fill(ln, kc, per_bin, nb, nch, cs[j], cs[j] * kChunk + lane,
                   n, lane);
            nsum += (unsigned)n;
            base += tot[j];
          }
          carry += all;
          K8_MARK(3);
          // bins from the cursor's word on (at least those after the
          // batch's last candidate)
          const long long left =
              cw < words ? (long long)nb - (long long)cw * 32 * kChunk : 0;
          if (done(carry, left, m)) break;
        }
        // placed: `carry`, the walk's 64-bit prefix, is the same in every
        // thread.  Where it stayed below 2^31 no bin's int32 prefix c
        // wrapped, so the n = clip(m - c, 0, a) of the bins in bin order
        // telescope to min(carry, m) (skipped chunks add a = 0); else the
        // warps' sums.  Either way one barrier: the next step's summary
        // test reads the summaries this step's fills wrote.
        if (carry < (1LL << 31)) {
          if (tid == 0)
            a.placed[(size_t)s * C + k] = (int)min(carry, (long long)m);
          __syncthreads();
        } else {
          nsum = __reduce_add_sync(kFull, nsum);
          if (lane == 0) sh.s_part[warp] = nsum;
          __syncthreads();
          if (tid == 0) {
            unsigned sum = 0u;
            for (int i = 0; i < warps; ++i) sum += sh.s_part[i];
            a.placed[(size_t)s * C + k] = (int)sum;
          }
        }
        K8_MARK(3);
      }
    }
    // the lane's results
    int mine = 0;
    for (int b = gt; b < nb; b += gthreads) {
      bool any = false;
      for (int h = 0; h < held; ++h) any |= ln.L[(size_t)h * nb + b] > 0.0f;
      if (a.loads_out)
        for (int r = 0; r < R; ++r) {
          const int h = sh.hidx[r];
          a.loads_out[((size_t)s * nb + b) * R + r] =
              h >= 0 ? ln.L[(size_t)h * nb + b] : 0.0f;
        }
      if (a.touched) a.touched[b] = any;
      mine += any;
    }
    mine = (int)__reduce_add_sync(kFull, (unsigned)mine);
    if (a.block) {
      if (lane == 0) sh.s_part[warp] = (unsigned)mine;
      __syncthreads();
      if (tid == 0) {
        unsigned sum = 0u;
        for (int i = 0; i < warps; ++i) sum += sh.s_part[i];
        a.used[s] = (int)sum;
      }
      __syncthreads();  // the next lane zeroes the loads
    } else {
      if (lane == 0) a.used[s] = mine;
      __syncwarp();
    }
    K8_MARK(4);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
k8_binpack_counts(K8Args a) {
  extern __shared__ int dyn[];
  __shared__ long long wt[2][kWarps];  // block mode: a batch's totals
  __shared__ unsigned s_part[kWarps];  // block mode: warps' sums
  __shared__ int s_held;
  K8_CLOCKS_START
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, warps = T >> 5;
  const int C = a.C, R = a.R;
  int* hcol = dyn;          // [R] the held columns, in order
  int* hidx = dyn + R;      // [R] a column's place among them, or -1
  // the map: the columns some class requests (int(req) != 0)
  for (int r = warp; r < R; r += warps) {
    bool any = false;
    for (int c = lane; c < C && !any; c += 32)
      any = (int)a.reqs[(size_t)c * R + r] != 0;
    any = __any_sync(kFull, any);
    if (lane == 0) hidx[r] = any;
  }
  __syncthreads();
  if (tid == 0) {
    int held = 0;
    for (int r = 0; r < R; ++r) {
      const bool on = hidx[r] != 0;
      hidx[r] = on ? held : -1;
      if (on) hcol[held++] = r;
    }
    s_held = held;
  }
  __syncthreads();
  const int held = s_held;
  const Layout lay = make_layout(a.nb, R, C, held, a.per_bin, a.block, T);
  int* cls_m = dyn + lay.table;           // [C]
  int* cls_real = cls_m + C;              // [C]
  int* cls_rq = cls_real + C;             // [C][held]
  unsigned* cls_mag = reinterpret_cast<unsigned*>(cls_rq) + (size_t)C * held;
  if (lay.staged) {
    for (int c = tid; c < C; c += T) {
      bool real = false;
      for (int r = 0; r < R; ++r) real |= a.reqs[(size_t)c * R + r] > 0.0f;
      cls_m[c] = a.counts[c];
      cls_real[c] = real;
    }
    for (int e = tid; e < C * held; e += T) {
      const int c = e / held, h = e - c * held;
      const int rq = (int)a.reqs[(size_t)c * R + hcol[h]];
      cls_rq[e] = rq;
      cls_mag[e] = rq > 0 ? magic(rq) : 0u;
    }
  }
  if (blockIdx.x == 0 && tid == 0 && a.path_out) {
    a.path_out[0] = a.block | lay.tier << 1 | lay.staged << 3;
    a.path_out[1] = lay.lanes;
    a.path_out[2] = held;
  }
  __syncthreads();
  if ((a.block ? 0 : warp) < lay.lanes) {
    Shared sh;
    sh.hcol = hcol;
    sh.hidx = hidx;
    sh.cls_m = cls_m;
    sh.cls_real = cls_real;
    sh.cls_rq = cls_rq;
    sh.cls_mag = cls_mag;
    sh.w_rq = dyn + lay.warp0 + (size_t)warp * 2 * held;
    sh.w_mag = reinterpret_cast<unsigned*>(sh.w_rq + held);
    sh.mask = reinterpret_cast<unsigned*>(dyn + lay.mask);
    sh.wt = wt;
    sh.s_part = s_part;
#ifdef K8_PHASE_CLOCKS
    long long* clk = clocks_;
    long long* cnt = counts_;
#else
    long long* clk = nullptr;
    long long* cnt = nullptr;
    long long then_ = 0;
#endif
    if (a.block && lay.tier > 0) {      // loads in the workspace
      switch (held) {
        case 1: run_lanes<1, kBatchWork>(a, lay, sh, clk, cnt, then_); break;
        case 2: run_lanes<2, kBatchWork>(a, lay, sh, clk, cnt, then_); break;
        case 3: run_lanes<3, kBatchWork>(a, lay, sh, clk, cnt, then_); break;
        case 4: run_lanes<4, kBatchWork>(a, lay, sh, clk, cnt, then_); break;
        default: run_lanes<0, kBatchWork>(a, lay, sh, clk, cnt, then_);
      }
    } else {
      switch (held) {
        case 1: run_lanes<1, kBatchBlock>(a, lay, sh, clk, cnt, then_); break;
        case 2: run_lanes<2, kBatchBlock>(a, lay, sh, clk, cnt, then_); break;
        case 3: run_lanes<3, kBatchBlock>(a, lay, sh, clk, cnt, then_); break;
        case 4: run_lanes<4, kBatchBlock>(a, lay, sh, clk, cnt, then_); break;
        default: run_lanes<0, kBatchBlock>(a, lay, sh, clk, cnt, then_);
      }
    }
  }
  K8_CLOCKS_END
}

cudaError_t smem_limit_set() {
  static std::mutex mu;
  static std::set<int> done;   // devices
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  if (done.count(dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(k8_binpack_counts,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess) done.insert(dev);
  return err;
}

}  // namespace

#ifdef K8_PHASE_CLOCKS
extern "C" const char* binpack_counts_phase_names() {
  return "step prologue,walk or summary test,scan,fill,"
         "lane prologue and epilogue";
}
extern "C" int binpack_counts_phase_reset() {
  const unsigned long long zero[kPhases + kCounts] = {};
  const cudaError_t err =
      cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(g_phase_clocks));
  return (int)(err != cudaSuccess
                   ? err
                   : cudaMemcpyToSymbol(g_counts, zero, sizeof(g_counts)));
}
extern "C" int binpack_counts_phase_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                   sizeof(unsigned long long) * kPhases);
}
// thread 0's steps walked, candidate chunks, chunks where some bin
// admits and chunks filled since the last reset (warp 0's lanes alone
// with a warp a lane; warp 0's chunks alone with a block a lane)
extern "C" int binpack_counts_phase_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_counts,
                                   sizeof(unsigned long long) * kCounts);
}
#endif

// One call: reqs f32[C, R], counts i32[C], caps f32[S, R] (uniform) or
// f32[nb, R] (per_bin, S 1), order i32[S, C]; the launch shape (block:
// a block a lane, else a warp a lane; grid blocks of kThreads) and
// work, grid x 2 slots of R nb (2 R nb per-bin) + R ceil(nb / 32) floats
// where some held count would not fit shared memory
// (kernels.binpack_counts_paths says), else null; outputs used i32[S],
// placed i32[S, C], loads_out f32[S, nb, R] or null, touched bool[nb] or
// null, path_out i32[3] (the path bits: block, tier x 2, staged x 8;
// lanes a block; held columns) or null.  All device pointers, rows
// contiguous.  One kernel launch and no other stream operation (the
// function's shared-memory limit is set once a device).  Returns a
// cudaError_t code.
extern "C" int binpack_counts_launch(const float* reqs, const int* counts,
                                     int C, int R, const float* caps,
                                     int per_bin, int nb, const int* order,
                                     int S, int block, int grid,
                                     float* work, int* used,
                                     int* placed, float* loads_out,
                                     uint8_t* touched, int* path_out,
                                     cudaStream_t stream) {
  if (C <= 0 || R <= 0 || nb <= 0 || S <= 0 || (per_bin && S != 1) ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = smem_limit_set();
  if (err != cudaSuccess) return (int)err;
  K8Args a{reqs, counts, caps, order, work, used, placed, loads_out,
           touched, path_out, C, R, nb, S, per_bin, block};
  k8_binpack_counts<<<grid, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}
