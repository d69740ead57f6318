// K13: the sequential engine's whole scan over one batch, for Hopper
// (sm_90a), in one launch.
//
// Replaces the JAX package's models/batched.py schedule_impl (:581): its
// lax.scan (:976) of the step (:704), with _dynamic_scores (:471), with or
// without in-batch pod affinity.  The plain twin is the port's eager step
// loop (models/batched.py scan_plain), which the kernel equals bit for
// bit.  The static pass (K11's mask, K12's state-independent total) and
// the caller's extra mask and score (folded in here, as the twin's
// static_pass folds them) are its input; for each pod b in batch
// order, against the state the earlier pods left:
//   fit      PodFitsResources on the carried requested, and with nominated
//            pods, pass one: the claims of those with priority >= the pod's
//            on their node (a per-node list made once a batch)
//   ports    no in-batch host port of an earlier pod on the node conflicts
//            with one of the pod's (the batch vocabulary's conflict matrix)
//   scores   Least/MostRequested, BalancedAllocation, RTC on the carried
//            nonzero requests, SelectorSpread on the snapshot's counts plus
//            the earlier pods that match all the pod's selectors
//            (spread_match), summed onto the static total in the twin's
//            order (models/batched.py scan_plain, rounded with _rn)
//   sample   with a limit, only the first `limit` feasible nodes from the
//            rotated start stay (limit_feasible)
//   select   K1's rule (select_row.cuh) with the counter last_index0 + b
//   top-k    with tk > 0, K3's winner-pinned ranking of the same row
//   commit   requested, nonzero and the used ports of the chosen node.
// With in-batch pod affinity (the affinity mode, node_pair non-null) the
// scan carries each pod's pair state, the pods' own pairs or'ed (summed for
// the preferred weights) with those the earlier commits added (the
// reference's pair reads :748, :776 and commit :874-916), in the u_* rows:
//   affinity MatchInterPodAffinity against the pod's rows, gathered over
//            the node's pairs (pair_gather.cuh): no forbidden pair, no pair
//            of a valid anti term, and each valid affinity term in one of
//            its pairs or bootstrapped (no pair matches it anywhere, the
//            pod matches it itself, the node has its key)
//   IPA      w_ipa times ipa_normalize of the raw sums (the preferred
//            weights over the node's pairs), min and max over the valid
//            nodes, added last
//   pairs    after the pick, for every later pod: the pair of the chosen
//            node under each term's key where the committed pod matches
//            the later pod's affinity or anti term, its anti terms forbid
//            a later pod it matches, and the preferred weights: the hard
//            affinity weight, the later pod's preferred terms it matches,
//            its own preferred terms the later pod matches (integers:
//            exact in any order).
// The in-batch spread counts are the reference's spread_extra row of the
// pod (:865-868), rebuilt at each step from the earlier pods' hosts: b
// atomic adds of integers (exact in any order) instead of a [B, N] carry.
//
// Bound: barriers.  The bytes are few (the static rows, 5 bytes a (pod,
// node), read once; the node state stays in L1/L2), but step b + 1 reads
// what step b committed, so the B steps run one after another, each a
// chain of block-wide reductions (the spread maxima, the row's max, its
// ties' prefix, the pick, K - 1 top-k passes, the sample's prefix), each
// ending in __syncthreads.  A plain design: one block of 1,024 threads,
// each owning a contiguous run of nodes (so that node order is thread
// order for the tie prefix), the per-step rows in a global workspace.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "pair_gather.cuh"
#include "priority_math.cuh"
#include "select_row.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;      // ipa_normalize's masked extremes
constexpr int kSmemMax = 96 * 1024;  // the request row and zone sums above
                                     // this: zone sums in the workspace

// Do the zone sums live in shared memory (behind the request row)?
__host__ __device__ inline bool zs_in_smem(int r, int tp) {
  return ((long long)r + tp) * 4 <= kSmemMax;
}

using select_row::kNeg;
using select_row::nan_max;

}  // namespace

// The arguments of one launch, passed by value (ctypes.Structure
// SeqScanArgs in kernels/__init__.py mirrors it field for field).
struct SeqScanArgs {
  // the snapshot
  const float* allocatable;     // [N, R]
  const float* requested;       // [N, R] before the batch
  const float* nonzero;         // [N, 2]
  const float* group_counts;    // [N, G]
  const uint8_t* topo;          // [N, TP]
  const int* pair_key;          // [TP]
  // the batch
  const float* req;             // [B, R]
  const float* pod_nonzero;     // [B, 2]
  const int* priority;          // [B]
  const int* group_ids;         // [B, GP]
  const uint8_t* group_valid;   // [B, GP]
  const float* spread_counts;   // [B, N], or null (spread-lean batch)
  const float* spread_match;    // [B, B] [i, j]: j raises i's counts
  const uint8_t* pod_ports;     // [B, PV]
  const uint8_t* conflict;      // [PV, PV]
  const uint8_t* static_mask;   // [B, N]
  const float* static_score;    // [B, N]
  const uint8_t* extra_mask;    // [B, N] folded into the static mask, or null
  const float* extra_score;     // [B, N] added to the static score, or null
  // nominated pods, or null
  const int* nom_prio;          // [K]
  const float* nom_req;         // [K, R]
  const int* nom_order;         // [K] claim indices in node order
  const int* nom_start;         // [N + 1] each node's first in nom_order
  // configuration
  const float* rtc_xs;          // [n_rtc] RequestedToCapacityRatio curve
  const float* rtc_ys;
  const int* feas_limit;        // [] or null: no sampling
  // outputs
  int* hosts;                   // [B], -1 unschedulable
  float* requested_out;         // [N, R]
  float* nonzero_out;           // [N, 2]
  int* top_nodes;               // [B, tk], or null (tk == 0)
  float* top_scores;            // [B, tk]
  int* top_feas;                // [B]
  uint8_t* work;                // seq_scan_workspace_bytes(n, pv, tp)
  // in-batch pod affinity, or null (node_pair null: no affinity mode)
  const int* node_pair;         // [N, KT] each node's pair a key slot
  const uint8_t* node_valid;    // [N]
  const int* aff_slot;          // [B, PT] each term's topology key slot
  const int* anti_slot;         // [B, AT]
  const int* pref_slot;         // [B, PP]
  const uint8_t* aff_valid;     // [B, PT]
  const uint8_t* aff_self;      // [B, PT]
  const uint8_t* anti_valid;    // [B, AT]
  const uint8_t* aff_match;     // [B, B, PT] [j, i, t]: j matches i's term t
  const uint8_t* anti_match;    // [B, B, AT]
  const uint8_t* anti_own;      // [B, AT, B] [j, t, i]: i matches j's term t
  const uint8_t* aff_own;       // [B, PT, B]
  const uint8_t* pref_match;    // [B, B, PP]
  const uint8_t* pref_own;      // [B, PP, B]
  const float* pref_weight;     // [B, PP] signed
  uint8_t* u_aff;               // [B, PT, TP] the pods' pairs, then the
  uint8_t* u_anti;              // [B, AT, TP]   scan's commits, in place
  uint8_t* u_forb;              // [B, TP]
  float* u_pref;                // [B, TP]
  uint8_t* any_aff;             // [B, PT] does any pair match the term
  float w_least, w_most, w_bal, w_spread, w_rtc, w_ipa, hard_w;
  int b, n, r, g, gp, pv, tp, tk, n_rtc, zone_key, last_index0, kt, pt, at,
      pp;
};

namespace {

struct Work {
  float* tot;        // [N] the step's total
  float* counts;     // [N] the step's spread counts
  float* zs;         // [TP] their zone sums
  float* raw;        // [N] the step's IPA raw sums (affinity mode)
  int* zone;         // [N] each node's zone pair, or -1
  int* hist;         // [N] sampled: masked nodes at each rotated position
  int* first;        // [N] the lowest such node
  int* pre;          // [N] exclusive prefix of hist
  int* qlist;        // [PV] ports an earlier claim must not hold
  uint8_t* msk;      // [N] the step's mask
  uint8_t* used;     // [N, PV] in-batch ports claimed on each node
};

__host__ __device__ inline uint8_t* take(uint8_t* base, size_t& off,
                                         size_t bytes) {
  uint8_t* p = base ? base + off : nullptr;
  off += (bytes + 15) & ~(size_t)15;
  return p;
}

// The workspace's arrays from its base (null: only the size); returns its
// bytes.
__host__ __device__ inline size_t carve(const SeqScanArgs* a, uint8_t* base,
                                        Work* w) {
  const size_t n = (size_t)a->n, tp = (size_t)a->tp, pv = (size_t)a->pv;
  size_t off = 0;
  uint8_t* tot = take(base, off, n * 4);
  uint8_t* counts = take(base, off, n * 4);
  uint8_t* zs = take(base, off, tp * 4);
  uint8_t* raw = take(base, off, n * 4);
  uint8_t* zone = take(base, off, n * 4);
  uint8_t* hist = take(base, off, n * 4);
  uint8_t* first = take(base, off, n * 4);
  uint8_t* pre = take(base, off, n * 4);
  uint8_t* qlist = take(base, off, pv * 4);
  uint8_t* msk = take(base, off, n);
  uint8_t* used = take(base, off, n * pv);
  if (w) {
    w->tot = (float*)tot;
    w->counts = (float*)counts;
    w->zs = (float*)zs;
    w->raw = (float*)raw;
    w->zone = (int*)zone;
    w->hist = (int*)hist;
    w->first = (int*)first;
    w->pre = (int*)pre;
    w->qlist = (int*)qlist;
    w->msk = msk;
    w->used = used;
  }
  return off;
}

struct Shared {
  float f[kWarps];
  float g[kWarps];
  int i[kWarps];
  long long l[kWarps];
  int nq, host;
};

// fmaxf over the block (every thread gets it); the spread maxima
__device__ float block_fmax(float v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.f[threadIdx.x >> 5] = v;
  __syncthreads();
  float x = sh.f[0];
  for (int k = 1; k < kWarps; ++k) x = fmaxf(x, sh.f[k]);
  return x;
}

// fminf of mn and fmaxf of mx over the block, in one exchange (every
// thread gets both); the IPA sums' extremes
__device__ void block_minmax(float& mn, float& mx, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    sh.f[threadIdx.x >> 5] = mn;
    sh.g[threadIdx.x >> 5] = mx;
  }
  __syncthreads();
  mn = sh.f[0];
  mx = sh.g[0];
  for (int k = 1; k < kWarps; ++k) {
    mn = fminf(mn, sh.f[k]);
    mx = fmaxf(mx, sh.g[k]);
  }
}

// MatchInterPodAffinity of pod b on node n against the carried pair rows
__device__ bool affinity_ok(const SeqScanArgs& a, int b, int n) {
  const int* np = a.node_pair + (size_t)n * a.kt;
  const size_t tp = (size_t)a.tp;
  if (pair_gather::any_hit(a.u_forb + (size_t)b * tp, np, a.kt)) return false;
  for (int t = 0; t < a.at; ++t) {
    const size_t i = (size_t)b * a.at + t;
    if (__ldg(a.anti_valid + i) &&
        pair_gather::any_hit(a.u_anti + i * tp, np, a.kt))
      return false;
  }
  for (int t = 0; t < a.pt; ++t) {
    const size_t i = (size_t)b * a.pt + t;
    if (!__ldg(a.aff_valid + i) ||
        pair_gather::any_hit(a.u_aff + i * tp, np, a.kt))
      continue;
    if (!a.any_aff[i] && __ldg(a.aff_self + i) &&
        pair_gather::pair_of(np, __ldg(a.aff_slot + i)) >= 0)
      continue;
    return false;
  }
  return true;
}

// The AddPod analogue of pod b committed on host h, for the later pod i:
// one pair a (term, key) at h's pair of the key
__device__ void commit_pairs(const SeqScanArgs& a, int b, int h, int i) {
  const int* nph = a.node_pair + (size_t)h * a.kt;
  const size_t B = (size_t)a.b, tp = (size_t)a.tp;
  for (int t = 0; t < a.pt; ++t)
    if (__ldg(a.aff_match + ((size_t)b * B + i) * a.pt + t)) {
      const int p =
          pair_gather::pair_at(nph, a.aff_slot, (size_t)i * a.pt + t);
      if (p >= 0) {
        a.u_aff[((size_t)i * a.pt + t) * tp + p] = 1;
        a.any_aff[(size_t)i * a.pt + t] = 1;
      }
    }
  for (int t = 0; t < a.at; ++t)
    if (__ldg(a.anti_match + ((size_t)b * B + i) * a.at + t)) {
      const int p =
          pair_gather::pair_at(nph, a.anti_slot, (size_t)i * a.at + t);
      if (p >= 0) a.u_anti[((size_t)i * a.at + t) * tp + p] = 1;
    }
  // b's anti terms forbid their domains to the later pods they match
  for (int t = 0; t < a.at; ++t)
    if (__ldg(a.anti_own + ((size_t)b * a.at + t) * B + i)) {
      const int p =
          pair_gather::pair_at(nph, a.anti_slot, (size_t)b * a.at + t);
      if (p >= 0) a.u_forb[(size_t)i * tp + p] = 1;
    }
  // the preferred weights, in the reference's order of terms: the hard
  // affinity weight of b's terms i matches, i's preferred terms b
  // matches, b's preferred terms i matches
  float* up = a.u_pref + (size_t)i * tp;
  for (int t = 0; t < a.pt; ++t)
    if (__ldg(a.aff_own + ((size_t)b * a.pt + t) * B + i)) {
      const int p =
          pair_gather::pair_at(nph, a.aff_slot, (size_t)b * a.pt + t);
      if (p >= 0) up[p] = __fadd_rn(up[p], a.hard_w);
    }
  for (int t = 0; t < a.pp; ++t)
    if (__ldg(a.pref_match + ((size_t)b * B + i) * a.pp + t)) {
      const int p =
          pair_gather::pair_at(nph, a.pref_slot, (size_t)i * a.pp + t);
      if (p >= 0)
        up[p] = __fadd_rn(up[p], __ldg(a.pref_weight + (size_t)i * a.pp + t));
    }
  for (int t = 0; t < a.pp; ++t)
    if (__ldg(a.pref_own + ((size_t)b * a.pp + t) * B + i)) {
      const int p =
          pair_gather::pair_at(nph, a.pref_slot, (size_t)b * a.pp + t);
      if (p >= 0)
        up[p] = __fadd_rn(up[p], __ldg(a.pref_weight + (size_t)b * a.pp + t));
    }
}

// the NaN-propagating max over the block; the row's best
__device__ float block_nan_max(float v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.f[threadIdx.x >> 5] = v;
  __syncthreads();
  float x = sh.f[0];
  for (int k = 1; k < kWarps; ++k) x = nan_max(x, sh.f[k]);
  return x;
}

__device__ long long block_max_ll(long long v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(kFull, v, o);
    v = u > v ? u : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.l[threadIdx.x >> 5] = v;
  __syncthreads();
  long long x = sh.l[0];
  for (int k = 1; k < kWarps; ++k) x = sh.l[k] > x ? sh.l[k] : x;
  return x;
}

// exclusive prefix of v over the threads in order; *total gets the sum
__device__ int block_excl_scan(int v, Shared& sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();
  if (lane == 31) sh.i[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int s = sh.i[k];
    before += k < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// (n - start) with int32 wrap, floor mod N: the sampling order's position
__device__ __forceinline__ int rotated(int n, int start, int N) {
  const int w = (int)(unsigned)((long long)n - (long long)start);
  const int r = w % N;
  return r < 0 ? r + N : r;
}

__global__ void __launch_bounds__(kThreads, 1) k13_seq_scan(
    const SeqScanArgs a) {
  extern __shared__ float rq[];   // [R] the step's request row, then
                                  // the zone sums when they fit
  __shared__ Shared sh;
  Work w;
  carve(&a, a.work, &w);
  const int N = a.n, R = a.r, PV = a.pv, tid = threadIdx.x;
  // zone sums take one atomic add a node onto a few slots: shared memory
  // serves those far faster than L2
  if (zs_in_smem(R, a.tp)) w.zs = rq + R;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int n0 = min(tid * chunk, N), n1 = min(n0 + chunk, N);
  const bool spread_on = a.w_spread != 0.f;
  const bool use_most = a.w_most != 0.f, use_rtc = a.w_rtc != 0.f;
  const bool limited = a.feas_limit != nullptr;
  const int lim = limited ? *a.feas_limit : 0;
  const bool aff = a.node_pair != nullptr;

  // the state the batch starts from (+ 0.0: the twin's first commit adds
  // 0.0 to every row, so a -0.0 reads 0.0 from then on)
  int hz = 0;
  for (int n = n0; n < n1; ++n) {
    for (int r = 0; r < R; ++r)
      a.requested_out[(size_t)n * R + r] =
          __fadd_rn(a.requested[(size_t)n * R + r], 0.f);
    for (int k = 0; k < 2; ++k)
      a.nonzero_out[2 * (size_t)n + k] = __fadd_rn(a.nonzero[2 * (size_t)n + k], 0.f);
    for (int p = 0; p < PV; ++p) w.used[(size_t)n * PV + p] = 0;
    const int z = prio_math::zone_of(a.topo + (size_t)n * a.tp, a.pair_key,
                                     a.tp, a.zone_key);
    w.zone[n] = z;
    hz |= z >= 0;
  }
  const bool have_zones = __syncthreads_or(hz) != 0;

  for (int b = 0; b < a.b; ++b) {
    const int li = (int)((unsigned)a.last_index0 + (unsigned)b);
    const int prio = __ldg(a.priority + b);
    const float pnz0 = __ldg(a.pod_nonzero + 2 * (size_t)b);
    const float pnz1 = __ldg(a.pod_nonzero + 2 * (size_t)b + 1);
    const uint8_t* pports = a.pod_ports + (size_t)b * PV;
    for (int r = tid; r < R; r += kThreads) rq[r] = __ldg(a.req + (size_t)b * R + r);
    int any_port = 0;
    for (int p = tid; p < PV; p += kThreads) any_port |= __ldg(pports + p);
    if (spread_on) {
      for (int n = n0; n < n1; ++n) {
        float c;
        if (a.spread_counts) {
          c = __ldg(a.spread_counts + (size_t)b * N + n);
        } else {
          c = 0.f;   // the pod's groups over the snapshot's columns
          for (int j = 0; j < a.gp; ++j) {
            const size_t k = (size_t)b * a.gp + j;
            const int g = __ldg(a.group_ids + k);
            if (__ldg(a.group_valid + k) && g >= 0 && g < a.g)
              c = __fadd_rn(c, __ldg(a.group_counts + (size_t)n * a.g + g));
          }
        }
        w.counts[n] = c;
      }
      for (int k = tid; k < a.tp; k += kThreads) w.zs[k] = 0.f;
    }
    if (tid == 0) {
      sh.nq = 0;
      sh.host = 0;
    }
    any_port = __syncthreads_or(any_port);
    // barrier 1 passed: the row, the base counts, zeroed zone sums
    if (any_port) {
      // q is forbidden on a node where an earlier pod holds it: it
      // conflicts with one of this pod's ports
      for (int q = tid; q < PV; q += kThreads) {
        bool c = false;
        for (int p = 0; p < PV && !c; ++p)
          c = __ldg(pports + p) && __ldg(a.conflict + (size_t)q * PV + p);
        if (c) w.qlist[atomicAdd(&sh.nq, 1)] = q;
      }
    }
    if (spread_on) {
      // the earlier pods that match all this pod's selectors
      for (int j = tid; j < b; j += kThreads) {
        const int h = a.hosts[j];
        if (h >= 0) {
          const float m = __ldg(a.spread_match + (size_t)b * a.b + j);
          if (m != 0.f) atomicAdd(w.counts + h, m);
        }
      }
    }
    __syncthreads();   // barrier 2: counts and qlist complete
    const int nq = sh.nq;
    float mx_node = 0.f, mx_zone = 0.f;
    if (spread_on) {
      float mx = -INFINITY;
      for (int n = n0; n < n1; ++n) {
        const float c = w.counts[n];
        mx = fmaxf(mx, c);
        const int z = w.zone[n];
        if (z >= 0) atomicAdd(w.zs + z, c);
      }
      mx_node = block_fmax(mx, sh);          // barriers 3, 4
      float mz = -INFINITY;
      if (have_zones)
        for (int k = tid; k < a.tp; k += kThreads) mz = fmaxf(mz, w.zs[k]);
      mx_zone = block_fmax(mz, sh);          // barriers 5, 6
    }
    float ipa_mn = 0.f, ipa_spr = 0.f;
    if (aff) {
      // the IPA raw sums and their extremes over the valid nodes
      const float* urow = a.u_pref + (size_t)b * a.tp;
      float mn = kBig, mx = -kBig;
      for (int n = n0; n < n1; ++n) {
        const float x =
            pair_gather::sum(urow, a.node_pair + (size_t)n * a.kt, a.kt);
        w.raw[n] = x;
        if (__ldg(a.node_valid + n)) {
          mn = fminf(mn, x);
          mx = fmaxf(mx, x);
        }
      }
      block_minmax(mn, mx, sh);              // 2 barriers
      ipa_mn = mn;
      ipa_spr = __fsub_rn(mx, mn);
    }

    // the step's mask and total, node by node
    for (int n = n0; n < n1; ++n) {
      const float* cur = a.requested_out + (size_t)n * R;
      const float* alloc = a.allocatable + (size_t)n * R;
      bool fit = true;
      for (int r = 0; r < R; ++r) {
        const float x = rq[r];
        if (x > 0.f && __fadd_rn(cur[r], x) > __ldg(alloc + r)) fit = false;
      }
      if (a.nom_start) {
        const int c0 = __ldg(a.nom_start + n), c1 = __ldg(a.nom_start + n + 1);
        if (c1 > c0) {
          // podFitsOnNode's pass one: the claims of nominated pods with
          // priority >= this pod's on the node
          for (int r = 0; r < R && fit; ++r) {
            const float x = rq[r];
            if (!(x > 0.f)) continue;
            float extra = 0.f;
            for (int c = c0; c < c1; ++c) {
              const int k = __ldg(a.nom_order + c);
              if (__ldg(a.nom_prio + k) >= prio)
                extra = __fadd_rn(extra, __ldg(a.nom_req + (size_t)k * R + r));
            }
            if (__fadd_rn(__fadd_rn(cur[r], extra), x) > __ldg(alloc + r))
              fit = false;
          }
        }
      }
      bool port_bad = false;
      for (int i = 0; i < nq && !port_bad; ++i)
        port_bad = w.used[(size_t)n * PV + w.qlist[i]] != 0;
      const size_t bn = (size_t)b * N + n;
      bool m = __ldg(a.static_mask + bn) &&
               (!a.extra_mask || __ldg(a.extra_mask + bn)) && fit &&
               !port_bad;
      if (aff && m) m = affinity_ok(a, b, n);
      const float cap[2] = {__ldg(alloc), __ldg(alloc + 1)};
      const float rq2[2] = {__fadd_rn(a.nonzero_out[2 * (size_t)n], pnz0),
                            __fadd_rn(a.nonzero_out[2 * (size_t)n + 1], pnz1)};
      float least, most;
      prio_math::least_most_sums(cap, rq2, least, most);
      float sp = 0.f;
      if (spread_on) {
        const int z = w.zone[n];
        sp = prio_math::spread(mx_node, w.counts[n], have_zones && z >= 0,
                               mx_zone, z >= 0 ? w.zs[z] : 0.f);
      }
      float total = __ldg(a.static_score + bn);
      if (a.extra_score) total = __fadd_rn(total, __ldg(a.extra_score + bn));
      total = __fadd_rn(total, __fmul_rn(a.w_least, prio_math::half_floor(least)));
      if (use_most)
        total = __fadd_rn(total, __fmul_rn(a.w_most, prio_math::half_floor(most)));
      total = __fadd_rn(total, __fmul_rn(a.w_bal, prio_math::balanced(cap, rq2)));
      total = __fadd_rn(total, __fmul_rn(a.w_spread, sp));
      if (use_rtc)
        total = __fadd_rn(total, __fmul_rn(
            a.w_rtc, prio_math::rtc(a.rtc_xs, a.rtc_ys, a.n_rtc, cap, rq2)));
      if (aff) {
        // ipa_normalize, then w_ipa times it, added last
        float ipa = 0.f;
        if (__ldg(a.node_valid + n) && ipa_spr > 0.f)
          ipa = floorf(__fdiv_rn(
              __fmul_rn(prio_math::kMaxPriority, __fsub_rn(w.raw[n], ipa_mn)),
              ipa_spr));
        total = __fadd_rn(total, __fmul_rn(a.w_ipa, ipa));
      }
      w.tot[n] = total;
      w.msk[n] = m;
      if (limited) {
        w.hist[n] = 0;
        w.first[n] = INT_MAX;
      }
    }
    __syncthreads();   // barrier 7

    if (limited) {
      // keep the first `lim` masked nodes in the rotated order from li:
      // a node's rank is the masked nodes at earlier positions, plus the
      // lower node at its own (the int32 wrap can put two nodes there)
      for (int n = n0; n < n1; ++n)
        if (w.msk[n]) {
          const int r = rotated(n, li, N);
          atomicAdd(w.hist + r, 1);
          atomicMin(w.first + r, n);
        }
      __syncthreads();                                   // S1
      int s = 0;
      for (int r = n0; r < n1; ++r) s += w.hist[r];
      int all;
      int run = block_excl_scan(s, sh, &all);            // S2, S3
      for (int r = n0; r < n1; ++r) {
        w.pre[r] = run;
        run += w.hist[r];
      }
      __syncthreads();                                   // S4
      for (int n = n0; n < n1; ++n)
        if (w.msk[n]) {
          const int r = rotated(n, li, N);
          const int rank = w.pre[r] + (w.hist[r] == 2 && w.first[r] != n);
          if (rank >= lim) w.msk[n] = 0;
        }
      __syncthreads();                                   // S5
    }

    // select: K1's rule over the row
    float bm = -INFINITY;
    int anyf = 0;
    for (int n = n0; n < n1; ++n) {
      const bool m = w.msk[n] != 0;
      bm = nan_max(bm, m ? w.tot[n] : kNeg);
      anyf |= m;
    }
    const float best = block_nan_max(bm, sh);            // barriers 8, 9
    int t = 0;
    for (int n = n0; n < n1; ++n) t += w.msk[n] && w.tot[n] == best;
    int ties;
    const int before = block_excl_scan(t, sh, &ties);    // barriers 10, 11
    if (ties > 0) {
      const int k = select_row::floor_mod(li, ties);
      if (k >= before && k < before + t) {
        int seen = before;
        for (int n = n0; n < n1; ++n)
          if (w.msk[n] && w.tot[n] == best) {
            if (seen == k) {
              sh.host = n;
              break;
            }
            ++seen;
          }
      }
    }
    const bool feasible = __syncthreads_or(anyf) != 0;   // barrier 12
    const int host = sh.host;

    if (a.tk > 0) {
      // K3's winner-pinned top-k of the same row
      int cnt = 0;
      for (int n = n0; n < n1; ++n) cnt += w.msk[n];
      int count;
      block_excl_scan(cnt, sh, &count);
      const float half = kNeg * 0.5f;
      int* nodes_out = a.top_nodes + (size_t)b * a.tk;
      float* scores_out = a.top_scores + (size_t)b * a.tk;
      if (tid == 0) {
        a.top_feas[b] = count;
        const float wv = feasible ? (w.msk[host] ? w.tot[host] : kNeg) : kNeg;
        const bool ok = wv > half;
        nodes_out[0] = ok ? (feasible ? host : -1) : -1;
        scores_out[0] = ok ? wv : 0.0f;
      }
      long long prev = LLONG_MAX;
      for (int j = 1; j < a.tk; ++j) {
        long long bp = LLONG_MIN;
        for (int n = n0; n < n1; ++n) {
          const float v = (feasible && n == host) ? kNeg
                                                  : (w.msk[n] ? w.tot[n] : kNeg);
          const long long p = select_row::pack(select_row::order_key(v), n);
          if (p < prev && p > bp) bp = p;
        }
        const long long pick = block_max_ll(bp, sh);
        if (tid == 0) {
          const float v = select_row::key_value((int)(pick >> 31));
          const bool ok = v > half;
          nodes_out[j] = ok ? select_row::unpack_node(pick) : -1;
          scores_out[j] = ok ? v : 0.0f;
        }
        prev = pick;
      }
    }

    // commit
    if (feasible) {
      for (int r = tid; r < R; r += kThreads) {
        float* x = a.requested_out + (size_t)host * R + r;
        *x = __fadd_rn(*x, rq[r]);
      }
      if (tid < 2) {
        float* x = a.nonzero_out + 2 * (size_t)host + tid;
        *x = __fadd_rn(*x, tid == 0 ? pnz0 : pnz1);
      }
      for (int p = tid; p < PV; p += kThreads)
        if (__ldg(pports + p)) w.used[(size_t)host * PV + p] = 1;
      if (aff)   // one later pod a thread: its rows are its own
        for (int i = b + 1 + tid; i < a.b; i += kThreads)
          commit_pairs(a, b, host, i);
    }
    if (tid == 0) a.hosts[b] = feasible ? host : -1;
    __syncthreads();   // barrier 13: the commit before the next step
  }
}

}  // namespace

// The bytes of the workspace one launch needs.
extern "C" long long seq_scan_workspace_bytes(int n, int pv, int tp) {
  SeqScanArgs a{};
  a.n = n;
  a.pv = pv;
  a.tp = tp;
  return (long long)carve(&a, nullptr, nullptr);
}

// The block's threads (the wrapper's barrier count uses them).
extern "C" int seq_scan_threads() { return kThreads; }

// The scan over a.b pods on `stream`: one kernel launch of one block, and
// no other stream operation.  Returns a cudaError_t code.
extern "C" int seq_scan_launch(SeqScanArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.r < 2 || a.pv <= 0 || a.tp <= 0 ||
      a.tk < 0 || a.tk > a.n || (a.tk > 0 && !a.top_nodes) || !a.work)
    return (int)cudaErrorInvalidValue;
  if (a.node_pair && (a.kt < 0 || a.pt < 0 || a.at < 0 || a.pp < 0 ||
                      !a.node_valid || !a.u_forb || !a.u_pref))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)a.r + (zs_in_smem(a.r, a.tp) ? a.tp : 0)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k13_seq_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k13_seq_scan<<<1, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
