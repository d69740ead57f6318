// K13: the sequential engine's whole scan over one batch, for Hopper
// (sm_90a), in one launch of one thread-block cluster.
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
// pod (:865-868): each block keeps the list of the earlier pods placed on
// its nodes and adds their spread_match entries (integers: exact in any
// order) into the next step's counts while the select's partials travel.
//
// Bound: dependent stages.  The bytes are few (the static rows, 5 bytes a
// (pod, node), read once), but step b + 1 reads what step b committed, so
// the B steps run one after another, each a chain of reductions over the
// nodes.  The design:
//   * one cluster of C = 16 blocks (non-portable: the launch fails where
//     the card cannot place it), block r owning the contiguous nodes
//     [r * chunk, (r + 1) * chunk); lane l of warp w takes node
//     base + 32 * (w + k * warps) + l, so a warp's row reads coalesce and
//     node order is (word, bit) order of a warp ballot;
//   * the carried node state (allocatable, requested, nonzero, the used
//     ports, each node's zone) and the step's rows (totals, mask, spread
//     counts, tie and sample words) stay in the block's shared memory for
//     the whole batch, and requested / nonzero are written back at the
//     end.  Where they do not fit (a large N x R) the same kernel keeps
//     them in the global workspace, a block's slice each;
//   * a step has one cluster-wide stage for each dependent stage of the
//     function: the spread maxima (the node max and the zone sums), with
//     affinity the IPA sums' extremes, with a limit the sample's rotated
//     prefix (each block's masked count and its counts below the
//     rotation's three break points), and the select (each block's best,
//     ties at it, feasible count and top-k list).  Each block pushes its
//     partial into every block's inbox; then every block reads them all
//     from its own shared memory.  The select's partials name the block
//     that holds the (li mod ties)-th tie; only that block finds the host
//     in its tie words and commits (with affinity every block needs the
//     host, and the tie words travel too);
//   * the pushes are st.async stores counted on the receiver's mbarrier,
//     and a stage waits for its bytes alone.  A cluster barrier would
//     fence all memory GPU-wide at its arrive and invalidate L1 at its
//     wait.  It stays where global memory must be ordered: the affinity
//     mode's first stage (the pair commits' writes before the rows are
//     read), the sample (its rank reads another block's prefix), and the
//     state in the global workspace;
//   * a pipeline a step deep: pod b + 1's static rows (and the lean spread
//     groups' counts), request, ports, nonzero request and priority are
//     loaded at the start of step b and used a step later;
//   * with affinity the later pods' pair commits spread over all the
//     cluster's threads, pod i on thread i mod (C x threads).
// Every partial is double-buffered by step parity, so a block may run one
// stage ahead of a slower reader.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "pair_gather.cuh"
#include "priority_math.cuh"
#include "select_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 384;    // 168 registers a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;      // ipa_normalize's masked extremes
constexpr int kZoneSlots = 64;       // zone sums in the partials up to this
constexpr int kTopSlots = 8;         // top-k lists in shared memory up to this
constexpr int kWordSlots = 32;       // tie words a block pushes (affinity)
constexpr int kGroupRegs = 2;        // a lean pod's groups loaded ahead
// the blocks of the cluster: 16; tools/k13_compare.py builds an 8-block
// variant (-DK13_CLUSTER=8) to time beside it
#ifndef K13_CLUSTER
#define K13_CLUSTER 16
#endif
constexpr int kCluster = K13_CLUSTER;
static_assert(kCluster == 8 || kCluster == 16, "K13_CLUSTER: 8 or 16");
constexpr int kMaxKT = 4;            // node-pair slots a node keeps at hand
// dynamic shared memory a block may take (the card's 227 KB less the
// static inboxes and slots, with room to spare)
constexpr long long kSmemBudget = 192 * 1024;

using select_row::kNeg;
using select_row::nan_max;

// With -DK13_PHASE_CLOCKS each block's thread 0 sums the SM clock spent
// between the step's phase marks (K13_MARK) over the batch, read back with
// seq_scan_phase_clocks (tools/k13_compare.py --phases).  Off by default:
// the marks compile to nothing.
#ifdef K13_PHASE_CLOCKS
constexpr int kPhases = 14;
__device__ long long g_phase_clocks[kCluster][kPhases];
#define K13_MARK(i)                                            \
  if (tid == 0) {                                              \
    long long now_;                                            \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(now_) :: "memory"); \
    clocks_[i] += now_ - then_;                                \
    then_ = now_;                                              \
  }
#else
#define K13_MARK(i)
#endif

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
  uint8_t* work;                // seq_scan_workspace_size(args)
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

// Where a launch keeps what: the cluster's shape, and the byte offsets of
// each array in the node storage (a block's dynamic shared memory, or its
// slice of the workspace when the carried state does not fit), the block
// arrays (always shared memory) and the workspace.  Made on the host.
struct Layout {
  int c, t, warps;           // blocks, threads a block, warps a block
  int chunk, k, w, pvw;      // nodes a block, slots a thread, mask words,
                             // port words
  int node_smem, list_smem;  // node storage / placed list in shared memory
  // node storage: the state (shared memory only; else the outputs and
  // the snapshot's rows themselves), then the step's rows
  long long o_alloc, o_req, o_nz, o_used, o_cz, o_t1, o_aux, o_cnt, o_inc,
      o_raw, o_pre, o_wd, o_wp, o_tw, o_mk, o_np, o_nv;
  // dynamic shared memory after the node storage (if there)
  long long o_rq, o_qm, o_pb, o_list, smem;
  // the workspace: c slices, then the zone and top-k exchanges
  long long o_slice_list, o_slice_wtop, o_slice_zg, slice, o_zx, o_tx, ws;
};

inline long long take(long long& off, long long bytes) {
  const long long o = off;
  off += (bytes + 15) & ~15LL;
  return o;
}

Layout make_layout(const SeqScanArgs& a) {
  const int c = kCluster;
  Layout L{};
  L.c = c;
  L.chunk = (a.n + c - 1) / c;
  const int t = (L.chunk + 31) / 32 * 32;
  L.t = t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
  L.warps = L.t / 32;
  L.k = (L.chunk + L.t - 1) / L.t;
  L.w = (L.chunk + 31) / 32;
  L.pvw = (a.pv + 31) / 32;
  const long long ch = L.chunk, R = a.r;
  // the step's rows, wherever the state lives
  long long rows = 0;
  L.o_used = take(rows, ch * L.pvw * 4);
  L.o_cz = take(rows, ch * 4);
  L.o_t1 = take(rows, ch * 4);
  L.o_aux = take(rows, ch * 4);
  L.o_cnt = take(rows, ch * 4);
  L.o_inc = take(rows, ch * 4);
  L.o_raw = take(rows, ch * 4);
  L.o_pre = take(rows, ch * 4);
  L.o_wd = take(rows, (long long)L.w * 4);
  L.o_wp = take(rows, (long long)L.w * 4);
  L.o_tw = take(rows, 2LL * L.w * 4);
  L.o_mk = take(rows, ch);
  L.o_np = take(rows, ch * kMaxKT * 4);
  L.o_nv = take(rows, ch);
  long long blk = 0;   // the block arrays
  const long long rq = take(blk, 2 * R * 4);
  const long long qm = take(blk, 2LL * L.pvw * 4);
  const long long pb = take(blk, 2LL * L.pvw * 4);
  long long state = 0;
  const long long o_alloc = take(state, ch * R * 4);
  const long long o_req = take(state, ch * R * 4);
  const long long o_nz = take(state, ch * 2 * 4);
  const long long list_bytes = (long long)a.b * 8;
  L.node_smem = state + rows + blk <= kSmemBudget;
  long long off = 0;
  if (L.node_smem) {
    L.o_alloc = o_alloc;
    L.o_req = o_req;
    L.o_nz = o_nz;
    off = state;
    const long long shift = off;   // the rows follow the state
    L.o_used += shift; L.o_cz += shift; L.o_t1 += shift; L.o_aux += shift;
    L.o_cnt += shift; L.o_inc += shift; L.o_raw += shift;
    L.o_pre += shift; L.o_wd += shift; L.o_wp += shift; L.o_tw += shift;
    L.o_mk += shift;
    L.o_np += shift; L.o_nv += shift;
    off += rows;
  }
  L.o_rq = off + rq;
  L.o_qm = off + qm;
  L.o_pb = off + pb;
  off += blk;
  L.list_smem = off + list_bytes <= kSmemBudget;
  if (L.list_smem) L.o_list = take(off, list_bytes);
  L.smem = off;
  // a block's workspace slice
  long long s = L.node_smem ? 0 : rows;
  L.o_slice_list = L.list_smem ? 0 : take(s, list_bytes);
  L.o_slice_wtop = a.tk > kTopSlots ? take(s, (long long)L.warps * a.tk * 8) : 0;
  L.o_slice_zg =
      a.tp > kZoneSlots ? take(s, (long long)L.warps * a.tp * 4) : 0;
  L.slice = (s + 255) & ~255LL;
  long long ws = L.slice * c;
  L.o_zx = a.tp > kZoneSlots ? take(ws, 2LL * c * a.tp * 4) : 0;
  L.o_tx = a.tk > kTopSlots ? take(ws, 2LL * c * a.tk * 8) : 0;
  L.ws = ws > 0 ? ws : 16;
  return L;
}

// One block's partial of a step.  Each block pushes it into slot [its
// rank] of every block's inbox before the stage's cluster barrier, so that
// after the barrier each block reads all partials from its own shared
// memory.
struct Part {
  float node_max;           // spread: the node max over its nodes
  float ipa_mn, ipa_mx;     // affinity: the IPA sums' extremes (valid nodes)
  float best;               // the row's best over its nodes
  int ties, feas;           // its nodes tied at best, its feasible nodes
  int l_total;              // sampling: its masked nodes before the cut
  int l_below[3];           //   of them below the rotation's break points
  float zsum[kZoneSlots];   // spread: its zone sums (zone-key pair order)
  long long top[kTopSlots]; // top-k: its best packs
  uint32_t words[kWordSlots];  // affinity: its tie words
};

struct Slots {
  float f[32], h[32];
  int i[32], j[32];
  float zg[32 * kZoneSlots];          // each warp's copy of the zone sums
  long long top[32 * kTopSlots];
};

// ---- the cluster

__device__ __forceinline__ int cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The exchange without cluster barriers: a stage's partials go out with
// st.async into the same place of every block's inbox, each store counted
// on that block's mbarrier for the stage, which completes when all its
// bytes have landed.  A cluster barrier's release is a GPU-wide fence
// (MEMBAR.ALL.GPU) and its acquire invalidates L1 (CCTL.IVALL); this waits
// for the data alone.
constexpr int kStA = 0, kStS = 1, kStI = 2;   // spread maxima, select, IPA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* m) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(m))
               : "memory");
}

// this block's one arrival of a phase, with the bytes the phase waits for
__device__ __forceinline__ void mbar_expect(uint64_t* m, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(m)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* m, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(m)), "r"(parity)
        : "memory");
}

// v into the place of `field` (this block's address) in block rank's
// shared memory, counted on rank's mbarrier at m's place
__device__ __forceinline__ void push_async(const void* field, uint32_t v,
                                           int rank, const uint64_t* m) {
  uint32_t ra, rm;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(smem_addr(field)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rm) : "r"(smem_addr(m)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(ra),
      "r"(v), "r"(rm)
      : "memory");
}

__device__ __forceinline__ void push_async(const void* field,
                                           unsigned long long v, int rank,
                                           const uint64_t* m) {
  uint32_t ra, rm;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(smem_addr(field)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rm) : "r"(smem_addr(m)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(ra),
      "l"(v), "r"(rm)
      : "memory");
}

template <class T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)rank);
}

// The value at p (an address in this block's node storage) in block
// `rank`'s copy: its shared memory, or its workspace slice (written by
// another SM: read from L2).
template <class T>
__device__ __forceinline__ T peer(const T* p, int rank, int me,
                                  const Layout& L) {
  if (L.node_smem) return *at_rank(const_cast<T*>(p), rank);
  return __ldcg(reinterpret_cast<const T*>(
      reinterpret_cast<const char*>(p) + (long long)(rank - me) * L.slice));
}

// ---- warps

__device__ __forceinline__ float warp_fmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_fmin(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_nan_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_incl(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ long long warp_max_ll(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(kFull, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// each warp's slot x[warp] folded over the block's warps, in every lane
__device__ __forceinline__ float fold_fmax(const float* x, int warps,
                                          int lane) {
  return warp_fmax(lane < warps ? x[lane] : -INFINITY);
}

__device__ __forceinline__ int fold_sum(const int* x, int warps, int lane) {
  return warp_sum(lane < warps ? x[lane] : 0);
}

// the position of the k-th (from 0) set bit of x, which has more than k
__device__ __forceinline__ int nth_bit(unsigned x, int k) {
  int pos = 0;
  for (int width = 16; width > 0; width >>= 1) {
    const unsigned low = x & ((1u << width) - 1u);
    const int c = __popc(low);
    if (k >= c) {
      k -= c;
      x >>= width;
      pos += width;
    } else {
      x = low;
    }
  }
  return pos;
}

// The k largest of n packs (get(i), LLONG_MIN: none), the winner-pinned
// way: with pinned >= 0 that node counts at kNeg, wherever its own pack
// stands.  Run by a whole warp; out[j] gets the j-th, lane 0 writes.
template <class Get>
__device__ void warp_topk(Get get, int n, int k, int pinned, long long* out,
                          int lane) {
  const long long pin =
      pinned >= 0 ? select_row::pack(select_row::order_key(kNeg), pinned)
                  : LLONG_MIN;
  long long prev = LLONG_MAX;
  for (int j = 0; j < k; ++j) {
    long long bp = lane == 0 && pin < prev ? pin : LLONG_MIN;
    for (int i = lane; i < n; i += 32) {
      const long long p = get(i);
      if (p == LLONG_MIN ||
          (pinned >= 0 && select_row::unpack_node(p) == pinned))
        continue;
      if (p < prev && p > bp) bp = p;
    }
    bp = warp_max_ll(bp);
    if (lane == 0) out[j] = bp;
    prev = bp;
  }
}

// ---- the step's pieces

// Loads issued where they stand: the compiler may neither sink nor repeat
// them (a read-only load it would otherwise issue again at its use, a step
// later than it is written, to spare registers).
__device__ __forceinline__ float ld_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_early(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint8_t ld_early(const uint8_t* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=h"(v) : "l"(p));
  return (uint8_t)v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A lean pod's groups (group_ids, group_valid), loaded a step before the
// node rows that gather them (up to kGroupRegs; a pod with more sums its
// counts when used).
struct Groups {
  int id[kGroupRegs];
  uint8_t ok[kGroupRegs];
};

__device__ __forceinline__ Groups load_groups(const SeqScanArgs& a, int b) {
  Groups q;
#pragma unroll
  for (int j = 0; j < kGroupRegs; ++j) {
    const size_t k = (size_t)b * a.gp + j;
    q.id[j] = j < a.gp ? ld_early(a.group_ids + k) : -1;
    q.ok[j] = j < a.gp ? ld_early(a.group_valid + k) : 0;
  }
  return q;
}

// A pod's static row at one node, loaded a step before it is used: the
// masks, the scores and the spread base count's addends (the shipped
// count, or a lean pod's group counts, 0 where a group is off), summed
// when used.
struct Row {
  float ss, es, c0, c1;
  uint8_t sm, em;
};

__device__ __forceinline__ Row load_row(const SeqScanArgs& a, int b, int n,
                                        bool spread, const Groups& q) {
  Row x;
  const size_t bn = (size_t)b * a.n + n;
  x.sm = ld_early(a.static_mask + bn);
  x.em = a.extra_mask ? ld_early(a.extra_mask + bn) : 1;
  x.ss = ld_early(a.static_score + bn);
  x.es = a.extra_score ? ld_early(a.extra_score + bn) : 0.f;
  x.c0 = x.c1 = 0.f;
  if (spread) {
    if (a.spread_counts) {
      x.c0 = ld_early(a.spread_counts + bn);
    } else if (a.gp <= kGroupRegs) {
      const float* row = a.group_counts + (size_t)n * a.g;
      if (q.ok[0] && q.id[0] >= 0 && q.id[0] < a.g) x.c0 = ld_early(row + q.id[0]);
      if (q.ok[1] && q.id[1] >= 0 && q.id[1] < a.g) x.c1 = ld_early(row + q.id[1]);
    }
  }
  return x;
}

// Pod b's spread base count at node n from its row: the twin's sum over
// the pod's groups from 0.0 (adding 0.0 for an off group changes no sum
// that starts at +0.0), or the shipped count.
__device__ __forceinline__ float base_count(const SeqScanArgs& a, int b,
                                            int n, const Row& x) {
  if (a.spread_counts) return x.c0;
  if (a.gp <= kGroupRegs) return __fadd_rn(__fadd_rn(0.f, x.c0), x.c1);
  float c = 0.f;   // more groups than registers: gathered now
  for (int j = 0; j < a.gp; ++j) {
    const size_t k = (size_t)b * a.gp + j;
    const int g = __ldg(a.group_ids + k);
    if (__ldg(a.group_valid + k) && g >= 0 && g < a.g)
      c = __fadd_rn(c, __ldg(a.group_counts + (size_t)n * a.g + g));
  }
  return c;
}

// A pod's request row, conflict words (the ports an earlier claim must not
// hold on the node) and port words into buffer `buf` (zeroed words), read
// now: the first pod, and the columns past a thread each.
__device__ void load_pod(const SeqScanArgs& a, int b, float* rq,
                         uint32_t* qm, uint32_t* pb, int tid, int nthreads,
                         int from) {
  for (int r = from + tid; r < a.r; r += nthreads)
    rq[r] = __ldg(a.req + (size_t)b * a.r + r);
  if (from > 0 && a.pv <= 32) return;
  const uint8_t* pports = a.pod_ports + (size_t)b * a.pv;
  for (int q = tid; q < a.pv; q += nthreads) {
    bool c = false;
    for (int p = 0; p < a.pv && !c; ++p)
      c = __ldg(pports + p) && __ldg(a.conflict + (size_t)q * a.pv + p);
    if (c) atomicOr(qm + (q >> 5), 1u << (q & 31));
    if (__ldg(pports + q)) atomicOr(pb + (q >> 5), 1u << (q & 31));
  }
}

// The next pod's scalars a thread holds from the start of a step to the
// window: its request column `tid`, port `tid`, nonzero request and
// priority, the spread_match entry of the placed pod `tid` of the block's
// list, and the next pod's entry for this pod (mb: the commit's).
struct PodAhead {
  float rq, m, pnz0, pnz1, mb;
  int prio;
  uint8_t port;
};

// The affinity mode's reads go out together: no early exit, the loops
// over a pod's terms unrolled, a node's first kMaxKT pairs in registers
// (the rest read from its row of node_pair); the u rows, which other SMs
// write within the launch, come from L2.

// A node's pair under key slot `slot` (-1: none): pr its first kMaxKT
// pairs, np its row of node_pair.
__device__ __forceinline__ int pair_in(const int* pr, const int* np,
                                       int slot) {
  if (slot < 0) return -1;
  if (slot >= kMaxKT) return __ldg(np + slot);
  int p = -1;
#pragma unroll
  for (int k = 0; k < kMaxKT; ++k)
    if (slot == k) p = pr[k];
  return p;
}

// Is any of the node's pairs set in row?
__device__ __forceinline__ bool any_hit_all(const uint8_t* row, const int* pr,
                                            const int* np, int kt) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kMaxKT; ++k)
    if (pr[k] >= 0) hit |= __ldcg(row + pr[k]) != 0;
  for (int k = kMaxKT; k < kt; ++k) {
    const int p = __ldg(np + k);
    if (p >= 0) hit |= __ldcg(row + p) != 0;
  }
  return hit;
}

// MatchInterPodAffinity of pod b on node n against the carried pair rows,
// and (raw) the IPA raw sum of pod b's preferred weights over n's pairs.
// pr: n's first kMaxKT pairs (-1 past kt).
__device__ bool affinity_ok(const SeqScanArgs& a, int b, int n, const int* pr,
                            float* raw) {
  const int* np = a.node_pair + (size_t)n * a.kt;
  const size_t tp = (size_t)a.tp;
  // the raw sum in slot order from 0.0
  float s = 0.f;
  const float* urow = a.u_pref + (size_t)b * tp;
#pragma unroll
  for (int k = 0; k < kMaxKT; ++k)
    if (pr[k] >= 0) s = __fadd_rn(s, __ldcg(urow + pr[k]));
  for (int k = kMaxKT; k < a.kt; ++k) {
    const int p = __ldg(np + k);
    if (p >= 0) s = __fadd_rn(s, __ldcg(urow + p));
  }
  *raw = s;
  bool ok = !any_hit_all(a.u_forb + (size_t)b * tp, pr, np, a.kt);
#pragma unroll 4
  for (int t = 0; t < a.at; ++t) {
    const size_t i = (size_t)b * a.at + t;
    const bool hit = any_hit_all(a.u_anti + i * tp, pr, np, a.kt);
    ok &= !(hit & (__ldg(a.anti_valid + i) != 0));
  }
#pragma unroll 4
  for (int t = 0; t < a.pt; ++t) {
    const size_t i = (size_t)b * a.pt + t;
    // in one of its pairs, or bootstrapped: no pair matches it anywhere,
    // the pod matches it itself, the node has its key
    const bool hit = any_hit_all(a.u_aff + i * tp, pr, np, a.kt);
    const bool boot = (__ldcg(a.any_aff + i) == 0) &
                      (__ldg(a.aff_self + i) != 0) &
                      (pair_in(pr, np, __ldg(a.aff_slot + i)) >= 0);
    ok &= (__ldg(a.aff_valid + i) == 0) | hit | boot;
  }
  return ok;
}

// The AddPod analogue of pod b committed on host h, for the later pod i:
// one pair a (term, key) at h's pair of the key.  hp: h's first kMaxKT
// pairs, nph: its row of node_pair.  The flags, slots and weights of the
// terms go out together, and the preferred weights are summed a key slot
// at a time (integers: exact in any order), so the u_pref row takes one
// read and one write a pair.
__device__ void commit_pairs(const SeqScanArgs& a, int b, const int* hp,
                             const int* nph, int i) {
  const size_t B = (size_t)a.b, tp = (size_t)a.tp;
#pragma unroll 4
  for (int t = 0; t < a.pt; ++t) {
    const size_t it = (size_t)i * a.pt + t;
    const bool m = __ldg(a.aff_match + ((size_t)b * B + i) * a.pt + t);
    const int p = pair_in(hp, nph, __ldg(a.aff_slot + it));
    if (m && p >= 0) {
      a.u_aff[it * tp + p] = 1;
      a.any_aff[it] = 1;
    }
  }
#pragma unroll 4
  for (int t = 0; t < a.at; ++t) {
    const size_t it = (size_t)i * a.at + t;
    const bool m = __ldg(a.anti_match + ((size_t)b * B + i) * a.at + t);
    const int p = pair_in(hp, nph, __ldg(a.anti_slot + it));
    if (m && p >= 0) a.u_anti[it * tp + p] = 1;
    // b's anti terms forbid their domains to the later pods they match
    const bool own = __ldg(a.anti_own + ((size_t)b * a.at + t) * B + i);
    const int q = pair_in(hp, nph, __ldg(a.anti_slot + (size_t)b * a.at + t));
    if (own && q >= 0) a.u_forb[(size_t)i * tp + q] = 1;
  }
  // the preferred weights: the hard affinity weight of b's terms i
  // matches, i's preferred terms b matches, b's preferred terms i matches
  float* up = a.u_pref + (size_t)i * tp;
  float acc[kMaxKT];
  bool touched[kMaxKT];
#pragma unroll
  for (int k = 0; k < kMaxKT; ++k) {
    acc[k] = 0.f;
    touched[k] = false;
  }
  auto add = [&](bool on, int slot, float w) {
    if (on && slot >= kMaxKT) {   // a slot past the registers: now
      const int p = __ldg(nph + slot);
      if (p >= 0) up[p] = __fadd_rn(__ldcg(up + p), w);
    }
#pragma unroll
    for (int k = 0; k < kMaxKT; ++k)
      if (on && slot == k && hp[k] >= 0) {
        acc[k] = __fadd_rn(acc[k], w);
        touched[k] = true;
      }
  };
#pragma unroll 4
  for (int t = 0; t < a.pt; ++t)
    add(__ldg(a.aff_own + ((size_t)b * a.pt + t) * B + i),
        __ldg(a.aff_slot + (size_t)b * a.pt + t), a.hard_w);
#pragma unroll 4
  for (int t = 0; t < a.pp; ++t) {
    add(__ldg(a.pref_match + ((size_t)b * B + i) * a.pp + t),
        __ldg(a.pref_slot + (size_t)i * a.pp + t),
        __ldg(a.pref_weight + (size_t)i * a.pp + t));
    add(__ldg(a.pref_own + ((size_t)b * a.pp + t) * B + i),
        __ldg(a.pref_slot + (size_t)b * a.pp + t),
        __ldg(a.pref_weight + (size_t)b * a.pp + t));
  }
  float cur[kMaxKT];
#pragma unroll
  for (int k = 0; k < kMaxKT; ++k)
    cur[k] = touched[k] ? __ldcg(up + hp[k]) : 0.f;
#pragma unroll
  for (int k = 0; k < kMaxKT; ++k)
    if (touched[k]) up[hp[k]] = __fadd_rn(cur[k], acc[k]);
}

// (n - start) with int32 wrap, floor mod N: the sampling order's position
__device__ __forceinline__ int rotated(int n, int start, int N) {
  const int w = (int)(unsigned)((long long)n - (long long)start);
  const int r = w % N;
  return r < 0 ? r + N : r;
}

__device__ __forceinline__ int floor_mod64(long long x, int N) {
  const long long r = x % N;
  return (int)(r < 0 ? r + N : r);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    k13_seq_scan(const SeqScanArgs a, const Layout L) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ Part part[2];                   // this block's, as it is built
  __shared__ Part box[2][kCluster];          // every block's, pushed here
  __shared__ uint64_t mbar[3][2];            // [stage][parity]
  __shared__ Slots sl;
  const int me = cta_rank(), C = L.c, T = L.t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.n, R = a.r, B = a.b, chunk = L.chunk, K = L.k;
  const int base = min(me * chunk, N), cnt = min(chunk, N - base);
  uint8_t* slice = a.work + (long long)me * L.slice;
  uint8_t* ns = L.node_smem ? dyn : slice;
  // the carried state: element (node ln, column r) at [ln * sn + r * sr]
  const float* alloc;
  float *req, *nz;
  long long sn, sr, zn, zr;
  if (L.node_smem) {
    alloc = (const float*)(ns + L.o_alloc);
    req = (float*)(ns + L.o_req);
    nz = (float*)(ns + L.o_nz);
    sn = 1; sr = chunk; zn = 1; zr = chunk;
  } else {
    alloc = a.allocatable + (size_t)base * R;
    req = a.requested_out + (size_t)base * R;
    nz = a.nonzero_out + (size_t)base * 2;
    sn = R; sr = 1; zn = 2; zr = 1;
  }
  uint32_t* used = (uint32_t*)(ns + L.o_used);   // [pvw][chunk]
  int* cz = (int*)(ns + L.o_cz);                 // each node's zone slot
  float* t1 = (float*)(ns + L.o_t1);             // the step's totals
  float* aux = (float*)(ns + L.o_aux);           // the step's RTC score
  float* cntv = (float*)(ns + L.o_cnt);          // the step's spread counts
  float* inc = (float*)(ns + L.o_inc);           // the in-batch additions
  float* raw = (float*)(ns + L.o_raw);           // the IPA raw sums
  int* pre = (int*)(ns + L.o_pre);               // masked nodes before each
  uint32_t* wd = (uint32_t*)(ns + L.o_wd);       // sampled: masked words
  int* wp = (int*)(ns + L.o_wp);                 // their exclusive prefix
  uint32_t* tw = (uint32_t*)(ns + L.o_tw);       // [2][W] tie words
  uint8_t* mk = ns + L.o_mk;                     // the step's mask
  int* npc = (int*)(ns + L.o_np);     // [kMaxKT][chunk] affinity: the pairs
  uint8_t* nv = ns + L.o_nv;          // affinity: node_valid
  float* rq = (float*)(dyn + L.o_rq);            // [2][R] the pod's request
  uint32_t* qm = (uint32_t*)(dyn + L.o_qm);      // [2][pvw] conflict words
  uint32_t* pb = (uint32_t*)(dyn + L.o_pb);      // [2][pvw] port words
  int2* list = (int2*)(L.list_smem ? dyn + L.o_list
                                   : slice + L.o_slice_list);
  long long* wtop = a.tk > kTopSlots ? (long long*)(slice + L.o_slice_wtop)
                                     : sl.top;
  float* zx = a.tp > kZoneSlots ? (float*)(a.work + L.o_zx) : nullptr;
  long long* tx = a.tk > kTopSlots ? (long long*)(a.work + L.o_tx) : nullptr;
  const int pvw = L.pvw, W = L.w, warps = L.warps;
  const bool spread_on = a.w_spread != 0.f;
  const bool use_most = a.w_most != 0.f, use_rtc = a.w_rtc != 0.f;
  const bool limited = a.feas_limit != nullptr;
  const int lim = limited ? *a.feas_limit : 0;
  const bool aff = a.node_pair != nullptr;
  const int tk = a.tk;

  // ---- the state the batch starts from (+ 0.0: the twin's first commit
  // adds 0.0 to every row, so a -0.0 reads 0.0 from then on)
  int zk = 0;   // the zone-key pairs (every block counts the same)
  for (int p = tid; p < a.tp; p += T) zk += __ldg(a.pair_key + p) == a.zone_key;
  zk = warp_sum(zk);
  if (lane == 0) sl.i[warp] = zk;
  for (int k = 0; k < K; ++k) {
    const int ln = tid + k * T;
    if (ln >= cnt) continue;
    const int n = base + ln;
    for (int r = 0; r < R; ++r) {
      const float x = __fadd_rn(__ldg(a.requested + (size_t)n * R + r), 0.f);
      req[ln * sn + r * sr] = x;
      if (L.node_smem)
        ((float*)alloc)[ln * sn + r * sr] = __ldg(a.allocatable + (size_t)n * R + r);
    }
    for (int q = 0; q < 2; ++q)
      nz[ln * zn + q * zr] = __fadd_rn(__ldg(a.nonzero + 2 * (size_t)n + q), 0.f);
    for (int q = 0; q < pvw; ++q) used[q * chunk + ln] = 0u;
    // the node's zone: its first pair of the zone key, as a slot among
    // the zone-key pairs
    const uint8_t* topo = a.topo + (size_t)n * a.tp;
    int z = -1, seen = 0;
    for (int j = 0; j < a.tp; ++j) {
      const bool key = __ldg(a.pair_key + j) == a.zone_key;
      if (key && __ldg(topo + j)) {
        z = seen;
        break;
      }
      seen += key;
    }
    cz[ln] = z;
    inc[ln] = -0.f;   // x + -0.0 == x: a node no earlier pod raised
    if (aff) {
      for (int j = 0; j < kMaxKT; ++j)
        npc[j * chunk + ln] = j < a.kt ? __ldg(a.node_pair + (size_t)n * a.kt + j) : -1;
      nv[ln] = __ldg(a.node_valid + n);
    }
  }
  for (int q = tid; q < 2 * pvw; q += T) {
    qm[q] = 0u;
    pb[q] = 0u;
  }
  for (int z = tid; z < kZoneSlots; z += T) {
    part[0].zsum[z] = 0.f;
    part[1].zsum[z] = 0.f;
  }
  if (zx)
    for (int z = tid; z < 2 * a.tp; z += T)
      zx[((size_t)(z / a.tp) * C + me) * a.tp + z % a.tp] = 0.f;
  __syncthreads();
  {
    int s = 0;
    for (int q = 0; q < warps; ++q) s += sl.i[q];
    zk = s;
  }
  // the exchange: st.async and mbarriers where every partial lives in
  // shared memory, the state too, and no sample reads another block's
  // rows; else the partials go out with plain remote stores and a cluster
  // barrier.  With affinity the first stage stays a cluster barrier: it
  // orders the pair commits' global writes before the reads of the rows.
  const bool xa = L.node_smem && !aff && !limited && zk <= kZoneSlots;
  const bool xs = L.node_smem && !limited && tk <= kTopSlots &&
                  (!aff || W <= kWordSlots);
  if (tid == 0) {
    for (int st = 0; st < 3; ++st) {
      mbar_init(&mbar[st][0]);
      mbar_init(&mbar[st][1]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every block's mbarriers before the first push
  const uint32_t bytes_a = (uint32_t)C * 4u * (1u + (uint32_t)zk);
  const uint32_t bytes_s =
      (uint32_t)C * (12u + 8u * (uint32_t)tk + (aff ? 4u * (uint32_t)W : 0u));
  const uint32_t bytes_i = (uint32_t)C * 8u;
  // this warp's copy of the step's zone sums
  float* zg = zk > kZoneSlots
                  ? (float*)(slice + L.o_slice_zg) + (size_t)warp * a.tp
                  : sl.zg + warp * kZoneSlots;
  load_pod(a, 0, rq, qm, pb, tid, T, 0);
  // the pipeline: pod b's rows at this thread's first node (cur) and its
  // scalars are in registers when step b starts; step b loads pod b + 1's
  // (nxt, ahead) and pod b + 2's groups
  Groups grp = load_groups(a, 0);
  Row cur{}, nxt{};
  if (cnt > tid) cur = load_row(a, 0, base + tid, spread_on, grp);
  if (B > 1) grp = load_groups(a, 1);
  float pnz0 = __ldg(a.pod_nonzero), pnz1 = __ldg(a.pod_nonzero + 1);
  int prio = __ldg(a.priority);
  PodAhead ahead{};
  int len = 0;   // the placed list's length (every thread keeps it)
  // the sampling's break points: li's segment of nodes without the int32
  // wrap starts at sA, the wrapped one (nodes from nw on) at sB
  __syncthreads();

#ifdef K13_PHASE_CLOCKS
  long long clocks_[kPhases] = {};
  long long then_ = clock64();
#endif
  for (int b = 0; b < B; ++b) {
    const int par = b & 1;
    const int li = (int)((unsigned)a.last_index0 + (unsigned)b);
    const float* rqb = rq + par * R;
    const uint32_t* qmb = qm + par * pvw;
    const uint32_t* pbb = pb + par * pvw;
    bool any_q = false;
    for (int q = 0; q < pvw; ++q) any_q |= qmb[q] != 0u;
    float* zloc = zk <= kZoneSlots ? part[par].zsum
                                   : zx + ((size_t)par * C + me) * a.tp;
    // the next pod's word buffers: zeroed now, filled in the select's wait
    for (int q = tid; q < pvw; q += T) {
      qm[(par ^ 1) * pvw + q] = 0u;
      pb[(par ^ 1) * pvw + q] = 0u;
    }
    if (tid == 0) {   // this step's phases of the exchanged stages
      if (xa && spread_on) mbar_expect(&mbar[kStA][par], bytes_a);
      if (xs) mbar_expect(&mbar[kStS][par], bytes_s);
      if (xs && aff) mbar_expect(&mbar[kStI][par], bytes_i);
    }
    const uint32_t phase = (uint32_t)(b >> 1) & 1u;
    // ---- pass 1: fit, ports, the state-dependent scores but spread and
    // IPA, the spread counts and their block maxima
    float nmax = -INFINITY;
    auto pass1 = [&](int ln, const Row& x) {
      const int n = base + ln;
      bool fit = true;
      for (int r = 0; r < R; ++r) {
        const float q = rqb[r];
        if (q > 0.f && __fadd_rn(req[ln * sn + r * sr], q) > alloc[ln * sn + r * sr])
          fit = false;
      }
      if (a.nom_start) {
        const int c0 = __ldg(a.nom_start + n), c1 = __ldg(a.nom_start + n + 1);
        if (c1 > c0) {
          // podFitsOnNode's pass one: the claims of nominated pods with
          // priority >= this pod's on the node
          for (int r = 0; r < R && fit; ++r) {
            const float q = rqb[r];
            if (!(q > 0.f)) continue;
            float extra = 0.f;
            for (int c = c0; c < c1; ++c) {
              const int k = __ldg(a.nom_order + c);
              if (__ldg(a.nom_prio + k) >= prio)
                extra = __fadd_rn(extra, __ldg(a.nom_req + (size_t)k * R + r));
            }
            if (__fadd_rn(__fadd_rn(req[ln * sn + r * sr], extra), q) >
                alloc[ln * sn + r * sr])
              fit = false;
          }
        }
      }
      bool port_bad = false;
      if (any_q)
        for (int q = 0; q < pvw && !port_bad; ++q)
          port_bad = (used[q * chunk + ln] & qmb[q]) != 0u;
      mk[ln] = x.sm && x.em && fit && !port_bad;
      const float cap[2] = {alloc[ln * sn], alloc[ln * sn + sr]};
      const float rq2[2] = {__fadd_rn(nz[ln * zn], pnz0),
                            __fadd_rn(nz[ln * zn + zr], pnz1)};
      float least, most;
      prio_math::least_most_sums(cap, rq2, least, most);
      float total = x.ss;
      if (a.extra_score) total = __fadd_rn(total, x.es);
      total = __fadd_rn(total, __fmul_rn(a.w_least, prio_math::half_floor(least)));
      if (use_most)
        total = __fadd_rn(total, __fmul_rn(a.w_most, prio_math::half_floor(most)));
      total = __fadd_rn(total, __fmul_rn(a.w_bal, prio_math::balanced(cap, rq2)));
      t1[ln] = total;
      if (use_rtc)
        aux[ln] = prio_math::rtc(a.rtc_xs, a.rtc_ys, a.n_rtc, cap, rq2);
      if (spread_on) {
        const float c = __fadd_rn(base_count(a, b, n, x), inc[ln]);
        inc[ln] = -0.f;
        cntv[ln] = c;
        nmax = fmaxf(nmax, c);
        const int z = cz[ln];
        if (z >= 0) atomicAdd(zloc + z, c);   // integers: exact in any order
      }
    };
    K13_MARK(13);                                       // the step's start
    if (tid < cnt) pass1(tid, cur);
    for (int k = 1; k < K; ++k)   // nodes past the first a thread: now
      if (tid + k * T < cnt)
        pass1(tid + k * T,
              load_row(a, b, base + tid + k * T, spread_on, load_groups(a, b)));

    K13_MARK(0);                                        // pass 1
    // pod b + 1's loads, used from this step's select on (and pod b +
    // 2's groups)
    if (b + 1 < B) {
      const int b1 = b + 1;
      if (cnt > tid) nxt = load_row(a, b1, base + tid, spread_on, grp);
      if (b + 2 < B) grp = load_groups(a, b + 2);
      ahead.rq = tid < R ? ld_early(a.req + (size_t)b1 * R + tid) : 0.f;
      ahead.port = tid < a.pv ? ld_early(a.pod_ports + (size_t)b1 * a.pv + tid) : 0;
      ahead.pnz0 = ld_early(a.pod_nonzero + 2 * (size_t)b1);
      ahead.pnz1 = ld_early(a.pod_nonzero + 2 * (size_t)b1 + 1);
      ahead.prio = ld_early(a.priority + b1);
      ahead.m = spread_on && tid < len
                    ? ld_early(a.spread_match + (size_t)b1 * B + list[tid].x)
                    : 0.f;
      ahead.mb = spread_on ? ld_early(a.spread_match + (size_t)b1 * B + b) : 0.f;
    }

    if (spread_on) {
      nmax = warp_fmax(nmax);
      if (lane == 0) sl.f[warp] = nmax;
      __syncthreads();                                  // block: spread
      // the node max and the zone sums into every block's inbox, a value
      // a thread
      const float nm = fold_fmax(sl.f, warps, lane);
      const int zp = zk <= kZoneSlots ? zk : 0;
      for (int i = tid; i < C * (1 + zp); i += T) {
        const int r = i % C, f = i / C;
        float* field = f == 0 ? &box[par][me].node_max : &box[par][me].zsum[f - 1];
        const float v = f == 0 ? nm : part[par].zsum[f - 1];
        if (xa)
          push_async(field, __float_as_uint(v), r, &mbar[kStA][par]);
        else
          *at_rank(field, r) = v;
      }
    }
    // cluster A: the spread partials; with affinity also the fence
    // behind the previous step's pair commits
    K13_MARK(1);                                        // its block max
    if (xa && spread_on)
      mbar_wait(&mbar[kStA][par], phase);
    else if (spread_on || aff)
      cluster_sync();
    K13_MARK(2);                                        // cluster A

    float mx_node = 0.f, mx_zone = 0.f;
    if (spread_on) {
      mx_node = warp_fmax(lane < C ? box[par][lane].node_max : -INFINITY);
      // the zone sums over the cluster, in each warp; pairs no node's
      // zone sums to 0
      float mz = zk < a.tp ? 0.f : -INFINITY;
      for (int z = lane; z < zk; z += 32) {
        float v[kCluster];     // every block's partial first, then the sum
        if (zk <= kZoneSlots) {
#pragma unroll
          for (int r = 0; r < kCluster; ++r)
            v[r] = r < C ? box[par][r].zsum[z] : 0.f;
        } else {
#pragma unroll
          for (int r = 0; r < kCluster; ++r)
            v[r] = r < C ? __ldcg(zx + ((size_t)par * C + r) * a.tp + z) : 0.f;
        }
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          if (r < C) s = __fadd_rn(s, v[r]);
        zg[z] = s;
        mz = fmaxf(mz, s);
      }
      mx_zone = warp_fmax(mz);
      __syncwarp();
    }
    float ipa_mn = 0.f, ipa_spr = 0.f;
    if (aff) {
      // the IPA raw sums, their extremes over the valid nodes, and
      // MatchInterPodAffinity on the masked nodes
      float mn = kBig, mx = -kBig;
      for (int k = 0; k < K; ++k) {
        const int ln = tid + k * T;
        if (ln >= cnt) continue;
        const int n = base + ln;
        int pr[kMaxKT];
#pragma unroll
        for (int j = 0; j < kMaxKT; ++j) pr[j] = npc[j * chunk + ln];
        float x;
        const bool ok = affinity_ok(a, b, n, pr, &x);
        raw[ln] = x;
        if (nv[ln]) {
          mn = fminf(mn, x);
          mx = fmaxf(mx, x);
        }
        if (!ok) mk[ln] = 0;
      }
      mn = warp_fmin(mn);
      mx = warp_fmax(mx);
      if (lane == 0) {
        sl.f[warp] = mn;
        sl.h[warp] = mx;
      }
    }
    K13_MARK(3);                                        // zone sums, IPA
    if (aff) {
      __syncthreads();                                  // block: IPA
      if (warp == 0) {
        const float mn = warp_fmin(lane < warps ? sl.f[lane] : kBig);
        const float mx = fold_fmax(sl.h, warps, lane);
        if (lane < C) {
          Part& mine = box[par][me];
          if (xs) {
            push_async(&mine.ipa_mn, __float_as_uint(mn), lane, &mbar[kStI][par]);
            push_async(&mine.ipa_mx, __float_as_uint(mx), lane, &mbar[kStI][par]);
          } else {
            *at_rank(&mine.ipa_mn, lane) = mn;
            *at_rank(&mine.ipa_mx, lane) = mx;
          }
        }
      }
      if (xs)                                           // cluster I
        mbar_wait(&mbar[kStI][par], phase);
      else
        cluster_sync();
      float mn = kBig, mx = -kBig;
      if (lane < C) {
        mn = box[par][lane].ipa_mn;
        mx = box[par][lane].ipa_mx;
      }
      mn = warp_fmin(mn);
      mx = warp_fmax(mx);
      ipa_mn = mn;
      ipa_spr = __fsub_rn(mx, mn);
    }

    K13_MARK(4);                                        // cluster I
    // ---- pass 2: the totals
    for (int k = 0; k < K; ++k) {
      const int ln = tid + k * T;
      if (ln >= cnt) continue;
      float total = t1[ln];
      float sp = 0.f;
      if (spread_on) {
        const int z = cz[ln];
        sp = prio_math::spread(mx_node, cntv[ln], z >= 0, mx_zone,
                               z >= 0 ? zg[z] : 0.f);
      }
      total = __fadd_rn(total, __fmul_rn(a.w_spread, sp));
      if (use_rtc) total = __fadd_rn(total, __fmul_rn(a.w_rtc, aux[ln]));
      if (aff) {
        // ipa_normalize, then w_ipa times it, added last
        float ipa = 0.f;
        if (nv[ln] && ipa_spr > 0.f)
          ipa = floorf(__fdiv_rn(
              __fmul_rn(prio_math::kMaxPriority, __fsub_rn(raw[ln], ipa_mn)),
              ipa_spr));
        total = __fadd_rn(total, __fmul_rn(a.w_ipa, ipa));
      }
      t1[ln] = total;
    }

    K13_MARK(5);                                        // pass 2
    if (limited) {
      // keep the first `lim` masked nodes in the rotated order from li.
      // Node n's position is rotated(n, li); the nodes from nw on wrap
      // int32 (n - li > INT_MAX) and start their rotation at sB, the
      // others at sA, so two nodes can share a position (the lower first).
      for (int k = 0; k < K; ++k) {
        const int ln = tid + k * T;
        const unsigned m = __ballot_sync(kFull, ln < cnt && mk[ln]);
        if (lane == 0 && k * warps + warp < W) wd[k * warps + warp] = m;
      }
      __syncthreads();                                  // block: words
      if (warp == 0) {
        int carry = 0;
        for (int w0 = 0; w0 < W; w0 += 32) {
          const int c = w0 + lane < W ? __popc(wd[w0 + lane]) : 0;
          const int incl = warp_incl(c, lane);
          if (w0 + lane < W) wp[w0 + lane] = carry + incl - c;
          carry += __shfl_sync(kFull, incl, 31);
        }
      }
      __syncthreads();                                  // block: prefix
      const long long nw64 =
          li >= 0 ? (long long)N : (long long)INT_MAX + li + 1;
      const int nw = (int)(nw64 < 0 ? 0 : (nw64 > N ? N : nw64));
      const int sA = floor_mod64(li, N);
      const int sB = floor_mod64((long long)li + (1LL << 32), N);
      auto local_p = [&](int x) {   // this block's masked nodes below x
        if (x <= base) return 0;
        const int lx = x - base;
        if (lx >= cnt) return wp[W - 1] + __popc(wd[W - 1]);
        return wp[lx >> 5] + __popc(wd[lx >> 5] & ((1u << (lx & 31)) - 1u));
      };
      for (int k = 0; k < K; ++k) {
        const int ln = tid + k * T;
        if (ln < cnt) pre[ln] = local_p(base + ln);
      }
      if (warp == 0 && lane < C) {
        Part* dst = at_rank(&box[par][me], lane);
        dst->l_total = cnt > 0 ? wp[W - 1] + __popc(wd[W - 1]) : 0;
        dst->l_below[0] = local_p(sA);
        dst->l_below[1] = local_p(sB);
        dst->l_below[2] = local_p(nw);
      }
      cluster_sync();                                   // cluster L
      int tot_r = 0, bel[3] = {0, 0, 0};
      if (lane < C) {
        const Part& p = box[par][lane];
        tot_r = p.l_total;
        bel[0] = p.l_below[0];
        bel[1] = p.l_below[1];
        bel[2] = p.l_below[2];
      }
      const int incl = warp_incl(tot_r, lane);
      const int pbase = incl - tot_r;        // P(lane's first node)
      const int total = __shfl_sync(kFull, incl, 31);
      const int PsA = warp_sum(bel[0]), PsB = warp_sum(bel[1]),
                PnW = warp_sum(bel[2]);
      const int my_base = __shfl_sync(kFull, pbase, me);
      auto PA = [&](int x, int px) { return x < nw ? px : PnW; };
      auto PB = [&](int x, int px) { return x > nw ? px - PnW : 0; };
      const bool two = nw > 0 && nw < N;
      const int D = floor_mod64((long long)sB - sA, N);
      for (int k = 0; k < K; ++k) {
        const int ln = tid + k * T;
        const bool here = ln < cnt;
        const int n = base + (here ? ln : 0);
        const bool inA = n < nw;
        // the point of the other segment this node's rank reads
        const int e = floor_mod64(inA ? (long long)n + D : (long long)n - D, N);
        const int o = e / chunk;
        const int ob = __shfl_sync(kFull, pbase, o);
        int pe = 0;
        bool me_masked = false;
        if (two && here && mk[ln]) {
          pe = ob + peer(pre + (e - o * chunk), o, me, L);
          const int le = e - o * chunk;
          me_masked = (peer(wd + (le >> 5), o, me, L) >> (le & 31)) & 1u;
        }
        if (!here || !mk[ln]) continue;
        const int pn = my_base + pre[ln];    // P(n)
        const int p = rotated(n, li, N);
        int rank_n;
        // masked nodes of a segment at positions in [s, s + p): the
        // cyclic node range from s to the node at position p
        auto cyc = [&](auto P, int s, int end, int pend, int ps) {
          return s <= end ? P(end, pend) - P(s, ps)
                          : P(N, total) - P(s, ps) + P(end, pend);
        };
        if (!two) {
          const int s = nw == 0 ? sB : sA, ps = nw == 0 ? PsB : PsA;
          rank_n = s <= n ? pn - ps : total - ps + pn;
        } else if (inA) {
          rank_n = cyc(PA, sA, n, pn, PsA);
          if (p > 0) {
            const int end = (sB + p) % N;    // == e
            rank_n += cyc(PB, sB, end, pe, PsB);
          }
        } else {
          rank_n = cyc(PB, sB, n, pn, PsB);
          if (p > 0) {
            const int end = (sA + p) % N;    // == e
            rank_n += cyc(PA, sA, end, pe, PsA);
          }
          // a node of the first segment at the same position comes first
          if (e < nw && me_masked) ++rank_n;
        }
        if (rank_n >= lim) mk[ln] = 0;
      }
    }

    K13_MARK(6);                                        // the sample
    // ---- select: the block's best, its ties at it, its feasible count
    // and (top-k) each warp's best packs
    float bm = -INFINITY;
    int fc = 0;
    for (int k = 0; k < K; ++k) {
      const int ln = tid + k * T;
      const bool m = ln < cnt && mk[ln];
      if (ln < cnt) bm = nan_max(bm, m ? t1[ln] : kNeg);
      fc += __popc(__ballot_sync(kFull, m));
    }
    bm = warp_nan_max(bm);   // the warp's best; its tie words at it
    int tc = 0;
    for (int k = 0; k < K; ++k) {
      const int ln = tid + k * T;
      const unsigned t = __ballot_sync(kFull, ln < cnt && mk[ln] && t1[ln] == bm);
      if (lane == 0 && k * warps + warp < W) tw[par * W + k * warps + warp] = t;
      tc += __popc(t);
    }
    if (lane == 0) {
      sl.f[warp] = bm;
      sl.i[warp] = fc;
      sl.j[warp] = tc;
    }
    if (tk > 0) {
      auto mine = [&](int i) {   // this lane's slot i / 32 (i % 32 == lane)
        const int ln = tid + (i >> 5) * T;
        if (ln >= cnt) return LLONG_MIN;
        const float v = mk[ln] ? t1[ln] : kNeg;
        return select_row::pack(select_row::order_key(v), base + ln);
      };
      warp_topk(mine, K * 32, tk, -1, wtop + (size_t)warp * tk, lane);
    }
    __syncthreads();                                    // block: select
    K13_MARK(7);                                        // best, top-k
    // the block's best, its ties at it (the warps whose best it is), its
    // feasible count; a warp whose best it is not holds no tie
    const float best_r = warp_nan_max(lane < warps ? sl.f[lane] : -INFINITY);
    const int ties_r = warp_sum(lane < warps && sl.f[lane] == best_r ? sl.j[lane] : 0);
    const int feas_r = fold_sum(sl.i, warps, lane);
    if (lane == 0 && !(bm == best_r))
      for (int k = 0; k < K && k * warps + warp < W; ++k)
        tw[par * W + k * warps + warp] = 0u;
    // into every block's inbox, a value a thread
    for (int i = tid; i < 3 * C; i += T) {
      const int r = i % C, f = i / C;
      Part& mine = box[par][me];
      void* field = f == 0 ? (void*)&mine.best : f == 1 ? (void*)&mine.ties
                                                       : (void*)&mine.feas;
      const uint32_t v = f == 0   ? __float_as_uint(best_r)
                         : f == 1 ? (uint32_t)ties_r
                                  : (uint32_t)feas_r;
      if (xs)
        push_async(field, v, r, &mbar[kStS][par]);
      else
        *at_rank((uint32_t*)field, r) = v;
    }
    if (aff && xs && lane < C)
      // with affinity every block finds the host: each warp's tie words
      // (0 where its best is not the block's) into every inbox
      for (int k = 0; k < K && k * warps + warp < W; ++k) {
        const int w = k * warps + warp;
        push_async(&box[par][me].words[w], bm == best_r ? tw[par * W + w] : 0u,
                   lane, &mbar[kStS][par]);
      }
    if (tk > 0 && warp == 0) {
      long long* out = tx ? tx + ((size_t)par * C + me) * tk : part[par].top;
      warp_topk([&](int i) { return wtop[i]; }, warps * tk, tk, -1, out,
                lane);
      __syncwarp();
      if (!tx)
        for (int i = lane; i < C * tk; i += 32) {
          long long* field = &box[par][me].top[i / C];
          const long long v = part[par].top[i / C];
          if (xs)
            push_async(field, (unsigned long long)v, i % C, &mbar[kStS][par]);
          else
            *at_rank(field, i % C) = v;
        }
    }
    K13_MARK(8);                                        // ties
    if (!xs) cluster_arrive();                          // cluster S
    // while the cluster gathers: the next pod's scalars into its buffers,
    // and its spread additions (loaded a step ago)
    if (b + 1 < B) {
      float* rq1 = rq + (par ^ 1) * R;
      uint32_t* qm1 = qm + (par ^ 1) * pvw;
      uint32_t* pb1 = pb + (par ^ 1) * pvw;
      if (tid < R) rq1[tid] = ahead.rq;
      if (a.pv <= 32) {
        // the pod's ports as one word; port q is barred where an earlier
        // claim holds a port it conflicts with
        const unsigned ports = __ballot_sync(kFull, lane < a.pv && ahead.port);
        if (warp == 0) {
          bool c = false;
          if (lane < a.pv)
            for (unsigned x = ports; x && !c; x &= x - 1)
              c = __ldg(a.conflict + (size_t)lane * a.pv + (__ffs(x) - 1));
          const unsigned cw = __ballot_sync(kFull, c);
          if (lane == 0) {
            qm1[0] = cw;
            pb1[0] = ports;
          }
        }
      }
      load_pod(a, b + 1, rq1, qm1, pb1, tid, T, T);   // what is left
      if (aff && tid < cnt) {
        // pod b + 1's pair rows at this thread's node into L2: written
        // until the next stage's barrier, read right after it
        const size_t b1 = (size_t)b + 1, tp = (size_t)a.tp;
        for (int k = 0; k < kMaxKT; ++k) {
          const int p = npc[k * chunk + tid];
          if (p < 0) continue;
          prefetch_l2(a.u_pref + b1 * tp + p);
          prefetch_l2(a.u_forb + b1 * tp + p);
          for (int t = 0; t < a.at; ++t)
            prefetch_l2(a.u_anti + (b1 * a.at + t) * tp + p);
          for (int t = 0; t < a.pt; ++t)
            prefetch_l2(a.u_aff + (b1 * a.pt + t) * tp + p);
        }
      }
      if (spread_on) {
        // the earlier pods placed on this block's nodes raise the next
        // pod's counts where they match all its selectors (pass 1 read and
        // reset this step's)
        if (tid < len && ahead.m != 0.f) atomicAdd(inc + list[tid].y, ahead.m);
        for (int e = T + tid; e < len; e += T) {
          const int2 jl = list[e];
          const float m = __ldg(a.spread_match + (size_t)(b + 1) * B + jl.x);
          if (m != 0.f) atomicAdd(inc + jl.y, m);
        }
      }
    }
    K13_MARK(9);                                        // the window
    if (xs)
      mbar_wait(&mbar[kStS][par], phase);
    else
      cluster_wait();
    K13_MARK(10);                                       // cluster S

    // every warp: the cluster's best, ties and feasible count, and the
    // block holding the (li mod ties)-th tie in node order (no tie: node
    // 0's); that block finds the host in its tie words, and with affinity
    // every block does, reading them from it
    float br = -INFINITY;
    int tr = 0, fr = 0;
    if (lane < C) {
      const Part& p = box[par][lane];
      br = p.best;
      tr = p.ties;
      fr = p.feas;
    }
    const float best = warp_nan_max(br);
    const int at_best = lane < C && br == best ? tr : 0;
    const int tincl = warp_incl(at_best, lane);
    const int ties = __shfl_sync(kFull, tincl, 31);
    const int count = warp_sum(fr);
    const bool feasible = count > 0;
    int host = 0, o = 0, kk = 0;
    if (ties > 0) {
      const int kth = select_row::floor_mod(li, ties);
      const unsigned own = __ballot_sync(
          kFull, at_best > 0 && kth >= tincl - at_best && kth < tincl);
      o = __ffs(own) - 1;
      kk = kth - __shfl_sync(kFull, tincl - at_best, o);
    }
    const bool owner = o == me;
    if (ties > 0 && (owner || aff)) {
      const int ow = (min(chunk, N - o * chunk) + 31) / 32;
      const uint32_t* words = tw + par * W;
      for (int w0 = 0; w0 < ow; w0 += 32) {
        const uint32_t word =
            w0 + lane >= ow ? 0u
            : owner         ? words[w0 + lane]
            : xs            ? box[par][o].words[w0 + lane]
                            : peer(words + w0 + lane, o, me, L);
        const int c = __popc(word);
        const int incl = warp_incl(c, lane);
        const int all = __shfl_sync(kFull, incl, 31);
        if (kk < all) {
          const int l = __ffs(__ballot_sync(kFull, kk < incl)) - 1;
          const int before = __shfl_sync(kFull, incl - c, l);
          const uint32_t wl = __shfl_sync(kFull, word, l);
          host = o * chunk + (w0 + l) * 32 + nth_bit(wl, kk - before);
          break;
        }
        kk -= all;
      }
    }
    const int lh = host - base;
    K13_MARK(11);                                       // the host

    // ---- commit: the host's block
    if (owner && warp == 0) {
      if (feasible) {
        for (int r = lane; r < R; r += 32)
          req[lh * sn + r * sr] = __fadd_rn(req[lh * sn + r * sr], rqb[r]);
        if (lane < 2)
          nz[lh * zn + lane * zr] = __fadd_rn(nz[lh * zn + lane * zr],
                                              lane == 0 ? pnz0 : pnz1);
        for (int q = lane; q < pvw; q += 32) used[q * chunk + lh] |= pbb[q];
        if (spread_on && lane == 0) {
          list[len] = make_int2(b, lh);
          if (b + 1 < B && ahead.mb != 0.f) atomicAdd(inc + lh, ahead.mb);
        }
      }
      if (lane == 0) {
        a.hosts[b] = feasible ? host : -1;
        if (tk > 0) {
          a.top_feas[b] = count;
          const float half = kNeg * 0.5f;
          const float wv = feasible ? (mk[lh] ? t1[lh] : kNeg) : kNeg;
          const bool ok = wv > half;
          a.top_nodes[(size_t)b * tk] = ok ? (feasible ? host : -1) : -1;
          a.top_scores[(size_t)b * tk] = ok ? wv : 0.0f;
        }
      }
      if (tk > 1) {
        // K3's winner-pinned ranking: the rest of the row, the winner at
        // kNeg, over every block's best tk
        long long* picks = wtop;   // free: every warp's list was merged
        auto all = [&](int i) {
          const int r = i / tk, j = i % tk;
          return tx ? __ldcg(tx + ((size_t)par * C + r) * tk + j)
                    : box[par][r].top[j];
        };
        warp_topk(all, C * tk, tk - 1, feasible ? host : -1, picks, lane);
        __syncwarp();
        const float half = kNeg * 0.5f;
        for (int j = 1 + lane; j < tk; j += 32) {
          const long long pick = picks[j - 1];
          const float v = select_row::key_value((int)(pick >> 31));
          const bool ok = v > half;
          a.top_nodes[(size_t)b * tk + j] = ok ? select_row::unpack_node(pick) : -1;
          a.top_scores[(size_t)b * tk + j] = ok ? v : 0.0f;
        }
      }
    }
    if (b + 1 < B) {
      if (spread_on) {
        // the next step's zone sums start at 0
        float* znext = zk <= kZoneSlots ? part[par ^ 1].zsum
                                        : zx + ((size_t)(par ^ 1) * C + me) * a.tp;
        for (int z = tid; z < zk; z += T) znext[z] = 0.f;
      }
      if (aff && feasible) {
        // the pair commits, one later pod a thread of the cluster
        const int g = me * T + tid, all = C * T;
        const int* nph = a.node_pair + (size_t)host * a.kt;
        int hp[kMaxKT];
#pragma unroll
        for (int k = 0; k < kMaxKT; ++k) hp[k] = k < a.kt ? __ldg(nph + k) : -1;
        for (int i = g; i < B; i += all)
          if (i > b) commit_pairs(a, b, hp, nph, i);
      }
    }
    if (spread_on && feasible && owner) ++len;
    cur = nxt;
    pnz0 = ahead.pnz0;
    pnz1 = ahead.pnz1;
    prio = ahead.prio;
    __syncthreads();                                    // block: commit
    K13_MARK(12);                                       // commit
  }
#ifdef K13_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_clocks[me][i] = clocks_[i];
#endif

  // the carried state back to the outputs
  if (L.node_smem)
    for (int k = 0; k < K; ++k) {
      const int ln = tid + k * T;
      if (ln >= cnt) continue;
      const int n = base + ln;
      for (int r = 0; r < R; ++r)
        a.requested_out[(size_t)n * R + r] = req[ln * sn + r * sr];
      for (int q = 0; q < 2; ++q) a.nonzero_out[2 * (size_t)n + q] = nz[ln * zn + q * zr];
    }
  // no block leaves while another may still read its shared memory
  cluster_sync();
}

cudaLaunchConfig_t launch_config(const Layout& L, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.c, 1, 1);
  cfg.blockDim = dim3(L.t, 1, 1);
  cfg.dynamicSmemBytes = (size_t)L.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of this launch the card can hold at once (0: it cannot
// place one).  The answer depends on the device, the threads and the
// shared memory alone, and is kept for each; the function's attributes
// are set once a device, and again only when a launch needs more shared
// memory than any before it.
int placeable(const Layout& L, cudaError_t* err) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, long long>, int> known;
  static std::map<int, long long> smem_set;   // by device
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, L.t, L.smem);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  const auto set = smem_set.find(dev);
  if (set == smem_set.end() || set->second < L.smem) {
    *err = cudaFuncSetAttribute(k13_seq_scan,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)L.smem);
    if (*err != cudaSuccess) return 0;
    if (set == smem_set.end() && kCluster > 8) {
      *err = cudaFuncSetAttribute(
          k13_seq_scan, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (*err != cudaSuccess) return 0;
    }
    smem_set[dev] = L.smem;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(L, nullptr, attr);
  int n = 0;
  *err = cudaOccupancyMaxActiveClusters(&n, k13_seq_scan, &cfg);
  if (*err != cudaSuccess) return 0;
  known[key] = n;
  return n;
}

#ifdef K13_TOOLS
// The floor under a step's cluster stage: `steps` cluster barriers of one
// cluster, nothing between them.
__global__ void k13_barrier_floor(int steps) {
  for (int i = 0; i < steps; ++i) cluster_sync();
}
#endif

}  // namespace

// The paths a launch at these sizes takes, chosen by size (bits): 1 the
// carried node state in shared memory (else the global workspace), 2 more
// than one node a thread, 4 the top-k lists through the workspace (tk
// past kTopSlots), 8 the zone sums through the workspace (zk zone-key
// pairs past kZoneSlots), 16 with affinity (aff) the tie words past the
// pushed partial (the select behind a cluster barrier).
extern "C" int seq_scan_paths(int n, int r, int pv, int b, int tp, int tk,
                              int zk, int aff) {
  SeqScanArgs a{};
  a.n = n;
  a.r = r;
  a.pv = pv;
  a.b = b;
  a.tp = tp;
  a.tk = tk;
  const Layout L = make_layout(a);
  return (L.node_smem ? 1 : 0) | (L.k > 1 ? 2 : 0) |
         (tk > kTopSlots ? 4 : 0) | (zk > kZoneSlots ? 8 : 0) |
         (aff && L.w > kWordSlots ? 16 : 0);
}

// The workspace bytes one launch of these arguments needs.
extern "C" long long seq_scan_workspace_size(SeqScanArgs a) {
  return make_layout(a).ws;
}

#ifdef K13_PHASE_CLOCKS
// Each block's SM clocks by phase over the last launch (blocks x kPhases
// long longs).  Returns a cudaError_t code.
extern "C" int seq_scan_phase_clocks(long long* out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                   sizeof(long long) * kPhases * blocks);
}
#endif

#ifdef K13_TOOLS
// For tools/k13_compare.py.  `steps` cluster barriers in one launch of a
// cluster of c blocks of t threads (timing only, not counted); returns a
// cudaError_t code.
extern "C" int seq_scan_barrier_floor_launch(int steps, int c, int t,
                                             cudaStream_t stream) {
  if (c > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        k13_barrier_floor, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, 1, 1);
  cfg.blockDim = dim3(t, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k13_barrier_floor, steps);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The blocks of a launch over n nodes, and its threads a block.
extern "C" int seq_scan_shape(int n, int* threads) {
  SeqScanArgs a{};
  a.n = n;
  a.r = 2;
  a.pv = 1;
  a.b = 1;
  a.tp = 1;
  const Layout L = make_layout(a);
  *threads = L.t;
  return L.c;
}
#endif

// The scan over a.b pods on `stream`: one launch of one cluster, and no
// other stream operation.  Returns a cudaError_t code;
// cudaErrorInvalidConfiguration where the card cannot place the cluster.
extern "C" int seq_scan_launch(SeqScanArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.r < 2 || a.pv <= 0 || a.tp <= 0 ||
      a.tk < 0 || a.tk > a.n || (a.tk > 0 && !a.top_nodes) || !a.work)
    return (int)cudaErrorInvalidValue;
  if (a.node_pair && (a.kt < 0 || a.pt < 0 || a.at < 0 || a.pp < 0 ||
                      !a.node_valid || !a.u_forb || !a.u_pref))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(a);
  cudaError_t err = cudaSuccess;
  const int n = placeable(L, &err);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(L, stream, attr);
  err = cudaLaunchKernelEx(&cfg, k13_seq_scan, a, L);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
