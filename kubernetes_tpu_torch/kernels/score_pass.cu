// K12: the priorities of one score pass, for Hopper (sm_90a), in one launch
// of thread-block clusters.
//
// Replaces the JAX package's ops/priorities.py score_batch (:370) with
// every priority it computes: the 12 priorities of PRIORITY_ORDER over
// every (pod, node) pair of a batch, each normalized per pod over the
// node axis, and their weighted total.  The plain twin is
// kubernetes_tpu_torch/ops/priorities.py score_batch_plain, which the
// kernel equals bit for bit.
//
// Bound: operations at a batch of pods (some hundred compares and a few
// dozen f32 operations a (pod, node), the node rows read once, the total
// written once, 4 bytes a pair, 52 with need_per); at one pod, latency:
// the per-pod normalizations make two dependent walks over the nodes.
//
// The design (the path by size: kernels/__init__.py score_pass_paths,
// which the caller passes in the arguments):
//   * a cluster of kCluster blocks spreads the node axis: block r owns the
//     contiguous slice [r * slice, (r + 1) * slice), per_thread nodes a
//     thread (one at one pod, so one pod's nodes spread over 16 SMs); each
//     cluster scores a tile of `tile` pods, so at a batch of pods a node's
//     values serve the whole tile (node-outer, pod-inner loops);
//   * a node prologue loads, once a node for the whole tile and with its
//     loads issued together, what the node's rows give every pod: its
//     allocatable and nonzero requests, its zone, NodeLabel's score, and
//     whether it is valid, has a PreferNoSchedule taint, an image or an
//     avoided owner; a node without one of the last three skips that
//     priority's walk for every pod (the walk would add only +0);
//   * pass 1 keeps what the normalizations need in the block's arrays,
//     one value a (pod, node of the slice): NodeAffinity's matched-weight
//     sums, SelectorSpread's matching-pod counts and InterPodAffinity's
//     raw sums (the pod's preferred pair weights over the node's pairs, in
//     pair_gather::sum's order, the node's pairs read once for the tile;
//     NaN on an invalid node, which fminf / fmaxf skip),
//     and adds each count into the pod's zone partial (shared-memory
//     atomics; the counts are integers, so the sums are exact in any order
//     below 2^24).  A node's zone is its pair of the zone key in the
//     snapshot's node-pair table, node_pair[n, zslot] (a node lies in at
//     most one pair a key), at that pair's index among the zone key's
//     pairs (pair_rank): no launch of its own;
//   * the block folds each pod's maxima (NodeAffinity, TaintToleration's
//     intolerable PreferNoSchedule counts, counted here and again in pass
//     2 on the few nodes with such a taint, SelectorSpread, over every
//     column, padding included, as the reference's amax) and the IPA
//     sums' min and max over the valid nodes, a warp a pod; it pushes
//     them, and its zone partials, with st.async into every block's inbox
//     (distributed shared memory, counted on the receiver's mbarrier: no
//     cluster barrier's GPU-wide fence, no remote read); then every block
//     folds the inbox, a block's partials a lane of a half warp and the
//     fold by shuffles (the zone sums in the same integer order-free
//     way), and takes the zone maximum itself;
//   * pass 2 normalizes, computes the per-node priorities and writes the
//     weighted total, summed in PRIORITY_ORDER as the twin's need_per=False
//     loop does, and with need_per the f32[B, 12, N] rows.
// A priority whose row is off (zero weight, and no per rows asked for or
// skip_zero_weight) is neither computed nor added; its per row reads 0.
// Where a block's arrays pass kSmemBudget bytes (a large slice or many
// zone pairs), they live in the global workspace, a (cluster, block)
// region each, and the peers read the zone partials from L2 behind a
// cluster barrier: no N, TP or B is refused.
//
// The arithmetic follows the twin operation for operation, each rounding
// written out (__fadd_rn, __fmul_rn, __fdiv_rn) so that nvcc contracts
// nothing: the SelectorSpread blend is the one fused multiply-add the
// compiled reference emits (__fmaf_rn with the twin's fma_f32 operands),
// ImageLocality multiplies by the folded reciprocal, the division of the
// integer normalizations is IEEE (the build has no --use_fast_math), and
// RequestedToCapacityRatio's interpolation ends in the reference's fused
// multiply-add.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "label_select.cuh"
#include "pair_gather.cuh"
#include "priority_math.cuh"

namespace {

using label_select::kPad;
using prio_math::fdiv_floor;
using prio_math::kMaxPriority;

// the blocks of a cluster: 16 (kernels.K12_CLUSTER); tools/k12_compare.py
// builds another size (-DK12_CLUSTER=8) to time beside it
#ifndef K12_CLUSTER
#define K12_CLUSTER 16
#endif
constexpr int kCluster = K12_CLUSTER;
static_assert(kCluster >= 1 && kCluster <= 16, "K12_CLUSTER: 1 to 16");
constexpr int kMaxThreads = 512;    // kernels.K12_MAX_THREADS
// blocks of kMaxThreads an SM the compiler plans registers for (2: 64
// registers a thread); tools/k12_compare.py --variants times others
#ifndef K12_MIN_BLOCKS
#define K12_MIN_BLOCKS 2
#endif
constexpr int kMaxTile = 32;        // kernels.K12_MAX_TILE
constexpr int kLanes = 16;          // a cluster's partials, a half warp
constexpr int kPairRegs = 4;        // node-pair slots a thread keeps at hand
constexpr int kPodGroups = 8;       // a pod's spread groups kept in smem
static_assert(kCluster <= kLanes, "a half warp folds the cluster");
constexpr long long kSmemBudget = 200 * 1024;   // kernels.K12_SMEM_BUDGET
constexpr int kPrios = 12;          // NUM_PRIORITIES
constexpr float kBig = 3.4e38f;     // InterPodAffinity's masked extremes
constexpr float kImgMin = 23.f * 1024 * 1024;
constexpr float kImgMax = 1000.f * 1024 * 1024;

// PRIORITY_ORDER
enum {
  kSpread = 0, kInterPod, kLeast, kBalanced, kAvoid, kNodeAffinity,
  kTaint, kImage, kMost, kNodeLabel, kRtc, kLimits
};

// a pod's per-block values: the maxima, the IPA extremes, whether any
// node lies in a zone; and the cluster's zone maximum
enum { kMxNa = 0, kMxTt, kMxSp, kMnIpa, kMxIpa, kHaveZ, kMxZone, kParts };

// With -DK12_PHASE_CLOCKS thread 0 of every block adds the SM clock spent
// between the launch's phase marks (K12_MARK) into g_phase_clocks by its
// rank in the cluster, read back with score_pass_phase_clocks
// (tools/k12_compare.py --phases).  Off by default: the marks compile to
// nothing.
#ifdef K12_PHASE_CLOCKS
constexpr int kPhases = 10;
__device__ unsigned long long g_phase_clocks[kCluster][kPhases];
#define K12_MARK(i)                                                   \
  if (threadIdx.x == 0) {                                             \
    long long now_;                                                   \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(now_) :: "memory"); \
    clocks_[i] += now_ - then_;                                       \
    then_ = now_;                                                     \
  }
#else
#define K12_MARK(i)
#endif

}  // namespace

// The arguments of one launch, passed by value (ctypes.Structure
// ScorePassArgs in kernels/__init__.py mirrors it field for field).
struct ScorePassArgs {
  // cluster
  const float* allocatable;     // [N, R]
  const float* node_nonzero;    // [N, 2]
  const uint8_t* valid;         // [N]
  const int* label_keys;        // [N, L]
  const int* label_vals;
  const float* label_nums;
  const int* node_name_id;      // [N]
  const int* taint_key;         // [N, T]
  const int* taint_val;
  const int* taint_effect;
  const int* image_id;          // [N, I]
  const float* image_size;
  const int* avoid_owner;       // [N, A]
  const float* group_counts;    // [N, G]
  // pods
  const float* pod_nonzero;     // [B, 2]
  const float* limits2;         // [B, 2]
  const int* owner_uid;         // [B]
  const int* tol_key;           // [B, TT]
  const int* tol_op;
  const int* tol_val;
  const int* tol_effect;
  const uint8_t* tol_valid;
  const float* pref_weight;     // [B, PS]
  const uint8_t* pref_term_valid;
  const int* pref_expr_key;     // [B, PS, E]
  const int* pref_expr_op;
  const int* pref_expr_vals;    // [B, PS, E, V]
  const int* pref_expr_nval;
  const float* pref_expr_num;
  const uint8_t* pref_expr_valid;
  const int* group_ids;         // [B, GP]
  const uint8_t* group_valid;
  const float* spread_counts;   // [B, N], or null (spread-lean batch)
  const int* image_ids;         // [B, C]
  // the snapshot's node-pair table (ops/predicates.py NodePairs)
  const int* node_pair;         // [N, KT] each node's pair a key slot, or -1
  const int* pair_rank;         // [TP] each pair's index among its key's
  const float* ipa_w;           // [B, TP] the pods' preferred pair weights,
                                // or null (affinity-lean batch, row off)
  // configuration
  const int* prefs_key;         // [n_prefs] NodeLabelPriority
  const int* prefs_presence;
  const float* prefs_weight;
  const float* rtc_xs;          // [n_rtc] RequestedToCapacityRatio curve
  const float* rtc_ys;
  float* work;                  // [tiles, cluster, region] when not smem_mode
  float* total;                 // [B, N]
  float* per;                   // [B, 12, N], or null
  float w[kPrios];
  int b, n, r, l, t, tt, i, c, a, g, gp, ps, e, v, tp, kt;
  int n_prefs, n_rtc, rows;
  int zslot;                    // the zone key's slot, or -1 (no zones)
  int zones;                    // the zone key's pairs (0 with zslot -1)
  // the path (score_pass_paths): blocks a cluster, threads a block, nodes
  // a thread, pods a cluster, nodes a block; the arrays in shared memory
  // or the workspace, a block's floats and each array's offset (-1: off)
  int cluster, threads, per_thread, tile, slice, smem_mode, region, inbox;
  int node_off, na_off, sp_off, ipa_off, zp_off, zt_off;
};

namespace {

__device__ __forceinline__ bool row_on(const ScorePassArgs& a, int k) {
  return (a.rows >> k) & 1;
}

// NodeAffinity's sum of the weights of the preferred terms the node
// matches
__device__ float node_affinity_sum(const ScorePassArgs& a, int b, int n) {
  const label_select::LabelRows lr{a.label_keys, a.label_vals, a.label_nums,
                                   a.node_name_id, a.l};
  const label_select::ExprRows ex{a.pref_expr_key,  a.pref_expr_op,
                                  a.pref_expr_vals, a.pref_expr_nval,
                                  a.pref_expr_num,  a.pref_expr_valid, a.v};
  float sum = 0.f;
  for (int s = 0; s < a.ps; ++s) {
    const size_t ts = (size_t)b * a.ps + s;
    bool ok = __ldg(a.pref_term_valid + ts) != 0;
    for (int e = 0; e < a.e && ok; ++e)
      ok = label_select::eval_expr(lr, ex, n, ts * a.e + e);
    sum = __fadd_rn(sum, ok ? __ldg(a.pref_weight + ts) : 0.f);
  }
  return sum;
}

// TaintToleration's count of the node's PreferNoSchedule taints no
// toleration of the pod tolerates
__device__ float intolerable(const ScorePassArgs& a, int b, int n) {
  float count = 0.f;
  for (int t = 0; t < a.t; ++t) {
    const size_t nt = (size_t)n * a.t + t;
    if (__ldg(a.taint_effect + nt) != 1) continue;
    const int key = __ldg(a.taint_key + nt), val = __ldg(a.taint_val + nt);
    bool tol = false;
    for (int j = 0; j < a.tt && !tol; ++j) {
      const size_t k = (size_t)b * a.tt + j;
      const int te = __ldg(a.tol_effect + k), tk = __ldg(a.tol_key + k);
      tol = __ldg(a.tol_valid + k) && (te == kPad || te == 1) &&
            (tk == 0 || tk == key) &&
            (__ldg(a.tol_op + k) == 1 || __ldg(a.tol_val + k) == val);
    }
    if (!tol) count = __fadd_rn(count, 1.f);
  }
  return count;
}

// SelectorSpread's matching-pod count: the shipped row, or for a
// spread-lean batch the pod's one-hot groups times the snapshot's group
// columns (integers: exact in any order)
__device__ __forceinline__ float spread_count(const ScorePassArgs& a, int b,
                                              int n) {
  if (a.spread_counts) return __ldg(a.spread_counts + (size_t)b * a.n + n);
  float c = 0.f;
#pragma unroll 4
  for (int j = 0; j < a.gp; ++j) {
    const size_t k = (size_t)b * a.gp + j;
    const int g = __ldg(a.group_ids + k);
    if (__ldg(a.group_valid + k) && g >= 0 && g < a.g)
      c = __fadd_rn(c, __ldg(a.group_counts + (size_t)n * a.g + g));
  }
  return c;
}

// Node n's zone: the index, among the zone key's pairs, of its pair of
// that key (the twin's zone_layout argmax), or -1
__device__ __forceinline__ int zone_index(const ScorePassArgs& a, int n) {
  const int p =
      pair_gather::pair_of(a.node_pair + (size_t)n * a.kt, a.zslot);
  return p >= 0 ? __ldg(a.pair_rank + p) : -1;
}

// InterPodAffinity's raw sum of pod b on node n: its preferred pair
// weights over the node's pairs
__device__ __forceinline__ float ipa_raw(const ScorePassArgs& a, int b,
                                         int n) {
  return pair_gather::sum(a.ipa_w + (size_t)b * a.tp,
                          a.node_pair + (size_t)n * a.kt, a.kt);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---- the cluster

__device__ __forceinline__ int cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// Every block's writes before the barrier seen by every block after it
// (its release fences memory GPU-wide, its acquire invalidates L1): only
// where the zone partials lie in the global workspace.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A split barrier's arrival: at the start, once this block's mbarrier is
// initialised (its wait comes before the first push); after the pushes,
// as the exit guard (its wait comes before the block leaves, so no block
// leaves while a push may still be on its way to it or from it).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The exchange: each block pushes its partials with st.async into the
// same place of every block's inbox, each store counted on the receiver's
// mbarrier, which completes when all its bytes have landed (no barrier's
// GPU-wide fence, no L1 invalidated, no remote read).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* m) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(m))
               : "memory");
}

// this block's one arrival, with the bytes the phase waits for
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
__device__ __forceinline__ void push_async(const void* field, float v,
                                           int rank, const uint64_t* m) {
  uint32_t ra, rm;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(smem_addr(field)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rm) : "r"(smem_addr(m)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(ra),
      "r"(__float_as_uint(v)), "r"(rm)
      : "memory");
}

// A node's pod-independent values, kept in the block's arrays by the
// node prologue (one slot a node of the slice)
enum { kNdCap0 = 0, kNdCap1, kNdNz0, kNdNz1, kNdLabel, kNdZone, kNdFlags,
       kNdArrays };
// kNdFlags' bits: valid, a PreferNoSchedule taint, an image, an avoided
// owner
enum { kFlagValid = 1, kFlagPrefTaint = 2, kFlagImages = 4,
       kFlagAvoid = 8 };

__global__ void __launch_bounds__(kMaxThreads, K12_MIN_BLOCKS)
    k12_score_pass(
    const ScorePassArgs a) {
  extern __shared__ __align__(16) float smem[];   // inbox, [region]
  __shared__ float part[kMaxTile][kParts];   // this block's, pushed to all
  __shared__ float fin[kMaxTile][kParts];    // the cluster's
  __shared__ uint64_t mbar;                  // the inbox's bytes
  __shared__ float pod_s[kMaxTile][4];       // nonzero cpu, mem; limits
  __shared__ int owner_s[kMaxTile];
  __shared__ int pod_img[kMaxTile];          // the pod names an image
  __shared__ int pod_g[kMaxTile][kPodGroups];  // its spread groups, or -1
#ifdef K12_PHASE_CLOCKS
  long long clocks_[kPhases] = {};
  long long then_;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(then_) :: "memory");
#endif
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  const int rank = cta_rank();
  const long long tile = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long b0 = tile * a.tile;
  // past the last tile (the grid's rounding): the whole cluster leaves
  if (b0 >= a.b) return;
  const int np = (int)min((long long)a.tile, (long long)a.b - b0);
  const int S = a.slice, Z = a.zones;
  const int base = rank * S;
  const int cnt = max(0, min(S, a.n - base));
  // the inbox: [block, pod, word] the blocks' partials, each pod's
  // kMxZone values and, with its zone partials in shared memory, its Z
  const bool zone_push = a.smem_mode;
  const int kin = kMxZone + (zone_push ? a.zones : 0);
  float* inbox = smem;
  float* reg = a.smem_mode
                   ? smem + a.inbox
                   : a.work + ((size_t)tile * kCluster + rank) * a.region;
  if (tid == 0) {
    mbar_init(&mbar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const bool on_spread = row_on(a, kSpread);
  const bool on_ipa = row_on(a, kInterPod) && a.ipa_w;
  const bool on_na = row_on(a, kNodeAffinity) && a.ps > 0;
  const bool on_tt = row_on(a, kTaint);
  const bool zones = on_spread && Z > 0;
  float* nd = reg + a.node_off;    // [kNdArrays, slice] node prologue
  int* nd_zone = (int*)(nd + kNdZone * S);
  int* nd_flags = (int*)(nd + kNdFlags * S);
  float* na = reg + a.na_off;      // [tile, slice] each, where on
  float* sp = reg + a.sp_off;
  float* ip = reg + a.ipa_off;
  float* zp = reg + a.zp_off;      // [tile, Z] zone partials, pushed
  float* zt = reg + a.zt_off;      // [tile, Z] the cluster's zone sums
  if (zones)
    for (int k = tid; k < np * Z; k += T) zp[k] = 0.f;
  // the tile's pods, a warp a pod, its loads side by side
  for (int p = warp; p < np; p += warps) {
    const size_t b = (size_t)(b0 + p);
    if (lane < 2) pod_s[p][lane] = __ldg(a.pod_nonzero + 2 * b + lane);
    else if (lane < 4) pod_s[p][lane] = __ldg(a.limits2 + 2 * b + lane - 2);
    else if (lane == 4) owner_s[p] = __ldg(a.owner_uid + b);
    int img = 0;
    for (int c = lane; c < a.c; c += 32)
      img |= __ldg(a.image_ids + b * a.c + c) != kPad;
    img = __any_sync(0xffffffffu, img);
    if (lane == 0) pod_img[p] = img;
    if (lane < kPodGroups && lane < a.gp) {
      const size_t k = b * a.gp + lane;
      const int g = __ldg(a.group_ids + k);
      pod_g[p][lane] = __ldg(a.group_valid + k) && g >= 0 && g < a.g ? g : -1;
    }
  }
  // the node prologue: what a node's rows give every pod of the tile,
  // its loads issued together
  int in_zone = 0, pref_taint = 0;
  for (int k = 0; k < a.per_thread; ++k) {
    const int ln = tid + k * T;
    if (ln >= cnt) break;
    const int n = base + ln;
    nd[kNdCap0 * S + ln] = __ldg(a.allocatable + (size_t)n * a.r);
    nd[kNdCap1 * S + ln] = __ldg(a.allocatable + (size_t)n * a.r + 1);
    nd[kNdNz0 * S + ln] = __ldg(a.node_nonzero + 2 * (size_t)n);
    nd[kNdNz1 * S + ln] = __ldg(a.node_nonzero + 2 * (size_t)n + 1);
    const int z = zones ? zone_index(a, n) : -1;
    nd_zone[ln] = z;
    in_zone |= z >= 0;
    int flags = __ldg(a.valid + n) ? kFlagValid : 0;
#pragma unroll 4
    for (int t = 0; t < a.t; ++t)
      if (__ldg(a.taint_effect + (size_t)n * a.t + t) == 1)
        flags |= kFlagPrefTaint;
#pragma unroll 4
    for (int j = 0; j < a.i; ++j)
      if (__ldg(a.image_id + (size_t)n * a.i + j) != kPad)
        flags |= kFlagImages;
#pragma unroll 2
    for (int j = 0; j < a.a; ++j)
      if (__ldg(a.avoid_owner + (size_t)n * a.a + j) != kPad)
        flags |= kFlagAvoid;
    nd_flags[ln] = flags;
    pref_taint |= flags & kFlagPrefTaint;
    float label_score = 0.f;   // NodeLabel: the node's alone
    if (row_on(a, kNodeLabel)) {
      const int* lk = a.label_keys + (size_t)n * a.l;
      for (int q = 0; q < a.n_prefs; ++q) {
        const int key = __ldg(a.prefs_key + q);
        bool present = false;
        for (int j = 0; j < a.l; ++j) present |= __ldg(lk + j) == key;
        const float v = present == (__ldg(a.prefs_presence + q) != 0)
                            ? kMaxPriority
                            : 0.f;
        label_score =
            __fadd_rn(label_score, __fmul_rn(__ldg(a.prefs_weight + q), v));
      }
    }
    nd[kNdLabel * S + ln] = label_score;
  }
  cluster_arrive();   // this block's mbarrier is ready for the pushes
  // whether a node of the slice has a PreferNoSchedule taint
  const int slice_taints = __syncthreads_or(pref_taint);
  K12_MARK(0);                                        // start

  // pass 1, a priority at a time, each node's row serving the tile
  if (on_na)
    for (int k = 0; k < a.per_thread; ++k) {
      const int ln = tid + k * T;
      if (ln >= cnt) break;
      for (int p = 0; p < np; ++p)
        na[p * S + ln] = node_affinity_sum(a, (int)(b0 + p), base + ln);
    }
  K12_MARK(1);                                        // NodeAffinity
  if (on_spread)
    for (int k = 0; k < a.per_thread; ++k) {
      const int ln = tid + k * T;
      if (ln >= cnt) break;
      const int n = base + ln;
      const int z = nd_zone[ln];
      for (int p = 0; p < np; ++p) {
        // the shipped row, or the pod's groups (kept in shared memory up
        // to kPodGroups, in spread_count's order) over the node's columns
        float c = 0.f;
        if (a.spread_counts || a.gp > kPodGroups) {
          c = spread_count(a, (int)(b0 + p), n);
        } else {
          const float* gc = a.group_counts + (size_t)n * a.g;
          for (int j = 0; j < a.gp; ++j) {
            const int g = pod_g[p][j];
            if (g >= 0) c = __fadd_rn(c, __ldg(gc + g));
          }
        }
        sp[p * S + ln] = c;
        if (z >= 0) atomicAdd(zp + p * Z + z, c);
      }
    }
  K12_MARK(2);                                        // SelectorSpread
  if (on_ipa)
    for (int k = 0; k < a.per_thread; ++k) {
      const int ln = tid + k * T;
      if (ln >= cnt) break;
      const int n = base + ln;
      if (!(nd_flags[ln] & kFlagValid)) {
        for (int p = 0; p < np; ++p) ip[p * S + ln] = NAN;
        continue;
      }
      if (a.kt > kPairRegs) {
        for (int p = 0; p < np; ++p)
          ip[p * S + ln] = ipa_raw(a, (int)(b0 + p), n);
        continue;
      }
      // the node's pairs once, then each pod's weights at them: the
      // pair_gather::sum of every pod, in slot order
      int pr[kPairRegs];
#pragma unroll
      for (int j = 0; j < kPairRegs; ++j)
        pr[j] = j < a.kt ? __ldg(a.node_pair + (size_t)n * a.kt + j) : -1;
      for (int p = 0; p < np; ++p) {
        const float* row = a.ipa_w + (size_t)(b0 + p) * a.tp;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kPairRegs; ++j)
          if (pr[j] >= 0) s = __fadd_rn(s, __ldg(row + pr[j]));
        ip[p * S + ln] = s;
      }
    }
  K12_MARK(3);                                        // InterPodAffinity
  const int have_zone = __syncthreads_or(in_zone);
  K12_MARK(4);                                        // pass 1's barrier

  // the block's partials, a warp a pod; with no array on and no taint to
  // count, a slice's TaintToleration maximum is 0 (no node: the identity)
  const bool walk = on_na || on_spread || on_ipa || (on_tt && slice_taints);
  for (int p = warp; p < np; p += warps) {
    float mna = -INFINITY, mtt = -INFINITY, msp = -INFINITY;
    float mn = kBig, mx = -kBig;
    if (on_tt && !slice_taints && cnt > 0) mtt = 0.f;
    for (int ln = lane; walk && ln < cnt; ln += 32) {
      if (on_na) mna = fmaxf(mna, na[p * S + ln]);
      // TaintToleration's counts, here alone: a node without a
      // PreferNoSchedule taint counts none for any pod
      if (on_tt && slice_taints)
        mtt = fmaxf(mtt, nd_flags[ln] & kFlagPrefTaint
                             ? intolerable(a, (int)(b0 + p), base + ln)
                             : 0.f);
      if (on_spread) msp = fmaxf(msp, sp[p * S + ln]);
      if (on_ipa) {
        const float s = ip[p * S + ln];
        mn = fminf(mn, s);
        mx = fmaxf(mx, s);
      }
    }
    mna = warp_max(mna);
    mtt = warp_max(mtt);
    msp = warp_max(msp);
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      part[p][kMxNa] = mna;
      part[p][kMxTt] = mtt;
      part[p][kMxSp] = msp;
      part[p][kMnIpa] = mn;
      part[p][kMxIpa] = mx;
      part[p][kHaveZ] = have_zone ? 1.f : 0.f;
    }
  }
  __syncthreads();    // the block's partials and zone partials complete
  K12_MARK(5);                                        // block partials

  // the exchange: every block's partials pushed into every block's inbox
  if (tid == 0) mbar_expect(&mbar, (uint32_t)(kCluster * np * kin * 4));
  cluster_wait();     // every block's mbarrier is ready
  {
    const int words = np * kin;
    for (int i = tid; i < kCluster * words; i += T) {
      const int q = i / words, r = i - q * words, p = r / kin, f = r - p * kin;
      push_async(inbox + (rank * a.tile + p) * kin + f,
                 f < kMxZone ? part[p][f] : zp[p * Z + f - kMxZone], q,
                 &mbar);
    }
  }
  // zone partials in the workspace: written before this barrier, read
  // from L2 after it
  if (zones && !zone_push) cluster_sync();
  cluster_arrive();   // the exit guard's arrival
  mbar_wait(&mbar, 0);
  K12_MARK(6);                                        // cluster exchange

  // the cluster's values, a warp a pod, a block's partials a lane (half a
  // warp each, lane q & 15 reading block q's from the inbox): maxima,
  // minima and the zone sums (integers: exact in any order) folded by
  // shuffles; the zone maximum over the twin's TP columns (0 where a pair
  // is not the zone key's)
  const int q = lane & (kLanes - 1), half = lane / kLanes;
  for (int p = warp; p < np; p += warps) {
    if (half == 0) {
      float v[kMxZone];
#pragma unroll
      for (int f = 0; f < kMxZone; ++f)
        v[f] = q < kCluster ? inbox[(q * a.tile + p) * kin + f]
                            : (f == kMnIpa ? kBig : -INFINITY);
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
        for (int f = 0; f < kMxZone; ++f) {
          const float y = __shfl_xor_sync(0x0000ffffu, v[f], o, kLanes);
          v[f] = f == kMnIpa ? fminf(v[f], y) : fmaxf(v[f], y);
        }
      if (q == 0)
#pragma unroll
        for (int f = 0; f < kMxZone; ++f) fin[p][f] = v[f];
    }
    if (zones) {
      float mz = Z < a.tp ? 0.f : -INFINITY;
      for (int z0 = 0; z0 < Z; z0 += 2) {
        const int z = z0 + half;
        const int at = p * Z + z;
        float s = 0.f;
        if (z < Z && q < kCluster)
          s = zone_push ? inbox[(q * a.tile + p) * kin + kMxZone + z]
                        : __ldcg(a.work +
                                 ((size_t)tile * kCluster + q) * a.region +
                                 a.zp_off + at);
        for (int o = kLanes / 2; o > 0; o >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o, kLanes));
        if (z < Z) {
          if (q == 0) zt[at] = s;
          mz = fmaxf(mz, s);
        }
      }
      mz = fmaxf(mz, __shfl_xor_sync(0xffffffffu, mz, kLanes));
      if (lane == 0) fin[p][kMxZone] = mz;
    }
  }
  __syncthreads();
  K12_MARK(7);                                        // cluster fold

  // pass 2, a node's values serving the tile
  const bool on_least = row_on(a, kLeast), on_most = row_on(a, kMost);
  // 10 / (MAX - MIN), the reference's folded ImageLocality factor
  const float img_scale =
      __fmul_rn(__fdiv_rn(1.f, kImgMax - kImgMin), kMaxPriority);
  for (int k = 0; k < a.per_thread; ++k) {
    const int ln = tid + k * T;
    if (ln >= cnt) break;
    const int n = base + ln;
    const float cap[2] = {nd[kNdCap0 * S + ln], nd[kNdCap1 * S + ln]};
    const float nz0 = nd[kNdNz0 * S + ln], nz1 = nd[kNdNz1 * S + ln];
    const float label_score = nd[kNdLabel * S + ln];
    const int z = nd_zone[ln], flags = nd_flags[ln];
    const bool ok = on_ipa && (flags & kFlagValid);
    for (int p = 0; p < np; ++p) {
      const size_t b = (size_t)(b0 + p);
      const float* f = fin[p];
      float sc[kPrios];
#pragma unroll
      for (int j = 0; j < kPrios; ++j) sc[j] = 0.f;
      const float rq[2] = {__fadd_rn(pod_s[p][0], nz0),
                           __fadd_rn(pod_s[p][1], nz1)};
      if (on_spread)
        sc[kSpread] = prio_math::spread(
            f[kMxSp], sp[p * S + ln], f[kHaveZ] != 0.f && z >= 0,
            f[kMxZone], z >= 0 ? zt[p * Z + z] : 0.f);
      if (ok) {
        const float ipa_spread = __fsub_rn(f[kMxIpa], f[kMnIpa]);
        sc[kInterPod] =
            ipa_spread > 0.f
                ? fdiv_floor(__fmul_rn(kMaxPriority,
                                       __fsub_rn(ip[p * S + ln], f[kMnIpa])),
                             ipa_spread)
                : 0.f;
      }
      if (on_least)
        sc[kLeast] = prio_math::half_floor(prio_math::least_sum(cap, rq));
      if (on_most)
        sc[kMost] = prio_math::half_floor(prio_math::most_sum(cap, rq));
      if (row_on(a, kBalanced)) sc[kBalanced] = prio_math::balanced(cap, rq);
      if (row_on(a, kAvoid)) {
        // a node with no avoided owner avoids no pod
        bool avoid = false;
        const int owner = owner_s[p];
        if ((flags & kFlagAvoid) && owner != kPad)
          for (int j = 0; j < a.a; ++j)
            avoid |= owner == __ldg(a.avoid_owner + (size_t)n * a.a + j);
        sc[kAvoid] = avoid ? 0.f : kMaxPriority;
      }
      if (on_na)
        sc[kNodeAffinity] =
            f[kMxNa] > 0.f
                ? fdiv_floor(__fmul_rn(kMaxPriority, na[p * S + ln]),
                             f[kMxNa])
                : 0.f;
      if (on_tt) {
        sc[kTaint] = kMaxPriority;
        if (f[kMxTt] > 0.f) {
          const float c = flags & kFlagPrefTaint
                              ? intolerable(a, (int)b, n)
                              : 0.f;
          sc[kTaint] = __fsub_rn(
              kMaxPriority,
              fdiv_floor(__fmul_rn(kMaxPriority, c), f[kMxTt]));
        }
      }
      if (row_on(a, kImage)) {
        // the matched sizes; a PAD image on either side matches nothing,
        // and skipping its +0 keeps every sum (all >= +0) bit for bit
        float summed = 0.f;
        if ((flags & kFlagImages) && pod_img[p])
          for (int c = 0; c < a.c; ++c) {
            const int pid = __ldg(a.image_ids + b * a.c + c);
            if (pid == kPad) continue;
            float inner = 0.f;
            for (int j = 0; j < a.i; ++j) {
              const size_t nk = (size_t)n * a.i + j;
              if (pid == __ldg(a.image_id + nk))
                inner = __fadd_rn(inner, __ldg(a.image_size + nk));
            }
            summed = __fadd_rn(summed, inner);
          }
        // 10 * (s - MIN) / (MAX - MIN) with the reference's folded
        // factor; 0 at or below MIN
        const float clamped = fminf(fmaxf(summed, kImgMin), kImgMax);
        sc[kImage] =
            floorf(__fmul_rn(__fsub_rn(clamped, kImgMin), img_scale));
      }
      if (row_on(a, kNodeLabel)) sc[kNodeLabel] = label_score;
      if (row_on(a, kRtc))
        sc[kRtc] = prio_math::rtc(a.rtc_xs, a.rtc_ys, a.n_rtc, cap, rq);
      if (row_on(a, kLimits)) {
        const float lim0 = pod_s[p][2], lim1 = pod_s[p][3];
        const bool fits = (lim0 == 0.f || cap[0] >= lim0) &&
                          (lim1 == 0.f || cap[1] >= lim1);
        sc[kLimits] = fits && (lim0 > 0.f || lim1 > 0.f) ? 1.f : 0.f;
      }
      float total = 0.f;
#pragma unroll
      for (int j = 0; j < kPrios; ++j)
        if (a.w[j] != 0.f) total = __fadd_rn(total, __fmul_rn(a.w[j], sc[j]));
      a.total[b * a.n + n] = total;
      if (a.per) {
#pragma unroll
        for (int j = 0; j < kPrios; ++j)
          a.per[(b * kPrios + j) * a.n + n] = sc[j];
      }
    }
  }
  K12_MARK(8);                                        // pass 2
  cluster_wait();
  K12_MARK(9);                                        // the exit guard
#ifdef K12_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i)
      atomicAdd(&g_phase_clocks[rank][i], (unsigned long long)clocks_[i]);
#endif
}

// Does the path in `a` hold its arrays where it says, within its region?
bool layout_ok(const ScorePassArgs& a) {
  if (a.cluster != kCluster || a.threads < 32 || a.threads > kMaxThreads ||
      a.threads % 32 || a.per_thread < 1 || a.tile < 1 ||
      a.tile > kMaxTile || a.slice < 1 ||
      (long long)a.threads * a.per_thread < a.slice ||
      (long long)a.slice * kCluster < a.n || a.region < 0)
    return false;
  const long long rows = (long long)a.tile * a.slice;
  if (a.node_off < 0 ||
      a.node_off + (long long)kNdArrays * a.slice > a.region)
    return false;
  const bool spread = (a.rows >> kSpread) & 1;
  const bool zones = spread && a.zones > 0;
  const bool on[3] = {((a.rows >> kNodeAffinity) & 1) && a.ps > 0, spread,
                      ((a.rows >> kInterPod) & 1) && a.ipa_w};
  const int off[3] = {a.na_off, a.sp_off, a.ipa_off};
  for (int k = 0; k < 3; ++k)
    if (on[k] && (off[k] < 0 || off[k] + rows > a.region)) return false;
  if (zones && (a.zp_off < 0 || a.zt_off < 0 ||
                a.zp_off + (long long)a.tile * a.zones > a.region ||
                a.zt_off + (long long)a.tile * a.zones > a.region))
    return false;
  const long long kin = kMxZone + (a.smem_mode && zones ? a.zones : 0);
  if (a.inbox != kCluster * a.tile * kin) return false;
  return a.smem_mode ? ((long long)a.region + a.inbox) * 4 <= kSmemBudget
                     : (a.work != nullptr || a.region == 0);
}

cudaLaunchConfig_t launch_config(const ScorePassArgs& a, dim3 grid,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(a.threads, 1, 1);
  cfg.dynamicSmemBytes =
      ((size_t)a.inbox + (a.smem_mode ? (size_t)a.region : 0)) * sizeof(float);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of this launch the card can hold at once (0: it cannot
// place one), kept by device, threads and shared memory; the function's
// attributes (the shared-memory budget, the non-portable cluster size)
// are set once a device.
int placeable(const ScorePassArgs& a, cudaError_t* err) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, long long>, int> known;
  static std::map<int, bool> attributes_set;   // by device
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  const long long smem =
      ((long long)a.inbox + (a.smem_mode ? a.region : 0)) * 4;
  std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, a.threads, smem);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  if (!attributes_set[dev]) {
    *err = cudaFuncSetAttribute(k12_score_pass,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmemBudget);
    if (*err != cudaSuccess) return 0;
    if (kCluster > 8) {
      *err = cudaFuncSetAttribute(
          k12_score_pass, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (*err != cudaSuccess) return 0;
    }
    attributes_set[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(a, dim3(kCluster, 1, 1),
                                               nullptr, attr);
  int n = 0;
  *err = cudaOccupancyMaxActiveClusters(&n, k12_score_pass, &cfg);
  if (*err != cudaSuccess) return 0;
  known[key] = n;
  return n;
}

}  // namespace

#ifdef K12_PHASE_CLOCKS
// The phases' names, in the order of score_pass_phase_clocks.
extern "C" const char* score_pass_phase_names() {
  return "start,pass 1 NodeAffinity,pass 1 SelectorSpread,"
         "pass 1 InterPodAffinity,pass 1 barrier,"
         "block partials (TaintToleration's counts),cluster exchange,"
         "cluster fold,pass 2,exit guard";
}

extern "C" int score_pass_phase_count() { return kPhases; }

// Zero the phase clocks (before the launch they are to time).
extern "C" int score_pass_phase_reset() {
  static const unsigned long long zero[kCluster][kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
}

// The SM clocks by block rank and phase, summed over every cluster of the
// launches since the reset (kCluster x kPhases unsigned long longs).
extern "C" int score_pass_phase_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                   sizeof(unsigned long long) * kCluster *
                                       kPhases);
}
#endif

// The blocks of a cluster this build launches (kernels.K12_CLUSTER).
extern "C" int score_pass_cluster() { return kCluster; }

// The clusters of a launch with these arguments the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t code.
extern "C" int score_pass_active_clusters(ScorePassArgs a) {
  cudaError_t err = cudaSuccess;
  const int n = placeable(a, &err);
  return err != cudaSuccess ? -(int)err : n;
}

// One score pass on `stream`: one launch of ceil(b / tile) clusters of
// kCluster blocks, and no other stream operation.  Returns a cudaError_t
// code; cudaErrorInvalidConfiguration where the card cannot place a
// cluster.
extern "C" int score_pass_launch(ScorePassArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.tp <= 0 || a.kt <= 0 || !a.node_pair ||
      !a.pair_rank || !a.total || a.zslot >= a.kt || a.zones < 0 ||
      (a.zslot >= 0) != (a.zones > 0) || !layout_ok(a))
    return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)a.b + a.tile - 1) / a.tile;
  const long long gy = tiles < 65535 ? tiles : 65535;
  const long long gz = (tiles + gy - 1) / gy;
  if (gz > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int n = placeable(a, &err);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(
      a, dim3(kCluster, (unsigned)gy, (unsigned)gz), stream, attr);
  err = cudaLaunchKernelEx(&cfg, k12_score_pass, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
