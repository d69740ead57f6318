// K11: the predicate pass of one filter, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/predicates.py filter_batch (:409), with
// every predicate it stacks and the selector evaluation _eval_exprs (:61):
// the 23 predicates of PREDICATE_ORDER over every (pod, node) pair of a
// batch.  The plain twin is kubernetes_tpu_torch/ops/predicates.py
// filter_batch_plain / predicate_stack_plain, which the kernel equals bit
// for bit.
//
// Three modes:
//   mask  (stack_mode 0): out bool[B, N] = valid[n] & pod_valid[b] & the
//         AND of every row, folded in registers; no stack is written (the
//         engines' need_per=False route);
//   stack (stack_mode 1): out bool[B, 23, N], row k = predicate k's verdict
//         (the need_per=True route; kernel K7 folds it);
//   candidates (stack_mode 2): out bool[B, N] = valid[n] & !fits &
//         !hard_fail, the nodes where preemption might help (the JAX
//         package's models/preemption.py make_preempt_eval, :144-169:
//         filter_batch, required_affinity_ok and preemption_candidates in
//         one launch).  fits: every row passes; hard_fail: a row of the
//         `unresolvable` bit mask fails, or component 3 of
//         MatchInterPodAffinity (the pod's required affinity terms alone,
//         aff_rules_ok) fails whatever the profile enables.  Pod validity
//         is not read, as in the reference.  The twin is
//         models/preemption.py preempt_eval_plain.
// A predicate the profile disables (a 0 bit in `enabled`) reads all true.
//
// The topology-pair terms (the existing pods' forbidden pairs, the
// anti-affinity and affinity terms of MatchInterPodAffinity and their
// topology keys, the volume zone and binding terms) are the reference's
// incidence products with the topology; here each is a gather over the
// node's pairs (pair_gather.cuh): the pods' pair rows bool[B, X, TP] are
// read at node_pair[n, k] for the KT topology key slots, and "the node has
// the term's key" is node_pair[n, slot] >= 0 (aff_slot: each affinity
// term's key slot).  A family the batch is lean in (its width is not TP)
// passes, as in the twin.  node_pair_build, a second kernel here, makes
// the table once a snapshot upload.
//
// Bound: operations, at the live shapes.  The inputs are the snapshot's
// node rows (a few hundred bytes a node) and the pods' rows, read once
// (about 2 MB at 6,144 nodes), and the output, 1 byte a (pod, node) in
// mask mode; the work is some tens of integer compares a (pod, node) pair
// once the walks that can only pass are skipped.  The layout (the path,
// kernels.filter_pass_paths, chosen on the host and passed in the
// arguments): a block owns a slice of nodes, `per_thread` nodes a thread
// strided by the block's threads, so that a warp reads and writes 32
// consecutive nodes; the grid is (node slices, pod tiles), a block walks a
// tile of pods over its slice: at one pod a node a thread over many
// blocks, at a batch two nodes a thread and 32 pods a block.  A thread
// reads its node's rows in place for each pod of the tile, from L1 after
// the first (a copy of the slice's resource and label rows in shared
// memory measured no faster at a batch and slower at one pod).  No
// thread-block cluster: each (pod, node) verdict stands alone, and the
// one per-pod value that needs a whole row (an affinity term's "matches
// any pair") is read 16 bytes a load by a warp.  Two prologues, each once
// a block:
//   the pod prologue (kPodParts parts of the pod's record, a warp a part
//     and a lane a pod, in flight together): the rows the pod passes on
//     every node, the rows a pair walk decides, its first requests, its
//     valid anti-affinity terms; then each valid required affinity term's
//     "matches any pair" flag (a warp a term, the whole TP-wide row in
//     16-byte loads, every load independent);
//   the node prologue (a thread a node, before its pods; the first node's
//     loads in flight beside the pod prologue's): the rows the node passes
//     for every pod (condition, pressures, label presence, and the taint,
//     port and disk walks where it has none of them), its first kPairRegs
//     pairs and, for an affinity batch, whether it lies in a pair of each
//     tile pod's forbidden pairs or valid anti-affinity terms (8 pods'
//     gathers in flight at a time).
// A pair then sets every row either side passes, leaves unset a row the
// flags fail that no walk could pass, and walks the rest: Host,
// PodFitsResources (the requests from the pod's record) and
// GeneralPredicates inline, MatchInterPodAffinity from the node
// prologue's gather and the affinity rules, every other walk out of line
// (rare_walk), so that the loop's common path stays small.  A walk is
// skipped only where its verdict is the constant it would compute on
// every input (the argument stands beside each skip below).  The stop
// rules are the parent's: in mask mode a pair stops at its first failure,
// in candidates mode at its first failing unresolvable row (the answer is
// then false) and before its walk when component 3 fails; stack mode
// walks every row.  The order of the rows does not change a verdict: mask
// mode reads "every row passes", candidates mode "some row fails and no
// unresolvable one does", stack mode every row.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>

#include "label_select.cuh"
#include "pair_gather.cuh"

namespace {

using label_select::kPad;

// the paths the kernel takes (kernels.filter_pass_paths picks within them)
constexpr int kMaxThreads = 256;
constexpr int kMaxPerThread = 4;
constexpr int kMaxTile = 64;
// kernels.K11_SMEM_BUDGET, the tile's affinity flags (dynamic shared
// memory): set as the function's limit once a device, so that they fit
// beside the static arrays (pods, sel) whatever their size
constexpr long long kSmemBudget = 48 * 1024;
constexpr int kPairRegs = 4;           // node-pair slots a thread keeps
constexpr int kResCols = 4;            // requests a pod's record keeps
constexpr int kSelRegs = 2;            // nodeSelector entries it keeps
constexpr int kPreds = 23;             // NUM_PREDICATES
constexpr uint32_t kAll = (1u << kPreds) - 1;
enum { kMaskMode = 0, kStackMode = 1, kCandidatesMode = 2 };

// PREDICATE_ORDER
enum {
  kCondition = 0, kUnschedulable, kGeneral, kHost, kHostPorts, kSelector,
  kResources, kDiskConflict, kTaints, kNoExecute, kLabelPresence,
  kServiceAffinity, kEBS, kGCE, kCSI, kAzure, kCinder, kVolumeBinding,
  kVolumeZone, kMemPressure, kPIDPressure, kDiskPressure, kInterPod
};

__host__ __device__ constexpr uint32_t bit(int k) { return 1u << k; }

// the parts of GeneralPredicates
constexpr uint32_t kGeneralParts =
    bit(kHost) | bit(kResources) | bit(kHostPorts) | bit(kSelector);
// the rows no pair walk can decide: the node's or the pod's flags do
constexpr uint32_t kFlagRows =
    bit(kCondition) | bit(kPIDPressure) | bit(kDiskPressure) |
    bit(kLabelPresence) | bit(kMemPressure) | bit(kUnschedulable);
// the rows walked out of line (rare_walk): every walked row but Host,
// PodFitsResources, GeneralPredicates and MatchInterPodAffinity
constexpr uint32_t kRareRows =
    kAll & ~kFlagRows &
    ~(bit(kHost) | bit(kResources) | bit(kGeneral) | bit(kInterPod));

// a pod's flags (the pod prologue's)
enum : uint32_t {
  kPodValid = 1u << 0, kWalkAff = 1u << 1,
  // PodMatchNodeSelector is the AND of the kSelRegs entries the tile's
  // `sel` keeps (their count in bits kSelShift up): no required node
  // affinity read, at most kSelRegs valid nodeSelector entries
  kPodSimpleSel = 1u << 2
};
constexpr int kSelShift = 8;

// With -DK11_PHASE_CLOCKS thread 0 of every block adds the SM clock spent
// between the launch's phase marks (K11_MARK) into g_phase_clocks, read
// back with filter_pass_phase_clocks (tools/k11_compare.py --phases).  Off
// by default: the marks compile to nothing.
#ifdef K11_PHASE_CLOCKS
constexpr int kPhases = 3;
__device__ unsigned long long g_phase_clocks[kPhases];
#define K11_MARK(i)                                                   \
  if (threadIdx.x == 0) {                                             \
    long long now_;                                                   \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(now_) :: "memory"); \
    clocks_[i] += now_ - then_;                                       \
    then_ = now_;                                                     \
  }
#else
#define K11_MARK(i)
#endif

}  // namespace

// The arguments of one launch, passed by value (ctypes.Structure
// FilterPassArgs in kernels/__init__.py mirrors it field for field).
// Cluster fields are [N, ...] rows, pod fields [B, ...] rows, all
// contiguous; bool tensors are one byte an element.
struct FilterPassArgs {
  // cluster
  const float* allocatable;      // [N, R]
  const float* requested;        // [N, R]
  const uint8_t* valid;          // [N]
  const uint8_t* unschedulable;  // [N]
  const uint8_t* not_ready;
  const uint8_t* mem_pressure;
  const uint8_t* disk_pressure;
  const uint8_t* pid_pressure;
  const int* node_name_id;       // [N]
  const int* label_keys;         // [N, L]
  const int* label_vals;
  const float* label_nums;
  const int* taint_key;          // [N, T]
  const int* taint_val;
  const int* taint_effect;
  const int* node_port_pp;       // [N, P]
  const int* node_port_ip;
  const uint8_t* node_port_used;
  const float* vol_counts;       // [N, VT]
  const float* vol_limits;
  const int* node_disk_ids;      // [N, DVN]
  // pods
  const uint8_t* pod_valid;      // [B]
  const float* req;              // [B, R]
  const uint8_t* best_effort;    // [B]
  const int* node_name_req;      // [B]
  const int* port_pp;            // [B, Q]
  const int* port_ip;
  const uint8_t* port_valid;
  const int* tol_key;            // [B, TT]
  const int* tol_op;
  const int* tol_val;
  const int* tol_effect;
  const uint8_t* tol_valid;
  const int* ns_keys;            // [B, NS]
  const int* ns_vals;
  const uint8_t* ns_valid;
  const uint8_t* has_req_affinity;  // [B]
  const uint8_t* term_valid;     // [B, S]
  const int* expr_key;           // [B, S, E]
  const int* expr_op;
  const int* expr_vals;          // [B, S, E, V]
  const int* expr_nval;          // [B, S, E]
  const float* expr_num;
  const uint8_t* expr_valid;
  const float* new_vol_counts;   // [B, VT]
  const float* vol_overlap;      // [B, VT, N], or null (lean)
  const int* disk_ids;           // [B, DV]
  const uint8_t* vol_fail_all;   // [B]
  const int* svc_aff_fixed;      // [B, SA]
  const int* svc_aff_d0;         // [B]
  const int* svc_aff_d1;
  const uint8_t* aff_term_pairs; // [B, PT, TP] (read when aff_on)
  const uint8_t* aff_term_valid; // [B, PT]
  const uint8_t* aff_term_self;
  const uint8_t* anti_term_valid;  // [B, AT]
  const uint8_t* vol_zone_valid;   // [B, VZ]
  const uint8_t* vol_bind_valid;   // [B, VB]
  const uint8_t* forbidden_pairs;  // [B, TP] (read when aff_on)
  const uint8_t* anti_term_pairs;  // [B, AT, TP] (read when aff_on)
  const uint8_t* vol_zone_pairs;   // [B, VZ, TP] (read when vz_on)
  const uint8_t* vol_bind_pairs;   // [B, VB, TP] (read when vb_on)
  const int* node_pair;          // [N, KT] each node's pair a key slot, or -1
  const int* aff_slot;           // [B, PT] each affinity term's key slot
  // configuration
  const float* max_vols;         // [VT] per-column default limits
  const int* presence_keys;      // [n_presence]
  const int* svc_labels;         // [n_svc]
  uint8_t* out;                  // [B, N] (mask, candidates) or [B, 23, N]
  int b, n, r, l, t, p, q, tt, ns, s, e, v, vt, dv, dvn, sa, at, pt, vz,
      vb, tp;
  int kt, aff_on, vz_on, vb_on;
  // unresolvable: the rows (bit k: predicate k) whose failure preemption
  // cannot fix, read in candidates mode
  int n_presence, presence_present, n_svc, unsched_key, enabled,
      unresolvable, stack_mode;
  // the path (kernels.filter_pass_paths): threads a block, nodes a thread,
  // pods a tile, nodes a block (threads x per_thread)
  int threads, per_thread, tile, slice;
};

namespace {

// The pod prologue's values of one pod of a tile.  pass: the rows (bit
// k: predicate k) the pod passes on every node; walk: the rows a pair
// walk decides where neither side's flags pass them (a row in neither
// fails on the flags alone).
struct PodInfo {
  uint32_t flags;
  uint32_t pass;
  uint32_t walk;
  uint32_t res;       // resource columns c < 32 the pod requests (> 0)
  uint32_t vol;       // attach-count columns c < 32 whose vol_ok it walks
  int name_req;
  float rx[kResCols]; // the requests of res's first kResCols columns
  uint32_t anti;      // its valid anti-affinity terms k < 32
};

// The node prologue's values of one node.  pass: the rows the node
// passes for every pod.
struct NodeInfo {
  bool valid;
  uint32_t pass;
  int name;
  int pairs[kPairRegs];   // node_pair[n, k] for k < min(KT, kPairRegs)
};

// Node n's label slots.
__device__ __forceinline__ label_select::Slots slots_of(
    const FilterPassArgs& a, int n) {
  const size_t o = (size_t)n * a.l;
  return {a.label_keys + o, a.label_vals + o, a.label_nums + o, a.l,
          a.node_name_id + n};
}

// The value id node_label_value gives `key` on the node of `slots`.
__device__ __forceinline__ int label_id(const label_select::Slots& slots,
                                        int key) {
  int v;
  float unused;
  label_select::slot_value(slots, key, &v, &unused);
  return v;
}

// _node_label_value: the max over every slot of its value where it holds
// `key` and PAD where not, or PAD when no slot holds it; no node-name
// field.
__device__ __forceinline__ int svc_label_value(const FilterPassArgs& a,
                                               int n, int key) {
  int v = INT_MIN;
  bool any = false;
  const int* lk = a.label_keys + (size_t)n * a.l;
  const int* lv = a.label_vals + (size_t)n * a.l;
  for (int i = 0; i < a.l; ++i) {
    const bool h = __ldg(lk + i) == key;
    any |= h;
    v = max(v, h ? __ldg(lv + i) : kPad);
  }
  return any ? v : kPad;
}

// CheckServiceAffinity with the profile's labels (n_svc > 0): each label's
// value on node n equals the pod's fixed value, or else the value on the
// node its service's first pod runs on (src) where that node has it.
__device__ __noinline__ bool service_ok(const FilterPassArgs& a, int b,
                                        int n) {
  const int d0 = __ldg(a.svc_aff_d0 + b), d1 = __ldg(a.svc_aff_d1 + b);
  const int src = d0 == n ? d1 : d0;
  bool ok = true;
  for (int k = 0; k < a.n_svc && ok; ++k) {
    const int key = __ldg(a.svc_labels + k);
    const int vn = svc_label_value(a, n, key);
    const int fixed = __ldg(a.svc_aff_fixed + (size_t)b * a.sa + k);
    if (fixed != kPad) {
      ok = vn == fixed;
    } else if (src >= 0) {
      const int vs = svc_label_value(a, src, key);
      ok = vs == kPad || vn == vs;
    }
  }
  return ok;
}

// PodMatchNodeSelector: the nodeSelector map AND the required node
// affinity (an OR of terms, each an AND of expressions; an empty term
// matches nothing)
__device__ __noinline__ bool selector_ok(const FilterPassArgs& a, int b,
                                         label_select::Slots slots) {
  for (int i = 0; i < a.ns; ++i) {
    const size_t k = (size_t)b * a.ns + i;
    if (!__ldg(a.ns_valid + k)) continue;
    int nv;
    float nn;
    label_select::slot_value(slots, __ldg(a.ns_keys + k), &nv, &nn);
    if (nv != __ldg(a.ns_vals + k)) return false;
  }
  if (a.s == 0 || !__ldg(a.has_req_affinity + b)) return true;
  const label_select::ExprRows ex{a.expr_key, a.expr_op,   a.expr_vals,
                                  a.expr_nval, a.expr_num, a.expr_valid,
                                  a.v};
  for (int s = 0; s < a.s; ++s) {
    const size_t ts = (size_t)b * a.s + s;
    if (!__ldg(a.term_valid + ts)) continue;
    bool nonempty = false, all = true;
    for (int e = 0; e < a.e; ++e) {
      const size_t i = ts * a.e + e;
      nonempty |= __ldg(a.expr_valid + i) != 0;
      if (all && !label_select::eval_expr_at(slots, ex, i)) all = false;
    }
    if (nonempty && all) return true;
  }
  return false;
}

// PodFitsResources: no column the pod requests (> 0) overflows.  A column
// with a request <= 0 or NaN passes on every node (the parent's test is
// `x > 0 && used + x > alloc`), so only the columns of the pod's `res`
// are walked below 32, the first kResCols of them with the requests its
// record keeps; the columns from 32 are tested as the parent does.
__device__ __forceinline__ bool resources_ok(const FilterPassArgs& a, int n,
                                             int b, const PodInfo& pi) {
  const float* used = a.requested + (size_t)n * a.r;
  const float* alloc = a.allocatable + (size_t)n * a.r;
  // the record's columns first, their loads in flight together
  uint32_t m = pi.res;
  bool ok = true;
#pragma unroll
  for (int i = 0; i < kResCols; ++i) {
    const int c = m ? __ffs(m) - 1 : 0;
    if (m)
      ok &= !(__fadd_rn(__ldg(used + c), pi.rx[i]) > __ldg(alloc + c));
    m &= m - 1;
  }
  if (!ok) return false;
  const float* rq = a.req + (size_t)b * a.r;
  for (; m; m &= m - 1) {
    const int c = __ffs(m) - 1;
    if (__fadd_rn(__ldg(used + c), __ldg(rq + c)) > __ldg(alloc + c))
      return false;
  }
  for (int c = 32; c < a.r; ++c) {
    const float x = __ldg(rq + c);
    if (x > 0.f && __fadd_rn(__ldg(used + c), x) > __ldg(alloc + c))
      return false;
  }
  return true;
}

__device__ __noinline__ bool ports_ok(const FilterPassArgs& a, int b,
                                      int n) {
  const int* npp = a.node_port_pp + (size_t)n * a.p;
  const int* nip = a.node_port_ip + (size_t)n * a.p;
  const uint8_t* nused = a.node_port_used + (size_t)n * a.p;
  for (int q = 0; q < a.q; ++q) {
    const size_t k = (size_t)b * a.q + q;
    if (!__ldg(a.port_valid + k)) continue;
    const int pp = __ldg(a.port_pp + k), ip = __ldg(a.port_ip + k);
    for (int p = 0; p < a.p; ++p) {
      if (!__ldg(nused + p) || __ldg(npp + p) != pp) continue;
      const int x = __ldg(nip + p);
      if (ip == x || ip == 0 || x == 0) return false;
    }
  }
  return true;
}

__device__ __noinline__ bool disk_ok(const FilterPassArgs& a, int b,
                                     int n) {
  const int* nv = a.node_disk_ids + (size_t)n * a.dvn;
  for (int d = 0; d < a.dv; ++d) {
    const int x = __ldg(a.disk_ids + (size_t)b * a.dv + d);
    if (x == kPad) continue;
    for (int k = 0; k < a.dvn; ++k)
      if (__ldg(nv + k) == x) return false;
  }
  return true;
}

// (NoSchedule/NoExecute ok, NoExecute ok) as bits 0 and 1: every
// considered taint of the node is tolerated by some toleration of the pod
// (ToleratesTaint)
__device__ __noinline__ int taints_ok(const FilterPassArgs& a, int b,
                                      int n) {
  bool sched = true, exec = true;
  for (int t = 0; t < a.t; ++t) {
    const size_t nt = (size_t)n * a.t + t;
    const int eff = __ldg(a.taint_effect + nt);
    if (eff != 0 && eff != 2) continue;
    const int key = __ldg(a.taint_key + nt), val = __ldg(a.taint_val + nt);
    bool tol = false;
    for (int j = 0; j < a.tt && !tol; ++j) {
      const size_t k = (size_t)b * a.tt + j;
      const int te = __ldg(a.tol_effect + k), tk = __ldg(a.tol_key + k);
      tol = __ldg(a.tol_valid + k) && (te == kPad || te == eff) &&
            (tk == 0 || tk == key) &&
            (__ldg(a.tol_op + k) == 1 || __ldg(a.tol_val + k) == val);
    }
    if (!tol) {
      sched = false;
      if (eff == 2) exec = false;
    }
  }
  return (sched ? 1 : 0) | (exec ? 2 : 0);
}

// min that keeps a NaN operand, as torch.minimum
__device__ __forceinline__ float min_nan(float x, float y) {
  return (isnan(x) || isnan(y)) ? NAN : fminf(x, y);
}

// one attach-count column of max_volume_counts
__device__ __noinline__ bool vol_ok(const FilterPassArgs& a, int b, int n,
                                    int c) {
  float nw = __ldg(a.new_vol_counts + (size_t)b * a.vt + c);
  if (a.vol_overlap) {
    nw = __fsub_rn(nw, __ldg(a.vol_overlap + ((size_t)b * a.vt + c) * a.n + n));
    if (nw < 0.f) nw = 0.f;
  }
  const float used = __ldg(a.vol_counts + (size_t)n * a.vt + c);
  const float lim = min_nan(__ldg(a.max_vols + c),
                            __ldg(a.vol_limits + (size_t)n * a.vt + c));
  return !(nw > 0.f && __fadd_rn(used, nw) > lim);
}

// vol_ok where the pod prologue says the column can fail (`vol`), else
// its constant true
__device__ __forceinline__ bool vol_col_ok(const FilterPassArgs& a, int b,
                                           int n, uint32_t vol, int c) {
  return (c < 32 && !((vol >> c) & 1u)) || vol_ok(a, b, n, c);
}

// Is any of the node's kPairRegs slots' pairs set in row (bool[TP])?
// Every slot's byte is read, byte 0 for a slot without a pair (its value
// unused), so that the loads wait on no branch: the form the gathers
// below unroll.  K11 writes no pair row, so they go through the
// read-only cache.
__device__ __forceinline__ bool regs_hit(const uint8_t* row,
                                         const NodeInfo& nd) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kPairRegs; ++k) {
    const int q = nd.pairs[k];
    const uint8_t v = __ldg(row + max(q, 0));
    hit |= q >= 0 && v != 0;
  }
  return hit;
}

// Is any of node n's pairs set in row (bool[TP])?  The first kPairRegs
// slots from the node prologue's registers, else the table.
__device__ __forceinline__ bool node_hit(const FilterPassArgs& a,
                                         const uint8_t* row,
                                         const NodeInfo& nd, int n) {
  if (a.kt <= kPairRegs) return regs_hit(row, nd);
  return pair_gather::any_hit(row, a.node_pair + (size_t)n * a.kt, a.kt);
}

// AND over terms of "the node is in one of the term's pairs" (an invalid
// term passes)
__device__ __noinline__ bool pair_terms_ok(const FilterPassArgs& a, int b,
                                           int n, NodeInfo nd,
                                           const uint8_t* pairs, int k_terms,
                                           const uint8_t* term_valid) {
  for (int k = 0; k < k_terms; ++k)
    if (__ldg(term_valid + (size_t)b * k_terms + k) &&
        !node_hit(a, pairs + ((size_t)b * k_terms + k) * a.tp, nd, n))
      return false;
  return true;
}

// Component 3 of MatchInterPodAffinity (the twin's required_affinity_ok):
// every valid required affinity term of the pod holds on node n.
// any_match[k]: term k matches some pair (the pod prologue's scan).
__device__ __noinline__ bool aff_rules_ok(const FilterPassArgs& a, int b,
                                          int n, NodeInfo nd,
                                          const uint8_t* any_match) {
  for (int k = 0; k < a.pt; ++k) {
    const size_t i = (size_t)b * a.pt + k;
    if (!__ldg(a.aff_term_valid + i) ||
        node_hit(a, a.aff_term_pairs + i * a.tp, nd, n))
      continue;
    // the bootstrap: no pair matches the term anywhere, the pod matches
    // it itself, and the node has the term's key
    if (!any_match[k] && __ldg(a.aff_term_self + i) &&
        pair_gather::pair_of(a.node_pair + (size_t)n * a.kt,
                             __ldg(a.aff_slot + i)) >= 0)
      continue;
    return false;
  }
  return true;
}

// Does node n lie in a pair of the pod's forbidden pairs (unless
// terms_only) or of one of its valid anti-affinity terms
// (MatchInterPodAffinity's first two components)?  anti: the valid terms
// below 32; the rest are read.
__device__ __forceinline__ bool anti_hit(const FilterPassArgs& a, int b,
                                         int n, const NodeInfo& nd,
                                         uint32_t anti, bool terms_only) {
  bool hit = !terms_only &&
             node_hit(a, a.forbidden_pairs + (size_t)b * a.tp, nd, n);
  for (uint32_t m = anti; m; m &= m - 1)
    hit |= node_hit(
        a, a.anti_term_pairs + ((size_t)b * a.at + __ffs(m) - 1) * a.tp, nd,
        n);
  for (int k = 32; k < a.at; ++k)
    hit |= __ldg(a.anti_term_valid + (size_t)b * a.at + k) &&
           node_hit(a, a.anti_term_pairs + ((size_t)b * a.at + k) * a.tp, nd,
                    n);
  return hit;
}

// Bit p: node n lies in a pair of the forbidden pairs or of a valid
// anti-affinity term of pod b0 + p, for the tile's np pods (anti_hit's
// answer).  Where the node's pairs sit in registers (KT <= kPairRegs), in
// passes whose loads wait on no branch, 8 pods at a time: every pod's
// forbidden row; the first valid term's row of each pod that has one
// (first: those pods); then the rest of the terms of the pods that have
// more (more: those pods, rare), by anti_hit.
__device__ __forceinline__ uint64_t forbidden_bits(
    const FilterPassArgs& a, const PodInfo* pods, int b0, int np,
    uint64_t first, uint64_t more, int n, const NodeInfo& nd) {
  uint64_t hit = 0;
  if (a.kt > kPairRegs) {
    for (int p = 0; p < np; ++p)
      if (anti_hit(a, b0 + p, n, nd, pods[p].anti, false)) hit |= 1ull << p;
    return hit;
  }
  for (int p0 = 0; p0 < np; p0 += 8) {
    bool h[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = min(p0 + u, np - 1);
      h[u] = regs_hit(a.forbidden_pairs + (size_t)(b0 + p) * a.tp, nd);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (h[u] && p0 + u < np) hit |= 1ull << (p0 + u);
  }
  for (uint64_t m = first; m;) {
    int ps[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ps[u] = m ? __ffsll((long long)m) - 1 : -1;
      m &= m - 1;
    }
    bool h[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = ps[u] >= 0 ? ps[u] : ps[0];
      h[u] = regs_hit(a.anti_term_pairs +
                          ((size_t)(b0 + p) * a.at + __ffs(pods[p].anti) - 1) *
                              a.tp,
                      nd);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (h[u] && ps[u] >= 0) hit |= 1ull << ps[u];
  }
  for (uint64_t m = more & ~hit; m; m &= m - 1) {
    const int p = __ffsll((long long)m) - 1;
    const uint32_t anti = pods[p].anti;
    if (anti_hit(a, b0 + p, n, nd, anti & (anti - 1), true))
      hit |= 1ull << p;
  }
  return hit;
}

// The rows of `rows` a pair walk decides beyond Host, PodFitsResources
// and MatchInterPodAffinity, in the parent's order, out of line (a small
// loop body keeps the hot path in the instruction cache): bit k of the
// result is set where row k passes; the walk returns at the first failure
// of a row in `stop`, the rows not yet walked unset.  `parts`:
// GeneralPredicates' parts it also needs (HostPorts, PodMatchNodeSelector)
// whatever `rows` holds, their failures never stopping it.
__device__ __noinline__ uint32_t rare_walk(const FilterPassArgs& a, int n,
                                           int b, PodInfo pi,
                                           NodeInfo nd,
                                           const uint8_t* any_match,
                                           uint32_t rows, uint32_t parts,
                                           uint32_t stop) {
  uint32_t w = 0;
#define K11_DO(k) ((rows >> (k)) & 1u)
#define K11_SET(k, ok)                        \
  do {                                        \
    if (ok) w |= bit(k);                      \
    else if ((stop >> (k)) & 1u) return w;    \
  } while (0)
  if (K11_DO(kEBS)) K11_SET(kEBS, vol_col_ok(a, b, n, pi.vol, 0));
  if (K11_DO(kGCE)) K11_SET(kGCE, vol_col_ok(a, b, n, pi.vol, 1));
  if (K11_DO(kCSI)) {
    // the named CSI predicate folds the generic column and every
    // per-driver column
    bool ok = vol_col_ok(a, b, n, pi.vol, 2);
    for (int c = 5; c < a.vt && ok; ++c) ok = vol_col_ok(a, b, n, pi.vol, c);
    K11_SET(kCSI, ok);
  }
  if (K11_DO(kAzure)) K11_SET(kAzure, vol_col_ok(a, b, n, pi.vol, 3));
  if (K11_DO(kCinder)) K11_SET(kCinder, vol_col_ok(a, b, n, pi.vol, 4));
  if (K11_DO(kVolumeBinding))
    K11_SET(kVolumeBinding, pair_terms_ok(a, b, n, nd, a.vol_bind_pairs,
                                          a.vb, a.vol_bind_valid));
  if (K11_DO(kVolumeZone))
    K11_SET(kVolumeZone, pair_terms_ok(a, b, n, nd, a.vol_zone_pairs, a.vz,
                                       a.vol_zone_valid));
  if (K11_DO(kHostPorts) || ((parts >> kHostPorts) & 1u)) {
    const bool ok = ports_ok(a, b, n);
    if (K11_DO(kHostPorts)) K11_SET(kHostPorts, ok);
    else if (ok) w |= bit(kHostPorts);
  }
  if (K11_DO(kDiskConflict)) K11_SET(kDiskConflict, disk_ok(a, b, n));
  if (K11_DO(kTaints) || K11_DO(kNoExecute)) {
    const int ok = taints_ok(a, b, n);
    if (K11_DO(kTaints)) K11_SET(kTaints, ok & 1);
    if (K11_DO(kNoExecute)) K11_SET(kNoExecute, ok & 2);
  }
  if (K11_DO(kServiceAffinity))
    K11_SET(kServiceAffinity, service_ok(a, b, n));
  if (K11_DO(kSelector) || ((parts >> kSelector) & 1u)) {
    const bool ok = selector_ok(a, b, slots_of(a, n));
    if (K11_DO(kSelector)) K11_SET(kSelector, ok);
    else if (ok) w |= bit(kSelector);
  }
#undef K11_SET
#undef K11_DO
  return w;
}

// The verdict bits of node n (node j of the slice) for pod b (bit k:
// predicate k passes; a row the profile disables reads true).  A row
// either side's flags pass is set without a walk; a row they fail, and
// no walk can pass, is left unset; the rest are walked.  It returns at
// the first failure of a row in `stop` (every row in mask mode, none in
// stack mode, the unresolvable rows in candidates mode), the bits of the
// rows not yet walked unset.
__device__ __forceinline__ uint32_t eval_pair(
    const FilterPassArgs& a, int n, int b, const PodInfo& pi, const int2* sel,
    const NodeInfo& nd, const uint8_t* any_match, bool forbidden,
    uint32_t stop) {
  const uint32_t en = (uint32_t)a.enabled & kAll;
  uint32_t known = nd.pass | pi.pass;
  // GeneralPredicates passes on the flags where its four parts do
  if ((known & kGeneralParts) == kGeneralParts) known |= bit(kGeneral);
  uint32_t bits = (~en | known) & kAll;
  const uint32_t open = en & ~known;
  if (open & ~pi.walk & stop) return bits;   // failed on the flags alone
  const uint32_t todo = open & pi.walk;
  if (!todo) return bits;
  const bool general = (todo >> kGeneral) & 1u;
  bool host = (known >> kHost) & 1u, res = (known >> kResources) & 1u;
  if (!host && (general || ((todo >> kHost) & 1u))) {
    host = pi.name_req == nd.name;
    if (host) bits |= (todo & bit(kHost));
    else if (todo & stop & bit(kHost)) return bits;
  }
  if (!res && (general || ((todo >> kResources) & 1u))) {
    res = resources_ok(a, n, b, pi);
    if (res) bits |= (todo & bit(kResources));
    else if (todo & stop & bit(kResources)) return bits;
  }
  if ((todo >> kInterPod) & 1u) {
    // MatchInterPodAffinity (an affinity-lean batch passes on the pod's
    // flags): `forbidden`, the node prologue's gather of the first two
    // components, then component 3
    if (!forbidden && (!(pi.flags & kWalkAff) ||
                       aff_rules_ok(a, b, n, nd, any_match)))
      bits |= bit(kInterPod);
    else if (stop & bit(kInterPod))
      return bits;
  }
  uint32_t parts = known & kGeneralParts;
  uint32_t rare = todo & kRareRows;
  uint32_t need = general ? (bit(kHostPorts) | bit(kSelector)) & ~known : 0u;
  if ((pi.flags & kPodSimpleSel) &&
      ((todo | need) & bit(kSelector))) {
    // PodMatchNodeSelector, inline: the AND of the pod's few entries
    const auto slots = slots_of(a, n);
    const int entries = (pi.flags >> kSelShift) & 3;
    bool ok = true;
#pragma unroll
    for (int i = 0; i < kSelRegs; ++i)
      if (i < entries) ok &= label_id(slots, sel[i].x) == sel[i].y;
    if (ok) {
      bits |= todo & bit(kSelector);
      parts |= bit(kSelector);
    } else if (todo & stop & bit(kSelector)) {
      return bits;
    }
    rare &= ~bit(kSelector);
    need &= ~bit(kSelector);
  }
  if (rare | need) {
    const uint32_t w =
        rare_walk(a, n, b, pi, nd, any_match, rare, need, stop);
    bits |= w & rare;
    if (rare & ~w & stop) return bits;
    parts |= w & need;
  }
  if (general) {
    if (host && res && (parts & bit(kHostPorts)) && (parts & bit(kSelector)))
      bits |= bit(kGeneral);
  }
  return bits;
}

// The pod prologue is kPodParts parts, a warp a part for 32 pods of the
// tile (a lane a pod), the parts in flight together; each ORs its rows
// into the pod's record (zeroed before).  Each pass bit stands on the
// argument beside it: the walk it skips would compute that constant.
constexpr int kPodParts = 4;

__device__ void pod_part(const FilterPassArgs& a, int b, int part,
                         PodInfo* pi, int2* sel) {
  uint32_t f = 0, pass = 0, walk = 0;
  if (part == 0) {
    if (__ldg(a.pod_valid + b)) f |= kPodValid;
    // CheckNodeMemoryPressure fails only a best-effort pod
    if (!__ldg(a.best_effort + b)) pass |= bit(kMemPressure);
    // PodFitsHost: PAD asks for no node
    pi->name_req = __ldg(a.node_name_req + b);
    if (pi->name_req == kPad) pass |= bit(kHost);
    else walk |= bit(kHost);
    // CheckNodeUnschedulable: a toleration of the unschedulable taint;
    // taints: with no valid toleration every considered taint is
    // untolerated, so the node's flags decide (a fail where it has one)
    bool tols = false, unsched = false;
#pragma unroll 4
    for (int j = 0; j < a.tt; ++j) {
      const size_t k = (size_t)b * a.tt + j;
      const int te = __ldg(a.tol_effect + k), tk = __ldg(a.tol_key + k);
      const bool valid = __ldg(a.tol_valid + k) != 0;
      tols |= valid;
      unsched |= valid && (te == kPad || te == 0) &&
                 (tk == 0 || tk == a.unsched_key) &&
                 (__ldg(a.tol_op + k) == 1 || __ldg(a.tol_val + k) == 0);
    }
    if (unsched) pass |= bit(kUnschedulable);
    if (tols) walk |= bit(kTaints) | bit(kNoExecute);
    walk |= bit(kGeneral);
  } else if (part == 1) {
    // PodFitsResources: a column with a request <= 0 or NaN passes
    const float* rq = a.req + (size_t)b * a.r;
    uint32_t res = 0;
    int i = 0;
#pragma unroll 4
    for (int c = 0; c < a.r && c < 32; ++c) {
      const float x = __ldg(rq + c);
      if (x > 0.f) {
        res |= 1u << c;
        if (i < kResCols) pi->rx[i++] = x;
      }
    }
    pi->res = res;
    if (res == 0 && a.r <= 32) pass |= bit(kResources);
    else walk |= bit(kResources);
    // vol_ok fails only where the pod's count nw is > 0: with the overlap
    // lean, a count <= 0 or NaN passes on every node; with the overlap,
    // only a NaN count does (NaN - x is NaN, and an overlap < 0 could
    // lift a count <= 0 above 0)
    uint32_t vol = 0;
#pragma unroll 4
    for (int c = 0; c < a.vt && c < 32; ++c) {
      const float nw = __ldg(a.new_vol_counts + (size_t)b * a.vt + c);
      if (a.vol_overlap ? !isnan(nw) : nw > 0.f) vol |= 1u << c;
    }
    pi->vol = vol;
    const int cols[4] = {kEBS, kGCE, kAzure, kCinder};
    const int col_of[4] = {0, 1, 3, 4};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((vol >> col_of[k]) & 1u) walk |= bit(cols[k]);
      else pass |= bit(cols[k]);
    // the CSI row folds column 2 and every per-driver column from 5
    if ((vol & ~0x1bu) == 0 && a.vt <= 32) pass |= bit(kCSI);
    else walk |= bit(kCSI);
  } else if (part == 2) {
    // a lean pair family, or no valid term of it: the walk skips every
    // term; CheckVolumeBinding fails everywhere where vol_fail_all
    bool any = false;
    for (int k = 0; a.vb_on && k < a.vb; ++k)
      any |= __ldg(a.vol_bind_valid + (size_t)b * a.vb + k) != 0;
    if (!__ldg(a.vol_fail_all + b))
      (any ? walk : pass) |= bit(kVolumeBinding);
    any = false;
    for (int k = 0; a.vz_on && k < a.vz; ++k)
      any |= __ldg(a.vol_zone_valid + (size_t)b * a.vz + k) != 0;
    (any ? walk : pass) |= bit(kVolumeZone);
    // PodFitsHostPorts: every invalid port is skipped
    any = false;
#pragma unroll 4
    for (int q = 0; q < a.q; ++q)
      any |= __ldg(a.port_valid + (size_t)b * a.q + q) != 0;
    (any ? walk : pass) |= bit(kHostPorts);
    // NoDiskConflict: a PAD disk id is skipped
    any = false;
#pragma unroll 4
    for (int d = 0; d < a.dv; ++d)
      any |= __ldg(a.disk_ids + (size_t)b * a.dv + d) != kPad;
    (any ? walk : pass) |= bit(kDiskConflict);
    // CheckServiceAffinity without the profile's labels passes
    (a.n_svc == 0 ? pass : walk) |= bit(kServiceAffinity);
  } else {
    // PodMatchNodeSelector: no valid nodeSelector entry and no required
    // node affinity read passes; a few entries and no required affinity
    // are kept for the pair's inline test
    const bool req = a.s > 0 && __ldg(a.has_req_affinity + b);
    int entries = 0;
#pragma unroll 4
    for (int i = 0; i < a.ns; ++i) {
      const size_t k = (size_t)b * a.ns + i;
      if (!__ldg(a.ns_valid + k)) continue;
      if (entries < kSelRegs)
        sel[entries] = make_int2(__ldg(a.ns_keys + k), __ldg(a.ns_vals + k));
      ++entries;
    }
    (req || entries ? walk : pass) |= bit(kSelector);
    if (!req && entries && entries <= kSelRegs)
      f |= kPodSimpleSel | (uint32_t)entries << kSelShift;
    // MatchInterPodAffinity: an affinity-lean batch passes
    if (a.aff_on) {
      walk |= bit(kInterPod);
      uint32_t anti = 0;
      for (int k = 0; k < a.at && k < 32; ++k)
        if (__ldg(a.anti_term_valid + (size_t)b * a.at + k)) anti |= 1u << k;
      pi->anti = anti;
      for (int k = 0; k < a.pt; ++k)
        if (__ldg(a.aff_term_valid + (size_t)b * a.pt + k)) f |= kWalkAff;
    } else {
      pass |= bit(kInterPod);
    }
  }
  if (f) atomicOr(&pi->flags, f);
  if (pass) atomicOr(&pi->pass, pass);
  if (walk) atomicOr(&pi->walk, walk);
}

// The node prologue of node n: its validity, the rows it passes for every
// pod, its name and its first node-pair slots.
__device__ NodeInfo node_info(const FilterPassArgs& a, int n) {
  NodeInfo nd;
  uint32_t pass = 0;
  nd.valid = __ldg(a.valid + n) != 0;
  // the node-only rows
  if (!__ldg(a.not_ready + n)) pass |= bit(kCondition);
  if (!__ldg(a.mem_pressure + n)) pass |= bit(kMemPressure);
  if (!__ldg(a.disk_pressure + n)) pass |= bit(kDiskPressure);
  if (!__ldg(a.pid_pressure + n)) pass |= bit(kPIDPressure);
  if (!__ldg(a.unschedulable + n)) pass |= bit(kUnschedulable);
  // taints: the walk skips every taint but NoSchedule (0) and NoExecute
  // (2), and the NoExecute row fails only on an untolerated 2
  bool sched = false, exec = false;
  for (int t = 0; t < a.t; ++t) {
    const int eff = __ldg(a.taint_effect + (size_t)n * a.t + t);
    sched |= eff == 0 || eff == 2;
    exec |= eff == 2;
  }
  if (!sched) pass |= bit(kTaints);
  if (!exec) pass |= bit(kNoExecute);
  // ports: the walk skips every unused node port
  bool any = false;
  for (int p = 0; p < a.p; ++p)
    any |= __ldg(a.node_port_used + (size_t)n * a.p + p) != 0;
  if (!any) pass |= bit(kHostPorts);
  // disks: a PAD node disk id never equals the pod's (non-PAD) id
  any = false;
  for (int k = 0; k < a.dvn; ++k)
    any |= __ldg(a.node_disk_ids + (size_t)n * a.dvn + k) != kPad;
  if (!any) pass |= bit(kDiskConflict);
  // CheckNodeLabelPresence reads the node alone
  bool ok = true;
  const int* lk = a.label_keys + (size_t)n * a.l;
  for (int i = 0; i < a.n_presence && ok; ++i) {
    const int key = __ldg(a.presence_keys + i);
    bool present = false;
    for (int k = 0; k < a.l; ++k) present |= __ldg(lk + k) == key;
    ok = present == (a.presence_present != 0);
  }
  if (ok) pass |= bit(kLabelPresence);
  nd.pass = pass;
  nd.name = __ldg(a.node_name_id + n);
#pragma unroll
  for (int k = 0; k < kPairRegs; ++k)
    nd.pairs[k] = k < a.kt && a.kt <= kPairRegs
                      ? __ldg(a.node_pair + (size_t)n * a.kt + k)
                      : -1;
  return nd;
}

// Is any byte of row (bool[tp]) set?  A warp's lanes read it 16 bytes a
// load where it is 16-byte aligned, every load independent of the last.
__device__ __forceinline__ bool row_any(const uint8_t* row, int tp,
                                        int lane) {
  bool any = false;
  int i0 = 0;
  if (((uintptr_t)row & 15) == 0) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const int n16 = tp >> 4;
    for (int q = lane; q < n16; q += 32) {
      const uint4 v = __ldg(r4 + q);
      any |= (v.x | v.y | v.z | v.w) != 0;
    }
    i0 = n16 << 4;
  }
  for (int i = i0 + lane; i < tp; i += 32) any |= __ldg(row + i) != 0;
  return __any_sync(0xffffffffu, any);
}

__global__ void __launch_bounds__(kMaxThreads) k11_filter_pass(
    const __grid_constant__ FilterPassArgs a) {
  extern __shared__ uint8_t any_match[];     // [tile, PT] when aff_on
  __shared__ PodInfo pods[kMaxTile];
  __shared__ int2 sel[kMaxTile][kSelRegs];   // nodeSelector (key, value)
#ifdef K11_PHASE_CLOCKS
  long long clocks_[kPhases] = {};
  long long then_;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(then_) :: "memory");
#endif
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  const long long tile = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long b0 = tile * a.tile;
  // past the last tile (the grid's rounding)
  if (b0 >= a.b) return;
  const int np = (int)min((long long)a.tile, (long long)a.b - b0);
  const long long n0 = (long long)blockIdx.x * a.slice;
  const int cnt = (int)min((long long)a.slice, (long long)a.n - n0);
  // the pod prologue: a warp a part of 32 pods; then each valid affinity
  // term's "matches any pair" flag, a warp a term over the whole TP-wide
  // row (an invalid term's flag is never read)
  for (int p = tid; p < np; p += T) pods[p] = PodInfo{};
  // the node prologue of the thread's first node, its loads in flight
  // beside the pod prologue's
  NodeInfo first;
  if (tid < cnt) first = node_info(a, (int)(n0 + tid));
  __syncthreads();
  for (int it = warp; it < kPodParts * ((np + 31) >> 5); it += warps) {
    const int p = (it / kPodParts) * 32 + lane;
    if (p < np)
      pod_part(a, (int)(b0 + p), it % kPodParts, &pods[p], sel[p]);
  }
  if (a.aff_on) {
    for (int r = warp; r < np * a.pt; r += warps) {
      const size_t i = (size_t)b0 * a.pt + r;
      if (!__ldg(a.aff_term_valid + i)) continue;
      const bool any = row_any(a.aff_term_pairs + i * a.tp, a.tp, lane);
      if (lane == 0) any_match[r] = any;
    }
  }
  __syncthreads();
  K11_MARK(0);                                        // the pod prologue
  // the tile's pods with a valid anti-affinity term below 32, and those
  // with more than one (or with terms past 32)
  uint64_t first_anti = 0, more_anti = 0;
  for (int p = 0; a.aff_on && p < np; ++p) {
    const uint32_t anti = pods[p].anti;
    if (anti) first_anti |= 1ull << p;
    if ((anti & (anti - 1)) || a.at > 32) more_anti |= 1ull << p;
  }
  const int mode = a.stack_mode;
  const uint32_t unres = (uint32_t)a.unresolvable & kAll;
  const uint32_t stop = mode == kMaskMode ? kAll
                        : mode == kCandidatesMode ? unres : 0u;
  for (int q = 0; q < a.per_thread; ++q) {
    const int j = tid + q * T;
    if (j >= cnt) break;
    const int n = (int)(n0 + j);
    const NodeInfo nd = q == 0 ? first : node_info(a, n);
    const bool valid = nd.valid;
    // bit p: node n lies in a pair of pod p's forbidden pairs or of a
    // valid anti-affinity term
    const uint64_t forbidden =
        a.aff_on ? forbidden_bits(a, pods, (int)b0, np, first_anti,
                                  more_anti, n, nd)
                 : 0;
    K11_MARK(1);                                      // the node prologue
    for (int p = 0; p < np; ++p) {
      const PodInfo pi = pods[p];
      const int b = (int)(b0 + p);
      const uint8_t* am = any_match + (size_t)p * a.pt;
      // mask: a valid node and pod, every row passes; candidates: a valid
      // node whose required affinity rules hold (a failure there is
      // unresolvable), the pod's validity unread, some row failing and no
      // unresolvable one (an early return leaves its bit unset); stack:
      // every node's rows
      const bool alive =
          mode == kStackMode ||
          (valid && (mode == kMaskMode ? (pi.flags & kPodValid) != 0
                                       : !(pi.flags & kWalkAff) ||
                                             aff_rules_ok(a, b, n, nd, am)));
      const uint32_t bits =
          alive ? eval_pair(a, n, b, pi, sel[p], nd, am,
                            (forbidden >> p) & 1u, stop)
                : 0u;
      if (mode == kStackMode) {
        uint8_t* o = a.out + (size_t)b * kPreds * a.n + n;
#pragma unroll
        for (int k = 0; k < kPreds; ++k) o[(size_t)k * a.n] = (bits >> k) & 1u;
      } else {
        a.out[(size_t)b * a.n + n] =
            alive && (mode == kMaskMode
                          ? bits == kAll
                          : bits != kAll && (bits & unres) == unres);
      }
    }
    K11_MARK(2);                                      // the walk, the writes
  }
#ifdef K11_PHASE_CLOCKS
  if (threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i)
      atomicAdd(&g_phase_clocks[i], (unsigned long long)clocks_[i]);
#endif
}

// The dynamic shared memory of a launch: the tile's any_match flags.
long long smem_bytes(const FilterPassArgs& a) {
  return a.aff_on ? (long long)a.tile * a.pt : 0;
}

// Is the path in `a` one the kernel takes?
bool layout_ok(const FilterPassArgs& a) {
  return a.threads >= 32 && a.threads <= kMaxThreads &&
         a.threads % 32 == 0 && a.per_thread >= 1 &&
         a.per_thread <= kMaxPerThread &&
         (long long)a.slice == (long long)a.threads * a.per_thread &&
         a.tile >= 1 && a.tile <= kMaxTile && smem_bytes(a) <= kSmemBudget;
}

// The function's dynamic shared-memory limit, kSmemBudget, set once a
// device: the default 48 KB counts the static arrays too, which would
// refuse a tile's flags near the budget.  Setting an attribute is no
// stream operation, so a launch inside a graph capture may do it.
cudaError_t smem_limit_set() {
  static std::mutex mu;
  static std::set<int> done;   // devices
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  if (done.count(dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(k11_filter_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBudget);
  if (err == cudaSuccess) done.insert(dev);
  return err;
}

}  // namespace

#ifdef K11_PHASE_CLOCKS
// The phases' names, in the order of filter_pass_phase_clocks.
extern "C" const char* filter_pass_phase_names() {
  return "pod prologue,node prologue,walk and writes";
}

// Zero the phase clocks (before the launch they are to time).
extern "C" int filter_pass_phase_reset() {
  static const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
}

// The SM clocks by phase, summed over every block of the launches since
// the reset (kPhases unsigned long longs).
extern "C" int filter_pass_phase_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                   sizeof(unsigned long long) * kPhases);
}
#endif

// One filter pass: the arguments above, on `stream`, in the mode
// stack_mode names, on the path the arguments carry: one launch of
// ceil(n / slice) x ceil(b / tile) blocks of `threads` threads, and no
// other stream operation.  Returns a cudaError_t code.
extern "C" int filter_pass_launch(FilterPassArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.pt < 0 || a.stack_mode < kMaskMode ||
      a.stack_mode > kCandidatesMode || !a.out || !layout_ok(a))
    return (int)cudaErrorInvalidValue;
  if ((a.aff_on || a.vz_on || a.vb_on) && (!a.node_pair || a.kt < 0))
    return (int)cudaErrorInvalidValue;
  const long long slices = ((long long)a.n + a.slice - 1) / a.slice;
  const long long tiles = ((long long)a.b + a.tile - 1) / a.tile;
  const long long gy = tiles < 65535 ? tiles : 65535;
  const long long gz = (tiles + gy - 1) / gy;
  if (slices > INT_MAX || gz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)slices, (unsigned)gy, (unsigned)gz);
  const cudaError_t err = smem_limit_set();
  if (err != cudaSuccess) return (int)err;
  k11_filter_pass<<<grid, a.threads, (size_t)smem_bytes(a), stream>>>(a);
  return (int)cudaGetLastError();
}

namespace {

// node_pair[n, slot[p]] := p for every pair p node n lies in, -1 for a
// slot it has no pair of (topo bool[N, TP]; slot i32[TP] the pair's
// topology key slot, -1 for an unused pair).  The snapshot layer checked
// on the host that a node lies in at most one pair of each key and in no
// pair without a key (ops/predicates.py check_node_pairs), so each entry
// has one writer.  One warp a node: its lanes fill the node's row with -1,
// then walk the node's topology row, 16 bytes a lane a step when the rows
// are 16-byte aligned.
__global__ void node_pair_build_kernel(const uint8_t* __restrict__ topo,
                                       const int* __restrict__ slot, int n,
                                       int tp, int kt, int vec,
                                       int* __restrict__ table) {
  const long long node =
      (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (node >= n) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* row = topo + (size_t)node * tp;
  int* out = table + (size_t)node * kt;
  for (int k = lane; k < kt; k += 32) out[k] = -1;
  __syncwarp();
  if (vec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int q = lane; q < tp / 16; q += 32) {
      const uint4 v = __ldg(row4 + q);
      if (!(v.x | v.y | v.z | v.w)) continue;
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
      for (int i = 0; i < 16; ++i)
        if (b[i]) {
          const int p = q * 16 + i, s = __ldg(slot + p);
          if (s >= 0) out[s] = p;
        }
    }
    return;
  }
  for (int p = lane; p < tp; p += 32) {
    if (!__ldg(row + p)) continue;
    const int s = __ldg(slot + p);
    if (s >= 0) out[s] = p;
  }
}

}  // namespace

// The node-pair table of one snapshot on `stream`, written whole: one
// kernel launch and no other stream operation.  Returns a cudaError_t
// code.
extern "C" int node_pair_build_launch(const uint8_t* topo, const int* slot,
                                      int n, int tp, int kt, int* table,
                                      cudaStream_t stream) {
  if (n <= 0 || tp <= 0 || kt <= 0) return (int)cudaErrorInvalidValue;
  const int warps = 8;
  const long long blocks = ((long long)n + warps - 1) / warps;
  const int vec = tp % 16 == 0 && (uintptr_t)topo % 16 == 0;
  node_pair_build_kernel<<<(unsigned)blocks, warps * 32, 0, stream>>>(
      topo, slot, n, tp, kt, vec, table);
  return (int)cudaGetLastError();
}
