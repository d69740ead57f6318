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
// mask mode; the work is some hundred integer compares a (pod, node) pair
// (label lookups over L slots, tolerations x taints, ports x ports).  So
// the design keeps everything in registers: the grid is (B, node tiles),
// a thread owns 4 consecutive nodes of one pod, walks the predicates and
// keeps the verdict bits of each node in one register word.  The pod's row
// is read through the read-only cache: every thread of a block reads the
// same words, one broadcast transaction each; the per-pod values the
// whole block needs (whether a toleration covers the unschedulable taint,
// whether each affinity term matches any pair) are reduced once a block
// into shared memory.  In mask mode a node stops at its first failure, in
// candidates mode at its first failing unresolvable row (the answer is
// then false) and before its walk when component 3 fails.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "label_select.cuh"
#include "pair_gather.cuh"

namespace {

using label_select::kPad;

constexpr int kThreads = 128;
constexpr int kNodesPerThread = 4;
constexpr int kPreds = 23;          // NUM_PREDICATES
constexpr uint32_t kAll = (1u << kPreds) - 1;
enum { kMaskMode = 0, kStackMode = 1, kCandidatesMode = 2 };

// PREDICATE_ORDER
enum {
  kCondition = 0, kUnschedulable, kGeneral, kHost, kHostPorts, kSelector,
  kResources, kDiskConflict, kTaints, kNoExecute, kLabelPresence,
  kServiceAffinity, kEBS, kGCE, kCSI, kAzure, kCinder, kVolumeBinding,
  kVolumeZone, kMemPressure, kPIDPressure, kDiskPressure, kInterPod
};

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
      unresolvable, stack_mode, vec;
};

namespace {

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

// PodMatchNodeSelector: the nodeSelector map AND the required node
// affinity (an OR of terms, each an AND of expressions; an empty term
// matches nothing)
__device__ bool selector_ok(const FilterPassArgs& a, int b, int n) {
  const label_select::LabelRows lr{a.label_keys, a.label_vals, a.label_nums,
                                   a.node_name_id, a.l};
  for (int i = 0; i < a.ns; ++i) {
    const size_t k = (size_t)b * a.ns + i;
    if (!__ldg(a.ns_valid + k)) continue;
    int nv;
    float nn;
    label_select::label_value(lr, n, __ldg(a.ns_keys + k), &nv, &nn);
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
      if (all && !label_select::eval_expr(lr, ex, n, i)) all = false;
    }
    if (nonempty && all) return true;
  }
  return false;
}

__device__ __forceinline__ bool resources_ok(const FilterPassArgs& a, int b,
                                             int n) {
  const float* rq = a.req + (size_t)b * a.r;
  const float* used = a.requested + (size_t)n * a.r;
  const float* alloc = a.allocatable + (size_t)n * a.r;
  for (int i = 0; i < a.r; ++i) {
    const float x = __ldg(rq + i);
    if (x > 0.f && __fadd_rn(__ldg(used + i), x) > __ldg(alloc + i))
      return false;
  }
  return true;
}

__device__ __forceinline__ bool ports_ok(const FilterPassArgs& a, int b,
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

__device__ __forceinline__ bool disk_ok(const FilterPassArgs& a, int b,
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

// (NoSchedule/NoExecute ok, NoExecute ok): every considered taint of the
// node is tolerated by some toleration of the pod (ToleratesTaint)
__device__ __forceinline__ void taints_ok(const FilterPassArgs& a, int b,
                                          int n, bool* sched, bool* exec) {
  *sched = true;
  *exec = true;
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
      *sched = false;
      if (eff == 2) *exec = false;
    }
  }
}

// min that keeps a NaN operand, as torch.minimum
__device__ __forceinline__ float min_nan(float x, float y) {
  return (isnan(x) || isnan(y)) ? NAN : fminf(x, y);
}

// one attach-count column of max_volume_counts
__device__ __forceinline__ bool vol_ok(const FilterPassArgs& a, int b, int n,
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

// AND over terms of "the node is in one of the term's pairs" (an invalid
// term passes); a lean batch (!on) passes
__device__ __forceinline__ bool pair_terms_ok(const FilterPassArgs& a, int b,
                                              int n, bool on,
                                              const uint8_t* pairs,
                                              int k_terms,
                                              const uint8_t* term_valid) {
  if (!on) return true;
  const int* np = a.node_pair + (size_t)n * a.kt;
  for (int k = 0; k < k_terms; ++k)
    if (__ldg(term_valid + (size_t)b * k_terms + k) &&
        !pair_gather::any_hit(pairs + ((size_t)b * k_terms + k) * a.tp, np,
                              a.kt))
      return false;
  return true;
}

// Component 3 of MatchInterPodAffinity (the twin's required_affinity_ok):
// every valid required affinity term of the pod holds on node n; an
// affinity-lean batch passes.  any_match[k]: term k matches some pair
// (the block's scan).
__device__ bool aff_rules_ok(const FilterPassArgs& a, int b, int n,
                             const uint8_t* any_match) {
  if (!a.aff_on) return true;
  const int* np = a.node_pair + (size_t)n * a.kt;
  for (int k = 0; k < a.pt; ++k) {
    const size_t i = (size_t)b * a.pt + k;
    if (!__ldg(a.aff_term_valid + i) ||
        pair_gather::any_hit(a.aff_term_pairs + i * a.tp, np, a.kt))
      continue;
    // the bootstrap: no pair matches the term anywhere, the pod matches
    // it itself, and the node has the term's key
    if (!any_match[k] && __ldg(a.aff_term_self + i) &&
        pair_gather::pair_of(np, __ldg(a.aff_slot + i)) >= 0)
      continue;
    return false;
  }
  return true;
}

// MatchInterPodAffinity: the existing pods' anti-affinity (forbidden
// pairs), the pod's own anti-affinity terms, then component 3
__device__ bool inter_pod_ok(const FilterPassArgs& a, int b, int n,
                             const uint8_t* any_match) {
  if (!a.aff_on) return true;
  const int* np = a.node_pair + (size_t)n * a.kt;
  if (pair_gather::any_hit(a.forbidden_pairs + (size_t)b * a.tp, np, a.kt))
    return false;
  for (int k = 0; k < a.at; ++k)
    if (__ldg(a.anti_term_valid + (size_t)b * a.at + k) &&
        pair_gather::any_hit(
            a.anti_term_pairs + ((size_t)b * a.at + k) * a.tp, np, a.kt))
      return false;
  return aff_rules_ok(a, b, n, any_match);
}

// The verdict bits of node n for pod b (bit k: predicate k passes).  It
// returns at the first failure of a row in `stop` (every row in mask mode,
// none in stack mode, the unresolvable rows in candidates mode), the bits
// of the rows not yet walked unset.
__device__ uint32_t eval_node(const FilterPassArgs& a, int b, int n,
                              bool tol_unsched, const uint8_t* any_match,
                              uint32_t stop) {
  const uint32_t en = (uint32_t)a.enabled;
  uint32_t bits = ~en & kAll;
#define K11_ON(k) ((en >> (k)) & 1u)
#define K11_SET(k, ok)                        \
  do {                                        \
    if (ok) bits |= 1u << (k);                \
    else if ((stop >> (k)) & 1u) return bits; \
  } while (0)
  // node-only and per-pod flags first: the cheap rows
  if (K11_ON(kCondition)) K11_SET(kCondition, !__ldg(a.not_ready + n));
  if (K11_ON(kMemPressure))
    K11_SET(kMemPressure,
            !(__ldg(a.best_effort + b) && __ldg(a.mem_pressure + n)));
  if (K11_ON(kPIDPressure)) K11_SET(kPIDPressure, !__ldg(a.pid_pressure + n));
  if (K11_ON(kDiskPressure))
    K11_SET(kDiskPressure, !__ldg(a.disk_pressure + n));
  if (K11_ON(kUnschedulable))
    K11_SET(kUnschedulable, !(__ldg(a.unschedulable + n) && !tol_unsched));
  const bool general = K11_ON(kGeneral);
  bool host = true, res = true, ports = true, sel = true;
  if (general || K11_ON(kHost)) {
    const int want = __ldg(a.node_name_req + b);
    host = want == kPad || want == __ldg(a.node_name_id + n);
    if (K11_ON(kHost)) K11_SET(kHost, host);
  }
  if (general || K11_ON(kResources)) {
    res = resources_ok(a, b, n);
    if (K11_ON(kResources)) K11_SET(kResources, res);
  }
  if (K11_ON(kEBS)) K11_SET(kEBS, vol_ok(a, b, n, 0));
  if (K11_ON(kGCE)) K11_SET(kGCE, vol_ok(a, b, n, 1));
  if (K11_ON(kCSI)) {
    // the named CSI predicate folds the generic column and every
    // per-driver column
    bool ok = vol_ok(a, b, n, 2);
    for (int c = 5; c < a.vt && ok; ++c) ok = vol_ok(a, b, n, c);
    K11_SET(kCSI, ok);
  }
  if (K11_ON(kAzure)) K11_SET(kAzure, vol_ok(a, b, n, 3));
  if (K11_ON(kCinder)) K11_SET(kCinder, vol_ok(a, b, n, 4));
  if (K11_ON(kVolumeBinding))
    K11_SET(kVolumeBinding,
            !__ldg(a.vol_fail_all + b) &&
                pair_terms_ok(a, b, n, a.vb_on, a.vol_bind_pairs, a.vb,
                              a.vol_bind_valid));
  if (K11_ON(kVolumeZone))
    K11_SET(kVolumeZone,
            pair_terms_ok(a, b, n, a.vz_on, a.vol_zone_pairs, a.vz,
                          a.vol_zone_valid));
  if (general || K11_ON(kHostPorts)) {
    ports = ports_ok(a, b, n);
    if (K11_ON(kHostPorts)) K11_SET(kHostPorts, ports);
  }
  if (K11_ON(kDiskConflict)) K11_SET(kDiskConflict, disk_ok(a, b, n));
  if (K11_ON(kTaints) || K11_ON(kNoExecute)) {
    bool sched, exec;
    taints_ok(a, b, n, &sched, &exec);
    if (K11_ON(kTaints)) K11_SET(kTaints, sched);
    if (K11_ON(kNoExecute)) K11_SET(kNoExecute, exec);
  }
  if (K11_ON(kLabelPresence)) {
    bool ok = true;
    const int* lk = a.label_keys + (size_t)n * a.l;
    for (int i = 0; i < a.n_presence && ok; ++i) {
      const int key = __ldg(a.presence_keys + i);
      bool present = false;
      for (int j = 0; j < a.l; ++j) present |= __ldg(lk + j) == key;
      ok = present == (a.presence_present != 0);
    }
    K11_SET(kLabelPresence, ok);
  }
  if (K11_ON(kServiceAffinity)) {
    bool ok = true;
    if (a.n_svc > 0) {
      const int d0 = __ldg(a.svc_aff_d0 + b), d1 = __ldg(a.svc_aff_d1 + b);
      const int src = d0 == n ? d1 : d0;
      for (int j = 0; j < a.n_svc && ok; ++j) {
        const int key = __ldg(a.svc_labels + j);
        const int vn = svc_label_value(a, n, key);
        const int fixed = __ldg(a.svc_aff_fixed + (size_t)b * a.sa + j);
        if (fixed != kPad) {
          ok = vn == fixed;
        } else if (src >= 0) {
          const int vs = svc_label_value(a, src, key);
          ok = vs == kPad || vn == vs;
        }
      }
    }
    K11_SET(kServiceAffinity, ok);
  }
  if (general || K11_ON(kSelector)) {
    sel = selector_ok(a, b, n);
    if (K11_ON(kSelector)) K11_SET(kSelector, sel);
  }
  if (general) K11_SET(kGeneral, res && host && ports && sel);
  if (K11_ON(kInterPod)) K11_SET(kInterPod, inter_pod_ok(a, b, n, any_match));
#undef K11_SET
#undef K11_ON
  return bits;
}

__global__ void __launch_bounds__(kThreads) k11_filter_pass(
    const FilterPassArgs a) {
  extern __shared__ uint8_t any_match[];   // [PT] when aff_on
  __shared__ int tol_unsched;
  const int b = blockIdx.x;
  // per-pod values the whole block needs: a toleration of the
  // unschedulable taint (CheckNodeUnschedulable), and whether each
  // required affinity term matches any topology pair
  if (threadIdx.x == 0) {
    int ok = 0;
    for (int j = 0; j < a.tt; ++j) {
      const size_t k = (size_t)b * a.tt + j;
      const int te = __ldg(a.tol_effect + k), tk = __ldg(a.tol_key + k);
      ok |= __ldg(a.tol_valid + k) && (te == kPad || te == 0) &&
            (tk == 0 || tk == a.unsched_key) &&
            (__ldg(a.tol_op + k) == 1 || __ldg(a.tol_val + k) == 0);
    }
    tol_unsched = ok;
  }
  if (a.aff_on) {
    for (int k = 0; k < a.pt; ++k) {
      // an invalid term passes without its flag (inter_pod_ok): its row
      // is not scanned (the test is the same for the whole block)
      if (!__ldg(a.aff_term_valid + (size_t)b * a.pt + k)) {
        if (threadIdx.x == 0) any_match[k] = 0;
        continue;
      }
      const uint8_t* row = a.aff_term_pairs + ((size_t)b * a.pt + k) * a.tp;
      int mine = 0;
      for (int i = threadIdx.x; i < a.tp && !mine; i += kThreads)
        mine = __ldg(row + i) != 0;
      const int any = __syncthreads_or(mine);
      if (threadIdx.x == 0) any_match[k] = (uint8_t)any;
    }
  }
  __syncthreads();
  const long long n0 =
      ((long long)blockIdx.y * kThreads + threadIdx.x) * kNodesPerThread;
  if (n0 >= a.n) return;
  const bool tol = tol_unsched != 0;
  const bool pv = __ldg(a.pod_valid + b) != 0;
  const int mode = a.stack_mode;
  const uint32_t unres = (uint32_t)a.unresolvable & kAll;
  const uint32_t stop = mode == kMaskMode ? kAll
                        : mode == kCandidatesMode ? unres : 0u;
  uint32_t bits[kNodesPerThread];
  bool alive[kNodesPerThread];
#pragma unroll
  for (int j = 0; j < kNodesPerThread; ++j) {
    const int n = (int)n0 + j;
    bits[j] = 0;
    // candidates: a valid node whose required affinity rules hold (a
    // failure there is unresolvable), the pod's validity unread
    alive[j] = n < a.n && __ldg(a.valid + n) &&
               (mode == kCandidatesMode ? aff_rules_ok(a, b, n, any_match)
                                        : pv);
    if (n < a.n && (mode == kStackMode || alive[j]))
      bits[j] = eval_node(a, b, n, tol, any_match, stop);
  }
  if (mode != kStackMode) {
    // mask: every row passes; candidates: some row fails, no
    // unresolvable one (an early return leaves its bit unset)
    bool m[kNodesPerThread];
#pragma unroll
    for (int j = 0; j < kNodesPerThread; ++j)
      m[j] = alive[j] && (mode == kMaskMode
                              ? bits[j] == kAll
                              : bits[j] != kAll && (bits[j] & unres) == unres);
    const size_t o = (size_t)b * a.n + n0;
    if (a.vec) {
      *reinterpret_cast<uchar4*>(a.out + o) = make_uchar4(m[0], m[1], m[2],
                                                          m[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kNodesPerThread; ++j)
        if (n0 + j < a.n) a.out[o + j] = m[j];
    }
    return;
  }
  for (int k = 0; k < kPreds; ++k) {
    const size_t o = ((size_t)b * kPreds + k) * a.n + n0;
    if (a.vec) {
      uchar4 m;
      m.x = (bits[0] >> k) & 1u;
      m.y = (bits[1] >> k) & 1u;
      m.z = (bits[2] >> k) & 1u;
      m.w = (bits[3] >> k) & 1u;
      *reinterpret_cast<uchar4*>(a.out + o) = m;
    } else {
#pragma unroll
      for (int j = 0; j < kNodesPerThread; ++j)
        if (n0 + j < a.n) a.out[o + j] = (bits[j] >> k) & 1u;
    }
  }
}

}  // namespace

// One filter pass: the arguments above, on `stream`, in the mode
// stack_mode names.  vec != 0 takes the uchar4 stores, which need
// n % 4 == 0 and a 4-byte aligned `out`.  One kernel launch and no other
// stream operation.  Returns a cudaError_t code.
extern "C" int filter_pass_launch(FilterPassArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.pt < 0 || a.pt > 48 * 1024 ||
      a.stack_mode < kMaskMode || a.stack_mode > kCandidatesMode)
    return (int)cudaErrorInvalidValue;
  if (a.vec && (a.n % 4 || (uintptr_t)a.out % 4))
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kNodesPerThread;
  const long long tiles = (a.n + per_block - 1) / per_block;
  if (tiles > 65535 || a.b >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.b, (unsigned)tiles);
  if ((a.aff_on || a.vz_on || a.vb_on) && (!a.node_pair || a.kt < 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = a.aff_on ? (size_t)a.pt : 0;
  k11_filter_pass<<<grid, kThreads, smem, stream>>>(a);
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
