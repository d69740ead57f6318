// K14: the acceptance and the carry update of a speculative round, for
// Hopper (sm_90a).
//
// Replaces the part of the JAX package's models/speculative.py _round
// (:196) after select_hosts_batch.  The plain twin is the port's
// models/speculative.py round_commit_plain, which the kernels equal bit
// for bit.  Pod b, a
// proposer when it is active and K1 found it a node h, is accepted when h
// still fits its request on top of the carried requests of h, every
// earlier proposer of h in batch order and the claims of nominated pods
// with priority >= its own on h, and none of its host ports conflicts with
// one claimed on h or wanted by such an earlier proposer.  A proposer that
// is not accepted bounces for real (and h is banned from its emask, and
// the round raises the batch's redo flag) when it also fails against the
// accepted earlier proposers alone.  The accepted pods commit: hosts,
// requests, nonzero requests, the spread counts ([G, N] groups or [B, N]
// per pod), the claimed ports, the top-k rows; every pod's active flag,
// the rotation counter (+ B), the round count and the "any pod active"
// flag follow.
//
// The affinity mode (node_pair non-null; a batch with in-batch pod
// affinity, the reference's :405-434 and :495-545 but the pair commit,
// which kernel K16 makes after this) adds: a proposer is not accepted when
// an earlier proposer shares a topology domain with it under one of its
// anti terms that the earlier pod matches, or under one of the earlier
// pod's that it matches (node_pair comparisons, pair_gather.cuh); such a
// conflict with an accepted earlier pod is no real bounce; a passed-over
// pod with a later accepted pod whose node its round mask held, or to which
// it is related through required terms, raises the redo flag (the order
// inversion); and the retirement is deferred: while the round accepts
// anything an infeasible pod stays active, and a round that accepts
// nothing retires only the first infeasible pod in batch order.
//
// Two launches, a block a pod each, so that no block reads a carry row
// another block already wrote: k14_accept reads the carry (each pod's
// node row and claimed ports, kept in a scratch for the second) and
// decides `accept`; k14_apply rechecks the bounced proposers against the
// accepted ones and writes the carry.  The requests land with atomic adds
// of whole request columns: integers, exact in any order.  With a
// conditional handle, the last block of k14_apply sets it to "any pod
// active", the condition of the CUDA graph's WHILE node over the rounds.
//
// Bound: bytes.  The work is a few B x B and B x R passes over integers
// (in the affinity mode B x B x AT compares of node-pair rows more); the
// bytes are the batch's rows, the carry rows of the proposed nodes, the
// [B, N] emask row of each bounced pod and in the affinity mode the
// anti-affinity cross matches, read once.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pair_gather.cuh"

namespace {

constexpr int kThreads = 128;

}  // namespace

// The arguments of one round, passed by value (ctypes.Structure
// RoundCommitArgs in kernels/__init__.py mirrors it field for field).
struct RoundCommitArgs {
  // the round's picks
  const int* hosts;             // [B] K1's
  const uint8_t* feasible;      // [B]
  const int* top_nodes;         // [B, tk] K3's, or null (tk == 0)
  const float* top_scores;      // [B, tk]
  const int* top_feas;          // [B]
  // the batch
  const float* req;             // [B, R]
  const float* pod_nonzero;     // [B, 2]
  const int* priority;          // [B]
  const uint8_t* pod_ports;     // [B, PV]
  const uint8_t* conflict;      // [PV, PV]
  const int* group_ids;         // [B, GP]
  const uint8_t* group_valid;   // [B, GP]
  const float* spread_match;    // [B, B], or null (spread-lean batch)
  const float* allocatable;     // [N, R]
  // nominated pods, or null
  const int* nom_prio;          // [K]
  const float* nom_req;         // [K, R]
  const int* nom_order;         // [K] claim indices in node order
  const int* nom_start;         // [N + 1]
  // the carry, updated in place
  int* c_hosts;                 // [B]
  float* c_req;                 // [N, R]
  float* c_nz;                  // [N, 2]
  float* c_spread;              // [G, N] lean, or [B, N]
  uint8_t* c_claimed;           // [N, PV]
  uint8_t* c_emask;             // [B, N]
  uint8_t* c_active;            // [B]
  int* c_li;                    // []
  uint8_t* c_inv;               // []
  int* c_rounds;                // []
  uint8_t* c_any;               // [] any pod still active
  int* c_topn;                  // [B, tk], or null
  float* c_tops;                // [B, tk]
  int* c_feas;                  // [B]
  // scratch between the two launches
  uint8_t* prop;                // [B]
  uint8_t* accept;              // [B]
  float* node_req;              // [B, R] the carried row of the pod's node
  uint8_t* claimed_h;           // [B, PV] its claimed ports
  int* prior;                   // [B, B] each block's list of proposers
  unsigned* ticket;             // [] zero between rounds
  // in-batch pod affinity, or null (node_pair null: no affinity mode)
  const uint8_t* round_mask;    // [B, N] the round's mask (K15's)
  const uint8_t* rel;           // [B, B] related through required terms
  const int* node_pair;         // [N, KT]
  const int* anti_slot;         // [B, AT] each anti term's key slot
  const uint8_t* anti_match;    // [B, B, AT] [j, i, t]: j matches i's term t
  const uint8_t* anti_own;      // [B, AT, B] [j, t, i]: i matches j's term t
  int* any_acc;                 // [] any pod accepted this round (0 between)
  int* first_inf;               // [] the first infeasible active pod (INT_MAX
                                // between rounds)
  uint64_t cond;                // the WHILE node's handle, or 0
  int b, n, r, g, gp, pv, tk, kt, at;
};

namespace {

// Does pod b fit on h over the proposers listed in lst[0:cnt] (node row
// nrow, claimed ports crow)?  Every thread gets the answer.
__device__ bool fits_over(const RoundCommitArgs& a, int b, int h,
                          const int* lst, int cnt, const float* nrow,
                          const uint8_t* crow, uint8_t* pp) {
  const int R = a.r, PV = a.pv;
  const int prio = __ldg(a.priority + b);
  int over = 0;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float x = __ldg(a.req + (size_t)b * R + r);
    if (!(x > 0.f)) continue;
    float cum = 0.f;
    for (int i = 0; i < cnt; ++i)
      cum = __fadd_rn(cum, __ldg(a.req + (size_t)lst[i] * R + r));
    float held = __fadd_rn(nrow[r], cum);
    if (a.nom_start) {
      float extra = 0.f;
      const int c0 = __ldg(a.nom_start + h), c1 = __ldg(a.nom_start + h + 1);
      for (int c = c0; c < c1; ++c) {
        const int k = __ldg(a.nom_order + c);
        if (__ldg(a.nom_prio + k) >= prio)
          extra = __fadd_rn(extra, __ldg(a.nom_req + (size_t)k * R + r));
      }
      held = __fadd_rn(held, extra);
    }
    if (__fadd_rn(held, x) > __ldg(a.allocatable + (size_t)h * R + r))
      over = 1;
  }
  // ports: wanted by a listed proposer or claimed on h, conflicting with
  // one of b's
  const uint8_t* mine = a.pod_ports + (size_t)b * PV;
  int any_mine = 0;
  for (int p = threadIdx.x; p < PV; p += kThreads) {
    uint8_t u = crow[p];
    for (int i = 0; i < cnt && !u; ++i)
      u = __ldg(a.pod_ports + (size_t)lst[i] * PV + p);
    pp[p] = u;
    any_mine |= __ldg(mine + p);
  }
  any_mine = __syncthreads_or(any_mine);
  int conf = 0;
  if (any_mine)
    for (int q = threadIdx.x; q < PV && !conf; q += kThreads) {
      if (!__ldg(mine + q)) continue;
      for (int p = 0; p < PV && !conf; ++p)
        conf = pp[p] && __ldg(a.conflict + (size_t)p * PV + q);
    }
  return !__syncthreads_or(over | conf);
}

// Does an earlier proposer j of the round (accepted_only: an accepted one)
// share a topology domain with pod b on h under one of b's anti terms that
// j matches, or under one of j's that b matches?  Every thread gets the
// answer.
__device__ bool anti_conflict(const RoundCommitArgs& a, int b, int h,
                              bool accepted_only) {
  const int* nph = a.node_pair + (size_t)h * a.kt;
  const size_t B = (size_t)a.b, AT = (size_t)a.at;
  int c = 0;
  for (int j = threadIdx.x; j < b && !c; j += kThreads) {
    const bool on = accepted_only ? a.accept[j] != 0
                                  : a.c_active[j] && a.feasible[j];
    if (!on) continue;
    const int* npj = a.node_pair + (size_t)a.hosts[j] * a.kt;
    for (size_t t = 0; t < AT && !c; ++t) {
      const int sb = __ldg(a.anti_slot + (size_t)b * AT + t);
      const int sj = __ldg(a.anti_slot + (size_t)j * AT + t);
      c = (__ldg(a.anti_match + ((size_t)j * B + b) * AT + t) &&
           pair_gather::same_domain(nph, npj, sb)) ||
          (__ldg(a.anti_own + ((size_t)j * AT + t) * B + b) &&
           pair_gather::same_domain(npj, nph, sj));
    }
  }
  return __syncthreads_or(c) != 0;
}

__global__ void __launch_bounds__(kThreads) k14_accept(
    const RoundCommitArgs a) {
  extern __shared__ uint8_t pp[];   // [PV]
  __shared__ int cnt;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int R = a.r, PV = a.pv;
  const int h = a.hosts[b];
  const bool aff = a.node_pair != nullptr;
  const bool prop = a.c_active[b] && a.feasible[b];
  if (tid == 0) {
    a.prop[b] = prop;
    cnt = 0;
    if (b == 0) *a.c_any = 0;
    if (aff && a.c_active[b] && !a.feasible[b]) atomicMin(a.first_inf, b);
  }
  float* nrow = a.node_req + (size_t)b * R;
  uint8_t* crow = a.claimed_h + (size_t)b * PV;
  for (int r = tid; r < R; r += kThreads) nrow[r] = a.c_req[(size_t)h * R + r];
  for (int p = tid; p < PV; p += kThreads)
    crow[p] = a.c_claimed[(size_t)h * PV + p];
  __syncthreads();
  if (!prop) {
    if (tid == 0) a.accept[b] = 0;
    return;
  }
  // the earlier proposers of h, in any order (their requests add exactly)
  int* lst = a.prior + (size_t)b * a.b;
  for (int j = tid; j < b; j += kThreads)
    if (a.c_active[j] && a.feasible[j] && a.hosts[j] == h)
      lst[atomicAdd(&cnt, 1)] = j;
  __syncthreads();
  bool ok = fits_over(a, b, h, lst, cnt, nrow, crow, pp);
  // the same round's anti-affinity order: an earlier proposer in one of
  // the two pods' anti domains takes precedence
  if (aff && ok) ok = !anti_conflict(a, b, h, false);
  if (tid == 0) {
    a.accept[b] = ok;
    if (aff && ok) atomicExch(a.any_acc, 1);
  }
}

__global__ void __launch_bounds__(kThreads) k14_apply(
    const RoundCommitArgs a) {
  extern __shared__ uint8_t pp[];   // [PV]
  __shared__ int cnt;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int R = a.r, PV = a.pv, N = a.n;
  const int h = a.hosts[b];
  const bool prop = a.prop[b] != 0, acc = a.accept[b] != 0;
  const bool aff = a.node_pair != nullptr;
  const bool act = a.c_active[b] != 0, feas = a.feasible[b] != 0;
  if (tid == 0) cnt = 0;
  __syncthreads();
  bool bounce = false;
  if (prop && !acc) {
    // the accepted-only recheck: a real bounce holds against the
    // accepted earlier proposers of h alone
    int* lst = a.prior + (size_t)b * a.b;
    for (int j = tid; j < b; j += kThreads)
      if (a.prop[j] && a.accept[j] && a.hosts[j] == h)
        lst[atomicAdd(&cnt, 1)] = j;
    __syncthreads();
    bounce = !fits_over(a, b, h, lst, cnt, a.node_req + (size_t)b * R,
                        a.claimed_h + (size_t)b * PV, pp);
    // an anti conflict with an accepted earlier pod needs no ban: the
    // next round's pair state excludes the whole domain
    if (aff && bounce) bounce = !anti_conflict(a, b, h, true);
  }
  if (aff && act && !acc) {
    // the order inversion: a later pod accepted on a node this passed-
    // over pod's round mask held, or a later pod related to it
    int inv = 0;
    for (int j = b + 1 + tid; j < a.b && !inv; j += kThreads)
      inv = a.accept[j] &&
            (a.round_mask[(size_t)b * N + a.hosts[j]] ||
             __ldg(a.rel + (size_t)b * a.b + j));
    if (inv) *a.c_inv = 1;
  }
  // every pod adds its request times its acceptance to its node's row, as
  // the twin's index_add (0.0 for the others)
  for (int r = tid; r < R; r += kThreads)
    atomicAdd(a.c_req + (size_t)h * R + r,
              acc ? __ldg(a.req + (size_t)b * R + r) : 0.f);
  if (tid < 2)
    atomicAdd(a.c_nz + 2 * (size_t)h + tid,
              acc ? __ldg(a.pod_nonzero + 2 * (size_t)b + tid) : 0.f);
  if (acc) {
    if (a.spread_match) {
      // the pods whose selectors b matches count it on h
      for (int i = tid; i < a.b; i += kThreads) {
        const float m = __ldg(a.spread_match + (size_t)i * a.b + b);
        if (m != 0.f) atomicAdd(a.c_spread + (size_t)i * N + h, m);
      }
    } else {
      for (int j = tid; j < a.gp; j += kThreads) {
        const size_t k = (size_t)b * a.gp + j;
        const int g = __ldg(a.group_ids + k);
        if (__ldg(a.group_valid + k) && g >= 0 && g < a.g)
          atomicAdd(a.c_spread + (size_t)g * N + h, 1.f);
      }
    }
    for (int p = tid; p < PV; p += kThreads)
      if (__ldg(a.pod_ports + (size_t)b * PV + p))
        a.c_claimed[(size_t)h * PV + p] = 1;
    for (int k = tid; k < a.tk; k += kThreads) {
      a.c_topn[(size_t)b * a.tk + k] = __ldg(a.top_nodes + (size_t)b * a.tk + k);
      a.c_tops[(size_t)b * a.tk + k] = __ldg(a.top_scores + (size_t)b * a.tk + k);
    }
  }
  if (tid == 0) {
    if (acc) {
      a.c_hosts[b] = h;
      if (a.tk > 0) a.c_feas[b] = __ldg(a.top_feas + b);
    }
    if (bounce) {
      a.c_emask[(size_t)b * N + h] = 0;
      *a.c_inv = 1;
    }
    bool still = prop && !acc;
    // the deferred retirement of an infeasible pod
    if (aff && act && !feas) still = *a.any_acc || b != *a.first_inf;
    a.c_active[b] = still;
    if (still) *a.c_any = 1;
    if (b == 0) {
      *a.c_li = (int)((unsigned)*a.c_li + (unsigned)a.b);
      *a.c_rounds += 1;
    }
    // the last block to finish reads the flag every block has written
    __threadfence();
    if (atomicAdd(a.ticket, 1u) == (unsigned)a.b - 1) {
      __threadfence();
      const bool any = *(volatile uint8_t*)a.c_any != 0;
#if CUDART_VERSION >= 12040
      if (a.cond)
        cudaGraphSetConditional((cudaGraphConditionalHandle)a.cond,
                                any ? 1u : 0u);
#endif
      *a.ticket = 0;
      if (aff) {
        *a.any_acc = 0;
        *a.first_inf = INT_MAX;
      }
    }
  }
}

}  // namespace

// One round's commit on `stream`: two kernel launches (accept, apply) and
// no other stream operation.  Returns a cudaError_t code.
extern "C" int round_commit_launch(RoundCommitArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.r <= 0 || a.pv <= 0 || a.tk < 0 ||
      (a.tk > 0 && !(a.top_nodes && a.c_topn)) || !a.ticket)
    return (int)cudaErrorInvalidValue;
  if (a.node_pair && (a.kt < 0 || a.at < 0 || !a.round_mask || !a.rel ||
                      !a.any_acc || !a.first_inf))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.pv;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k14_accept, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          k14_apply, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k14_accept<<<a.b, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k14_apply<<<a.b, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
