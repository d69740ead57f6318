// K15: the speculative round's glue between the score pass and the
// selector, for Hopper (sm_90a).
//
// Replaces the part of the JAX package's models/speculative.py _round
// (:196) between score_batch and select_hosts_batch.  The plain twin is the
// port's models/speculative.py round_fold_plain, which the kernel equals
// bit for bit.  For each pod b (one block), over the N nodes:
//   total  = K12's total, plus, for a spread-lean batch, w_spread times
//            the pod's SelectorSpread score: the score of each of its
//            groups over the carried [G, N] counts (spread_score_from_counts,
//            priority_math.cuh), summed over its groups; a groupless pod
//            scores 10 everywhere
//   mask   = K11's mask & active[b] & emask[b, :] & valid[b], then with a
//            sampling limit the first `limit` feasible nodes from the
//            rotated start li + b (limit_feasible)
//   total += w_ipa times ipa_normalize of the IPA raw sums, for a batch
//            with in-batch pod affinity (u_pref non-null): the carried
//            preferred pair weights of the pod (its own and the earlier
//            rounds' commits) summed over each node's pairs
//            (pair_gather.cuh), min and max over the valid nodes
//   total += escore[b, :] when the caller gives one.
//
// Bound: bytes.  It reads the two [B, N] grids, emask and escore, and
// writes the total and the mask: 14 bytes a (pod, node), 18 with escore,
// plus the carried counts (L2-resident, read once a group a pod), and in
// the affinity mode each pod's pair weights (4 TP bytes) and the
// node-pair table (4 KT bytes a node, L2-resident).  A block
// a pod; each thread owns a contiguous run of nodes so that node order is
// thread order for the sampling prefix.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "pair_gather.cuh"
#include "priority_math.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemZs = 48 * 1024;  // zone sums above this: workspace
constexpr float kBig = 3.4e38f;     // ipa_normalize's masked extremes

}  // namespace

// The arguments of one launch, passed by value (ctypes.Structure
// RoundFoldArgs in kernels/__init__.py mirrors it field for field).
struct RoundFoldArgs {
  const float* total_in;        // [B, N] the score pass's total
  const uint8_t* mask_in;       // [B, N] the filter pass's mask
  const uint8_t* active;        // [B]
  const uint8_t* emask;         // [B, N]
  const uint8_t* pod_valid;     // [B]
  const float* escore;          // [B, N], or null
  const float* spread_g;        // [G, N] carried group counts, or null
  const int* group_ids;         // [B, GP]
  const uint8_t* group_valid;   // [B, GP]
  const int* zone_of_node;      // [N] each node's zone pair, or -1
  const int* feas_limit;        // [] or null: no sampling
  const int* li;                // [] the round's rotation counter
  float* total_out;             // [B, N]
  uint8_t* mask_out;            // [B, N]
  uint8_t* work;                // round_fold_workspace_bytes(b, n, tp, limited)
  const float* u_pref;          // [B, TP] carried preferred pair weights, or
                                // null (no in-batch pod affinity)
  const int* node_pair;         // [N, KT] (read with u_pref)
  const uint8_t* node_valid;    // [N]
  float w_spread, w_ipa;
  int b, n, g, gp, tp, kt;
};

namespace {

struct Shared {
  float f[kWarps];
  float g[kWarps];
  int i[kWarps];
};

// fminf of mn and fmaxf of mx over the block (every thread gets both)
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

__device__ float block_fmax(float v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.f[threadIdx.x >> 5] = v;
  __syncthreads();
  float x = sh.f[0];
  for (int k = 1; k < kWarps; ++k) x = fmaxf(x, sh.f[k]);
  return x;
}

__device__ int block_excl_scan(int v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();
  if (lane == 31) sh.i[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int k = 0; k < warp; ++k) before += sh.i[k];
  return before + incl - v;
}

__device__ __forceinline__ int rotated(int n, int start, int N) {
  const int w = (int)(unsigned)((long long)n - (long long)start);
  const int r = w % N;
  return r < 0 ? r + N : r;
}

__global__ void __launch_bounds__(kThreads) k15_round_fold(
    const RoundFoldArgs a) {
  extern __shared__ float zs_smem[];   // [TP] when they fit
  __shared__ Shared sh;
  const int b = blockIdx.x, N = a.n, tid = threadIdx.x;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int n0 = min(tid * chunk, N), n1 = min(n0 + chunk, N);
  const size_t row = (size_t)b * N;
  const bool limited = a.feas_limit != nullptr;
  // the work rows of this block: zone sums [TP], then with a limit the
  // histogram, first node and prefix [N] each
  float* zs = (size_t)a.tp * 4 <= (size_t)kSmemZs
                  ? zs_smem
                  : (float*)a.work + (size_t)b * a.tp;
  int* hist = (int*)(a.work + (size_t)a.b * a.tp * 4) + (size_t)b * 3 * N;
  int* first = hist + N;
  int* pre = first + N;

  if (a.spread_g) {
    // the pod's SelectorSpread score, its groups' scores summed in
    // total_out's row, then w_spread times it added to the total
    int hz = 0;
    for (int n = n0; n < n1; ++n) {
      hz |= __ldg(a.zone_of_node + n) >= 0;
      a.total_out[row + n] = 0.f;
    }
    const bool have_zones = __syncthreads_or(hz) != 0;
    bool has_g = false;
    for (int j = 0; j < a.gp; ++j) {
      const size_t k = (size_t)b * a.gp + j;
      const int g = __ldg(a.group_ids + k);
      if (!(__ldg(a.group_valid + k) && g >= 0 && g < a.g)) continue;
      has_g = true;
      if (a.w_spread == 0.f) continue;   // w * score adds 0 whatever it is
      const float* counts = a.spread_g + (size_t)g * N;
      for (int k2 = tid; k2 < a.tp; k2 += kThreads) zs[k2] = 0.f;
      __syncthreads();
      float mx = -INFINITY;
      for (int n = n0; n < n1; ++n) {
        const float c = __ldg(counts + n);
        mx = fmaxf(mx, c);
        const int z = __ldg(a.zone_of_node + n);
        if (z >= 0) atomicAdd(zs + z, c);
      }
      const float mx_node = block_fmax(mx, sh);
      float mz = -INFINITY;
      if (have_zones)
        for (int k2 = tid; k2 < a.tp; k2 += kThreads) mz = fmaxf(mz, zs[k2]);
      const float mx_zone = block_fmax(mz, sh);
      for (int n = n0; n < n1; ++n) {
        const int z = __ldg(a.zone_of_node + n);
        a.total_out[row + n] = __fadd_rn(
            a.total_out[row + n],
            prio_math::spread(mx_node, __ldg(counts + n), have_zones && z >= 0,
                              mx_zone, z >= 0 ? zs[z] : 0.f));
      }
      __syncthreads();   // zs is zeroed again for the next group
    }
    for (int n = n0; n < n1; ++n) {
      const float sp = has_g ? a.total_out[row + n] : prio_math::kMaxPriority;
      a.total_out[row + n] = __fadd_rn(__ldg(a.total_in + row + n),
                                       __fmul_rn(a.w_spread, sp));
    }
  } else {
    for (int n = n0; n < n1; ++n)
      a.total_out[row + n] = __ldg(a.total_in + row + n);
  }

  const bool pod_on = __ldg(a.active + b) && __ldg(a.pod_valid + b);
  for (int n = n0; n < n1; ++n) {
    const bool m = pod_on && __ldg(a.mask_in + row + n) && __ldg(a.emask + row + n);
    a.mask_out[row + n] = m;
    if (limited) {
      hist[n] = 0;
      first[n] = INT_MAX;
    }
  }
  if (limited) {
    // keep the first `limit` masked nodes in the rotated order from
    // li + b; a node's rank: the masked nodes at earlier positions, plus
    // the lower node at its own (the int32 wrap can put two there)
    const int lim = *a.feas_limit;
    const int start = (int)((unsigned)*a.li + (unsigned)b);
    __syncthreads();
    for (int n = n0; n < n1; ++n)
      if (a.mask_out[row + n]) {
        const int r = rotated(n, start, N);
        atomicAdd(hist + r, 1);
        atomicMin(first + r, n);
      }
    __syncthreads();
    int s = 0;
    for (int r = n0; r < n1; ++r) s += hist[r];
    int run = block_excl_scan(s, sh);
    for (int r = n0; r < n1; ++r) {
      pre[r] = run;
      run += hist[r];
    }
    __syncthreads();
    for (int n = n0; n < n1; ++n)
      if (a.mask_out[row + n]) {
        const int r = rotated(n, start, N);
        if (pre[r] + (hist[r] == 2 && first[r] != n) >= lim)
          a.mask_out[row + n] = 0;
      }
  }
  if (a.u_pref) {
    // the IPA score over the carried pair weights, renormalized per pod
    const float* urow = a.u_pref + (size_t)b * a.tp;
    float mn = kBig, mx = -kBig;
    for (int n = n0; n < n1; ++n)
      if (__ldg(a.node_valid + n)) {
        const float x = pair_gather::sum(urow, a.node_pair + (size_t)n * a.kt,
                                         a.kt);
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    block_minmax(mn, mx, sh);
    const float spr = __fsub_rn(mx, mn);
    for (int n = n0; n < n1; ++n) {
      float ipa = 0.f;
      if (__ldg(a.node_valid + n) && spr > 0.f) {
        const float x = pair_gather::sum(urow, a.node_pair + (size_t)n * a.kt,
                                         a.kt);
        ipa = floorf(__fdiv_rn(
            __fmul_rn(prio_math::kMaxPriority, __fsub_rn(x, mn)), spr));
      }
      a.total_out[row + n] = __fadd_rn(a.total_out[row + n],
                                       __fmul_rn(a.w_ipa, ipa));
    }
  }
  if (a.escore)
    for (int n = n0; n < n1; ++n)
      a.total_out[row + n] = __fadd_rn(a.total_out[row + n],
                                       __ldg(a.escore + row + n));
}

}  // namespace

// The bytes of the workspace one launch needs.
extern "C" long long round_fold_workspace_bytes(int b, int n, int tp,
                                                int limited) {
  return (long long)b * tp * 4 + (limited ? (long long)b * 3 * n * 4 : 0);
}

// One fold of B pod rows on `stream`: one kernel launch and no other
// stream operation.  Returns a cudaError_t code.
extern "C" int round_fold_launch(RoundFoldArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.tp <= 0 || !a.work || !a.li ||
      (a.u_pref && (!a.node_pair || !a.node_valid || a.kt < 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)a.tp * 4 <= (size_t)kSmemZs ? (size_t)a.tp * 4 : 0;
  k15_round_fold<<<a.b, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
