// K12: the priorities of one score pass, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/priorities.py score_batch (:370) with
// every priority it computes: the 12 priorities of PRIORITY_ORDER over
// every (pod, node) pair of a batch, each normalized per pod over the
// node axis, and their weighted total.  The plain twin is
// kubernetes_tpu_torch/ops/priorities.py score_batch_plain, which the
// kernel equals bit for bit.
//
// A block owns one pod row and makes two passes over the N nodes:
//   pass 1 writes NodeAffinity's matched-weight sums to shared memory and
//          takes the per-pod reductions: the maxima of those sums, of
//          TaintToleration's intolerable PreferNoSchedule counts and of
//          SelectorSpread's matching-pod counts (over all N columns,
//          padding included, as the reference's amax), SelectorSpread's
//          zone sums (shared-memory atomics, one slot a topology pair; the
//          counts are integers, so the sums are exact in any order while
//          they stay below 2^24), and InterPodAffinity's min and max over
//          the valid nodes;
//   pass 2 normalizes, computes the per-node priorities and writes the
//          weighted total, summed in PRIORITY_ORDER as the twin's
//          need_per=False loop does, and with need_per the f32[B, 12, N]
//          rows.
// A priority whose row is off (zero weight, and no per rows asked for or
// skip_zero_weight) is neither computed nor added; its per row reads 0.
// Past kSmemMax bytes of a block's arrays (N sums and TP zone slots) the
// arrays live in a global workspace, so no N or TP is refused.
//
// The arithmetic follows the twin operation for operation, each rounding
// written out (__fadd_rn, __fmul_rn, __fdiv_rn) so that nvcc contracts
// nothing: the SelectorSpread blend is the one fused multiply-add the
// compiled reference emits (__fmaf_rn with the twin's fma_f32 operands),
// ImageLocality multiplies by the folded reciprocal, the division of the
// integer normalizations is IEEE (the build has no --use_fast_math), and
// RequestedToCapacityRatio's interpolation ends in the reference's fused
// multiply-add.
//
// The zone of each node (the topology pair of the SelectorSpread zone key
// it belongs to, or -1) comes from k12_zone_index, a first launch of one
// warp a node over the node's pair row.
//
// Bound: operations.  The inputs (the snapshot's rows, a few hundred bytes
// a node, and the pods' rows) are read once; the output is the total, 4
// bytes a (pod, node), and with need_per 48 more.  The work is some
// hundred compares and a few dozen f32 operations a (pod, node).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "label_select.cuh"

namespace {

using label_select::kPad;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPrios = 12;          // NUM_PRIORITIES
constexpr int kSmemMax = 96 * 1024; // a block's arrays above this: workspace
constexpr float kMaxPriority = 10.f;
constexpr float kTiny = 1e-30f;     // the twin's clamp_min(b, 1e-30)
constexpr float kBig = 3.4e38f;     // InterPodAffinity's masked extremes
constexpr float kImgMin = 23.f * 1024 * 1024;
constexpr float kImgMax = 1000.f * 1024 * 1024;
constexpr float kRtcEps = 1.4210854715202004e-14f; // 2^-46: interp's dx == 0 test
// SelectorSpread's weights as the twin holds them: f32(2/3) and
// f32(1 - 2/3), each rounded once from the double
constexpr float kZoneWeight = (float)(2.0 / 3.0);
constexpr float kNodeWeight = (float)(1.0 - 2.0 / 3.0);

// PRIORITY_ORDER
enum {
  kSpread = 0, kInterPod, kLeast, kBalanced, kAvoid, kNodeAffinity,
  kTaint, kImage, kMost, kNodeLabel, kRtc, kLimits
};

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
  // made for this launch
  int* zone_of_node;            // [N] (k12_zone_index writes it)
  const float* ipa_sums;        // [B, N], or null (affinity-lean batch)
  // configuration
  const int* prefs_key;         // [n_prefs] NodeLabelPriority
  const int* prefs_presence;
  const float* prefs_weight;
  const float* rtc_xs;          // [n_rtc] RequestedToCapacityRatio curve
  const float* rtc_ys;
  float* work;                  // [B, region] when not smem_mode
  float* total;                 // [B, N]
  float* per;                   // [B, 12, N], or null
  float w[kPrios];
  int b, n, r, l, t, tt, i, c, a, g, gp, ps, e, v, tp;
  int n_prefs, n_rtc, rows, smem_mode, region, na_off, zs_off;
};

namespace {

__device__ __forceinline__ bool row_on(const ScorePassArgs& a, int k) {
  return (a.rows >> k) & 1;
}

// floor(x / max(d, 1e-30)): _fdiv_floor
__device__ __forceinline__ float fdiv_floor(float x, float d) {
  return floorf(__fdiv_rn(x, fmaxf(d, kTiny)));
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
  for (int j = 0; j < a.gp; ++j) {
    const size_t k = (size_t)b * a.gp + j;
    const int g = __ldg(a.group_ids + k);
    if (__ldg(a.group_valid + k) && g >= 0 && g < a.g)
      c = __fadd_rn(c, __ldg(a.group_counts + (size_t)n * a.g + g));
  }
  return c;
}

// jnp.interp with constant extrapolation, as ops/priorities.py interp
__device__ float interp(const ScorePassArgs& a, float x) {
  const int m = a.n_rtc;
  int i = 0;
  if (isnan(x)) {
    i = m;                         // searchsorted puts NaN last
  } else {
    for (int k = 0; k < m; ++k) i += __ldg(a.rtc_xs + k) <= x;
  }
  i = min(max(i, 1), m - 1);
  const int j = i - 1 < 0 ? i - 1 + m : i - 1;   // Python's negative index
  const float x0 = __ldg(a.rtc_xs + j), y0 = __ldg(a.rtc_ys + j);
  const float df = __fsub_rn(__ldg(a.rtc_ys + i), y0);
  const float dx = __fsub_rn(__ldg(a.rtc_xs + i), x0);
  const float delta = __fsub_rn(x, x0);
  const bool dx0 = fabsf(dx) <= kRtcEps;
  float f = dx0 ? y0 : __fmaf_rn(__fdiv_rn(delta, dx), df, y0);
  if (x < __ldg(a.rtc_xs)) f = __ldg(a.rtc_ys);
  if (x > __ldg(a.rtc_xs + m - 1)) f = __ldg(a.rtc_ys + m - 1);
  return f;
}

struct Reduced {
  float mx_spread, mx_na, mx_tt, ipa_mn, ipa_mx, mx_zone;
  bool have_zones;
};

// Max (or min) of one value a thread over the block; every thread gets
// the result.  `red` holds kWarps floats.
__device__ __forceinline__ float block_reduce(float x, bool is_min,
                                              float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_min ? fminf(x, y) : fmaxf(x, y);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int k = 1; k < kWarps; ++k) x = is_min ? fminf(x, red[k]) : fmaxf(x, red[k]);
  return x;
}

__global__ void __launch_bounds__(kThreads) k12_score_pass(
    const ScorePassArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  float* region = a.smem_mode ? smem : a.work + (size_t)b * a.region;
  float* na = region + a.na_off;   // [N] NodeAffinity sums
  float* zs = region + a.zs_off;   // [TP] SelectorSpread zone sums
  const bool on_spread = row_on(a, kSpread);
  const bool on_ipa = row_on(a, kInterPod) && a.ipa_sums;
  const bool on_na = row_on(a, kNodeAffinity) && a.ps > 0;
  const bool on_tt = row_on(a, kTaint);
  if (on_spread)
    for (int k = threadIdx.x; k < a.tp; k += kThreads) zs[k] = 0.f;
  __syncthreads();

  // pass 1
  float mx_sp = -INFINITY, mx_na = -INFINITY, mx_tt = -INFINITY;
  float ipa_mn = kBig, ipa_mx = -kBig;
  int have_z = 0;
  for (int n = threadIdx.x; n < a.n; n += kThreads) {
    if (on_na) {
      const float s = node_affinity_sum(a, b, n);
      na[n] = s;
      mx_na = fmaxf(mx_na, s);
    }
    if (on_tt) mx_tt = fmaxf(mx_tt, intolerable(a, b, n));
    if (on_spread) {
      const float c = spread_count(a, b, n);
      mx_sp = fmaxf(mx_sp, c);
      const int z = __ldg(a.zone_of_node + n);
      if (z >= 0) {
        atomicAdd(zs + z, c);
        have_z = 1;
      }
    }
    if (on_ipa && __ldg(a.valid + n)) {
      const float s = __ldg(a.ipa_sums + (size_t)b * a.n + n);
      ipa_mn = fminf(ipa_mn, s);
      ipa_mx = fmaxf(ipa_mx, s);
    }
  }
  Reduced r;
  r.mx_spread = block_reduce(mx_sp, false, red);
  r.mx_na = block_reduce(mx_na, false, red);
  r.mx_tt = block_reduce(mx_tt, false, red);
  r.ipa_mn = block_reduce(ipa_mn, true, red);
  r.ipa_mx = block_reduce(ipa_mx, false, red);
  r.have_zones = __syncthreads_or(have_z) != 0;
  float mz = -INFINITY;
  if (on_spread && r.have_zones)
    for (int k = threadIdx.x; k < a.tp; k += kThreads) mz = fmaxf(mz, zs[k]);
  r.mx_zone = block_reduce(mz, false, red);

  // pass 2
  const float pod_nz0 = __ldg(a.pod_nonzero + 2 * (size_t)b);
  const float pod_nz1 = __ldg(a.pod_nonzero + 2 * (size_t)b + 1);
  const float lim0 = __ldg(a.limits2 + 2 * (size_t)b);
  const float lim1 = __ldg(a.limits2 + 2 * (size_t)b + 1);
  const int owner = __ldg(a.owner_uid + b);
  const float ipa_spread = __fsub_rn(r.ipa_mx, r.ipa_mn);
  for (int n = threadIdx.x; n < a.n; n += kThreads) {
    float sc[kPrios];
    const float cap[2] = {__ldg(a.allocatable + (size_t)n * a.r),
                          __ldg(a.allocatable + (size_t)n * a.r + 1)};
    const float rq[2] = {
        __fadd_rn(pod_nz0, __ldg(a.node_nonzero + 2 * (size_t)n)),
        __fadd_rn(pod_nz1, __ldg(a.node_nonzero + 2 * (size_t)n + 1))};
#pragma unroll
    for (int k = 0; k < kPrios; ++k) sc[k] = 0.f;
    if (on_spread) {
      const float c = spread_count(a, b, n);
      const float ns =
          r.mx_spread > 0.f
              ? __fdiv_rn(__fmul_rn(kMaxPriority, __fsub_rn(r.mx_spread, c)),
                          fmaxf(r.mx_spread, 1.f))
              : kMaxPriority;
      const int z = __ldg(a.zone_of_node + n);
      float blended = ns;
      if (r.have_zones && z >= 0) {
        const float zsc =
            r.mx_zone > 0.f
                ? __fdiv_rn(__fmul_rn(kMaxPriority,
                                      __fsub_rn(r.mx_zone, zs[z])),
                            fmaxf(r.mx_zone, 1.f))
                : kMaxPriority;
        // fma(1/3, node, round(2/3 * zone)), the compiled reference's
        blended = __fmaf_rn(kNodeWeight, ns, __fmul_rn(kZoneWeight, zsc));
      }
      sc[kSpread] = floorf(blended);
    }
    if (on_ipa && __ldg(a.valid + n)) {
      const float s = __ldg(a.ipa_sums + (size_t)b * a.n + n);
      sc[kInterPod] =
          ipa_spread > 0.f
              ? fdiv_floor(__fmul_rn(kMaxPriority, __fsub_rn(s, r.ipa_mn)),
                           ipa_spread)
              : 0.f;
    }
    if (row_on(a, kLeast) || row_on(a, kMost)) {
      float least = 0.f, most = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool off = cap[k] == 0.f || rq[k] > cap[k];
        least += off ? 0.f
                     : fdiv_floor(__fmul_rn(__fsub_rn(cap[k], rq[k]),
                                            kMaxPriority), cap[k]);
        most += off ? 0.f
                    : fdiv_floor(__fmul_rn(rq[k], kMaxPriority), cap[k]);
      }
      sc[kLeast] = row_on(a, kLeast) ? floorf(__fdiv_rn(least, 2.f)) : 0.f;
      sc[kMost] = row_on(a, kMost) ? floorf(__fdiv_rn(most, 2.f)) : 0.f;
    }
    if (row_on(a, kBalanced)) {
      const float f0 = __fdiv_rn(rq[0], fmaxf(cap[0], kTiny));
      const float f1 = __fdiv_rn(rq[1], fmaxf(cap[1], kTiny));
      const bool over =
          f0 >= 1.f || cap[0] == 0.f || f1 >= 1.f || cap[1] == 0.f;
      sc[kBalanced] =
          over ? 0.f
               : floorf(__fmul_rn(__fsub_rn(1.f, fabsf(__fsub_rn(f0, f1))),
                                  kMaxPriority));
    }
    if (row_on(a, kAvoid)) {
      bool avoid = false;
      for (int k = 0; k < a.a; ++k)
        avoid |= owner != kPad && owner == __ldg(a.avoid_owner + (size_t)n * a.a + k);
      sc[kAvoid] = avoid ? 0.f : kMaxPriority;
    }
    if (on_na)
      sc[kNodeAffinity] =
          r.mx_na > 0.f ? fdiv_floor(__fmul_rn(kMaxPriority, na[n]), r.mx_na)
                        : 0.f;
    if (on_tt) {
      const float s = fdiv_floor(__fmul_rn(kMaxPriority, intolerable(a, b, n)),
                                 r.mx_tt);
      sc[kTaint] = r.mx_tt > 0.f ? __fsub_rn(kMaxPriority, s) : kMaxPriority;
    }
    if (row_on(a, kImage)) {
      float summed = 0.f;
      for (int c = 0; c < a.c; ++c) {
        const int pid = __ldg(a.image_ids + (size_t)b * a.c + c);
        float inner = 0.f;
        for (int k = 0; k < a.i; ++k) {
          const size_t nk = (size_t)n * a.i + k;
          inner = __fadd_rn(inner, (pid != kPad && pid == __ldg(a.image_id + nk))
                                       ? __ldg(a.image_size + nk)
                                       : 0.f);
        }
        summed = __fadd_rn(summed, inner);
      }
      const float clamped = fminf(fmaxf(summed, kImgMin), kImgMax);
      // 10 * (s - MIN) / (MAX - MIN) with the reference's folded factor
      const float scale = __fmul_rn(__fdiv_rn(1.f, kImgMax - kImgMin),
                                    kMaxPriority);
      sc[kImage] = floorf(__fmul_rn(__fsub_rn(clamped, kImgMin), scale));
    }
    if (row_on(a, kNodeLabel)) {
      float s = 0.f;
      const int* lk = a.label_keys + (size_t)n * a.l;
      for (int k = 0; k < a.n_prefs; ++k) {
        const int key = __ldg(a.prefs_key + k);
        bool present = false;
        for (int j = 0; j < a.l; ++j) present |= __ldg(lk + j) == key;
        const float v =
            present == (__ldg(a.prefs_presence + k) != 0) ? kMaxPriority : 0.f;
        s = __fadd_rn(s, __fmul_rn(__ldg(a.prefs_weight + k), v));
      }
      sc[kNodeLabel] = s;
    }
    if (row_on(a, kRtc)) {
      float f = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float util =
            cap[k] > 0.f
                ? __fdiv_rn(__fmul_rn(rq[k], 100.f), fmaxf(cap[k], kTiny))
                : 100.f;
        f = k == 0 ? interp(a, util) : __fadd_rn(f, interp(a, util));
      }
      sc[kRtc] = floorf(__fdiv_rn(f, 2.f));
    }
    if (row_on(a, kLimits)) {
      const bool ok = (lim0 == 0.f || cap[0] >= lim0) &&
                      (lim1 == 0.f || cap[1] >= lim1);
      sc[kLimits] = ok && (lim0 > 0.f || lim1 > 0.f) ? 1.f : 0.f;
    }
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kPrios; ++k)
      if (a.w[k] != 0.f) total = __fadd_rn(total, __fmul_rn(a.w[k], sc[k]));
    a.total[(size_t)b * a.n + n] = total;
    if (a.per) {
#pragma unroll
      for (int k = 0; k < kPrios; ++k)
        a.per[((size_t)b * kPrios + k) * a.n + n] = sc[k];
    }
  }
}

// zone_of_node[n]: the first topology pair of node n whose key is
// zone_key (the twin's zone_layout argmax), or -1; one warp a node.
__global__ void k12_zone_index(const uint8_t* __restrict__ topo,
                               const int* __restrict__ pair_key, int n,
                               int tp, int zone_key,
                               int* __restrict__ zone_of_node) {
  const long long node =
      (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (node >= n) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* row = topo + (size_t)node * tp;
  int first = INT_MAX;
  for (int base = 0; base < tp && first == INT_MAX; base += 32) {
    const int j = base + lane;
    const bool h = j < tp && __ldg(row + j) && __ldg(pair_key + j) == zone_key;
    const unsigned m = __ballot_sync(0xffffffffu, h);
    if (m) first = base + __ffs(m) - 1;
  }
  if (lane == 0) zone_of_node[node] = first == INT_MAX ? -1 : first;
}

}  // namespace

// The shared memory a block of k12_score_pass may take (its arrays go to
// the workspace above this).
extern "C" int score_pass_smem_max() { return kSmemMax; }

// One score pass: the zone index (when SelectorSpread's row is on) into
// a.zone_of_node from topo bool[N, TP] and pair_key i32[TP], then the
// priorities, on `stream`.  With smem_mode, a block keeps its `region`
// floats in shared memory (at most kSmemMax bytes), else in `work`.  Two
// kernel launches (one without the spread row) and no other stream
// operation.  Returns a cudaError_t code.
extern "C" int score_pass_launch(ScorePassArgs a, const uint8_t* topo,
                                 const int* pair_key, int zone_key,
                                 cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0 || a.tp <= 0 || a.region < 0)
    return (int)cudaErrorInvalidValue;
  const bool spread = (a.rows >> kSpread) & 1;
  if (spread) {
    const int warps = 8;
    const long long blocks = ((long long)a.n + warps - 1) / warps;
    k12_zone_index<<<(unsigned)blocks, warps * 32, 0, stream>>>(
        topo, pair_key, a.n, a.tp, zone_key, a.zone_of_node);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  size_t smem = 0;
  if (a.smem_mode) {
    smem = (size_t)a.region * sizeof(float);
    if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          k12_score_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemMax);
      if (err != cudaSuccess) return (int)err;
    }
  } else if (!a.work && a.region > 0) {
    return (int)cudaErrorInvalidValue;
  }
  k12_score_pass<<<(unsigned)a.b, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
