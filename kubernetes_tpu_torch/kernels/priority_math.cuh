// The state-dependent priority formulas of K12 (score_pass.cu), shared
// with K13 (seq_scan.cu) and K15 (round_fold.cu), which score against the
// carried node state: LeastRequested, MostRequested, BalancedAllocation,
// RequestedToCapacityRatio's interpolation and SelectorSpread's node/zone
// blend.  Each repeats ops/priorities.py's twin operation for operation,
// every rounding written out (__fadd_rn, __fmul_rn, __fdiv_rn) so that
// nvcc contracts nothing; the spread blend is the compiled reference's one
// fused multiply-add (__fmaf_rn with the twin's f32 constants) and the
// interpolation ends in the reference's fused multiply-add.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace prio_math {

constexpr float kMaxPriority = 10.f;
constexpr float kTiny = 1e-30f;     // the twin's clamp_min(b, 1e-30)
constexpr float kRtcEps = 1.4210854715202004e-14f; // 2^-46: interp's dx == 0 test
// SelectorSpread's weights as the twin holds them: f32(2/3) and
// f32(1 - 2/3), each rounded once from the double
constexpr float kZoneWeight = (float)(2.0 / 3.0);
constexpr float kNodeWeight = (float)(1.0 - 2.0 / 3.0);

// floor(x / max(d, 1e-30)): _fdiv_floor
__device__ __forceinline__ float fdiv_floor(float x, float d) {
  return floorf(__fdiv_rn(x, fmaxf(d, kTiny)));
}

// LeastRequested's and MostRequested's sums of the two per-resource
// scores (cap: the node's milliCPU and memory allocatable, rq: its nonzero
// requests with the pod's); each priority is floor(sum / 2).
__device__ __forceinline__ float least_sum(const float cap[2],
                                           const float rq[2]) {
  float least = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool off = cap[k] == 0.f || rq[k] > cap[k];
    least += off ? 0.f
                 : fdiv_floor(__fmul_rn(__fsub_rn(cap[k], rq[k]),
                                        kMaxPriority), cap[k]);
  }
  return least;
}

__device__ __forceinline__ float most_sum(const float cap[2],
                                          const float rq[2]) {
  float most = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool off = cap[k] == 0.f || rq[k] > cap[k];
    most += off ? 0.f : fdiv_floor(__fmul_rn(rq[k], kMaxPriority), cap[k]);
  }
  return most;
}

__device__ __forceinline__ void least_most_sums(const float cap[2],
                                                const float rq[2],
                                                float& least, float& most) {
  least = least_sum(cap, rq);
  most = most_sum(cap, rq);
}

// floor(sum / 2): a division by 2 and a multiplication by 0.5 round the
// same exact value, so the multiplication is the twin's division bit for
// bit
__device__ __forceinline__ float half_floor(float sum) {
  return floorf(__fmul_rn(sum, 0.5f));
}

// BalancedResourceAllocation
__device__ __forceinline__ float balanced(const float cap[2],
                                          const float rq[2]) {
  const float f0 = __fdiv_rn(rq[0], fmaxf(cap[0], kTiny));
  const float f1 = __fdiv_rn(rq[1], fmaxf(cap[1], kTiny));
  const bool over = f0 >= 1.f || cap[0] == 0.f || f1 >= 1.f || cap[1] == 0.f;
  return over ? 0.f
              : floorf(__fmul_rn(__fsub_rn(1.f, fabsf(__fsub_rn(f0, f1))),
                                 kMaxPriority));
}

// jnp.interp with constant extrapolation over the m points (xs, ys), as
// ops/priorities.py interp
__device__ __forceinline__ float interp(const float* xs, const float* ys,
                                        int m, float x) {
  int i = 0;
  if (isnan(x)) {
    i = m;                         // searchsorted puts NaN last
  } else {
    for (int k = 0; k < m; ++k) i += __ldg(xs + k) <= x;
  }
  i = min(max(i, 1), m - 1);
  const int j = i - 1 < 0 ? i - 1 + m : i - 1;   // Python's negative index
  const float x0 = __ldg(xs + j), y0 = __ldg(ys + j);
  const float df = __fsub_rn(__ldg(ys + i), y0);
  const float dx = __fsub_rn(__ldg(xs + i), x0);
  const float delta = __fsub_rn(x, x0);
  const bool dx0 = fabsf(dx) <= kRtcEps;
  float f = dx0 ? y0 : __fmaf_rn(__fdiv_rn(delta, dx), df, y0);
  if (x < __ldg(xs)) f = __ldg(ys);
  if (x > __ldg(xs + m - 1)) f = __ldg(ys + m - 1);
  return f;
}

// RequestedToCapacityRatio: the utilization through the curve, averaged
// over (cpu, mem)
__device__ __forceinline__ float rtc(const float* xs, const float* ys, int m,
                                     const float cap[2], const float rq[2]) {
  float f = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float util =
        cap[k] > 0.f
            ? __fdiv_rn(__fmul_rn(rq[k], 100.f), fmaxf(cap[k], kTiny))
            : 100.f;
    f = k == 0 ? interp(xs, ys, m, util) : __fadd_rn(f, interp(xs, ys, m, util));
  }
  return floorf(__fdiv_rn(f, 2.f));
}

// SelectorSpread from a node's matching-pod count c: mx_node, the max
// count over every node; in_zone, whether the fleet has zones and the
// node has one; then mx_zone, the max zone sum, and zsum, the node's.
__device__ __forceinline__ float spread(float mx_node, float c, bool in_zone,
                                        float mx_zone, float zsum) {
  const float ns =
      mx_node > 0.f
          ? __fdiv_rn(__fmul_rn(kMaxPriority, __fsub_rn(mx_node, c)),
                      fmaxf(mx_node, 1.f))
          : kMaxPriority;
  float blended = ns;
  if (in_zone) {
    const float zsc =
        mx_zone > 0.f
            ? __fdiv_rn(__fmul_rn(kMaxPriority, __fsub_rn(mx_zone, zsum)),
                        fmaxf(mx_zone, 1.f))
            : kMaxPriority;
    // fma(1/3, node, round(2/3 * zone)), the compiled reference's
    blended = __fmaf_rn(kNodeWeight, ns, __fmul_rn(kZoneWeight, zsc));
  }
  return floorf(blended);
}

// The first topology pair of a node's row (topo_row bool[tp]) whose key
// is zone_key (the twin's zone_layout argmax), or -1.
__device__ __forceinline__ int zone_of(const unsigned char* topo_row,
                                       const int* pair_key, int tp,
                                       int zone_key) {
  for (int j = 0; j < tp; ++j)
    if (__ldg(topo_row + j) && __ldg(pair_key + j) == zone_key) return j;
  return -1;
}

}  // namespace prio_math
