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
// Design: one block of kThreads a lane (a grid of at most kMaxGrid blocks
// walks the lanes).  Thread t owns bins t, t + kThreads, ...: it alone
// reads and writes their loads, so the loads need no barrier.  Loads live
// in shared memory, column-major ([R][nb]), when they fit, else in this
// block's slice of a global workspace.  A step tests bins in chunks of
// kThreads, lowest first: admission per bin, one block-wide exclusive scan
// (warp shuffles, then the warp totals double-buffered in shared memory:
// one barrier a chunk), the fill, the loads.  The scan runs in 64-bit, so
// the step knows where its true prefix stands: once it reaches m and no
// later prefix can pass 2^31 (so the wrapped int32 prefix the reference
// computes stays >= m), every later bin takes nothing and the step stops.
// Integer division follows the reference's floor semantics; the int32
// adds and products wrap as the reference's do.
//
// Bound: a chain of C dependent steps a lane.  The bytes (reqs, counts,
// caps and order read once, placed and used written once) are a few MB at
// the BASELINE sweep (S 10,000 lanes, C 256, nb 2,048, R 8); the
// operations are a few per (bin, requested column) that a step reaches.
// No tensor cores and no TMA: there is no matrix work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGrid = 1056;        // 8 blocks on each of 132 SMs
constexpr int kMaxGridWork = 264;     // with the loads in the workspace
constexpr size_t kSmemMax = 200 * 1024;

__device__ __forceinline__ int row_of(int oi, int C) {
  if (oi < 0) oi += C;
  return oi < 0 ? 0 : (oi >= C ? C - 1 : oi);
}

__device__ __forceinline__ int floor_div(int x, int d) {  // d > 0
  int q = x / d;
  if ((x % d) != 0 && x < 0) q -= 1;
  return q;
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__global__ void __launch_bounds__(kThreads) k8_binpack_counts(
    const float* __restrict__ reqs, const int* __restrict__ counts, int C,
    int R, const float* __restrict__ caps, int per_bin, int nb,
    const int* __restrict__ order, int S, int in_smem,
    float* __restrict__ work, int* __restrict__ used,
    int* __restrict__ placed, float* __restrict__ loads_out,
    uint8_t* __restrict__ touched) {
  extern __shared__ int dyn[];
  int* s_req = dyn;              // [R] int(req) of this step's class
  int* s_cap = dyn + R;          // [R] int(caps[s]) (uniform mode)
  float* L = in_smem ? reinterpret_cast<float*>(dyn + 2 * R)
                     : work + (size_t)blockIdx.x * nb * R;
  __shared__ long long wt[2][kWarps];
  __shared__ unsigned s_sum;
  __shared__ int s_used;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    for (size_t e = tid; e < (size_t)nb * R; e += kThreads) L[e] = 0.0f;
    if (!per_bin)
      for (int r = tid; r < R; r += kThreads)
        s_cap[r] = (int)caps[(size_t)s * R + r];
    int parity = 0;
    for (int k = 0; k < C; ++k) {
      __syncthreads();  // the previous step's readers of s_req are done
      const int oi = row_of(order[(size_t)s * C + k], C);
      const int m = counts[oi];
      bool pos = false;
      for (int r = tid; r < R; r += kThreads) {
        const float q = reqs[(size_t)oi * R + r];
        s_req[r] = (int)q;
        pos |= q > 0.0f;
      }
      if (tid == 0) s_sum = 0u;
      const bool real = __syncthreads_or(pos) != 0;
      if (!real || m <= 0) {
        if (tid == 0) placed[(size_t)s * C + k] = real ? 0 : m;
        continue;
      }
      unsigned nsum = 0u;
      long long carry = 0;
      for (int b0 = 0; b0 < nb; b0 += kThreads) {
        const int b = b0 + tid;
        int a = 0;
        if (b < nb) {
          int amin = INT_MAX;
          for (int r = 0; r < R; ++r) {
            const int rq = s_req[r];
            if (rq <= 0) continue;
            const int ci = per_bin ? (int)__ldg(caps + (size_t)b * R + r)
                                   : s_cap[r];
            const int rem = wrap_sub(ci, (int)L[(size_t)r * nb + b]);
            amin = min(amin, floor_div(rem, rq));
          }
          a = clip(amin, 0, m);
        }
        // block-wide exclusive scan of a, in 64-bit
        long long inc = a;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const long long v = __shfl_up_sync(kFull, inc, d);
          if (lane >= d) inc += v;
        }
        if (lane == 31) wt[parity][warp] = inc;
        __syncthreads();
        long long before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const long long t = wt[parity][w];
          before += w < warp ? t : 0;
          total += t;
        }
        parity ^= 1;
        const long long c64 = carry + before + inc - a;
        const int n = clip(wrap_sub(m, (int)(unsigned)(unsigned long long)c64),
                           0, a);
        if (n != 0) {
          for (int r = 0; r < R; ++r) {
            const int rq = s_req[r];
            const size_t e = (size_t)r * nb + b;
            L[e] = __fadd_rn(L[e], (float)(int)((unsigned)n * (unsigned)rq));
          }
          nsum += (unsigned)n;
        }
        carry += total;
        const long long left = (long long)nb - (b0 + kThreads);
        if (carry >= m && left > 0 &&
            carry + left * (long long)m < (1LL << 31))
          break;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) nsum += __shfl_xor_sync(kFull, nsum, d);
      if (lane == 0) atomicAdd(&s_sum, nsum);
      __syncthreads();
      if (tid == 0) placed[(size_t)s * C + k] = (int)s_sum;
    }
    // the lane's results
    if (tid == 0) s_used = 0;
    __syncthreads();
    int mine = 0;
    for (int b = tid; b < nb; b += kThreads) {
      bool any = false;
      for (int r = 0; r < R; ++r) {
        const float v = L[(size_t)r * nb + b];
        any |= v > 0.0f;
        if (loads_out) loads_out[((size_t)s * nb + b) * R + r] = v;
      }
      if (touched) touched[b] = any;
      mine += any;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) mine += __shfl_xor_sync(kFull, mine, d);
    if (lane == 0) atomicAdd(&s_used, mine);
    __syncthreads();
    if (tid == 0) used[s] = s_used;
    __syncthreads();  // the next lane zeroes L and s_used
  }
}

size_t smem_loads(int nb, int r) {
  const size_t bytes = (size_t)nb * r * sizeof(float);
  return bytes + 2 * (size_t)r * sizeof(int) <= kSmemMax ? bytes : 0;
}

}  // namespace

// floats of workspace a launch of S lanes of nb bins x r columns needs (0:
// its loads fit shared memory).
extern "C" long long binpack_counts_workspace_floats(int S, int nb, int r) {
  if (smem_loads(nb, r)) return 0;
  return (long long)(S < kMaxGridWork ? S : kMaxGridWork) * nb * r;
}

// One call: reqs f32[C, R], counts i32[C], caps f32[S, R] (uniform) or
// f32[nb, R] (per_bin, S 1), order i32[S, C]; outputs used i32[S], placed
// i32[S, C], loads_out f32[S, nb, R] or null, touched bool[nb] or null;
// work: binpack_counts_workspace_floats(S, nb, R) floats.  All device
// pointers, rows contiguous.  One kernel launch and no other stream
// operation.  Returns a cudaError_t code.
extern "C" int binpack_counts_launch(const float* reqs, const int* counts,
                                     int C, int R, const float* caps,
                                     int per_bin, int nb, const int* order,
                                     int S, float* work, int* used,
                                     int* placed, float* loads_out,
                                     uint8_t* touched, cudaStream_t stream) {
  if (C <= 0 || R <= 0 || nb <= 0 || S <= 0 || (per_bin && S != 1))
    return (int)cudaErrorInvalidValue;
  const size_t lb = smem_loads(nb, R);
  const int in_smem = lb != 0;
  const size_t smem = 2 * (size_t)R * sizeof(int) + lb;
  if (!in_smem && smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k8_binpack_counts, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = S < (in_smem ? kMaxGrid : kMaxGridWork)
                       ? S : (in_smem ? kMaxGrid : kMaxGridWork);
  k8_binpack_counts<<<grid, kThreads, smem, stream>>>(
      reqs, counts, C, R, caps, per_bin, nb, order, S, in_smem, work, used,
      placed, loads_out, touched);
  return (int)cudaGetLastError();
}
