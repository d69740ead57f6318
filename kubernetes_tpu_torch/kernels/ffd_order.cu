// K9: the first-fit-decreasing class order, for Hopper (sm_90a).
//
// Replaces the JAX package's models/binpack.py ffd_order (:127), which
// binpack_shapes (:210), binpack_shapes_compressed (:233) and the capacity
// planner's stage 1 (runtime/capacity.py :159) run once a candidate shape.
// Given reqs f32[C, R] and caps f32[S, R] it writes order i32[S, C]: lane s
// sorts the C items by
//   frac[i, r] = reqs[i, r] / max(caps[s, r], 1e-30)     (IEEE f32 division)
//   primary    = max over r of frac[i, r]                  (NaN propagates)
// descending, then frac[i, 0], frac[i, 1], ... descending, then the input
// index ascending: jnp.lexsort's stable order over (-frac[:, R-1], ...,
// -frac[:, 0], -primary).  The reference's sort comparator canonicalises
// its float keys first (every zero to +0.0, every NaN to one +NaN) and then
// compares them in IEEE total order; each key here is mapped to an int32 in
// that same order (key32), so -0.0 and 0.0 tie and NaNs sort last.
//
// Design: an item's place is its rank, the number of items that sort
// before it.  Block (x, s) owns kThreads items of lane s, one a thread, and
// walks all C items of the lane in tiles of kThreads: each tile's primary
// keys are computed once into shared memory, and a thread counts the tile
// items whose key is below its own.  Only an equal primary key takes the
// slow path, which compares the column keys (recomputed from reqs) and
// then the index.  The rank is a permutation, so every block writes its
// items' places without conflict.  Any C and any R.
//
// Bound: operations.  A lane needs C * C key compares (about C^2 / 2 of
// them decide a pair) and C * R divisions; the bytes (reqs and caps read
// once, order written once) are a few MB at the BASELINE sweep (S 10,000,
// C 256, R 8).  The O(C^2) rank is what a simple kernel that is right
// costs: a merge or radix sort would cut it to O(C log C) (PERF.md).  No
// tensor cores and no TMA: there is no matrix work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// IEEE total order on the canonicalised key -x: zeros to +0, NaN to +NaN.
__device__ __forceinline__ int key32(float x) {
  float v = -x;
  if (v == 0.0f) return 0;
  if (isnan(v)) return 0x7fc00000;
  const int b = __float_as_int(v);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

__device__ __forceinline__ float frac(const float* __restrict__ reqs, int i,
                                      int r, int R, const float* capm) {
  return __fdiv_rn(reqs[(size_t)i * R + r], capm[r]);
}

__device__ __forceinline__ int primary_key(const float* __restrict__ reqs,
                                           int i, int R, const float* capm) {
  float m = frac(reqs, i, 0, R, capm);
  for (int r = 1; r < R; ++r) {
    const float f = frac(reqs, i, r, R, capm);
    m = (isnan(m) || isnan(f)) ? __int_as_float(0x7fc00000) : fmaxf(m, f);
  }
  return key32(m);
}

// does item j sort before item i (their primary keys are equal)?
__device__ __forceinline__ bool tie_before(const float* __restrict__ reqs,
                                           int j, int i, int R,
                                           const float* capm) {
  for (int r = 0; r < R; ++r) {
    const int kj = key32(frac(reqs, j, r, R, capm));
    const int ki = key32(frac(reqs, i, r, R, capm));
    if (kj != ki) return kj < ki;
  }
  return j < i;
}

__global__ void __launch_bounds__(kThreads) k9_ffd_order(
    const float* __restrict__ reqs, int C, int R,
    const float* __restrict__ caps, int* __restrict__ order) {
  extern __shared__ float capm[];  // [R]: max(caps[s], 1e-30), NaN kept
  __shared__ int tile[kThreads];
  const int s = blockIdx.y;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float c = caps[(size_t)s * R + r];
    capm[r] = isnan(c) ? c : (c > 1e-30f ? c : 1e-30f);
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool mine = i < C;
  const int ki = mine ? primary_key(reqs, i, R, capm) : INT_MAX;
  int rank = 0;
  for (int j0 = 0; j0 < C; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    tile[threadIdx.x] = j < C ? primary_key(reqs, j, R, capm) : INT_MAX;
    __syncthreads();
    if (mine) {
      const int n = min(kThreads, C - j0);
      for (int jj = 0; jj < n; ++jj) {
        const int kj = tile[jj];
        if (kj < ki) {
          ++rank;
        } else if (kj == ki && j0 + jj != i &&
                   tie_before(reqs, j0 + jj, i, R, capm)) {
          ++rank;
        }
      }
    }
    __syncthreads();
  }
  if (mine) order[(size_t)s * C + rank] = i;
}

}  // namespace

// order i32[S, C] of reqs f32[C, R] under each lane's caps f32[S, R]; all
// device pointers, rows contiguous.  One kernel launch and no other stream
// operation.  Returns a cudaError_t code.
extern "C" int ffd_order_launch(const float* reqs, int C, int R,
                                const float* caps, int S, int* order,
                                cudaStream_t stream) {
  if (C <= 0 || R <= 0 || S <= 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k9_ffd_order, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((C + kThreads - 1) / kThreads, S);
  k9_ffd_order<<<grid, kThreads, smem, stream>>>(reqs, C, R, caps, order);
  return (int)cudaGetLastError();
}
