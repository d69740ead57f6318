// K1: masked row argmax with a rotating tie-break, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/select.py select_host (:73) and its vmap
// select_hosts_batch (:162), which XLA fused on the TPU.  For each row b of
// scores f32[B, N] under mask bool[B, N]:
//   s      = mask ? score : -3.4e38
//   best   = max(s), NaN propagating (jnp.max semantics)
//   ties   = mask & (s == best)          (-0.0 == 0.0 is a tie)
//   li     = int32(last_index0 + b), wrapping like the reference's int32
//   k      = li mod max(#ties, 1), floor modulo
//   host   = node index of the k-th tie in node order, 0 if there is none
//   feasible = any(mask)
//
// Bound: bytes.  The kernel reads B*N*5 bytes (scores and mask) once from
// device memory and does a few operations per byte, far below the card's
// ridge.  Design: one block per row.  Pass 1 reduces best and any(mask)
// with coalesced strided loads; pass 2 counts each thread's ties over a
// contiguous chunk of the row (mostly L2 hits after pass 1), a block-wide
// exclusive scan of those counts names the thread whose chunk holds tie k,
// and that thread walks its chunk for the index.  No tensor cores, no TMA:
// a later version may fuse this into the score pass so the [B, N] grid never
// reaches device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3.4e38f;

// max that propagates NaN (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
select_hosts_kernel(const float* __restrict__ scores,
                    const uint8_t* __restrict__ mask, int n, int li0,
                    int32_t* __restrict__ hosts,
                    uint8_t* __restrict__ feasible) {
  __shared__ float warp_best[kWarps];
  __shared__ int scan[kThreads];
  __shared__ float row_best;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* s_row = scores + (size_t)b * n;
  const uint8_t* m_row = mask + (size_t)b * n;

  // ---- pass 1: best over s and any(mask), coalesced
  float best = -INFINITY;
  int any = 0;
  for (int i = t; i < n; i += kThreads) {
    const bool m = m_row[i] != 0;
    any |= m;
    best = nan_max(best, m ? s_row[i] : kNeg);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = nan_max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if ((t & 31) == 0) warp_best[t >> 5] = best;
  any = __syncthreads_or(any);
  if (t == 0) {
    float v = warp_best[0];
    for (int w = 1; w < kWarps; ++w) v = nan_max(v, warp_best[w]);
    row_best = v;
  }
  __syncthreads();
  best = row_best;

  // ---- pass 2: ties per contiguous chunk, block exclusive scan
  const int chunk = (n + kThreads - 1) / kThreads;
  const int lo = min(t * chunk, n);
  const int hi = min(lo + chunk, n);
  int count = 0;
  for (int i = lo; i < hi; ++i)
    count += (m_row[i] != 0) && (s_row[i] == best);
  scan[t] = count;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // Hillis-Steele inclusive
    const int add = t >= off ? scan[t - off] : 0;
    __syncthreads();
    scan[t] += add;
    __syncthreads();
  }
  const int total = scan[kThreads - 1];
  const int before = scan[t] - count;

  if (total == 0) {
    if (t == 0) hosts[b] = 0;  // jnp.argmax of an all-false row
  } else {
    const int li = (int)((unsigned)li0 + (unsigned)b);  // int32 wrap
    int k = li % total;
    if (k < 0) k += total;  // floor modulo for a wrapped negative counter
    if (k >= before && k < before + count) {
      int seen = before;
      for (int i = lo; i < hi; ++i) {
        if ((m_row[i] != 0) && (s_row[i] == best)) {
          if (seen == k) {
            hosts[b] = i;
            break;
          }
          ++seen;
        }
      }
    }
  }
  if (t == 0) feasible[b] = any ? 1 : 0;
}

}  // namespace

extern "C" int select_hosts_launch(const float* scores, const uint8_t* mask,
                                   int rows, int n, int li0, int32_t* hosts,
                                   uint8_t* feasible, cudaStream_t stream) {
  if (rows <= 0) return 0;
  select_hosts_kernel<<<rows, kThreads, 0, stream>>>(scores, mask, n, li0,
                                                     hosts, feasible);
  return (int)cudaGetLastError();
}

extern "C" const char* select_hosts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
