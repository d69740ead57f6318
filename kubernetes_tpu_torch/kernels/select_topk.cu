// K3: the winner-pinned top-k of each row, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/select.py select_topk (:114) and its vmap
// select_topk_batch (:152), which XLA fused on the TPU beside the selector.
// It is a read-only companion to K1: it takes K1's (hosts, feasible) for
// the same rows instead of recomputing them.  For each row b of scores
// f32[B, N] under mask bool[B, N], with h = hosts[b], f = feasible[b]:
//   s       = mask ? score : -3.4e38
//   col 0   = (h, s[h]) when f, else (-1, -3.4e38)
//   s2      = s with s[h] set to -3.4e38 when f
//   col 1.. = the K-1 best of s2 in the reference's top_k order: higher
//             first in the total order of order_key (-0.0 below 0.0, a
//             positive NaN above +inf), the lower node first among equal
//             keys
//   a column whose value is not above -1.7e38 reads (-1, 0.0)
//   feasible_count = popcount(mask row)
// An h outside [0, N) is read as the reference indexes it (a negative h
// wraps once, then it clamps) and masks out no column.
//
// Bound: bytes.  The function reads B*N*5 bytes (scores and mask) and the
// B hosts and flags, and writes B*(8K+4): the same 0.0188 ms as K1 at
// [2048, 6144] on the card's HBM.  What the design does about it:
//  - One read of the row.  A block of 256 threads takes a row; in its one
//    pass over device memory each thread turns its nodes into 32-bit order
//    keys (the winner's already set to the filler), keeps them in shared
//    memory when the row has at most 40,960 nodes, counts the mask and
//    keeps its best packed key for the first runner-up.  Wider rows (up to
//    K1's 70,000 cases and beyond) are read again for each later pass.
//  - No exclusion list.  A node's packed key is (order key << 31) | (2^31
//    - 1 - node): unique, and ordered exactly as top_k orders. Runner-up j
//    is the largest packed key strictly below runner-up j-1's, so each pass
//    is one max reduction with one compare a node, for any K.
//  - Two barriers a reduction: warp shuffles, then one warp over the eight
//    warps' maxima.
// No tensor cores and no TMA: a later version may fuse this with K1, whose
// row pass already reads the same bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "select_row.cuh"

namespace {

using select_row::kIdxMask;
using select_row::key_value;
using select_row::kNeg;
using select_row::order_key;
using select_row::pack;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMaxN = 40960;  // rows kept in shared memory

// max over the block; every thread gets it.  red holds kWarps + 1 values.
__device__ __forceinline__ long long block_max(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long u = __shfl_xor_sync(kFull, v, off);
    v = u > v ? u : v;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? red[lane] : LLONG_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long u = __shfl_xor_sync(kFull, w, off);
      w = u > w ? u : w;
    }
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const long long out = red[kWarps];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

__device__ __forceinline__ int block_sum(int v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? (int)red[lane] : 0;
    w = __reduce_add_sync(kFull, w);
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const int out = (int)red[kWarps];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads) k3_select_topk(
    const float* __restrict__ scores, const uint8_t* __restrict__ mask,
    const int* __restrict__ hosts, const uint8_t* __restrict__ feasible,
    int N, int K, int use_smem, int* __restrict__ top_nodes,
    float* __restrict__ top_scores, int* __restrict__ feasible_count) {
  extern __shared__ int keys[];
  __shared__ long long red[kWarps + 1];
  const int b = blockIdx.x;
  const float* srow = scores + (size_t)b * N;
  const uint8_t* mrow = mask + (size_t)b * N;
  const int h = hosts[b];
  const bool f = feasible[b] != 0;
  // s2's key of node n: the winner (when feasible) reads the filler
  auto key_of = [&](int n) -> int {
    const float v = (f && n == h) ? kNeg : (mrow[n] ? srow[n] : kNeg);
    return order_key(v);
  };
  int count = 0;
  long long best = LLONG_MIN;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const bool m = mrow[n] != 0;
    count += m;
    const float v = (f && n == h) ? kNeg : (m ? srow[n] : kNeg);
    const int k = order_key(v);
    if (use_smem) keys[n] = k;
    const long long p = pack(k, n);
    best = p > best ? p : best;
  }
  count = block_sum(count, &red[0]);  // its barriers publish keys[] too
  int* nodes_out = top_nodes + (size_t)b * K;
  float* scores_out = top_scores + (size_t)b * K;
  const float half = kNeg * 0.5f;
  if (threadIdx.x == 0) {
    feasible_count[b] = count;
    int hr = h < 0 ? h + N : h;
    hr = hr < 0 ? 0 : (hr >= N ? N - 1 : hr);
    const float wv = f ? (mrow[hr] ? srow[hr] : kNeg) : kNeg;
    const bool ok = wv > half;
    nodes_out[0] = ok ? (f ? h : -1) : -1;
    scores_out[0] = ok ? wv : 0.0f;
  }
  for (int j = 1; j < K; ++j) {
    const long long pick = block_max(best, &red[0]);
    if (threadIdx.x == 0) {
      const int n = (int)(kIdxMask - (pick & kIdxMask));
      const float v = key_value((int)(pick >> 31));
      const bool ok = v > half;
      nodes_out[j] = ok ? n : -1;
      scores_out[j] = ok ? v : 0.0f;
    }
    if (j + 1 == K) break;
    best = LLONG_MIN;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const long long p = pack(use_smem ? keys[n] : key_of(n), n);
      if (p < pick && p > best) best = p;
    }
  }
}

}  // namespace

extern "C" int select_topk_smem_max_n() { return kSmemMaxN; }

// K3 over B rows; outputs top_nodes i32[B, K], top_scores f32[B, K],
// feasible_count i32[B].  Returns the cudaError_t of the launch.
extern "C" int select_topk_launch(const float* scores, const uint8_t* mask,
                                  const int* hosts, const uint8_t* feasible,
                                  int B, int N, int K, int* top_nodes,
                                  float* top_scores, int* feasible_count,
                                  cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > N) return (int)cudaErrorInvalidValue;
  const int use_smem = N <= kSmemMaxN;
  const size_t smem = use_smem ? (size_t)N * sizeof(int) : 0;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      k3_select_topk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kSmemMaxN * sizeof(int)));
  if (e != cudaSuccess) return (int)e;
  k3_select_topk<<<B, kThreads, smem, stream>>>(
      scores, mask, hosts, feasible, N, K, use_smem, top_nodes, top_scores,
      feasible_count);
  return (int)cudaGetLastError();
}
