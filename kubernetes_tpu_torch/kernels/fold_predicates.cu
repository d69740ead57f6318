// K7: the predicate fold of one filter pass, for Hopper (sm_90a).
//
// Replaces the fold at the end of the JAX package's ops/predicates.py
// filter_batch (`jnp.all(stack, 1) & alive`, :464-467) and first_failure
// (:479-488), which models/generic.py schedule_batch_independent (:23)
// computes for the extender seam's FitError attribution.  Given the stacked
// predicate verdicts per_pred bool[B, K, N] (K = NUM_PREDICATES rows in
// PREDICATE_ORDER), the node rows' valid bool[N] and the pods' valid
// bool[B], it writes in one pass over the stack
//   mask[b, n]    = AND_k per_pred[b, k, n] & valid[n] & pod_valid[b]
//   failure[b, n] = the first k with !per_pred[b, k, n], or K if none
// failure ignores valid and pod_valid, as first_failure does.
//
// Bound: bytes.  The stack is read once (B * K * N bytes) and the outputs
// written once (5 * B * N bytes); there is no arithmetic to speak of.  At
// the extender's shape [1, 23, 6,144] that is 172 KB, far below one launch;
// at [2,048, 23, 6,144] 352 MB, 0.105 ms at the card's 3.35 TB/s.  So the
// design is the simple one that streams: a thread owns 4 consecutive nodes
// of one pod row and walks k = 0..K-1, loading one 4-byte word of the row
// per k (a warp reads 128 consecutive bytes, coalesced along N), and keeps
// the first failure of each of its nodes in registers.  Then it writes 4
// mask bytes and 4 failure words, as one uchar4 and one int4 store where N
// is a multiple of 4 and the pointers allow it, else byte by byte with the
// tail past N skipped.  No shared memory, no barrier, no second pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads) k7_fold_predicates(
    const uint8_t* __restrict__ per_pred, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ pod_valid, int b_rows, int k_rows, int n,
    long long quads, uint8_t* __restrict__ mask, int* __restrict__ failure) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)b_rows * quads) return;
  const int b = (int)(t / quads);
  const int n0 = (int)(t - (long long)b * quads) * 4;
  int fail[4] = {k_rows, k_rows, k_rows, k_rows};
  const uint8_t* row = per_pred + (size_t)b * k_rows * n + n0;
  for (int k = 0; k < k_rows; ++k, row += n) {
    uint8_t v[4];
    if (kVec) {
      const uchar4 w = __ldg(reinterpret_cast<const uchar4*>(row));
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = n0 + j < n ? __ldg(row + j) : 1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (fail[j] == k_rows && !v[j]) fail[j] = k;
  }
  const bool pv = pod_valid[b] != 0;
  const size_t o = (size_t)b * n + n0;
  if (kVec) {
    const uchar4 nv = __ldg(reinterpret_cast<const uchar4*>(valid + n0));
    uchar4 m;
    m.x = pv && nv.x && fail[0] == k_rows;
    m.y = pv && nv.y && fail[1] == k_rows;
    m.z = pv && nv.z && fail[2] == k_rows;
    m.w = pv && nv.w && fail[3] == k_rows;
    *reinterpret_cast<uchar4*>(mask + o) = m;
    *reinterpret_cast<int4*>(failure + o) =
        make_int4(fail[0], fail[1], fail[2], fail[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + j >= n) break;
      mask[o + j] = pv && valid[n0 + j] && fail[j] == k_rows;
      failure[o + j] = fail[j];
    }
  }
}

}  // namespace

// The fold of one filter pass: per_pred bool[b, k, n], valid bool[n],
// pod_valid bool[b] (a byte each), mask bool[b, n] and failure i32[b, n]
// written; all device pointers, rows contiguous.  vec != 0 takes the
// 4-byte loads and the uchar4 / int4 stores, which need n % 4 == 0 and
// per_pred, valid and mask 4-byte aligned and failure 16-byte aligned.
// One kernel launch and no other stream operation.  Returns a
// cudaError_t code.
extern "C" int fold_predicates_launch(const uint8_t* per_pred,
                                      const uint8_t* valid,
                                      const uint8_t* pod_valid, int b, int k,
                                      int n, int vec, uint8_t* mask,
                                      int* failure, cudaStream_t stream) {
  if (b <= 0 || k < 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (vec && (n % 4 || (uintptr_t)per_pred % 4 || (uintptr_t)valid % 4 ||
              (uintptr_t)mask % 4 || (uintptr_t)failure % 16))
    return (int)cudaErrorInvalidValue;
  const long long quads = (n + 3) / 4;
  const long long blocks = ((long long)b * quads + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (vec)
    k7_fold_predicates<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        per_pred, valid, pod_valid, b, k, n, quads, mask, failure);
  else
    k7_fold_predicates<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        per_pred, valid, pod_valid, b, k, n, quads, mask, failure);
  return (int)cudaGetLastError();
}
