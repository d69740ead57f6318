// K6: the megacycle's chained spread-count commit, for Hopper (sm_90a).
//
// Replaces the JAX package's models/megacycle.py _commit_group_counts
// (:78), the step of mega_impl's lax.scan (:188) that folds one window's
// placements into the carried SelectorSpread counts before the next window
// is scheduled: gc + node_onehot[B, N]^T . pod_group_onehot[B, G], a
// HIGHEST-precision f32 product there.  Given gc f32[N, G], the window's
// hosts i32[B] and its pods' group slots group_ids i32[B, S] and
// group_valid bool[B, S], it writes a NEW tensor
//   out[n, g] = gc[n, g] + #{(b, s) : hosts[b] == n, group_valid[b, s],
//                                     group_ids[b, s] == g}
// A pod with hosts < 0 (unschedulable or padding) adds nothing; a pod that
// lists one group in two valid slots adds 2, as ops/priorities.py
// pod_group_onehot's sum does.  gc is never written: it may be the live
// scheduler's resident snapshot, which the dirty-row scatter refreshes in
// place from the host truth.
//
// Exactness: every addend is 1 and every count stays below 2^24, so each
// partial sum is an integer that f32 holds exactly, and atomic adds in any
// order give the reference's product bit for bit.
//
// Bound: bytes.  The function reads gc and writes out (N * G * 4 bytes
// each) and reads the window's hosts and slots once; at the live cell's
// shape (N 6,144, G 32, B 2,048) that is about 1.6 MB, 0.0005 ms at the
// card's 3.35 TB/s, under one empty launch.  So K6 is one launch and no
// other stream operation, and what it costs past the launch is latency:
// one load from memory and one walk of the window's pods.  What the design
// does about it: a block owns kTile consecutive elements of out (any G; a
// tile may start or end inside a row), enough blocks to cover the SMs at
// the live shape (192 at G 32).  Each thread issues its gc loads into
// registers and zeroes its share of a shared-memory tile of deltas, so the
// memory latency overlaps the walk: every block reads the window's hosts
// (a few KB, from L2 after the first block) and adds, with shared-memory
// atomics, the (pod, slot) pairs that land in its own elements.  Then each
// thread writes gc + delta.  No block waits on another and there is no
// second pass.  gc + delta is exact (both integers below 2^24), so it is
// the reference's gc + product bit for bit.  No tensor cores and no TMA:
// there is no matrix work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 1024;  // elements of out a block owns
constexpr int kPer = kTile / kThreads;

__global__ void __launch_bounds__(kThreads) k6_commit_group_counts(
    const float* __restrict__ gc, const int* __restrict__ hosts,
    const int* __restrict__ gids, const uint8_t* __restrict__ gvalid, int n,
    int g, int b, int s, float* __restrict__ out) {
  __shared__ float delta[kTile];
  const long long e0 = (long long)blockIdx.x * kTile;
  const long long e1 = min(e0 + kTile, (long long)n * g);
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = e0 + k * kThreads + threadIdx.x;
    v[k] = i < e1 ? gc[i] : 0.0f;
    delta[k * kThreads + threadIdx.x] = 0.0f;
  }
  __syncthreads();
  // the rows this tile touches, to skip most pods on one compare
  const int r0 = (int)(e0 / g), r1 = (int)((e1 - 1) / g);
#pragma unroll 4
  for (int pod = threadIdx.x; pod < b; pod += kThreads) {
    const int h = hosts[pod];
    if (h < r0 || h > r1) continue;
    for (int j = 0; j < s; ++j) {
      const size_t p = (size_t)pod * s + j;
      const int grp = gids[p];
      if (!gvalid[p] || grp < 0 || grp >= g) continue;
      const long long i = (long long)h * g + grp;
      if (i >= e0 && i < e1) atomicAdd(delta + (i - e0), 1.0f);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = e0 + k * kThreads + threadIdx.x;
    if (i < e1) out[i] = v[k] + delta[k * kThreads + threadIdx.x];
  }
}

}  // namespace

// One window's commit: gc, out f32[n, g] (out a separate buffer), hosts
// i32[b], gids i32[b, s], gvalid bool[b, s] (a byte each), all device
// pointers, rows contiguous.  One kernel launch and no other stream
// operation.  Returns a cudaError_t code.
extern "C" int commit_group_counts_launch(const float* gc, const int* hosts,
                                          const int* gids,
                                          const uint8_t* gvalid, int n, int g,
                                          int b, int s, float* out,
                                          cudaStream_t stream) {
  if (n <= 0 || g <= 0 || b < 0 || s < 0 || gc == out)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n * g + kTile - 1) / kTile;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  k6_commit_group_counts<<<(unsigned)blocks, kThreads, 0, stream>>>(
      gc, hosts, gids, gvalid, n, g, b, s, out);
  return (int)cudaGetLastError();
}
