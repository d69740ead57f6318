// K10: the replicas' sequenced admission scan, for Hopper (sm_90a).
//
// Replaces the lax.scan `run` of the JAX package's runtime/reconciler.py
// ConflictReconciler._kernel (:185-209): the check a commit runs when a
// sibling replica committed since its dispatch, or a namespace quota is
// set.  Given, per candidate slot j of Bp, the node segment u_node[j] and
// the tenant segment u_ns[j] (first-occurrence slots, in [0, Bp)), the
// request row reqs[j], the live node headroom node_head[j] and tenant
// headroom ns_head[j] (f32[Bp, R]), and the DRF order i32[Bp], it walks
// the order one candidate at a time with spent_n, spent_t f32[Bp, R] = 0:
//   node_ok = all over r of rq <= (hn - spent_n[un]) + 1e-3   (f32, so)
//   ns_ok   = all over r of rq <= (ht - spent_t[ut]) + 1e-3
//   if node_ok and ns_ok: spent_n[un] += rq; spent_t[ut] += rq
// and writes admit[j] = node_ok and ns_ok, quota_ok[j] = ns_ok, in
// candidate order.  Padded slots carry zero requests and +inf headroom.
//
// Design: one block.  Every thread stages the next kChunk candidates'
// rows (through the order's gather) into shared memory; then warp 0 walks
// them, lane r holding columns r, r + 32, ...: two votes (__all_sync) a
// candidate and, when it is admitted, each lane adds its own columns, so a
// lane only ever reads the spent values it wrote.  The spent tables live
// in shared memory when they fit (Bp 2,048 x R 8: 128 KiB), else in a
// global workspace.  The f32 subtraction, addition and compare are
// written with __fsub_rn / __fadd_rn in the reference's order.
//
// Bound: a chain of Bp dependent steps.  The bytes (three i32[Bp] and
// three f32[Bp, R] read once, two bool[Bp] written once) are under 250 KB
// at Bp 2,048, R 8: 0.00007 ms of HBM time; the chain and its votes are
// the cost.  No tensor cores and no TMA: there is no matrix work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;
constexpr size_t kSmemMax = 200 * 1024;
constexpr float kEps = 1e-3f;

__device__ __forceinline__ int clamp_row(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__global__ void __launch_bounds__(kThreads, 1) k10_reconcile_admit(
    const int* __restrict__ u_node, const int* __restrict__ u_ns,
    const int* __restrict__ order, const float* __restrict__ reqs,
    const float* __restrict__ node_head, const float* __restrict__ ns_head,
    int Bp, int R, int kc_max, int spent_in_smem, float* __restrict__ work,
    uint8_t* __restrict__ admit, uint8_t* __restrict__ quota_ok) {
  extern __shared__ float dyn[];
  float* stage = dyn;                                  // [kc][3][R]
  float* spent_n = spent_in_smem ? dyn + (size_t)kc_max * 3 * R : work;
  float* spent_t = spent_n + (size_t)Bp * R;
  __shared__ int s_j[kChunk], s_un[kChunk], s_ut[kChunk];
  const int tid = threadIdx.x, lane = tid & 31;
  for (size_t e = tid; e < 2 * (size_t)Bp * R; e += kThreads)
    spent_n[e] = 0.0f;
  for (int k0 = 0; k0 < Bp; k0 += kc_max) {
    const int kc = min(kc_max, Bp - k0);
    __syncthreads();  // zeroing done / warp 0 done with the last chunk
    for (int q = tid; q < kc; q += kThreads) {
      const int j = clamp_row(order[k0 + q], Bp);
      s_j[q] = j;
      s_un[q] = clamp_row(u_node[j], Bp);
      s_ut[q] = clamp_row(u_ns[j], Bp);
    }
    __syncthreads();
    for (int e = tid; e < kc * R; e += kThreads) {
      const int q = e / R, r = e - q * R;
      const size_t src = (size_t)s_j[q] * R + r;
      float* row = stage + (size_t)q * 3 * R;
      row[r] = reqs[src];
      row[R + r] = node_head[src];
      row[2 * R + r] = ns_head[src];
    }
    __syncthreads();
    if (tid < 32) {
      for (int q = 0; q < kc; ++q) {
        const float* row = stage + (size_t)q * 3 * R;
        float* sn = spent_n + (size_t)s_un[q] * R;
        float* st = spent_t + (size_t)s_ut[q] * R;
        bool nok = true, tok = true;
        for (int r = lane; r < R; r += 32) {
          const float rq = row[r];
          nok &= rq <= __fadd_rn(__fsub_rn(row[R + r], sn[r]), kEps);
          tok &= rq <= __fadd_rn(__fsub_rn(row[2 * R + r], st[r]), kEps);
        }
        nok = __all_sync(kFull, nok);
        tok = __all_sync(kFull, tok);
        const bool ok = nok && tok;
        if (ok) {
          for (int r = lane; r < R; r += 32) {
            sn[r] = __fadd_rn(sn[r], row[r]);
            st[r] = __fadd_rn(st[r], row[r]);
          }
        }
        if (lane == 0) {
          admit[s_j[q]] = ok;
          quota_ok[s_j[q]] = tok;
        }
        __syncwarp();
      }
    }
  }
}

int chunk_rows(int r) {
  const int kc = (int)((48 * 1024) / ((size_t)3 * r * sizeof(float)));
  return kc < 1 ? 1 : (kc > kChunk ? kChunk : kc);
}

bool spent_fits(int bp, int r) {
  return (size_t)chunk_rows(r) * 3 * r * sizeof(float) +
             2 * (size_t)bp * r * sizeof(float) <= kSmemMax;
}

}  // namespace

// floats of workspace a launch of bp slots x r columns needs (0: the
// spent tables fit shared memory).
extern "C" long long reconcile_admit_workspace_floats(int bp, int r) {
  return spent_fits(bp, r) ? 0 : 2LL * bp * r;
}

// u_node, u_ns, order i32[bp]; reqs, node_head, ns_head f32[bp, r];
// admit, quota_ok bool[bp]; work: reconcile_admit_workspace_floats(bp, r)
// floats.  All device pointers, rows contiguous.  One kernel launch and no
// other stream operation.  Returns a cudaError_t code.
extern "C" int reconcile_admit_launch(const int* u_node, const int* u_ns,
                                      const int* order, const float* reqs,
                                      const float* node_head,
                                      const float* ns_head, int bp, int r,
                                      float* work, uint8_t* admit,
                                      uint8_t* quota_ok,
                                      cudaStream_t stream) {
  if (bp <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
  const int kc = chunk_rows(r);
  const int in_smem = spent_fits(bp, r);
  const size_t smem = (size_t)kc * 3 * r * sizeof(float) +
                      (in_smem ? 2 * (size_t)bp * r * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k10_reconcile_admit, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k10_reconcile_admit<<<1, kThreads, smem, stream>>>(
      u_node, u_ns, order, reqs, node_head, ns_head, bp, r, kc, in_smem,
      work, admit, quota_ok);
  return (int)cudaGetLastError();
}
