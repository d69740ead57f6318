// K2: the preemption what-if, its reprieve and the node pick, for Hopper
// (sm_90a).
//
// Replaces the JAX package's models/preemption.py preempt_one (:308, with
// has_vols, the path its pick_preemption_node takes) and _exact_prio_sum
// (:284).  For one preemptor over N nodes and an arena of M pods, with
// E = R + 2 + VT extended resource columns and Kv <= 1024 victim slots in
// reprieve order:
//   freed[n]  = the requests of node n's listed pods, added in ascending
//               arena index, then its initial volume credit
//   possible  = candidate & the pod fits: no column c with pod_req[c] > 0
//               and requested - freed + pod_req > allocatable
//   reprieve  = walk n's slots in slot order; re-add a victim (freed minus
//               its request, and minus 1 in a volume column whose identity
//               was fully evicted) while the pod still fits
//   keys      = PDB violations, highest victim priority, the exact priority
//               sum as (hi, lo), victim count, earliest start among the
//               top-priority victims
//   node      = the lexicographic minimum over possible nodes (criterion 5
//               maximised), the lowest row on a full tie; -1 if none
//   victim_mask[M], n_victims, n_pdb_violations of the picked node.
//
// The reference runs the reprieve as one lax.scan over the slots.  Steps
// on different nodes are independent (the volume tables key every identity
// by its node, so even the evicted counters are node-local), so here a
// thread owns a node and walks its own slots in order.  Three kernels:
//   k2_mark_nodes   which rows hold any arena pod (an empty segment's
//                   earliest start is +inf in the reference, F32_MAX else)
//   k2_node_pass    a thread a node; each block first copies the slot list
//                   to shared memory and sorts a copy by arena index, so
//                   that freed adds in the reference's order
//   k2_pick         one block: the lexicographic argmin, then the mask
//
// Arithmetic held to the reference bit for bit: adds and subtracts are
// __fadd_rn / __fsub_rn, evaluated in the reference's order
// ((requested - freed) + pod_req), never contracted; the priority sums are
// int32 (hi, lo) halves of prio ^ 0x80000000 with the carry normalised.
//
// Bound: bytes, and far below them in practice.  The function reads the two
// [N, E] node tables, the listed pods' rows and the arena's node column
// once, and writes the M-byte mask; at the live cell's shapes that is about
// a microsecond of device memory time.  This first version spends its time
// on latency instead: every node thread scans the whole slot list in
// shared memory twice, and the pick is one block.  A later version can
// bucket the slots by node first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 1024;  // the reference's victim-slot cap
constexpr int kMaxCols = 64;     // extended resource columns
constexpr int kNodeThreads = 64;
constexpr int kPickThreads = 1024;
constexpr int kIntMax = 2147483647;
constexpr int kIntMin = -2147483647 - 1;
constexpr float kF32Max = 3.40282347e38f;

// the pod fits on a node with this freed row: no requested column with
// (requested - freed) + pod_req > allocatable
__device__ __forceinline__ bool fits(const float* freed, const float* req,
                                     const float* alloc, const float* pod_req,
                                     int e) {
  for (int c = 0; c < e; ++c) {
    const float p = pod_req[c];
    if (p > 0.0f && __fadd_rn(__fsub_rn(req[c], freed[c]), p) > alloc[c])
      return false;
  }
  return true;
}

__global__ void k2_mark_nodes(const int* __restrict__ pods_node, int m_total,
                              int n, int* __restrict__ has_pod) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m_total;
       i += gridDim.x * blockDim.x) {
    const int nd = pods_node[i];
    if (nd >= 0 && nd < n) has_pod[nd] = 1;
  }
}

__global__ void __launch_bounds__(kNodeThreads) k2_node_pass(
    const float* __restrict__ requested, const float* __restrict__ allocatable,
    const float* __restrict__ pod_req, const uint8_t* __restrict__ candidates,
    const int* __restrict__ pods_node, const int* __restrict__ pods_priority,
    const float* __restrict__ pods_req,
    const uint8_t* __restrict__ pods_violating,
    const float* __restrict__ pods_start, const int* __restrict__ slots,
    int n_slots, const int* __restrict__ slot_vids, int vmax,
    const int* __restrict__ vid_type, const int* __restrict__ vid_total,
    const float* __restrict__ freed_vol_init, int n, int e, int vt,
    const int* __restrict__ has_pod, int* __restrict__ possible_out,
    int* __restrict__ n_viol_out, int* __restrict__ max_prio_out,
    int* __restrict__ hi_out, int* __restrict__ lo_out,
    int* __restrict__ n_vic_out, float* __restrict__ earliest_out,
    int* __restrict__ kept, int* evicted) {
  __shared__ int s_m[kMaxSlots];      // slot order: arena index, -1 pads
  __shared__ int s_rep[kMaxSlots];    // slot order: the reprieve row
  __shared__ int s_seg[kMaxSlots];    // slot order: the segment row or -1
  __shared__ int s_key[kMaxSlots];    // by arena index: m, kIntMax pads
  __shared__ int s_knode[kMaxSlots];  // by arena index: the segment row
  int pad = 1;
  while (pad < n_slots) pad <<= 1;
  for (int k = threadIdx.x; k < pad; k += blockDim.x) {
    int m = -1, rep = -1, seg = -1;
    if (k < n_slots) {
      m = slots[k];
      if (m >= 0) {
        const int nd = pods_node[m];
        // the scan's row is the clipped node; the segment sums drop a pod
        // outside [0, n)
        rep = min(max(nd, 0), n - 1);
        seg = (nd >= 0 && nd < n) ? nd : -1;
      }
      s_m[k] = m;
      s_rep[k] = rep;
      s_seg[k] = seg;
    }
    s_key[k] = seg >= 0 ? m : kIntMax;
    s_knode[k] = seg;
  }
  __syncthreads();
  // bitonic sort of (s_key, s_knode) by key: the listed pods in ascending
  // arena index (keys are distinct but for the pads)
  for (int size = 2; size <= pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < pad; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const int a = s_key[i], b = s_key[j];
          if ((a > b) == up) {
            s_key[i] = b;
            s_key[j] = a;
            const int t = s_knode[i];
            s_knode[i] = s_knode[j];
            s_knode[j] = t;
          }
        }
      }
      __syncthreads();
    }
  }

  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  if (!candidates[node]) {
    possible_out[node] = 0;
    return;
  }
  float freed[kMaxCols];
  float row[kMaxCols];
  float delta[kMaxCols];
  for (int c = 0; c < e; ++c) freed[c] = 0.0f;
  for (int i = 0; i < pad && s_key[i] != kIntMax; ++i) {
    if (s_knode[i] != node) continue;
    const float* r = pods_req + (size_t)s_key[i] * e;
    for (int c = 0; c < e; ++c) freed[c] = __fadd_rn(freed[c], r[c]);
  }
  const int rv = e - vt;
  for (int t = 0; t < vt; ++t)
    freed[rv + t] =
        __fadd_rn(freed[rv + t], freed_vol_init[(size_t)node * vt + t]);
  const float* req = requested + (size_t)node * e;
  const float* alloc = allocatable + (size_t)node * e;
  if (!fits(freed, req, alloc, pod_req, e)) {
    possible_out[node] = 0;
    return;
  }

  int n_vic = 0, n_viol = 0, max_prio = kIntMin, hi = 0, lo = 0;
  float earliest = kF32Max;
  for (int k = 0; k < n_slots; ++k) {
    if (s_rep[k] != node) continue;
    const int m = s_m[k];
    const float* r = pods_req + (size_t)m * e;
    for (int c = 0; c < e; ++c) row[c] = __fsub_rn(freed[c], r[c]);
    const int* vids = slot_vids + (size_t)k * vmax;
    // reprieving the first holder of a fully evicted volume restores its
    // attachment; the counts are read before this step's decrements
    for (int t = 0; t < vt; ++t) delta[t] = 0.0f;
    for (int v = 0; v < vmax; ++v) {
      const int id = vids[v];
      if (id < 0) continue;
      const int t = vid_type[id];
      if (evicted[id] >= vid_total[id] && t >= 0 && t < vt) delta[t] += 1.0f;
    }
    for (int t = 0; t < vt; ++t)
      row[rv + t] = __fadd_rn(row[rv + t], -delta[t]);
    const bool keep = fits(row, req, alloc, pod_req, e);
    kept[k] = keep;
    if (keep) {
      for (int c = 0; c < e; ++c) freed[c] = row[c];
      for (int v = 0; v < vmax; ++v) {
        const int id = vids[v];
        if (id >= 0) evicted[id] -= 1;
      }
    } else if (s_seg[k] == node) {
      ++n_vic;
      n_viol += pods_violating[m] ? 1 : 0;
      const int p = pods_priority[m];
      const unsigned u = (unsigned)p ^ 0x80000000u;
      hi += (int)(u >> 16);
      lo += (int)(u & 0xffffu);
      const float s = pods_start[m];
      if (p > max_prio) {
        max_prio = p;
        earliest = s;
      } else if (p == max_prio && s < earliest) {
        earliest = s;
      }
    }
  }
  possible_out[node] = 1;
  n_viol_out[node] = n_viol;
  max_prio_out[node] = max_prio;
  hi_out[node] = hi + (lo >> 16);
  lo_out[node] = lo & 0xffff;
  n_vic_out[node] = n_vic;
  earliest_out[node] =
      n_vic > 0 ? earliest : (has_pod[node] ? kF32Max : INFINITY);
}

struct Pick {
  int viol, prio, hi, lo, vic;
  float earliest;
  int node;  // -1: no possible node
};

// a ranks before b: criteria 1-4 low, 5 high, then the lower row
__device__ __forceinline__ bool before(const Pick& a, const Pick& b) {
  if (a.node < 0) return false;
  if (b.node < 0) return true;
  if (a.viol != b.viol) return a.viol < b.viol;
  if (a.prio != b.prio) return a.prio < b.prio;
  if (a.hi != b.hi) return a.hi < b.hi;
  if (a.lo != b.lo) return a.lo < b.lo;
  if (a.vic != b.vic) return a.vic < b.vic;
  if (a.earliest != b.earliest) return a.earliest > b.earliest;
  return a.node < b.node;
}

__global__ void __launch_bounds__(kPickThreads) k2_pick(
    const int* __restrict__ possible, const int* __restrict__ n_viol,
    const int* __restrict__ max_prio, const int* __restrict__ hi,
    const int* __restrict__ lo, const int* __restrict__ n_vic,
    const float* __restrict__ earliest, int n, const int* __restrict__ slots,
    int n_slots, const int* __restrict__ pods_node,
    const uint8_t* __restrict__ pods_violating, int m_total,
    const int* __restrict__ kept, int32_t* __restrict__ node_out,
    uint8_t* __restrict__ victim_mask, int32_t* __restrict__ n_victims_out,
    int32_t* __restrict__ n_viol_out) {
  __shared__ Pick s_pick[kPickThreads];
  __shared__ int s_sum[2][kPickThreads / 32];
  const int tid = threadIdx.x;
  Pick best{0, 0, 0, 0, 0, 0.0f, -1};
  for (int i = tid; i < n; i += blockDim.x) {
    if (!possible[i]) continue;
    const Pick c{n_viol[i], max_prio[i], hi[i], lo[i], n_vic[i], earliest[i],
                 i};
    if (before(c, best)) best = c;
  }
  s_pick[tid] = best;
  __syncthreads();
  for (int half = blockDim.x >> 1; half > 0; half >>= 1) {
    if (tid < half && before(s_pick[tid + half], s_pick[tid]))
      s_pick[tid] = s_pick[tid + half];
    __syncthreads();
  }
  const int chosen = s_pick[0].node;
  if (tid == 0) node_out[0] = chosen;
  for (int i = tid; i < m_total; i += blockDim.x) victim_mask[i] = 0;
  __syncthreads();
  int cnt = 0, viol = 0;
  if (chosen >= 0) {
    for (int k = tid; k < n_slots; k += blockDim.x) {
      const int m = slots[k];
      if (m >= 0 && pods_node[m] == chosen && !kept[k]) {
        victim_mask[m] = 1;
        ++cnt;
        viol += pods_violating[m] ? 1 : 0;
      }
    }
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  viol = __reduce_add_sync(0xffffffffu, viol);
  if ((tid & 31) == 0) {
    s_sum[0][tid >> 5] = cnt;
    s_sum[1][tid >> 5] = viol;
  }
  __syncthreads();
  if (tid == 0) {
    int a = 0, b = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      a += s_sum[0][w];
      b += s_sum[1][w];
    }
    n_victims_out[0] = a;
    n_viol_out[0] = b;
  }
}

}  // namespace

// One preemption pick.  Pointers are device pointers; bool tensors are one
// byte an element.  workspace: int32[8 * n + n_slots + n_vids], scratch the
// launch owns until the stream passes it.  Returns a cudaError_t code.
extern "C" int preempt_one_launch(
    const float* requested, const float* allocatable, const float* pod_req,
    const uint8_t* candidates, const int* pods_node, const int* pods_priority,
    const float* pods_req, const uint8_t* pods_violating,
    const float* pods_start, const int* slots, const int* slot_vids,
    const int* vid_type, const int* vid_total, const int* vid_listed,
    const float* freed_vol_init, int n, int e, int m_total, int n_slots,
    int vmax, int n_vids, int vt, int* workspace, int32_t* node_out,
    uint8_t* victim_mask, int32_t* n_victims_out, int32_t* n_viol_out,
    cudaStream_t stream) {
  if (n <= 0 || e <= 0 || e > kMaxCols || vt < 0 || vt > e || m_total <= 0 ||
      n_slots <= 0 || n_slots > kMaxSlots || vmax <= 0 || n_vids <= 0)
    return (int)cudaErrorInvalidValue;
  int* has_pod = workspace;
  int* possible = workspace + n;
  int* n_viol = workspace + 2 * (size_t)n;
  int* max_prio = workspace + 3 * (size_t)n;
  int* hi = workspace + 4 * (size_t)n;
  int* lo = workspace + 5 * (size_t)n;
  int* n_vic = workspace + 6 * (size_t)n;
  float* earliest = reinterpret_cast<float*>(workspace + 7 * (size_t)n);
  int* kept = workspace + 8 * (size_t)n;
  int* evicted = kept + n_slots;
  cudaError_t err =
      cudaMemsetAsync(has_pod, 0, sizeof(int) * (size_t)n, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(evicted, vid_listed, sizeof(int) * (size_t)n_vids,
                        cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  const int mark_blocks = m_total < 1024 * 256 ? (m_total + 255) / 256 : 1024;
  k2_mark_nodes<<<mark_blocks, 256, 0, stream>>>(pods_node, m_total, n,
                                                  has_pod);
  k2_node_pass<<<(n + kNodeThreads - 1) / kNodeThreads, kNodeThreads, 0,
                 stream>>>(
      requested, allocatable, pod_req, candidates, pods_node, pods_priority,
      pods_req, pods_violating, pods_start, slots, n_slots, slot_vids, vmax,
      vid_type, vid_total, freed_vol_init, n, e, vt, has_pod, possible,
      n_viol, max_prio, hi, lo, n_vic, earliest, kept, evicted);
  k2_pick<<<1, kPickThreads, 0, stream>>>(
      possible, n_viol, max_prio, hi, lo, n_vic, earliest, n, slots, n_slots,
      pods_node, pods_violating, m_total, kept, node_out, victim_mask,
      n_victims_out, n_viol_out);
  return (int)cudaGetLastError();
}
