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
// Arithmetic held to the reference bit for bit: adds and subtracts are
// __fadd_rn / __fsub_rn, evaluated in the reference's order
// ((requested - freed) + pod_req), never contracted; the priority sums are
// int32 (hi, lo) halves of prio ^ 0x80000000 with the carry normalised.
//
// Bound: bytes, and below them the launch.  The function reads the
// candidate rows of the two [N, E] node tables, the listed pods' rows and
// the slot list once, and writes the M-byte mask: at the live cell's
// shapes about 0.6 MB, 0.0002 ms of device memory time, far under one
// empty launch (about 0.005 ms on an H100).  So K2 is one launch and
// nothing else on the stream, and its time is a chain of dependent steps
// (loads, barriers, the ticket); the design keeps that chain short.  What
// it does about what held the first version (three kernels, a memset and a
// copy; a thread a node) far above its launch floor:
//  - Every block sorted the whole slot list.  Now a block owns 32 node rows,
//    reads the slot list (4 KB, in L2 after the first block) and each
//    listed pod's node once, keeps the few slots whose reprieve row is its
//    own, and orders those few in shared memory by ranking them: by (row,
//    slot) for the reprieve, by (row, in-segment first, arena index) for
//    freed.  No block sorts the list.
//  - Every node thread read every slot twice.  Now a row reads only its own
//    slots, and a non-candidate row reads its one-byte flag and nothing
//    else.  The listed pods' rows and keys are prefetched into L1 as they
//    are bucketed, and a row's walk issues each step's loads together, one
//    step ahead where registers allow (half a warp a row).
//  - freed/row/delta were float[64] arrays a thread, in local memory.  Now
//    kG lanes take a row, over its columns (kC a lane): E <= 16 takes half
//    a warp a row (the live cell's E is 15), E <= 32 a warp, E <= 64 a warp
//    with two columns a lane.  A victim's request row is one coalesced
//    load, freed and the step's row are registers, the fit test is one
//    ballot; `nvcc -Xptxas -v` reports no stack frame and no spill.
//    Above 64 columns (E = R + 2 + VT, and the encoder makes any R) a warp
//    takes a row and the row's freed sums live in a workspace row of E
//    floats instead of registers; its lanes read the node tables and the
//    request rows column by column, in the same order of operations.
//  - Two warps an SM hid no latency.  Now a block has 16 warps and two fit
//    an SM: at N = 6,144 the 192 blocks are resident at once.  Each thread
//    issues its rows' candidate flags and node-table columns before the
//    slot list's loads, so they arrive while the block buckets.
//  - The pick was one serial block, behind a memset and a copy.  Now each
//    block reduces its rows to one Pick, and the last block to finish (an
//    atomic ticket, which it sets back to 0 for the next launch) reduces
//    the blocks' picks and writes node, the counts and the mask's ones;
//    each slot's verdict waits for it in the workspace.  The blocks zero
//    the mask first.  The evicted counters of a row's volume identities
//    (node-local, as encoder.victim_volume_tables keys them) start from
//    vid_listed where the row's lanes first read them, so no table is
//    copied.  A row with no victim and no listed pod learns whether the
//    arena holds a pod on it (criterion 5's F32_MAX or +inf) from a scan
//    its block makes only then, so there is no marking pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 1024;  // the reference's victim-slot cap
constexpr int kMaxCols = 64;     // columns the register variants take
constexpr int kRows = 32;        // node rows a block owns
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSlotsPerThread = kMaxSlots / kThreads;
static_assert(kSlotsPerThread * kThreads == kMaxSlots, "slots split evenly");
static_assert(kRows == 32, "a block's rows are one warp's lanes");
constexpr int kPickInts = 8;  // a Pick as two int4
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMin = -2147483647 - 1;
constexpr float kF32Max = 3.40282347e38f;

struct Pick {
  int viol, prio, hi, lo, vic;
  float earliest;
  int node;  // -1: no possible node
};

__device__ __forceinline__ Pick none() {
  return Pick{0, 0, 0, 0, 0, 0.0f, -1};
}

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

// the first Pick of the warp's lanes, on every lane
__device__ __forceinline__ Pick warp_first(Pick p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Pick q;
    q.viol = __shfl_xor_sync(kFull, p.viol, off);
    q.prio = __shfl_xor_sync(kFull, p.prio, off);
    q.hi = __shfl_xor_sync(kFull, p.hi, off);
    q.lo = __shfl_xor_sync(kFull, p.lo, off);
    q.vic = __shfl_xor_sync(kFull, p.vic, off);
    q.earliest = __shfl_xor_sync(kFull, p.earliest, off);
    q.node = __shfl_xor_sync(kFull, p.node, off);
    if (before(q, p)) p = q;
  }
  return p;
}

// Prefetch the 128-byte line holding p into L1.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// K2 in one launch.  Template: kG lanes a row (16 or 32; a warp takes 32 /
// kG rows at once) and kC columns a lane (E <= kG * kC), or kC = 0: any E,
// the freed sums of row r in wide_f[r * E, (r + 1) * E).
template <int kG, int kC>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads) k2_preempt(
    const float* __restrict__ requested, const float* __restrict__ allocatable,
    const float* __restrict__ pod_req, const uint8_t* __restrict__ candidates,
    const int* __restrict__ pods_node, const int* __restrict__ pods_priority,
    const float* __restrict__ pods_req,
    const uint8_t* __restrict__ pods_violating,
    const float* __restrict__ pods_start, const int* __restrict__ slots,
    int n_slots, const int* __restrict__ slot_vids, int vmax,
    const int* __restrict__ vid_type, const int* __restrict__ vid_total,
    const int* __restrict__ vid_listed,
    const float* __restrict__ freed_vol_init, int n, int e, int m_total,
    int vt, int* __restrict__ picks, int* __restrict__ vic, int* evicted,
    unsigned* __restrict__ ticket, int32_t* __restrict__ node_out,
    uint8_t* __restrict__ victim_mask, int32_t* __restrict__ n_victims_out,
    int32_t* __restrict__ n_viol_out, float* __restrict__ wide_f) {
  constexpr bool kWide = kC == 0;
  constexpr int kCr = kWide ? 1 : kC;  // register arrays' length
  constexpr int kGroups = 32 / kG;          // rows a warp takes at once
  constexpr int kPass = kWarps * kGroups;   // rows a block takes at once
  constexpr int kPasses = kRows / kPass;
  static_assert(kPasses * kPass == kRows, "rows split evenly");
  // the block's entries: the listed slots whose reprieve row it owns
  __shared__ int s_k[kMaxSlots];    // slot index
  __shared__ int s_m[kMaxSlots];    // arena index
  __shared__ int s_row[kMaxSlots];  // local row, + kRows outside segments
  __shared__ short s_by_slot[kMaxSlots];  // entries by (row, slot)
  __shared__ short s_by_m[kMaxSlots];     // by (row, outside, arena index)
  __shared__ int s_cnt[kRows];
  __shared__ int s_start[kRows];
  __shared__ int s_need[kRows];  // 1: has_pod unknown, 2: the row holds one
  __shared__ Pick s_pick[kRows];
  __shared__ int s_n;
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / kG, gl = lane % kG;
  const unsigned gmask = kG == 32 ? kFull : (0xffffu << (g * kG));
  const int row0 = blockIdx.x * kRows;
  const int rv = e - vt;

  // zero the victim mask, 16 bytes a store where the pointer allows
  {
    const int lead = (int)((16 - ((uintptr_t)victim_mask & 15)) & 15);
    const int head = min(lead, m_total);
    const int n16 = (m_total - head) >> 4;
    uint4* v = reinterpret_cast<uint4*>(victim_mask + head);
    for (long long i = (long long)blockIdx.x * kThreads + tid; i < n16;
         i += (long long)gridDim.x * kThreads)
      v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (blockIdx.x == 0) {
      if (tid < head) victim_mask[tid] = 0;
      const int tail = head + (n16 << 4);
      if (tail + tid < m_total) victim_mask[tail + tid] = 0;
    }
  }
  if (tid < kRows) {
    s_cnt[tid] = 0;
    s_need[tid] = 0;
  }
  if (tid == 0) s_n = 0;

  // Loads in the order that lets them overlap: this thread's rows'
  // candidate flags and its slots, then the candidate rows' columns of
  // the node tables beside the slots' nodes.  A non-candidate row reads
  // nothing more.
  bool cand[kPasses];
#pragma unroll
  for (int s = 0; s < kPasses; ++s) {
    const int r = row0 + s * kPass + warp * kGroups + g;
    cand[s] = r < n && candidates[r];
  }
  int sm[kSlotsPerThread];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const int k = tid + u * kThreads;
    sm[u] = k < n_slots ? slots[k] : -1;
  }
  float q[kPasses][kCr], al[kPasses][kCr], ini[kPasses][kCr], pr[kCr];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = gl + c * kG;
    pr[c] = col < e ? pod_req[col] : 0.0f;
#pragma unroll
    for (int s = 0; s < kPasses; ++s) {
      const size_t r = row0 + s * kPass + warp * kGroups + g;
      const bool on = cand[s] && col < e;
      q[s][c] = on ? requested[r * e + col] : 0.0f;
      al[s][c] = on ? allocatable[r * e + col] : 0.0f;
      ini[s][c] = on && col >= rv ? freed_vol_init[r * vt + col - rv] : 0.0f;
    }
  }
  int snd[kSlotsPerThread];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u)
    snd[u] = sm[u] >= 0 ? pods_node[sm[u]] : -1;
  __syncthreads();

  // bucket: the scan's row is the clipped node; the segment sums drop a pod
  // outside [0, n).  vic[k] starts at -1 for every slot (a pad's in block
  // 0), and the rows' warps then mark their victims.
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const int k = tid + u * kThreads, m = sm[u], nd = snd[u];
    if (m < 0) {
      if (blockIdx.x == 0 && k < n_slots) vic[k] = -1;
      continue;
    }
    const int r = min(max(nd, 0), n - 1) - row0;
    if (r < 0 || r >= kRows) continue;
    vic[k] = -1;
    const int i = atomicAdd(&s_n, 1);
    s_k[i] = k;
    s_m[i] = m;
    s_row[i] = (nd >= 0 && nd < n) ? r : r + kRows;
    atomicAdd(&s_cnt[r], 1);
    // the rows' lanes read these next
    const float* row = pods_req + (size_t)m * e;
    prefetch_l1(row);
    prefetch_l1(row + e - 1);
    prefetch_l1(slot_vids + (size_t)k * vmax);
    prefetch_l1(pods_priority + m);
    prefetch_l1(pods_start + m);
    prefetch_l1(pods_violating + m);
  }
  __syncthreads();
  const int c = s_n;
  for (int i = tid; i < c; i += kThreads) {
    const int ki = s_k[i], wi = s_row[i];
    const int key_s = (wi & (kRows - 1)) * kMaxSlots + ki;
    const long long key_m = ((long long)((wi & (kRows - 1)) * 2 + wi / kRows)
                             << 41) |
                            ((long long)s_m[i] << 10) | ki;
    int rs = 0, rm = 0;
    for (int j = 0; j < c; ++j) {
      const int kj = s_k[j], wj = s_row[j];
      rs += (wj & (kRows - 1)) * kMaxSlots + kj < key_s;
      rm += (((long long)((wj & (kRows - 1)) * 2 + wj / kRows) << 41) |
             ((long long)s_m[j] << 10) | kj) < key_m;
    }
    s_by_slot[rs] = (short)i;
    s_by_m[rm] = (short)i;
  }
  if (warp == 0) {
    const int v = s_cnt[lane];
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    s_start[lane] = incl - v;
  }
  __syncthreads();

  // kG lanes a node row, over the columns gl + c * kG.  Loops run to the
  // warp's longest row, each row's lanes idle past their own.
  bool need = false;  // this thread's row wants the arena scan
#pragma unroll
  for (int s = 0; s < kPasses; ++s) {
    const int j = s * kPass + warp * kGroups + g;
    const int r = row0 + j;
    const int beg = s_start[j], cnt = cand[s] ? s_cnt[j] : 0;
    // Each loop below reads one entry of the row a step.  The loads of a
    // step are issued together and, with half a warp a row (whose
    // registers allow it), one step ahead of their use.
    constexpr bool kAhead = kG == 16;
    // freed: the row's listed pods in ascending arena index (its outside
    // entries come last), then its initial volume credit.  On the way, the
    // row's volume identities start at their listed holders (only this
    // row's lanes touch them).
    struct Listed {
      float rw[kCr];  // the request row, this lane's columns (0 outside)
      int vid;       // the entry's volume id number gl, or -1
    };
    auto load_listed = [&](int t, Listed& x) {
      const bool act = t < cnt;
      const int i = act ? s_by_m[beg + t] : 0;
      const bool seg = act && s_row[i] < kRows;
      const float* row = pods_req + (size_t)s_m[i] * e;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const int col = gl + cc * kG;
        x.rw[cc] = seg && col < e ? row[col] : 0.0f;
      }
      x.vid = act && gl < vmax ? slot_vids[(size_t)s_k[i] * vmax + gl] : -1;
    };
    float f[kCr];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) f[cc] = 0.0f;
    // the wide variant's freed sums: this row's workspace row, lane-owned
    // columns gl + kG * c
    float* fw = kWide && cand[s] ? wide_f + (size_t)r * e : nullptr;
    if constexpr (kWide) {
      if (fw != nullptr)
        for (int col = gl; col < e; col += kG) fw[col] = 0.0f;
    }
    bool has_seg = false;
    const int tmax = __reduce_max_sync(kFull, cnt);
    Listed lcur{}, lnext{};
    if (kAhead && tmax > 0) load_listed(0, lcur);
    for (int t = 0; t < tmax; ++t) {
      if (!kAhead)
        load_listed(t, lcur);
      else if (t + 1 < tmax)
        load_listed(t + 1, lnext);
      if (t < cnt) {
        const int i = s_by_m[beg + t];
        const int* vids = slot_vids + (size_t)s_k[i] * vmax;
        for (int v = gl; v < vmax; v += kG) {
          const int id = v == gl ? lcur.vid : vids[v];
          if (id >= 0) evicted[id] = vid_listed[id];
        }
        if (s_row[i] < kRows) {
          has_seg = true;
#pragma unroll
          for (int cc = 0; cc < kC; ++cc)
            if (gl + cc * kG < e) f[cc] = __fadd_rn(f[cc], lcur.rw[cc]);
          if constexpr (kWide) {
            const float* row = pods_req + (size_t)s_m[i] * e;
            for (int col = gl; col < e; col += kG)
              fw[col] = __fadd_rn(fw[col], row[col]);
          }
        }
      }
      if (kAhead) lcur = lnext;
    }
    __syncwarp();
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      const int col = gl + cc * kG;
      if (col < e && col >= rv) f[cc] = __fadd_rn(f[cc], ini[s][cc]);
    }
    if constexpr (kWide) {
      if (fw != nullptr)
        for (int col = gl; col < e; col += kG)
          if (col >= rv)
            fw[col] = __fadd_rn(fw[col],
                                freed_vol_init[(size_t)r * vt + col - rv]);
    }
    // the pod fits: no requested column of the row's lanes with
    // (requested - freed) + pod_req > allocatable
    auto fits = [&](const float* w) {
      bool bad = false;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        bad |= pr[cc] > 0.0f &&
               __fadd_rn(__fsub_rn(q[s][cc], w[cc]), pr[cc]) > al[s][cc];
      return (__ballot_sync(kFull, bad) & gmask) == 0u;
    };
    // the same test in the wide variant, on the row's columns of the
    // node tables and w(col); `on`: the row is a candidate (its tables may
    // be read).  Every lane votes.
    auto fits_wide = [&](bool on, auto w) {
      bool bad = false;
      if (on)
        for (int col = gl; col < e; col += kG) {
          const float p = pod_req[col];
          if (p > 0.0f)
            bad |= __fadd_rn(__fsub_rn(requested[(size_t)r * e + col],
                                       w(col)),
                             p) > allocatable[(size_t)r * e + col];
        }
      return (__ballot_sync(kFull, bad) & gmask) == 0u;
    };
    bool possible;  // every lane votes
    if constexpr (kWide)
      possible = fits_wide(cand[s], [&](int col) { return fw[col]; }) &&
                 cand[s];
    else
      possible = fits(f) && cand[s];
    // the reprieve: the row's entries in slot order
    struct Step {
      float rw[kCr];  // the request row, this lane's columns
      int vid0;      // the entry's first volume id, or -1
      int p;         // priority, start and PDB flag of an in-segment entry
      float st;
      bool pv;
    };
    int n_vic = 0, n_viol = 0, max_prio = kIntMin, hi = 0, lo = 0;
    float earliest = kF32Max;
    const int pcnt = possible ? cnt : 0;
    auto load_step = [&](int t, Step& x) {
      const bool act = t < pcnt;
      const int i = act ? s_by_slot[beg + t] : 0;
      const int m = s_m[i];
      const bool seg = act && s_row[i] < kRows;
      const float* row = pods_req + (size_t)m * e;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const int col = gl + cc * kG;
        x.rw[cc] = act && col < e ? row[col] : 0.0f;
      }
      x.vid0 = act ? slot_vids[(size_t)s_k[i] * vmax] : -1;
      x.p = seg ? pods_priority[m] : 0;
      x.st = seg ? pods_start[m] : 0.0f;
      x.pv = seg && pods_violating[m];
    };
    const int pmax = __reduce_max_sync(kFull, pcnt);
    Step cur{}, next{};
    if (kAhead && pmax > 0) load_step(0, cur);
    for (int t = 0; t < pmax; ++t) {
      if (!kAhead)
        load_step(t, cur);
      else if (t + 1 < pmax)
        load_step(t + 1, next);
      const bool act = t < pcnt;
      const int i = act ? s_by_slot[beg + t] : 0;
      const int k = s_k[i];
      const bool seg = act && s_row[i] < kRows;
      const int* vids = slot_vids + (size_t)k * vmax;
      float w[kCr];
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const int col = gl + cc * kG;
        w[cc] = act && col < e ? __fsub_rn(f[cc], cur.rw[cc]) : 0.0f;
      }
      // reprieving the first holder of a fully evicted volume restores its
      // attachment; the counts are read before this step's decrements
      if (act && vt > 0) {
        float d[kCr];
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) d[cc] = 0.0f;
        for (int v = 0; v < vmax; ++v) {
          const int id = v == 0 ? cur.vid0 : vids[v];
          if (id < 0) continue;
          const int ty = vid_type[id];
          if (ty < 0 || ty >= vt || evicted[id] < vid_total[id]) continue;
#pragma unroll
          for (int cc = 0; cc < kC; ++cc)
            if (ty == gl + cc * kG - rv) d[cc] += 1.0f;
        }
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          const int col = gl + cc * kG;
          if (col < e && col >= rv) w[cc] = __fadd_rn(w[cc], -d[cc]);
        }
      }
      bool keep;
      if constexpr (kWide) {
        // w(col): freed less the victim's request, less one in a volume
        // column whose identity the reprieve would restore (the counts
        // read before this step's decrements)
        const float* prow = pods_req + (size_t)s_m[i] * e;
        auto wcol = [&](int col) {
          float x = __fsub_rn(fw[col], prow[col]);
          if (vt > 0 && col >= rv) {
            float dd = 0.0f;
            for (int v = 0; v < vmax; ++v) {
              const int id = v == 0 ? cur.vid0 : vids[v];
              if (id < 0) continue;
              const int ty = vid_type[id];
              if (ty < 0 || ty >= vt || evicted[id] < vid_total[id]) continue;
              if (ty == col - rv) dd += 1.0f;
            }
            x = __fadd_rn(x, -dd);
          }
          return x;
        };
        keep = fits_wide(act, wcol) && act;
        if (keep)
          for (int col = gl; col < e; col += kG) fw[col] = wcol(col);
        // every lane has read the counts before lane 0 decrements them
        __syncwarp();
      } else {
        keep = fits(w) && act;
      }
      if (keep) {
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) f[cc] = w[cc];
        if (gl == 0)
          for (int v = 0; v < vmax; ++v) {
            const int id = v == 0 ? cur.vid0 : vids[v];
            if (id >= 0) evicted[id] -= 1;
          }
      }
      __syncwarp();
      if (seg && !keep) {
        ++n_vic;
        n_viol += cur.pv ? 1 : 0;
        const unsigned u = (unsigned)cur.p ^ 0x80000000u;
        hi += (int)(u >> 16);
        lo += (int)(u & 0xffffu);
        if (cur.p > max_prio) {
          max_prio = cur.p;
          earliest = cur.st;
        } else if (cur.p == max_prio && cur.st < earliest) {
          earliest = cur.st;
        }
        if (gl == 0) vic[k] = r;
      }
      if (kAhead) cur = next;
    }
    // no victim: F32_MAX if the row holds a pod, +inf if none; a listed
    // pod in its segment says it does, else the block scans the arena
    if (possible && n_vic == 0 && !has_seg) {
      need = true;
      if (gl == 0) s_need[j] = 1;
    }
    if (gl == 0)
      s_pick[j] = possible ? Pick{n_viol, max_prio, hi + (lo >> 16),
                                  lo & 0xffff, n_vic, earliest, r}
                           : none();
  }

  if (__syncthreads_or(need)) {
    for (int i = tid; i < m_total; i += kThreads) {
      const int r = pods_node[i] - row0;
      if (r >= 0 && r < kRows && s_need[r]) s_need[r] = 2;
    }
    __syncthreads();
    if (tid < kRows && s_need[tid])
      s_pick[tid].earliest = s_need[tid] == 2 ? kF32Max : INFINITY;
  }
  if (warp == 0) {
    const Pick p = warp_first(s_pick[lane]);
    if (lane == 0) {
      int4* out = reinterpret_cast<int4*>(picks) + 2 * blockIdx.x;
      out[0] = make_int4(p.viol, p.prio, p.hi, p.lo);
      out[1] = make_int4(p.vic, __float_as_int(p.earliest), p.node, 0);
    }
  }

  // The last block to finish takes the pick.  The barrier orders the
  // block's writes before thread 0's ticket, an acq_rel atomic at gpu
  // scope: its release is cumulative (the writes are visible before the
  // ticket is), and its acquire lets the last block read what the others
  // wrote, after the barrier below.
  __syncthreads();
  if (tid == 0) {
    unsigned before_me;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(before_me)
                 : "l"(ticket)
                 : "memory");
    s_last = before_me == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // this thread's slots' verdicts, loaded beside the blocks' picks
  int vr[kSlotsPerThread];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const int k = tid + u * kThreads;
    vr[u] = k < n_slots ? __ldcg(vic + k) : -1;
  }
  Pick best = none();
  const int4* in = reinterpret_cast<const int4*>(picks);
  for (int b = tid; b < (int)gridDim.x; b += kThreads) {
    const int4 x = __ldcg(in + 2 * b), y = __ldcg(in + 2 * b + 1);
    const Pick cb{x.x, x.y, x.z, x.w, y.x, __int_as_float(y.y), y.z};
    if (before(cb, best)) best = cb;
  }
  best = warp_first(best);
  if (lane == 0) s_pick[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const Pick p = warp_first(lane < kWarps ? s_pick[lane] : none());
    if (lane == 0) {
      s_n = p.node;
      node_out[0] = p.node;
      n_victims_out[0] = p.node >= 0 ? p.vic : 0;
      n_viol_out[0] = p.node >= 0 ? p.viol : 0;
      *ticket = 0u;
    }
  }
  __syncthreads();
  const int chosen = s_n;
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u)
    if (chosen >= 0 && vr[u] == chosen) victim_mask[sm[u]] = 1;
}

}  // namespace

// 32-bit scratch one launch needs: a Pick a block, then each slot's verdict
// [n_slots] (the row it is a victim on, or -1), the evicted counters
// [n_vids] and, above kMaxCols columns, the freed sums f32[n, e].
extern "C" int preempt_one_workspace_ints(int n, int n_slots, int n_vids,
                                          int e) {
  return kPickInts * ((n + kRows - 1) / kRows) + n_slots + n_vids +
         (e > kMaxCols ? n * e : 0);
}

// One preemption pick: one kernel launch and no other stream operation.
// Pointers are device pointers; bool tensors are one byte an element.
// workspace: int32[preempt_one_workspace_ints(...)], scratch the launch owns
// until the stream passes it; ticket: one uint32 that is 0 before the
// launch and that the launch leaves at 0 (so a stream may reuse it, one
// launch at a time).  Returns a cudaError_t code.
extern "C" int preempt_one_launch(
    const float* requested, const float* allocatable, const float* pod_req,
    const uint8_t* candidates, const int* pods_node, const int* pods_priority,
    const float* pods_req, const uint8_t* pods_violating,
    const float* pods_start, const int* slots, const int* slot_vids,
    const int* vid_type, const int* vid_total, const int* vid_listed,
    const float* freed_vol_init, int n, int e, int m_total, int n_slots,
    int vmax, int n_vids, int vt, int* workspace, unsigned* ticket,
    int32_t* node_out, uint8_t* victim_mask, int32_t* n_victims_out,
    int32_t* n_viol_out, cudaStream_t stream) {
  if (n <= 0 || e <= 0 || vt < 0 || vt > e || m_total <= 0 ||
      n_slots <= 0 || n_slots > kMaxSlots || vmax <= 0 || n_vids <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kRows - 1) / kRows;
  int* picks = workspace;
  int* vic = picks + (size_t)kPickInts * blocks;
  int* evicted = vic + n_slots;
  float* wide = reinterpret_cast<float*>(evicted + n_vids);
  auto kernel = e <= 16          ? k2_preempt<16, 1>
                : e <= 32        ? k2_preempt<32, 1>
                : e <= kMaxCols  ? k2_preempt<32, 2>
                                 : k2_preempt<32, 0>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      requested, allocatable, pod_req, candidates, pods_node, pods_priority,
      pods_req, pods_violating, pods_start, slots, n_slots, slot_vids, vmax,
      vid_type, vid_total, vid_listed, freed_vol_init, n, e, m_total, vt,
      picks, vic, evicted, ticket, node_out, victim_mask, n_victims_out,
      n_viol_out, wide);
  return (int)cudaGetLastError();
}
