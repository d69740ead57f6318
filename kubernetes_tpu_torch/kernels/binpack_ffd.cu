// K4: first-fit packing of pods into bins, for Hopper (sm_90a).
//
// Replaces the lax.scan of the JAX package's models/binpack.py binpack_ffd
// (:59), the first-fit step of the quality observatory's regret
// counterfactual (runtime/quality.py _ffd_counterfactual, :153).  Given
// reqs f32[P, R], per-bin capacities cap f32[N, R] (or one f32[R] row for
// every bin: cap_stride 0) and order i32[P], with loads f32[N, R] = 0:
//   for k in 0..P-1:
//     req   = reqs[order[k]]   (a negative index wraps once, then clamps)
//     real  = any(req > 0)
//     fits  = all(loads[n] + req <= cap[n])     per bin n, f32, no FMA
//     idx   = the first n that fits
//     ok    = real and some bin fits
//     if ok: loads[idx] += req
//     placed[k] = ok or not real
//   used = #bins with any(loads > 0)
//
// Bound: a chain of P dependent steps.  The bytes (reqs, cap, order read
// once; loads and placed written once) are under a megabyte at the
// regret's shape (N 6,144, R 8, P 2,048): 0.00015 ms of HBM time.  Each
// step needs the previous step's loads, so the floor is P times one
// block-wide min reduction and barrier; binpack_ffd_floor_launch times
// exactly that with no memory traffic.  (PERF.md holds the times.)  What the design does about it:
//  - One persistent block of T threads (1,024 for up to 8 columns, 512
//    for up to 16, 256 for up to 32, 128 for up to 64).  Thread t owns
//    bins t, t + T, ...: it alone reads and writes their loads, so a
//    step needs no barrier to publish an update,
//    only one for the reduction.  Its first bin's loads and capacity live
//    in registers, so a step over a cluster whose first fit lies in the
//    first T bins touches no memory but the request row.
//  - Loads in shared memory, column-major ([R][N], conflict-free for
//    neighbouring threads), when N * R * 4 bytes fit (N 6,144 x R 8:
//    192 KiB); else in a global workspace of the same layout.  Capacities
//    are read through the read-only path.
//  - A step tests the bins in rounds of T, lowest first, and stops after
//    the first round where a bin fits: over a cluster whose first fit lies
//    in the first T bins, one round of register compares a step.  A bin's
//    columns are tested without short-circuit, so a later round's
//    capacity loads go out together.
//  - One barrier a round: each warp's minimum goes to a slot double
//    buffered by the reductions' parity, and every warp reduces the slots
//    itself.
//  - Request rows are staged 64 steps at a time (fewer past 16 columns:
//    the ring stays 4 KiB) into a ring in shared memory (one extra
//    barrier and one load latency a chunk), so a step reads its row with
//    a broadcast from shared memory instead of waiting on device memory.
// R is the next power of two past 4 + the extended resource names, so any
// R can come.  Up to 64 columns the same kernel keeps the row in
// registers with fewer threads (256 for 32 columns, 128 for 64); above,
// k4_binpack_ffd_wide takes the same steps with no row in registers: a
// step reads its request row from device memory (a broadcast through L1)
// and every bin's loads from the shared-memory or workspace table, column
// by column.  The arithmetic and the order of the reductions are the same
// in every variant, so the result is too.
// No tensor cores and no TMA: there is no matrix work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;  // the ring's row width up to 16 columns
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory K4 may take (the card's 227 KiB a block, less a
// few KiB for the static slots and the request ring)
constexpr size_t kSmemDyn = 220 * 1024;
// request rows staged in shared memory at a time (one barrier a chunk)
constexpr int kChunk = 64;

__device__ __forceinline__ int row_of(const int* __restrict__ order, int k,
                                      int P) {
  int oi = order[k];
  if (oi < 0) oi += P;
  return oi < 0 ? 0 : (oi >= P ? P - 1 : oi);
}

// C: the register width of a request row (R <= C); T: threads.  Thread t
// owns bins t, t + T, ...; its first bin's loads and capacity stay in
// registers (ld0, cap0), the others' loads in L ([R][N]).
template <int C, int T>
__global__ void __launch_bounds__(T, 1) k4_binpack_ffd(
    const float* __restrict__ reqs, int P, int R,
    const float* __restrict__ cap, int cap_stride,
    const int* __restrict__ order, int N, float* work, int use_smem,
    float* __restrict__ loads_out, uint8_t* __restrict__ placed,
    int* __restrict__ used) {
  constexpr int kWarps = T / 32;
  extern __shared__ float smem[];
  __shared__ int red[2][32];
  __shared__ int tot[32];
  // the ring holds kChunk rows of 16 columns: fewer rows when wider
  constexpr int kCh = kChunk * kMaxCols / (C > kMaxCols ? C : kMaxCols);
  __shared__ float ring[kChunk * kMaxCols];  // [step in chunk][R]
  float* L = use_smem ? smem : work;  // [R][N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has0 = tid < N;
  float ld0[C], cap0[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    ld0[r] = 0.0f;
    cap0[r] = (has0 && r < R) ? __ldg(cap + (size_t)tid * cap_stride + r)
                              : 0.0f;
  }
  for (int n = tid + T; n < N; n += T) {
#pragma unroll
    for (int r = 0; r < C; ++r)
      if (r < R) L[(size_t)r * N + n] = 0.0f;
  }
  float rq[C];
  int parity = 0;  // the slot buffer of the next reduction
  for (int k = 0; k < P; ++k) {
    const int j = k % kCh;
    if (j == 0) {
      // the next kCh request rows, in order, into the ring: every read
      // of the previous chunk came before the last step's barrier
      for (int i = tid; i < kCh * R; i += T) {
        const int step = k + i / R;
        ring[i] = step < P
            ? __ldg(reqs + (size_t)row_of(order, step, P) * R + i % R)
            : 0.0f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < C; ++r) rq[r] = r < R ? ring[j * R + r] : 0.0f;
    bool real = false;
#pragma unroll
    for (int r = 0; r < C; ++r)
      if (r < R) real |= rq[r] > 0.0f;
    // rounds of T bins, lowest first: round 0 tests every thread's first
    // bin (registers), and a later round runs only when no bin of the
    // earlier ones fits, so the first fit is the first round's minimum
    int idx = INT_MAX;
    for (int base = 0; base < N && idx == INT_MAX; base += T) {
      const int n = base + tid;
      int mine = INT_MAX;
      if (n < N) {
        bool fit = true;
        if (base == 0) {
#pragma unroll
          for (int r = 0; r < C; ++r)
            if (r < R) fit &= __fadd_rn(ld0[r], rq[r]) <= cap0[r];
        } else {
          const float* c = cap + (size_t)n * cap_stride;
#pragma unroll
          for (int r = 0; r < C; ++r)
            if (r < R)
              fit &= __fadd_rn(L[(size_t)r * N + n], rq[r]) <= __ldg(c + r);
        }
        if (fit) mine = n;
      }
      const int wmin = __reduce_min_sync(kFull, mine);
      if (lane == 0) red[parity][warp] = wmin;
      __syncthreads();
      idx = __reduce_min_sync(kFull,
                              lane < kWarps ? red[parity][lane] : INT_MAX);
      parity ^= 1;
    }
    const bool ok = real && idx != INT_MAX;
    if (ok && idx % T == tid) {
      if (idx == tid) {
#pragma unroll
        for (int r = 0; r < C; ++r)
          if (r < R) ld0[r] = __fadd_rn(ld0[r], rq[r]);
      } else {
#pragma unroll
        for (int r = 0; r < C; ++r)
          if (r < R) {
            float* l = L + (size_t)r * N + idx;
            *l = __fadd_rn(*l, rq[r]);
          }
      }
    }
    if (tid == 0) placed[k] = (ok || !real) ? 1 : 0;
  }
  int mine_used = 0;
  for (int n = tid; n < N; n += T) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < C; ++r)
      if (r < R) {
        const float v = n == tid ? ld0[r] : L[(size_t)r * N + n];
        loads_out[(size_t)n * R + r] = v;
        any |= v > 0.0f;
      }
    mine_used += any;
  }
  mine_used = __reduce_add_sync(kFull, mine_used);
  if (lane == 0) tot[warp] = mine_used;
  __syncthreads();
  if (warp == 0) {
    const int s = __reduce_add_sync(kFull, lane < kWarps ? tot[lane] : 0);
    if (lane == 0) used[0] = s;
  }
}

// K4 for any R: the same steps with the loads of every bin in L ([R][N])
// and the request row read from device memory.  Thread t owns bins t,
// t + T, ...: it alone tests and updates them.
template <int T>
__global__ void __launch_bounds__(T, 1) k4_binpack_ffd_wide(
    const float* __restrict__ reqs, int P, int R,
    const float* __restrict__ cap, int cap_stride,
    const int* __restrict__ order, int N, float* work, int use_smem,
    float* __restrict__ loads_out, uint8_t* __restrict__ placed,
    int* __restrict__ used) {
  constexpr int kWarps = T / 32;
  extern __shared__ float smem[];
  __shared__ int red[2][32];
  __shared__ int tot[32];
  float* L = use_smem ? smem : work;  // [R][N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int n = tid; n < N; n += T)
    for (int r = 0; r < R; ++r) L[(size_t)r * N + n] = 0.0f;
  int parity = 0;  // the slot buffer of the next reduction
  for (int k = 0; k < P; ++k) {
    const float* rq = reqs + (size_t)row_of(order, k, P) * R;
    bool real = false;
    for (int r = 0; r < R; ++r) real |= __ldg(rq + r) > 0.0f;
    int idx = INT_MAX;
    for (int base = 0; base < N && idx == INT_MAX; base += T) {
      const int n = base + tid;
      int mine = INT_MAX;
      if (n < N) {
        const float* c = cap + (size_t)n * cap_stride;
        bool fit = true;
        for (int r = 0; r < R && fit; ++r)
          fit = __fadd_rn(L[(size_t)r * N + n], __ldg(rq + r)) <= __ldg(c + r);
        if (fit) mine = n;
      }
      const int wmin = __reduce_min_sync(kFull, mine);
      if (lane == 0) red[parity][warp] = wmin;
      __syncthreads();
      idx = __reduce_min_sync(kFull,
                              lane < kWarps ? red[parity][lane] : INT_MAX);
      parity ^= 1;
    }
    const bool ok = real && idx != INT_MAX;
    if (ok && idx % T == tid)
      for (int r = 0; r < R; ++r) {
        float* l = L + (size_t)r * N + idx;
        *l = __fadd_rn(*l, __ldg(rq + r));
      }
    if (tid == 0) placed[k] = (ok || !real) ? 1 : 0;
  }
  int mine_used = 0;
  for (int n = tid; n < N; n += T) {
    bool any = false;
    for (int r = 0; r < R; ++r) {
      const float v = L[(size_t)r * N + n];
      loads_out[(size_t)n * R + r] = v;
      any |= v > 0.0f;
    }
    mine_used += any;
  }
  mine_used = __reduce_add_sync(kFull, mine_used);
  if (lane == 0) tot[warp] = mine_used;
  __syncthreads();
  if (warp == 0) {
    const int s = __reduce_add_sync(kFull, lane < kWarps ? tot[lane] : 0);
    if (lane == 0) used[0] = s;
  }
}

// K4's step chain with nothing in it: per step one warp minimum, one slot
// write, one barrier and one slot minimum, as K4's 1,024-thread variant
// does; no memory.
__global__ void __launch_bounds__(1024, 1) k4_floor(int steps, int* sink) {
  __shared__ int red[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int acc = 0;
  for (int k = 0; k < steps; ++k) {
    const int w = __reduce_min_sync(kFull, (int)threadIdx.x + k);
    if (lane == 0) red[k & 1][warp] = w;
    __syncthreads();
    acc += __reduce_min_sync(kFull, red[k & 1][lane]);
  }
  if (acc == -1) sink[0] = acc;  // never true; keeps the loop
}

template <int C, int T>
int launch(const float* reqs, int P, int R, const float* cap, int cap_stride,
           const int* order, int N, float* work, int smem, float* loads,
           uint8_t* placed, int* used, cudaStream_t stream) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      k4_binpack_ffd<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemDyn);
  if (e != cudaSuccess) return (int)e;
  k4_binpack_ffd<C, T><<<1, T, smem, stream>>>(
      reqs, P, R, cap, cap_stride, order, N, work, smem > 0, loads, placed,
      used);
  return (int)cudaGetLastError();
}

int launch_wide(const float* reqs, int P, int R, const float* cap,
                int cap_stride, const int* order, int N, float* work,
                int smem, float* loads, uint8_t* placed, int* used,
                cudaStream_t stream) {
  constexpr int T = 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      k4_binpack_ffd_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemDyn);
  if (e != cudaSuccess) return (int)e;
  k4_binpack_ffd_wide<T><<<1, T, smem, stream>>>(
      reqs, P, R, cap, cap_stride, order, N, work, smem > 0, loads, placed,
      used);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of dynamic shared memory K4 takes for N bins of R columns: their
// loads, or 0 when they do not fit (then the caller passes a workspace of
// N * R floats)
extern "C" int binpack_ffd_smem_bytes(int n, int r) {
  const size_t b = (size_t)n * (size_t)r * sizeof(float);
  return b <= kSmemDyn ? (int)b : 0;
}

extern "C" int binpack_ffd_launch(const float* reqs, int P, int R,
                                  const float* cap, int cap_stride,
                                  const int* order, int N, float* work,
                                  float* loads, uint8_t* placed, int* used,
                                  cudaStream_t stream) {
  if (P < 0 || R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int smem = binpack_ffd_smem_bytes(N, R);
  if (smem == 0 && work == nullptr) return (int)cudaErrorInvalidValue;
  // up to 8 columns: 1,024 threads (64 registers each); up to 16: 512;
  // up to 32: 256; up to 64: 128; more: the wide variant, no row in
  // registers
  if (R <= 8)
    return launch<8, 1024>(reqs, P, R, cap, cap_stride, order, N, work, smem,
                           loads, placed, used, stream);
  if (R <= 16)
    return launch<16, 512>(reqs, P, R, cap, cap_stride, order, N, work, smem,
                           loads, placed, used, stream);
  if (R <= 32)
    return launch<32, 256>(reqs, P, R, cap, cap_stride, order, N, work, smem,
                           loads, placed, used, stream);
  if (R <= 64)
    return launch<64, 128>(reqs, P, R, cap, cap_stride, order, N, work, smem,
                           loads, placed, used, stream);
  return launch_wide(reqs, P, R, cap, cap_stride, order, N, work, smem, loads,
                     placed, used, stream);
}

extern "C" int binpack_ffd_floor_launch(int steps, cudaStream_t stream) {
  k4_floor<<<1, 1024, 0, stream>>>(steps, nullptr);
  return (int)cudaGetLastError();
}
