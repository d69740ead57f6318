// The row-select rules of K1 (select_hosts.cu) and K3 (select_topk.cu),
// shared with K13 (seq_scan.cu), which selects one row a step inside its
// scan.  They are the JAX package's ops/select.py rules:
//   * a row's max propagates NaN (jnp.max), and a NaN max has no tie;
//   * -0.0 == 0.0 is a tie;
//   * the winner is the (li mod #ties)-th tie in node order, li the int32
//     rotation counter (it wraps), the modulo a floor modulo;
//   * top_k ranks by the total order of order_key: -0.0 below 0.0, a
//     positive NaN above +inf and a negative NaN below -inf, the lower node
//     first among equal keys.

#pragma once

#include <cuda_runtime.h>

namespace select_row {

constexpr float kNeg = -3.4e38f;  // the masked-out filler
constexpr long long kIdxMask = (1LL << 31) - 1;

// max that propagates NaN (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Folds a max s that has t ties into the running max m with c ties.  NaN
// sticks, and once m is NaN, c means nothing.  -0.0 == 0.0, so the two
// count as one value.
__device__ __forceinline__ void fold(float& m, int& c, float s, int t) {
  if (s > m) {
    m = s;
    c = t;
  } else if (s == m) {
    c += t;
  } else if (s != s) {
    m = s;
  }
}

__device__ __forceinline__ int floor_mod(int li, int total) {
  int k = li % total;
  return k < 0 ? k + total : k;  // a wrapped negative counter
}

// The int32 key of an f32 value in top_k's total order.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k < 0 ? (k ^ 0x7fffffff) : k);
}

// (order key, node) as one int64, ordered as top_k orders: unique, the
// lower node above among equal keys.
__device__ __forceinline__ long long pack(int key, int n) {
  return (long long)key * (1LL << 31) + (kIdxMask - n);
}

__device__ __forceinline__ int unpack_node(long long p) {
  return (int)(kIdxMask - (p & kIdxMask));
}

}  // namespace select_row
