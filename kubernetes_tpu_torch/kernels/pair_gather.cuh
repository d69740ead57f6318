// The topology-pair gather K11, K12, K13, K14, K15 and K16 share.
//
// A node carries at most one value for each label key, so for each
// topology key slot k a node n lies in at most one topology pair,
// node_pair[n, k], or in none (-1) (ops/predicates.py build_node_pairs
// makes the table at the snapshot's upload and refuses a node in two
// pairs of one key).  So the
// reference's incidence product of a pair row with the topology,
// sum over TP of row[p] * topo[n, p], is a sum over the node's KT slots of
// row[node_pair[n, k]]: a count or an integer weight sum, exact in any
// order while it stays below 2^24, and equal to the f32 product bit for
// bit; "n and m share a domain under key k" is node_pair[n, k] ==
// node_pair[m, k] >= 0; and committing a pod on node h touches one pair
// per key, node_pair[h, k].
//
// The rows are read with plain loads: K13 writes the pair rows it reads
// within its own launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pair_gather {

// Is any of node n's pairs set in row (bool[TP])?  np: node n's row of
// node_pair, kt slots.
__device__ __forceinline__ bool any_hit(const uint8_t* row, const int* np,
                                        int kt) {
  for (int k = 0; k < kt; ++k) {
    const int p = __ldg(np + k);
    if (p >= 0 && row[p]) return true;
  }
  return false;
}

// The sum over node n's pairs of row (f32[TP]), in slot order from 0.0.
__device__ __forceinline__ float sum(const float* row, const int* np,
                                     int kt) {
  float s = 0.f;
  for (int k = 0; k < kt; ++k) {
    const int p = __ldg(np + k);
    if (p >= 0) s = __fadd_rn(s, row[p]);
  }
  return s;
}

// Node n's pair under key slot `slot` (-1: the key has no pair, or n none).
__device__ __forceinline__ int pair_of(const int* np, int slot) {
  return slot >= 0 ? __ldg(np + slot) : -1;
}

// Node n's pair under the key slot slots[i] of a term.
__device__ __forceinline__ int pair_at(const int* np, const int* slots,
                                       size_t i) {
  return pair_of(np, __ldg(slots + i));
}

// Do the nodes of rows np_a and np_b share a domain under key slot `slot`?
__device__ __forceinline__ bool same_domain(const int* np_a, const int* np_b,
                                            int slot) {
  if (slot < 0) return false;
  const int p = __ldg(np_a + slot);
  return p >= 0 && p == __ldg(np_b + slot);
}

}  // namespace pair_gather
