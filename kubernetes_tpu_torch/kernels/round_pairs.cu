// K16: the speculative round's pair commit and bootstrap gate, for Hopper
// (sm_90a).
//
// Replaces the part of the JAX package's models/speculative.py _round
// (:196) that threads the in-batch affinity state from round to round: the
// pair commit of the round's accepted pods (:495-545, the batched
// predicateMetadata.AddPod analogue) and the bootstrap gate the next
// round's filter reads (:236-242).  The plain twin is the port's
// models/speculative.py round_pairs_plain, which the kernel equals bit for
// bit.  For each pod i (one block):
//   commit  for every pod j accepted this round on node h (accept
//           non-null): the pair of h under each key (node_pair,
//           pair_gather.cuh) joins i's affinity terms j matches, i's anti
//           terms j matches, i's forbidden pairs when i matches one of j's
//           anti terms, and i's preferred pair weights: the hard affinity
//           weight for each of j's affinity terms i matches, the weight of
//           each of i's preferred terms j matches, the weight of each of
//           j's preferred terms i matches.  The carry holds the unions (the
//           pods' own pairs or'ed, their weights summed, from the start):
//           byte stores of 1, and exact atomic adds of integer weights
//           (exact in any order while the sums stay below 2^24)
//   gate    self_eff[i, t] = aff_self[i, t] and no earlier pod still
//           active matches i's affinity term t: a term that matches
//           nothing may bootstrap only when no earlier pod that could
//           satisfy it is pending.
// With accept null the launch makes the gate alone: the first round's.
//
// It is a launch of its own after K14's: no block of a launch reads a pair
// row another block writes (the filter and the fold read them in the next
// round), and the gate reads the active flags K14 wrote.
//
// Bound: bytes.  The cross matches of the accepted pods are read once
// (B x B x (PT + AT + PP) and their transposes, a byte each) with the
// active pods' affinity matches for the gate; the writes are a few bytes a
// (pod, term, accepted pod).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_gather.cuh"

namespace {

constexpr int kThreads = 128;

}  // namespace

// The arguments of one launch, passed by value (ctypes.Structure
// RoundPairsArgs in kernels/__init__.py mirrors it field for field).
struct RoundPairsArgs {
  const int* hosts;             // [B] the round's picks (K1's)
  const uint8_t* accept;        // [B] K14's, or null (the gate alone)
  const uint8_t* active;        // [B] the carry's, as K14 left it
  const int* node_pair;         // [N, KT]
  const int* aff_slot;          // [B, PT] each term's topology key slot
  const int* anti_slot;         // [B, AT]
  const int* pref_slot;         // [B, PP]
  const uint8_t* aff_self;      // [B, PT] the pods' own
  const uint8_t* aff_match;     // [B, B, PT] [j, i, t]: j matches i's term t
  const uint8_t* anti_match;    // [B, B, AT]
  const uint8_t* anti_own;      // [B, AT, B] [j, t, i]: i matches j's term t
  const uint8_t* aff_own;       // [B, PT, B]
  const uint8_t* pref_match;    // [B, B, PP]
  const uint8_t* pref_own;      // [B, PP, B]
  const float* pref_weight;     // [B, PP] signed
  uint8_t* u_aff;               // [B, PT, TP] the carry's unions, in place
  uint8_t* u_anti;              // [B, AT, TP]
  uint8_t* u_forb;              // [B, TP]
  float* u_pref;                // [B, TP]
  uint8_t* self_eff;            // [B, PT] the gated aff_self
  float hard_w;
  int b, tp, kt, pt, at, pp;
};

namespace {

__global__ void __launch_bounds__(kThreads) k16_round_pairs(
    const RoundPairsArgs a) {
  const int i = blockIdx.x, tid = threadIdx.x;
  const size_t B = (size_t)a.b, TP = (size_t)a.tp;
  const size_t PT = (size_t)a.pt, AT = (size_t)a.at, PP = (size_t)a.pp;
  if (a.accept) {
    float* up = a.u_pref + (size_t)i * TP;
    for (int j = tid; j < a.b; j += kThreads) {
      if (!a.accept[j]) continue;
      const int* nph = a.node_pair + (size_t)a.hosts[j] * a.kt;
      for (size_t t = 0; t < PT; ++t)
        if (__ldg(a.aff_match + ((size_t)j * B + i) * PT + t)) {
          const int p = pair_gather::pair_at(nph, a.aff_slot, i * PT + t);
          if (p >= 0) a.u_aff[(i * PT + t) * TP + p] = 1;
        }
      for (size_t t = 0; t < AT; ++t)
        if (__ldg(a.anti_match + ((size_t)j * B + i) * AT + t)) {
          const int p = pair_gather::pair_at(nph, a.anti_slot, i * AT + t);
          if (p >= 0) a.u_anti[(i * AT + t) * TP + p] = 1;
        }
      for (size_t t = 0; t < AT; ++t)
        if (__ldg(a.anti_own + ((size_t)j * AT + t) * B + i)) {
          const int p = pair_gather::pair_at(nph, a.anti_slot, j * AT + t);
          if (p >= 0) a.u_forb[(size_t)i * TP + p] = 1;
        }
      for (size_t t = 0; t < PT; ++t)
        if (__ldg(a.aff_own + ((size_t)j * PT + t) * B + i)) {
          const int p = pair_gather::pair_at(nph, a.aff_slot, j * PT + t);
          if (p >= 0) atomicAdd(up + p, a.hard_w);
        }
      for (size_t t = 0; t < PP; ++t)
        if (__ldg(a.pref_match + ((size_t)j * B + i) * PP + t)) {
          const int p = pair_gather::pair_at(nph, a.pref_slot, i * PP + t);
          if (p >= 0) atomicAdd(up + p, __ldg(a.pref_weight + i * PP + t));
        }
      for (size_t t = 0; t < PP; ++t)
        if (__ldg(a.pref_own + ((size_t)j * PP + t) * B + i)) {
          const int p = pair_gather::pair_at(nph, a.pref_slot, j * PP + t);
          if (p >= 0) atomicAdd(up + p, __ldg(a.pref_weight + j * PP + t));
        }
    }
  }
  // the next round's bootstrap gate
  for (size_t t = 0; t < PT; ++t) {
    int alive = 0;
    for (int j = tid; j < i && !alive; j += kThreads)
      alive = a.active[j] && __ldg(a.aff_match + ((size_t)j * B + i) * PT + t);
    alive = __syncthreads_or(alive);
    if (tid == 0)
      a.self_eff[i * PT + t] = __ldg(a.aff_self + i * PT + t) && !alive;
  }
}

}  // namespace

// One pair commit and gate (accept null: the gate alone) on `stream`: one
// kernel launch of a block a pod, and no other stream operation.  Returns a
// cudaError_t code.
extern "C" int round_pairs_launch(RoundPairsArgs a, cudaStream_t stream) {
  if (a.b <= 0 || a.tp <= 0 || a.kt < 0 || a.pt < 0 || a.at < 0 ||
      a.pp < 0 || !a.active || !a.u_forb || !a.u_pref ||
      (a.accept && (!a.hosts || !a.node_pair)))
    return (int)cudaErrorInvalidValue;
  k16_round_pairs<<<a.b, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
