// Node-label lookup and selector-expression evaluation shared by K11
// (filter_pass.cu, required node affinity) and K12 (score_pass.cu,
// preferred node affinity): the device form of ops/predicates.py
// node_label_value and _eval_exprs, one (node, expression) at a time.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace label_select {

constexpr int kPad = -1;
constexpr int kFieldNodeName = 1;   // FIELD_NODE_NAME_ID
enum { kIn = 0, kNotIn, kExists, kDoesNotExist, kGt, kLt };

// The snapshot's label rows: keys, value ids and numeric values [N, L].
struct LabelRows {
  const int* keys;
  const int* vals;
  const float* nums;
  const int* node_name_id;   // [N]
  int l;
};

// One pod-side expression tensor set: key, op, nval, num, valid [..., E]
// and vals [..., E, V], indexed by the flat expression index.
struct ExprRows {
  const int* key;
  const int* op;
  const int* vals;
  const int* nval;
  const float* num;
  const uint8_t* valid;
  int v;
};

// One node's label slots: its rows of the snapshot's [N, L] key, value
// id and numeric value fields, read through the read-only cache, and its
// name id.
struct Slots {
  const int* keys;
  const int* vals;
  const float* nums;
  int l;
  const int* name_id;   // the node's entry of node_name_id, read if asked
};

// Node n's row of lr.
__device__ __forceinline__ Slots node_slots(const LabelRows& lr, int n) {
  const size_t o = (size_t)n * lr.l;
  return {lr.keys + o, lr.vals + o, lr.nums + o, lr.l, lr.node_name_id + n};
}

// node_label_value: the max over the node's label slots holding `key` of
// the value id (PAD if none) and of the numeric value skipping NaN (-inf
// if none); a non-finite numeric max reads NaN; FIELD_NODE_NAME_ID
// resolves to the node name.  Every slot's value and number are read
// whatever its key, so that the loads of an unrolled step are in flight
// together; a caller that drops `num` leaves its loads to the compiler to
// drop.
__device__ __forceinline__ void slot_value(const Slots& r, int key, int* val,
                                           float* num) {
  int v = kPad;
  float x = -INFINITY;
#pragma unroll 4
  for (int i = 0; i < r.l; ++i) {
    const int k = __ldg(r.keys + i), vi = __ldg(r.vals + i);
    const float y = __ldg(r.nums + i);
    if (k != key) continue;
    v = max(v, vi);
    if (!isnan(y)) x = fmaxf(x, y);
  }
  *num = isfinite(x) ? x : NAN;
  *val = key == kFieldNodeName ? __ldg(r.name_id) : v;
}

// Expression i of ex against the node of r (_eval_exprs: an invalid
// expression is true; Gt and Lt are false on a NaN on either side; an op
// outside the six reads as Lt, as the reference's nested where does).
__device__ __forceinline__ bool eval_expr_at(const Slots& r,
                                             const ExprRows& ex, size_t i) {
  if (!__ldg(ex.valid + i)) return true;
  int nv;
  float nn;
  slot_value(r, __ldg(ex.key + i), &nv, &nn);
  const bool has = nv != kPad;
  const int op = __ldg(ex.op + i);
  if (op == kExists) return has;
  if (op == kDoesNotExist) return !has;
  if (op == kIn || op == kNotIn) {
    const int nval = __ldg(ex.nval + i);
    const int* vals = ex.vals + i * ex.v;
    bool in_set = false;
    for (int k = 0; k < ex.v; ++k)
      in_set |= k < nval && nv == __ldg(vals + k);
    return op == kIn ? (has && in_set) : !(has && in_set);
  }
  const float x = __ldg(ex.num + i);
  const bool num_ok = !isnan(x) && !isnan(nn);
  return op == kGt ? (has && num_ok && nn > x) : (has && num_ok && nn < x);
}

// Expression i of ex against node n of lr.
__device__ __forceinline__ bool eval_expr(const LabelRows& lr,
                                          const ExprRows& ex, int n,
                                          size_t i) {
  return eval_expr_at(node_slots(lr, n), ex, i);
}

}  // namespace label_select
