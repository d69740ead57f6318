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

// node_label_value: the max over the node's label slots holding `key` of
// the value id (PAD if none) and of the numeric value skipping NaN (-inf
// if none); a non-finite numeric max reads NaN; FIELD_NODE_NAME_ID
// resolves to the node name.
__device__ __forceinline__ void label_value(const LabelRows& lr, int n,
                                            int key, int* val, float* num) {
  int v = kPad;
  float x = -INFINITY;
  const int* lk = lr.keys + (size_t)n * lr.l;
  const int* lv = lr.vals + (size_t)n * lr.l;
  const float* ln = lr.nums + (size_t)n * lr.l;
  for (int i = 0; i < lr.l; ++i) {
    if (__ldg(lk + i) != key) continue;
    v = max(v, __ldg(lv + i));
    const float y = __ldg(ln + i);
    if (!isnan(y)) x = fmaxf(x, y);
  }
  *num = isfinite(x) ? x : NAN;
  *val = key == kFieldNodeName ? __ldg(lr.node_name_id + n) : v;
}

// Expression i of ex against node n (_eval_exprs: an invalid expression
// is true; Gt and Lt are false on a NaN on either side; an op outside the
// six reads as Lt, as the reference's nested where does).
__device__ __forceinline__ bool eval_expr(const LabelRows& lr,
                                          const ExprRows& ex, int n,
                                          size_t i) {
  if (!__ldg(ex.valid + i)) return true;
  int nv;
  float nn;
  label_value(lr, n, __ldg(ex.key + i), &nv, &nn);
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

}  // namespace label_select
