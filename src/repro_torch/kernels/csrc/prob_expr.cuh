// The planner kernels' shared float32 expressions: the accuracy
// probability P(lo <= X <= hi), X ~ N(cm, cs^2), of the prob_within,
// fused_score and planner_walk kernels, and the Goodman fold of the last
// two.
//
// The kernels must produce the same bits for the same (cm, cs): the
// planner recomputes a probability from a stored (mean, std) pair and
// relies on it equalling the fused kernel's in-line value.  So the
// expression is written once, with explicitly rounded operations
// (__fsub_rn / __fdiv_rn / __fadd_rn / __fmul_rn cannot be contracted into
// FMAs), in the reference's order: lo and hi are the float32 roundings of
// the host's double bounds, then (hi - cm) / s / sqrt2 -- two divisions.
// CUDA's erff is not XLA's erf, so this matches the TPU kernel
// (src/repro/kernels/planner_score.py _prob_expr, l.55) only to float32
// tolerance; within this library it is one function, hence bitwise stable.
#pragma once
#include <cuda_runtime.h>

namespace planner {

// float32(sqrt(2.0)), as numpy's np.float32(math.sqrt(2.0))
constexpr float kSqrt2 = 1.41421353816986083984375f;
// float32(1e-12), the indicator-branch threshold
constexpr float kSmall = 1e-12f;

__device__ __forceinline__ float phi(float bound, float cm, float s) {
  const float z = __fdiv_rn(__fdiv_rn(__fsub_rn(bound, cm), s), kSqrt2);
  return __fmul_rn(0.5f, __fadd_rn(1.0f, erff(z)));
}

__device__ __forceinline__ float prob_expr(float cm, float cs, float lo,
                                           float hi) {
  const bool small = cs <= kSmall;
  const float s = small ? 1.0f : cs;
  const float p = __fsub_rn(phi(hi, cm, s), phi(lo, cm, s));
  const float ind = (cm >= lo && cm <= hi) ? 1.0f : 0.0f;
  return small ? ind : p;
}

// The sequential Goodman fold of a candidate's children (mean m, std s)
// into the composed error RV, continued with the deduction-error factors
// (dm = mean, vt = std^2 + mean^2, mq = mean^2).  Children in order, every
// operation rounded on its own, so a (mean 1, std 0) child is the exact
// identity and two kernels that fold the same children agree bitwise.
struct Fold {
  float e_prod, v_term, e2_term;
};

__device__ __forceinline__ Fold fold_first(float m, float s) {
  return {m, __fadd_rn(__fmul_rn(s, s), __fmul_rn(m, m)), __fmul_rn(m, m)};
}

__device__ __forceinline__ void fold_next(Fold& f, float m, float s) {
  const float msq = __fmul_rn(m, m);
  f.e_prod = __fmul_rn(f.e_prod, m);
  f.v_term = __fmul_rn(f.v_term, __fadd_rn(__fmul_rn(s, s), msq));
  f.e2_term = __fmul_rn(f.e2_term, msq);
}

// composed (mean, std) = (e_prod dm, sqrt(max(v_term vt - e2_term mq, 0)))
__device__ __forceinline__ void fold_finish(const Fold& f, float dm,
                                            float vt, float mq, float* cm,
                                            float* cs) {
  *cm = __fmul_rn(f.e_prod, dm);
  const float v = __fmul_rn(f.v_term, vt);
  const float e2 = __fmul_rn(f.e2_term, mq);
  *cs = __fsqrt_rn(fmaxf(__fsub_rn(v, e2), 0.0f));
}

}  // namespace planner
