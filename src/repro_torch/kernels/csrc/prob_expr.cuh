// The float32 accuracy probability P(lo <= X <= hi), X ~ N(cm, cs^2),
// shared by the prob_within and fused_score kernels.
//
// Both kernels must produce the same bits for the same (cm, cs): the
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

}  // namespace planner
