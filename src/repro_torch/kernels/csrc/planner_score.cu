// Scoring kernels of the batched Section 5.2 planner (float32).
//
// Replaces the Pallas kernels of src/repro/kernels/planner_score.py:
//   prob_within_kernel <- _prob_kernel (l.98)
//   fused_score_kernel <- _fused_kernel (l.138)
//
// What bounds them on an H100: launch latency.  A planner record is tiny
// (at TPC-H SF1: nc <= 14 candidates, K <= 11 children, nf = 5 fractions,
// a few KB in all), so the bytes and operations of one call take
// nanoseconds and the few microseconds of a launch dominate.  The design
// therefore stays simple and exact rather than wide: one block per
// record, one thread per (candidate, fraction) for the Goodman fold and
// the probability, then one thread per fraction for the winners.
//
// Exactness contract inside this library:
// * both kernels evaluate the probability through planner::prob_expr
//   (prob_expr.cuh) with explicitly rounded float ops, and the library is
//   built with -fmad=false, so p recomputed by prob_within from
//   fused_score's own (cm, cs) has the same bits;
// * the Goodman fold runs over K sequentially in order (no tree
//   reduction), so a (mean 1, std 0) pad is the exact multiplicative
//   identity and K-padding is bitwise invisible;
// * winners take the first index on ties; "no winner" is 2^31 - 1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prob_expr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNoWinner = 0x7fffffff;

__global__ void prob_within_kernel(const float* __restrict__ m,
                                   const float* __restrict__ s,
                                   float* __restrict__ out, int n, float lo,
                                   float hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = planner::prob_expr(m[i], s[i], lo, hi);
}

// m, s: (nc, k, nf); dm, vt, mq: (nc,); mask67, pre9: (nc, nf) uint8;
// extra: (nc, nf); out: (3, nc, nf) = cm, cs, p; win: (2, nf) = w6, w9.
__global__ void fused_score_kernel(
    const float* __restrict__ m, const float* __restrict__ s,
    const float* __restrict__ dm, const float* __restrict__ vt,
    const float* __restrict__ mq, const uint8_t* __restrict__ mask67,
    const uint8_t* __restrict__ pre9, const float* __restrict__ extra,
    float* __restrict__ out, int* __restrict__ win, int nc, int k, int nf,
    float lo, float hi, float q) {
  const int ncf = nc * nf;
  float* cm_out = out;
  float* cs_out = out + ncf;
  float* p_out = out + 2 * ncf;
  for (int idx = threadIdx.x; idx < ncf; idx += blockDim.x) {
    const int c = idx / nf;
    const int f = idx - c * nf;
    const float* mc = m + static_cast<long long>(c) * k * nf + f;
    const float* sc = s + static_cast<long long>(c) * k * nf + f;
    float e_prod = mc[0];
    const float s0 = sc[0];
    float v_term = __fadd_rn(__fmul_rn(s0, s0), __fmul_rn(e_prod, e_prod));
    float e2_term = __fmul_rn(e_prod, e_prod);
    for (int kk = 1; kk < k; ++kk) {
      const float mk = mc[kk * nf];
      const float sk = sc[kk * nf];
      const float msq = __fmul_rn(mk, mk);
      e_prod = __fmul_rn(e_prod, mk);
      v_term = __fmul_rn(v_term, __fadd_rn(__fmul_rn(sk, sk), msq));
      e2_term = __fmul_rn(e2_term, msq);
    }
    const float cm = __fmul_rn(e_prod, dm[c]);
    const float v = __fmul_rn(v_term, vt[c]);
    const float e2 = __fmul_rn(e2_term, mq[c]);
    const float cs = __fsqrt_rn(fmaxf(__fsub_rn(v, e2), 0.0f));
    cm_out[idx] = cm;
    cs_out[idx] = cs;
    p_out[idx] = (mask67[idx] | pre9[idx])
                     ? planner::prob_expr(cm, cs, lo, hi) : 0.0f;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < nf; f += blockDim.x) {
    // lines 6-7: first argmax of p over enabled candidates with p >= q
    int w6 = kNoWinner;
    float best = 0.0f;
    for (int c = 0; c < nc; ++c) {
      const int i = c * nf + f;
      const float p = p_out[i];
      if (mask67[i] && p >= q && (w6 == kNoWinner || p > best)) {
        best = p;
        w6 = c;
      }
    }
    // lines 8-9, only where lines 6-7 found nothing: first argmin of the
    // extra sampling cost over pre-enabled candidates with p >= q
    int w9 = kNoWinner;
    if (w6 == kNoWinner) {
      float bx = 0.0f;
      for (int c = 0; c < nc; ++c) {
        const int i = c * nf + f;
        const float x = extra[i];
        if (pre9[i] && p_out[i] >= q && (w9 == kNoWinner || x < bx)) {
          bx = x;
          w9 = c;
        }
      }
    }
    win[f] = w6;
    win[nf + f] = w9;
  }
}

}  // namespace

extern "C" {

const char* planner_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int prob_within_launch(const void* m, const void* s, void* out, int n,
                       float lo, float hi, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  prob_within_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(s),
      static_cast<float*>(out), n, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

int fused_score_launch(const void* m, const void* s, const void* dm,
                       const void* vt, const void* mq, const void* mask67,
                       const void* pre9, const void* extra, void* out,
                       void* win, int nc, int k, int nf, float lo, float hi,
                       float q, void* stream) {
  fused_score_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(s),
      static_cast<const float*>(dm), static_cast<const float*>(vt),
      static_cast<const float*>(mq), static_cast<const uint8_t*>(mask67),
      static_cast<const uint8_t*>(pre9), static_cast<const float*>(extra),
      static_cast<float*>(out), static_cast<int*>(win), nc, k, nf, lo, hi, q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
