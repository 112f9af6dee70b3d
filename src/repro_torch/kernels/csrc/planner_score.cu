// Scoring kernels of the batched Section 5.2 planner (float32).
//
// Replaces the Pallas kernels of src/repro/kernels/planner_score.py:
//   prob_within_kernel  <- _prob_kernel (l.98)
//   fused_score_kernel  <- _fused_kernel (l.138), one target record
//   planner_walk_kernel <- _fused_kernel (l.138) and the host loop around
//                          it (src/repro/core/planner_engine.py _run): the
//                          whole greedy of one plan in one launch, and the
//                          plan's per-f feasibility check after it (the
//                          _prob_kernel call of src/repro/core/
//                          planner_engine.py l.428-433)
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
// * every kernel evaluates the probability through planner::prob_expr
//   and the Goodman fold through planner::fold_* (prob_expr.cuh) with
//   explicitly rounded float ops, and the library is built with
//   -fmad=false, so p recomputed by prob_within from fused_score's own
//   (cm, cs) has the same bits, and the walk's cm / cs / p equal the
//   per-record kernel's on the same children;
// * the Goodman fold runs over K sequentially in order (no tree
//   reduction), so a (mean 1, std 0) pad is the exact multiplicative
//   identity and K-padding is bitwise invisible;
// * winners take the first index on ties; "no winner" is 2^31 - 1.
//
// planner_walk_kernel: the records of one plan read states that earlier
// records wrote, so they run in order; but every read and write of the
// greedy is per (node, fraction), so the fractions are independent.  One
// block walks one fraction's records in order: threads over a record's
// candidates (the fold over its children, the probability, the float64
// sum of the unknown children's sampling costs), a barrier, warp 0 picks
// the winners (lines 6-7 first, then 8-9) with shuffles and lane 0 writes
// the states, a barrier.  The fraction's node state (code, float64 mean
// and std, float64 sampling cost: 25 B a node) lives in shared memory
// where it fits, else in the output arrays in global memory.  Where the
// host greedy works in float64, so does the walk: p >= q compares the
// float64 of p with the float64 q; the unknown children's cost is a
// float64 sum in child order, compared in float64 with the target's; the
// lines 8-9 winner is the first argmin of that float64 sum; total adds
// float64 costs in record order, a child's only while it is unresolved;
// SAMPLED nodes hold the float64 SampleCF mean and std, rounded to float32
// only where a child is gathered for the fold.  What bounds it: the
// records' dependency chain, two barriers per active record, not bytes
// or operations.  After the fraction's last record its block judges the
// plan's feasibility, one thread per target: p = prob_expr of the
// target's final (mean, std) rounded to float32 (what prob_within is given
// for the same RV), feasible = every float64(p) >= q_feas, a separate q:
// the "All" baseline walks under one q and judges under the caller's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prob_expr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNoWinner = 0x7fffffff;

// node state codes (planner_engine: _NONE, _DEDUCED, _SAMPLED, _EXACT)
constexpr uint8_t kNone = 0;
constexpr uint8_t kDeduced = 1;
constexpr uint8_t kSampled = 2;
constexpr uint8_t kExact = 3;
// walk winner codes per (record, fraction): a candidate index for lines
// 6-7, kWalkLine9 + index for lines 8-9
constexpr int kWalkSkip = -1;       // the target was resolved earlier
constexpr int kWalkFallback = -2;   // lines 10-11: SampleCF on the target
constexpr int kWalkLine9 = 1 << 20;
constexpr int kWalkThreads = 128;

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
    planner::Fold fold = planner::fold_first(mc[0], sc[0]);
    for (int kk = 1; kk < k; ++kk) planner::fold_next(fold, mc[kk * nf],
                                                      sc[kk * nf]);
    float cm, cs;
    planner::fold_finish(fold, dm[c], vt[c], mq[c], &cm, &cs);
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

// The greedy of one plan for fraction blockIdx.x.  Records r in order:
// tid[r] its target node, kind[r] its order class (row of samp_*),
// candidates cand_off[r] .. cand_off[r + 1] - 1, each with nchild[c]
// child ids child[c][0 ..] (K a row; pads are the EXACT node n1 - 1) and
// its deduction factors dm / vt / mq[c].  scost: (nf, n1) float64 sampling
// costs; samp_mean / samp_std: (2, nf) float64 SampleCF error RVs.
// targets: (T,) the plan's target node ids; exact: (X,) node ids that
// start EXACT with RV (1, 0), the existing indexes.  Outputs: state /
// mean / std (nf, n1), win (R, nf), total (nf,), p (T, nf), feasible
// (nf,).
template <bool SMEM>
__global__ void __launch_bounds__(kWalkThreads)
planner_walk_kernel(const int* __restrict__ tid, const int* __restrict__ kind,
                    const int* __restrict__ cand_off,
                    const int* __restrict__ child,
                    const int* __restrict__ nchild,
                    const int* __restrict__ targets,
                    const int* __restrict__ exact,
                    const float* __restrict__ dm,
                    const float* __restrict__ vt,
                    const float* __restrict__ mq,
                    const double* __restrict__ scost,
                    const double* __restrict__ samp_mean,
                    const double* __restrict__ samp_std,
                    uint8_t* __restrict__ state_out,
                    double* __restrict__ mean_out,
                    double* __restrict__ std_out, int* __restrict__ win,
                    double* __restrict__ total_out,
                    float* __restrict__ p_out,
                    uint8_t* __restrict__ feasible_out, int nrec, int k,
                    int n1, int nf, int max_cands, int ntargets, int nexact,
                    float lo, float hi, double q, double q_feas) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const long long col = static_cast<long long>(f) * n1;
  unsigned char* p = smem;
  double* mu = mean_out + col;
  double* sd = std_out + col;
  const double* sc = scost + col;
  if (SMEM) {
    mu = reinterpret_cast<double*>(p);
    sd = mu + n1;
    double* sc_sm = sd + n1;
    for (int i = t; i < n1; i += blockDim.x) sc_sm[i] = sc[i];
    sc = sc_sm;
    p += 3LL * n1 * sizeof(double);
  }
  // the current record's candidates
  double* c_extra = reinterpret_cast<double*>(p);
  float* c_cm = reinterpret_cast<float*>(c_extra + max_cands);
  float* c_cs = c_cm + max_cands;
  float* c_p = c_cs + max_cands;
  uint8_t* c_flag = reinterpret_cast<uint8_t*>(c_p + max_cands);  // 1: all
  uint8_t* st = state_out + col;            // children known; 2: lines 8-9
  if (SMEM) st = c_flag + max_cands;
  for (int i = t; i < n1; i += blockDim.x) {
    mu[i] = 1.0;
    sd[i] = 0.0;
    st[i] = i == n1 - 1 ? kExact : kNone;
  }
  if (nexact > 0) {
    // existing indexes, once every thread's NONE is written (an id may
    // lie in another thread's stride of the loop above); st is this
    // block's node state, in shared memory in the SMEM instance
    __syncthreads();
    for (int i = t; i < nexact; i += blockDim.x) {
      const int id = exact[i];
      st[id] = kExact;
      mu[id] = 1.0;
      sd[id] = 0.0;
    }
  }
  __syncthreads();
  const double smean[2] = {samp_mean[f], samp_mean[nf + f]};
  const double sstd[2] = {samp_std[f], samp_std[nf + f]};
  double total = 0.0;   // lane 0's

  for (int r = 0; r < nrec; ++r) {
    const int target = tid[r];
    // every thread reads the same state, written before the last barrier
    if (st[target] != kNone) {
      if (t == 0) win[static_cast<long long>(r) * nf + f] = kWalkSkip;
      continue;
    }
    const int o = cand_off[r];
    const int nc = cand_off[r + 1] - o;
    const int kc = kind[r];
    const double my_cost = sc[target];
    const float fm = __double2float_rn(smean[kc]);
    const float fs = __double2float_rn(sstd[kc]);
    for (int c = t; c < nc; c += blockDim.x) {
      const int* ch = child + static_cast<long long>(o + c) * k;
      const int nch = nchild[o + c];
      bool allk = true;
      double extra = 0.0;
      planner::Fold fold;
      for (int j = 0; j < nch; ++j) {
        const int id = ch[j];
        const bool known = st[id] != kNone;
        // unknown children hypothetically sampled (one Table 2 fit per
        // record: every child shares the target's method)
        const float m = known ? __double2float_rn(mu[id]) : fm;
        const float s = known ? __double2float_rn(sd[id]) : fs;
        if (!known) {
          allk = false;
          extra += sc[id];
        }
        if (j == 0)
          fold = planner::fold_first(m, s);
        else
          planner::fold_next(fold, m, s);
      }
      float cm, cs;
      planner::fold_finish(fold, dm[o + c], vt[o + c], mq[o + c], &cm, &cs);
      const bool pre9 = !allk && extra < my_cost;
      c_cm[c] = cm;
      c_cs[c] = cs;
      c_extra[c] = extra;
      c_p[c] = (allk || pre9) ? planner::prob_expr(cm, cs, lo, hi) : 0.0f;
      c_flag[c] = (allk ? 1 : 0) | (pre9 ? 2 : 0);
    }
    __syncthreads();
    if (t < 32) {
      // lines 6-7: first argmax of p over all-known candidates, p >= q
      float bp = -1.0f;
      int bi = kNoWinner;
      for (int c = t; c < nc; c += 32) {
        const float pc = c_p[c];
        if ((c_flag[c] & 1) && static_cast<double>(pc) >= q && pc > bp) {
          bp = pc;
          bi = c;
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float op = __shfl_xor_sync(0xffffffffu, bp, d);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, d);
        if (op > bp || (op == bp && oi < bi)) {
          bp = op;
          bi = oi;
        }
      }
      // lines 8-9, where 6-7 found none: first argmin of the float64
      // extra cost over the pre-enabled candidates with p >= q
      int xi = kNoWinner;
      if (bi == kNoWinner) {
        double bx = 0.0;
        for (int c = t; c < nc; c += 32) {
          if ((c_flag[c] & 2) && static_cast<double>(c_p[c]) >= q &&
              (xi == kNoWinner || c_extra[c] < bx)) {
            bx = c_extra[c];
            xi = c;
          }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const double ox = __shfl_xor_sync(0xffffffffu, bx, d);
          const int oi = __shfl_xor_sync(0xffffffffu, xi, d);
          if (oi != kNoWinner &&
              (xi == kNoWinner || ox < bx || (ox == bx && oi < xi))) {
            bx = ox;
            xi = oi;
          }
        }
      }
      if (t == 0) {
        int code;
        if (bi != kNoWinner) {
          st[target] = kDeduced;
          mu[target] = c_cm[bi];
          sd[target] = c_cs[bi];
          code = bi;
        } else if (xi != kNoWinner) {
          const int* ch = child + static_cast<long long>(o + xi) * k;
          const int nch = nchild[o + xi];
          for (int j = 0; j < nch; ++j) {
            const int id = ch[j];
            if (st[id] == kNone) {
              st[id] = kSampled;
              mu[id] = smean[kc];
              sd[id] = sstd[kc];
              total += sc[id];
            }
          }
          st[target] = kDeduced;
          mu[target] = c_cm[xi];
          sd[target] = c_cs[xi];
          code = kWalkLine9 + xi;
        } else {   // lines 10-11
          st[target] = kSampled;
          mu[target] = smean[kc];
          sd[target] = sstd[kc];
          total += sc[target];
          code = kWalkFallback;
        }
        win[static_cast<long long>(r) * nf + f] = code;
      }
    }
    __syncthreads();
  }
  // the states are final (the last record that wrote one ended in a
  // barrier): the plan's feasibility at this fraction
  bool ok = true;
  for (int i = t; i < ntargets; i += blockDim.x) {
    const int id = targets[i];
    const float pv = planner::prob_expr(__double2float_rn(mu[id]),
                                        __double2float_rn(sd[id]), lo, hi);
    p_out[static_cast<long long>(i) * nf + f] = pv;
    ok = ok && static_cast<double>(pv) >= q_feas;
  }
  ok = __syncthreads_and(ok);
  if (t == 0) {
    total_out[f] = total;
    feasible_out[f] = ok ? 1 : 0;
  }
  if (SMEM) {
    for (int i = t; i < n1; i += blockDim.x) {
      state_out[col + i] = st[i];
      mean_out[col + i] = mu[i];
      std_out[col + i] = sd[i];
    }
  }
}

size_t walk_smem_bytes(bool in_smem, int n1, int max_cands) {
  size_t b = static_cast<size_t>(max_cands) *
             (sizeof(double) + 3 * sizeof(float) + 1);
  if (in_smem) b += static_cast<size_t>(n1) * (3 * sizeof(double) + 1);
  return b;
}

// the most shared memory a block may opt into: the walk keeps its node
// state there where walk_smem_bytes(true, ..) fits in it
cudaError_t walk_optin(size_t* bytes) {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
  }
  *bytes = static_cast<size_t>(optin);
  return cudaSuccess;
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

// See planner_walk_kernel.  scost / state / mean / std are (nf, n1), one
// fraction a row; win is (nrec, nf), p (ntargets, nf).
int planner_walk_launch(const void* tid, const void* kind,
                        const void* cand_off, const void* child,
                        const void* nchild, const void* targets,
                        const void* exact, const void* dm, const void* vt,
                        const void* mq,
                        const void* scost, const void* samp_mean,
                        const void* samp_std, void* state, void* mean,
                        void* std, void* win, void* total, void* p,
                        void* feasible, int nrec, int k, int n1, int nf,
                        int max_cands, int ntargets, int nexact, float lo,
                        float hi, double q, double q_feas, void* stream) {
  size_t optin = 0;
  const cudaError_t e0 = walk_optin(&optin);
  if (e0 != cudaSuccess) return static_cast<int>(e0);
  const bool in_smem = walk_smem_bytes(true, n1, max_cands) <= optin;
  const size_t bytes = walk_smem_bytes(in_smem, n1, max_cands);
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = in_smem ? planner_walk_kernel<true>
                        : planner_walk_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<nf, kWalkThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tid), static_cast<const int*>(kind),
      static_cast<const int*>(cand_off), static_cast<const int*>(child),
      static_cast<const int*>(nchild), static_cast<const int*>(targets),
      static_cast<const int*>(exact), static_cast<const float*>(dm),
      static_cast<const float*>(vt), static_cast<const float*>(mq),
      static_cast<const double*>(scost),
      static_cast<const double*>(samp_mean),
      static_cast<const double*>(samp_std), static_cast<uint8_t*>(state),
      static_cast<double*>(mean), static_cast<double*>(std),
      static_cast<int*>(win), static_cast<double*>(total),
      static_cast<float*>(p), static_cast<uint8_t*>(feasible), nrec, k, n1,
      nf, max_cands, ntargets, nexact, lo, hi, q, q_feas);
  return static_cast<int>(cudaGetLastError());
}

// 1 where planner_walk_launch keeps the node state of a graph of n1 nodes
// in shared memory, 0 where in global memory; a CUDA error as -code
int planner_walk_in_smem(int n1, int max_cands) {
  size_t optin = 0;
  const cudaError_t e = walk_optin(&optin);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return walk_smem_bytes(true, n1, max_cands) <= optin ? 1 : 0;
}

}  // extern "C"
