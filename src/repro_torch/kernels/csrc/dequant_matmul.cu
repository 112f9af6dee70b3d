// Fused dequantize-matmul: decompress on read.
//
//     out (M, N) = a (M, K) @ (float(qw (K, N) int8) * scale (K / block, N))
//
// Replaces the Pallas kernel _dequant_matmul_kernel of
// src/repro/kernels/dequant_matmul.py (l.29).  As there, the int8 weight
// never exists in floating point in device memory: each block stages an
// int8 weight tile, dequantizes it in shared memory with its K block's
// scale row, and multiplies it into a float32 accumulator.
//
// Design (simple first): one 256-thread block owns a 64 x 64 output tile
// and loops over K in steps of `block` (128 on the main path), one scale
// row per step, staged in 32-deep slices: the slice's a tile (64 x 32
// float32, stored transposed) and its int8 weight tile (32 x 64),
// dequantized into shared memory.  Each thread accumulates a 4 x 4 patch
// in registers with float32 multiplies and adds on the CUDA cores (no
// tensor cores, no TF32).  Rows of a beyond M and columns beyond N are
// masked, so any M and N work; K must be a multiple of `block`, and
// `block` a multiple of 32 (the wrapper checks both).
//
// What bounds it on an H100: at prefill shapes (M = 512) the float32
// operations -- 2 M N K of them, 67 TFLOP/s outside the tensor cores -- and
// this SIMT loop reaches a fraction of that; at decode (M = 4) the int8
// weight bytes (K N of them, 3.35 TB/s), while the 64-row tile computes 60
// rows of zeros and leaves most of the card's SMs idle (N / 64 blocks).
// The library set is built with -fmad=false (build.py), so every
// multiply-add is two instructions, which halves the float32 rate this
// kernel can reach; it is kept for the planner kernels' bitwise
// contract, and is the first thing a redesign of this kernel revisits
// (then: tensor cores through bf16 or fp8 operands, a decode tile of 16
// rows or fewer, split-K for small M).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const float* __restrict__ a,
                      const int8_t* __restrict__ qw,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int m, int n, int k,
                      int block) {
  __shared__ float as[kBK][kBM + 1];   // a slice, transposed: as[k][m]
  __shared__ float ws[kBK][kBN];       // dequantized weight slice
  __shared__ float ss[kBN];            // the K block's scale row

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < k; kb += block) {
    __syncthreads();   // the previous step's readers are done with ss
    if (tid < kBN) {
      const int col = n0 + tid;
      ss[tid] = col < n ? scale[static_cast<long long>(kb / block) * n + col]
                        : 0.0f;
    }
    for (int k0 = kb; k0 < kb + block; k0 += kBK) {
      __syncthreads();   // ss is written; the last slice's readers are done
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int row = idx / kBK;
        const int kk = idx % kBK;
        const int grow = m0 + row;
        as[kk][row] = grow < m ? a[static_cast<long long>(grow) * k + k0 + kk]
                               : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int kk = idx / kBN;
        const int col = idx % kBN;
        const int gcol = n0 + col;
        ws[kk][col] =
            gcol < n ? static_cast<float>(
                           qw[static_cast<long long>(k0 + kk) * n + gcol]) *
                           ss[col]
                     : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[static_cast<long long>(row) * n + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* dequant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a: (m, k) float32; qw: (k, n) int8; scale: (k / block, n) float32;
// out: (m, n) float32; all row-major and contiguous.
int dequant_matmul_launch(const void* a, const void* qw, const void* scale,
                          void* out, int m, int n, int k, int block,
                          void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  dequant_matmul_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<float*>(out), m, n, k,
      block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
