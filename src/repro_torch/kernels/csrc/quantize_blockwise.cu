// Blockwise int8 quantization along the last dimension.
//
// Replaces the Pallas kernel _quantize_kernel of
// src/repro/kernels/quantize_blockwise.py (l.27): for every (row, block of
// `block` consecutive elements of the last dimension)
//     scale = max(absmax, 1e-12) / 127
//     q     = clip(round_half_even(x / scale), -127, 127)
// giving an (M, N) int8 tensor and (M, ceil(N / block)) float32 scales.
//
// What bounds it on an H100: device memory.  It reads every input element
// once (4 bytes in float32, 2 in bfloat16) and writes one byte per element
// plus a scale per block, with a handful of float operations per element:
// far below the card's ~20 float operations per byte.  The design is the
// simplest one that streams: one warp per (row, block), so a 128-element
// block is four coalesced 128-byte reads; the block's absmax is reduced
// across the warp with shuffles (max is exact in any order); the second
// pass re-reads the block (from L1) to quantize it.  No shared memory.
//
// Exactness contract: q and the scales are bit-equal to the plain PyTorch
// version (quantize_blockwise_plain): the scale is one IEEE division
// (nvcc's default -prec-div=true), x / scale another, and rintf rounds
// half to even like torch.round and jnp.round (never floorf(x + 0.5f)).
// The library set is built with -fmad=false (build.py).  The ragged last
// block is masked; the JAX wrapper zero-pads it instead, and a zero never
// moves an absmax, so the two agree.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x: (rows, n) row-major; q: (rows, n); scales: (rows, nb), nb blocks.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scales, long long rows,
                                int n, int block, int nb) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * nb) return;
  const long long row = warp / nb;
  const int b = static_cast<int>(warp - row * nb);
  const int start = b * block;
  const int stop = min(start + block, n);   // masks the ragged last block
  const T* xr = x + row * n;
  int8_t* qr = q + row * n;

  float amax = 0.0f;
  for (int j = start + lane; j < stop; j += 32)
    amax = fmaxf(amax, fabsf(load_f32(xr + j)));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float scale = fmaxf(amax, 1e-12f) / 127.0f;
  for (int j = start + lane; j < stop; j += 32) {
    const float v = rintf(load_f32(xr + j) / scale);
    qr[j] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (lane == 0) scales[row * nb + b] = scale;
}

template <typename T>
int launch(const void* x, void* q, void* scales, long long rows, int n,
           int block, void* stream) {
  const int nb = (n + block - 1) / block;
  const long long warps = rows * nb;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  quantize_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), rows, n, block, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// is_bf16: 0 for a float32 input, 1 for a bfloat16 one.
int quantize_blockwise_launch(const void* x, void* q, void* scales,
                              long long rows, int n, int block, int is_bf16,
                              void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(x, q, scales, rows, n, block, stream);
  return launch<float>(x, q, scales, rows, n, block, stream);
}

}  // extern "C"
