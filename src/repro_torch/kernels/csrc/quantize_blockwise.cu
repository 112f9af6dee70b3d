// Blockwise int8 quantization along the last dimension, and its inverse.
//
// quantize_kernel replaces the Pallas kernel _quantize_kernel of
// src/repro/kernels/quantize_blockwise.py (l.27): for every (row, block of
// `block` consecutive elements of the last dimension)
//     scale = max(absmax, 1e-12) / 127
//     q     = clip(round_half_even(x / scale), -127, 127)
// giving an (M, N) int8 tensor and (M, ceil(N / block)) float32 scales.
//
// dequantize_kernel replaces _dequantize_kernel (l.38): out = q * scale of
// the element's (row, block), one float32 multiply, cast to float32 or
// bfloat16 (round to nearest even).
//
// What bounds both on an H100: device memory.  Quantize reads every input
// element once (4 bytes in float32, 2 in bfloat16) and writes one byte per
// element plus a scale per block; dequantize reads one byte and writes 4
// (or 2); each does a handful of operations per element, far below the
// card's ~20 float operations per byte.
//
// Quantize is the simplest design that streams: one warp per (row, block),
// so a 128-element block is four coalesced 128-byte reads; the block's
// absmax is reduced across the warp with shuffles (max is exact in any
// order); the second pass re-reads the block (from L1) to quantize it.  No
// shared memory.
//
// Dequantize is elementwise over the flattened tensor: each thread takes 4
// consecutive elements per grid-stride step, finds their row and column
// with one integer division (32-bit where the tensor has fewer than 2^31
// elements), and reads the scale at row * nb + col / block.  Where the last
// dimension and the block are multiples of 4 the 4 elements share a row and
// a block, so the thread loads them as one char4 and stores one 16-byte
// (float32) or 8-byte (bfloat16) vector; otherwise it walks them one by
// one across the row boundary.  The scales (1/32 of the bytes read at block
// 128) come through L1.
//
// Exactness contract: q, the scales and the dequantized values are
// bit-equal to the plain PyTorch versions (quantize_blockwise_plain,
// dequantize_blockwise_plain): the scale is one IEEE division (nvcc's
// default -prec-div=true), x / scale another, and rintf rounds half to even
// like torch.round and jnp.round (never floorf(x + 0.5f)); q * scale is one
// rounded float32 multiply and __float2bfloat16_rn rounds like PyTorch's
// float-to-bfloat16 cast.  The library set is built with -fmad=false
// (build.py).  The ragged last block is masked; the JAX wrapper zero-pads it
// instead, and a zero never moves an absmax, so the two agree.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b,
                                       float c, float d) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(o);
  p[0] = __floats2bfloat162_rn(a, b);
  p[1] = __floats2bfloat162_rn(c, d);
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// q: (total / n, n) row-major int8; scales: (total / n, nb); out like q.
// Index is uint32_t when total < 2^31, else uint64_t.  vec (the launcher
// checks it): n % 4 == 0, block % 4 == 0, q 4-byte and out 16-byte (8-byte
// for bfloat16) aligned.
template <typename Index, typename OutT, bool kVec>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  OutT* __restrict__ out, Index total,
                                  Index n, Index block, Index nb) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x * 4;
  for (Index e = (static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x)
                 * 4;
       e < total; e += stride) {
    Index row = e / n;
    Index col = e - row * n;
    if (kVec) {
      const char4 v = *reinterpret_cast<const char4*>(q + e);
      const float s = scales[row * nb + col / block];
      store4(out + e, static_cast<float>(v.x) * s,
             static_cast<float>(v.y) * s, static_cast<float>(v.z) * s,
             static_cast<float>(v.w) * s);
    } else {
      for (Index j = e; j < e + 4 && j < total; ++j) {
        store1(out + j,
               static_cast<float>(q[j]) * scales[row * nb + col / block]);
        if (++col == n) {
          col = 0;
          ++row;
        }
      }
    }
  }
}

template <typename Index, typename OutT>
int launch_dequantize(const void* q, const void* scales, void* out,
                      long long total, int n, int block, int vec,
                      void* stream) {
  constexpr int kDqThreads = 256;
  const long long groups = (total + 3) / 4;
  // a grid-stride loop: at most 16 blocks per SM's worth of threads
  const long long blocks =
      std::min<long long>((groups + kDqThreads - 1) / kDqThreads, 132 * 16);
  const Index nb = static_cast<Index>((n + block - 1) / block);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<OutT*>(out);
  if (vec)
    dequantize_kernel<Index, OutT, true>
        <<<static_cast<unsigned>(blocks), kDqThreads, 0, st>>>(
            qp, sp, op, static_cast<Index>(total), static_cast<Index>(n),
            static_cast<Index>(block), nb);
  else
    dequantize_kernel<Index, OutT, false>
        <<<static_cast<unsigned>(blocks), kDqThreads, 0, st>>>(
            qp, sp, op, static_cast<Index>(total), static_cast<Index>(n),
            static_cast<Index>(block), nb);
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

// total = q.numel() > 0, n = q.shape[-1]; out_bf16: 0 for a float32
// output, 1 for a bfloat16 one; vec as dequantize_kernel requires.
int dequantize_blockwise_launch(const void* q, const void* scales, void* out,
                                long long total, int n, int block,
                                int out_bf16, int vec, void* stream) {
  // 32-bit indices while e + the grid stride (< 2^22) cannot wrap
  const bool narrow = total < (1LL << 31);
  if (out_bf16)
    return narrow ? launch_dequantize<uint32_t, __nv_bfloat16>(
                        q, scales, out, total, n, block, vec, stream)
                  : launch_dequantize<uint64_t, __nv_bfloat16>(
                        q, scales, out, total, n, block, vec, stream);
  return narrow ? launch_dequantize<uint32_t, float>(q, scales, out, total,
                                                     n, block, vec, stream)
                : launch_dequantize<uint64_t, float>(q, scales, out, total,
                                                     n, block, vec, stream);
}

}  // extern "C"
