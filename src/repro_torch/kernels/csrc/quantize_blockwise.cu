// Blockwise int8 quantization along the last dimension, and its inverse.
//
// quantize_kernel replaces the Pallas kernel _quantize_kernel of
// src/repro/kernels/quantize_blockwise.py (l.27): for every (row, block of
// `block` consecutive elements of the last dimension)
//     scale = max(absmax, 1e-12) / 127
//     q     = clip(round_half_even(x / scale), -127, 127)
// giving an (M, N) int8 tensor and (M, ceil(N / block)) float32 scales.
//
// dequantize_group_kernel replaces _dequantize_kernel (l.38): out = q *
// scale of the element's (row, block), one float32 multiply, cast to
// float32 or bfloat16 (round to nearest even), for a list of tensors.
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
// Dequantize is one grouped kernel: a launch takes a list of (q, scales,
// out) tensors in one kernel-parameter struct (up to kGroupCap items, the
// 32,764 bytes of parameters CUDA 12.1 allows on sm_90; a single call is a
// one-item list in a struct of its own, so it copies no unused
// parameters).  The work is the concatenated space of quantization blocks
// ("units": (tensor, row, block)) of all the items, walked by warps: a
// warp step takes one unit (a block of 128) or, where a tensor's rows are
// shorter than a block, as many whole units as fill the warp's lanes at 4
// elements a lane; the struct holds each item's first step.  A warp walks
// the steps grid-stride (a persistent grid, 16 blocks of 8 warps per SM);
// for each it finds the item (a warp-uniform search over the items' first
// steps, from the item of its previous step), derives the row and block of
// its unit with one division, and loads the unit's one scale (scales are
// laid out unit by unit, so the unit's index within its item is the
// scale's).  Each lane then takes 4 consecutive elements of the unit per
// 128 (or per its lanes x 4): one char4 load, one 16-byte (float32) or
// 8-byte (bfloat16) store, so a warp reads 128 contiguous q bytes and
// writes 512 contiguous output bytes per step.  Elements that do not make
// a full aligned group of 4 (a ragged last block, q or out at an unaligned
// address) go one at a time.  No per-element division; 32-bit indices
// within an item and at most 32 registers, so the SM holds its full 64
// warps, whose loads are in flight together; the step loop is unrolled by
// two, so a warp has two steps' loads in flight before it stores, and the
// float32 stores are streaming (st.global.cs).  The scales (1/32 of the
// bytes read at block 128) come through L1.
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

// float32: a streaming store (st.global.cs, evict first), as dequantize's
// output is written once
__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(a, b, c, d));
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b,
                                       float c, float d) {
  union {
    __nv_bfloat162 h[2];
    uint2 u;
  } p;
  p.h[0] = __floats2bfloat162_rn(a, b);
  p.h[1] = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(o) = p.u;
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// One tensor of a dequantize group: q (rows, n) int8 row-major, scales
// (rows, nb) float32, out (rows, n) float32 or bfloat16, fewer than 2^31
// elements (indices within an item are 32-bit; the wrapper splits a larger
// tensor into items by rows); its rows * nb units take warp steps
// [step_start, step_start + ceil(units / (32 >> log_lanes))), 2^log_lanes
// lanes to a unit.
struct DqItem {
  const int8_t* q;
  const float* s;
  void* out;
  long long step_start;
  long long units;
  int n;
  int nb;
  int log_lanes;
  int out_bf16;
};

// 56-byte items: 576 fill 32,272 bytes of the 32,764 CUDA 12.1 allows
#if CUDART_VERSION < 12010
#error "the dequantize group needs CUDA 12.1's 32,764 bytes of parameters"
#endif
constexpr int kGroupCap = 576;
constexpr int kParamBytes = 32764;

template <int kCap>
struct DqGroup {
  long long total_steps;
  int count;
  int block;
  DqItem items[kCap];
};
static_assert(sizeof(DqGroup<kGroupCap>) <= kParamBytes,
              "the group struct must fit the kernel parameter space");

constexpr int kDqThreads = 256;
constexpr int kDqBlocksPerSm = 16;     // grid; 8 resident (<= 32 regs)
constexpr int kSms = 132;              // H100 SXM

// the item holding warp step w: the last item whose first step is <= w,
// searched from `lo` (the item of the warp's previous, smaller step)
template <int kCap>
__device__ __forceinline__ int find_item(const DqGroup<kCap>& g, int lo,
                                         long long w) {
  if (lo + 1 < g.count && g.items[lo + 1].step_start <= w) {
    int hi = g.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (g.items[mid].step_start <= w) lo = mid;
      else hi = mid - 1;
    }
  }
  return lo;
}

template <typename OutT>
__device__ __forceinline__ void dq_store(void* out, unsigned e, char4 v,
                                         float s) {
  store4(static_cast<OutT*>(out) + e, static_cast<float>(v.x) * s,
         static_cast<float>(v.y) * s, static_cast<float>(v.z) * s,
         static_cast<float>(v.w) * s);
}

template <typename OutT>
__device__ __forceinline__ void dq_scalar(void* out, const int8_t* q,
                                          unsigned e, int cnt, float s) {
  for (int i = 0; i < cnt; ++i)
    store1(static_cast<OutT*>(out) + e + i,
           static_cast<float>(q[e + i]) * s);
}

template <int kCap>
__global__ void __launch_bounds__(kDqThreads, kDqBlocksPerSm / 2)
dequantize_group_kernel(const __grid_constant__ DqGroup<kCap> g) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kDqThreads / 32);
  const int block = g.block;
  long long w = static_cast<long long>(blockIdx.x) * (kDqThreads / 32) +
                (threadIdx.x >> 5);
  int item = 0;
  while (w < g.total_steps) {
    // the item's fields, read from the parameter struct once for all the
    // steps of it that this warp takes (w, w + warps, ...)
    item = find_item(g, item, w);
    const DqItem& it = g.items[item];
    const int8_t* const q = it.q;
    const float* const sp = it.s;
    void* const out = it.out;
    const unsigned units = static_cast<unsigned>(it.units);
    const unsigned n = static_cast<unsigned>(it.n);
    const unsigned nb = static_cast<unsigned>(it.nb);
    const int log_lanes = it.log_lanes;
    const bool bf16 = it.out_bf16 != 0;
    // whole groups of 4 are aligned for a char4 load and a vector store
    const bool vec = n % 4 == 0 && block % 4 == 0 &&
                     (reinterpret_cast<size_t>(q) & 3) == 0 &&
                     (reinterpret_cast<size_t>(out) & (bf16 ? 7 : 15)) == 0;
    const int j0 = (lane & ((1 << log_lanes) - 1)) * 4;
    const long long last =
        item + 1 < g.count ? g.items[item + 1].step_start : g.total_steps;
    const unsigned end = static_cast<unsigned>(last - it.step_start);
    unsigned step = static_cast<unsigned>(w - it.step_start);
#pragma unroll 2
    for (; step < end; step += warps) {
      const unsigned unit = (step << (5 - log_lanes)) + (lane >> log_lanes);
      if (unit >= units) continue;
      const unsigned row = unit / nb;
      const unsigned c0 = (unit - row * nb) * block;
      const int len = min(block, static_cast<int>(n - c0));
      const unsigned e0 = row * n + c0;
      const float sc = __ldg(sp + unit);
      for (int j = j0; j < len; j += 4 << log_lanes) {
        const unsigned e = e0 + j;
        const int cnt = min(4, len - j);
        if (vec && cnt == 4) {
          const char4 v = __ldg(reinterpret_cast<const char4*>(q + e));
          if (bf16) dq_store<__nv_bfloat16>(out, e, v, sc);
          else dq_store<float>(out, e, v, sc);
        } else if (bf16) {
          dq_scalar<__nv_bfloat16>(out, q, e, cnt, sc);
        } else {
          dq_scalar<float>(out, q, e, cnt, sc);
        }
      }
    }
    w = it.step_start + step;
  }
}

// Item i of a group from (q, s, out, rows, n, out_bf16), its steps after
// `steps`; returns the steps after it.
inline long long dq_item(DqItem& it, const void* q, const void* s, void* out,
                         long long rows, int n, int out_bf16, int block,
                         long long steps) {
  it.q = static_cast<const int8_t*>(q);
  it.s = static_cast<const float*>(s);
  it.out = out;
  it.n = n;
  it.nb = (n + block - 1) / block;
  it.out_bf16 = out_bf16;
  // lanes a unit fills at 4 elements a lane, a power of two <= 32
  const int lanes = (std::min(block, n) + 3) / 4;
  it.log_lanes = 0;
  while (it.log_lanes < 5 && (1 << it.log_lanes) < lanes) ++it.log_lanes;
  it.units = rows * it.nb;
  it.step_start = steps;
  const int per_step = 1 << (5 - it.log_lanes);
  return steps + (it.units + per_step - 1) / per_step;
}

template <int kCap>
int launch_group(const DqGroup<kCap>& g, void* stream) {
  const long long blocks = std::min<long long>(
      (g.total_steps + kDqThreads / 32 - 1) / (kDqThreads / 32),
      kSms * kDqBlocksPerSm);
  dequantize_group_kernel<kCap>
      <<<static_cast<unsigned>(blocks), kDqThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Fills items[0, count) from the host table (q, s, out, rows, n,
// out_bf16 per item, as int64) and launches.
int launch_table(const long long* table, int count, int block,
                 void* stream) {
  DqGroup<kGroupCap> g;
  g.count = count;
  g.block = block;
  long long steps = 0;
  for (int i = 0; i < count; ++i) {
    const long long* t = table + 6 * i;
    steps = dq_item(g.items[i], reinterpret_cast<const void*>(t[0]),
                    reinterpret_cast<const void*>(t[1]),
                    reinterpret_cast<void*>(t[2]), t[3],
                    static_cast<int>(t[4]), static_cast<int>(t[5]), block,
                    steps);
  }
  g.total_steps = steps;
  return launch_group(g, stream);
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

// One tensor: q (rows, n) int8, scales (rows, ceil(n / block)) float32,
// out (rows, n); rows, n >= 1, rows * n < 2^31; out_bf16: 0 for a float32
// output, 1 for a bfloat16 one.  Any alignment of q and out.
int dequantize_blockwise_launch(const void* q, const void* scales, void* out,
                                long long rows, int n, int block,
                                int out_bf16, void* stream) {
  DqGroup<1> g;
  g.count = 1;
  g.block = block;
  g.total_steps =
      dq_item(g.items[0], q, scales, out, rows, n, out_bf16, block, 0);
  return launch_group(g, stream);
}

// The most items one dequantize_group_launch takes.
int dequantize_group_capacity() { return kGroupCap; }

// table: count rows of 6 int64 (q, scales, out addresses, rows >= 1,
// n >= 1, out_bf16), as dequantize_blockwise_launch's arguments (rows * n
// < 2^31);
// 1 <= count <= dequantize_group_capacity().  One launch.
int dequantize_group_launch(const void* table, int count, int block,
                            void* stream) {
  return launch_table(static_cast<const long long*>(table), count, block,
                      stream);
}

}  // extern "C"
