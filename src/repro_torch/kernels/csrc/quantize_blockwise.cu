// Blockwise int8 quantization along the last dimension, and its inverse.
//
// quantize_group_kernel replaces the Pallas kernel _quantize_kernel of
// src/repro/kernels/quantize_blockwise.py (l.27): for every (row, block of
// `block` consecutive elements of the last dimension)
//     scale = max(absmax, 1e-12) / 127
//     q     = clip(round_half_even(x / scale), -127, 127)
// giving an (M, N) int8 tensor and (M, ceil(N / block)) float32 scales,
// for a list of tensors.
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
// Quantize walks its units as dequantize does (below), in a struct of
// items of the same size, but a unit of 128 takes 8 lanes, so a warp step
// is 4 units: a lane loads its 4 groups of 4 elements of the unit (four
// 16-byte float32 or 8-byte bfloat16 loads, 2 KB a warp in flight) and
// holds them in registers; no second pass over x.  The unit's absmax
// reduces across its 8 lanes in 3 shuffle rounds (max is exact in any
// order); the scale and its reciprocal are one IEEE division each per
// unit; each element is multiplied by the reciprocal, and divided by the
// scale only within 2^-14 of a .5 (q_bits proves the result equal to the
// division's); each group of 4 q bytes is stored as one 32-bit word and
// the unit's first lane stores the scale.  Chosen on an H100: a warp per
// unit, even with two units' loads in flight, was bounded by its per-unit
// work (five shuffle rounds, an index division, a scale division) and by
// too few loads in flight, and spilled at 32 registers; capping this
// kernel's registers to hold more warps made it slower.  A division per
// element costs little on normal data but takes its slow path on zeros
// and subnormals (most rows of an embedding gradient are zero); the
// multiply does not.  Elements that do not make a full aligned group of 4
// go one at a time, as in dequantize.  Blocks above 128 elements (no call
// site uses one) take a two-pass loop that reads the block again from L1.
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
// default -prec-div=true), q the integer nearest x / scale, half to even,
// like torch.round and jnp.round (q_bits: a multiply by the reciprocal
// where that is provably the same, the IEEE division elsewhere, never
// floorf(x + 0.5f)), clipped to +-127; q * scale is one
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

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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
template <typename Group>
__device__ __forceinline__ int find_item(const Group& g, int lo,
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

// An item's step layout: n, nb, the lanes of a unit, its units and its
// first step, `steps`; returns the steps after it.
template <typename Item>
inline long long place_item(Item& it, long long rows, int n, int block,
                            long long steps, int max_log_lanes = 5) {
  it.n = n;
  it.nb = (n + block - 1) / block;
  // lanes a unit fills at 4 elements a lane, a power of two <= 32 (or
  // 2^max_log_lanes)
  const int lanes = (std::min(block, n) + 3) / 4;
  it.log_lanes = 0;
  while (it.log_lanes < max_log_lanes && (1 << it.log_lanes) < lanes)
    ++it.log_lanes;
  it.units = rows * it.nb;
  it.step_start = steps;
  const int per_step = 1 << (5 - it.log_lanes);
  return steps + (it.units + per_step - 1) / per_step;
}

// Item i of a group from (q, s, out, rows, n, out_bf16), its steps after
// `steps`; returns the steps after it.
inline long long dq_item(DqItem& it, const void* q, const void* s, void* out,
                         long long rows, int n, int out_bf16, int block,
                         long long steps) {
  it.q = static_cast<const int8_t*>(q);
  it.s = static_cast<const float*>(s);
  it.out = out;
  it.out_bf16 = out_bf16;
  return place_item(it, rows, n, block, steps);
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

// ---- quantize -------------------------------------------------------

// One tensor of a quantize group: x (rows, n) float32 or bfloat16
// row-major, q (rows, n) int8, scales (rows, nb) float32, fewer than 2^31
// elements; its steps as a DqItem's.
struct QItem {
  const void* x;
  int8_t* q;
  float* s;
  long long step_start;
  long long units;
  int n;
  int nb;
  int log_lanes;
  int in_bf16;
};
static_assert(sizeof(QItem) == sizeof(DqItem),
              "quantize and dequantize groups take the same item count");

template <int kCap>
struct QGroup {
  long long total_steps;
  int count;
  int block;
  QItem items[kCap];
};
static_assert(sizeof(QGroup<kGroupCap>) <= kParamBytes,
              "the group struct must fit the kernel parameter space");

// 4 consecutive elements as float32: one 16-byte or 8-byte load
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } t;
  t.u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(t.h[0]);
  const float2 b = __bfloat1622float2(t.h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// A lane's group of 4 at x[e]: its first min(4, avail) elements (none
// when avail <= 0), zero beyond them: a zero never moves an absmax.
template <typename T>
__device__ __forceinline__ void q_load(const T* x, unsigned e, int avail,
                                       bool vec, float v[4]) {
  if (vec && avail >= 4) {
    load4(x + e, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = i < avail ? load_f32(x + e + i) : 0.0f;
  }
}

// The max of |v| over the 2^log_lanes lanes of a unit (xor partners stay
// inside the unit's aligned run of lanes).  Every lane of the warp calls it.
__device__ __forceinline__ float unit_absmax(float a, int log_lanes) {
  for (int off = (1 << log_lanes) >> 1; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

__device__ __forceinline__ float absmax4(const float v[4]) {
  return fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
               fmaxf(fabsf(v[2]), fabsf(v[3])));
}

// A unit's scale and its reciprocal, each one IEEE division
struct QScale {
  float scale;
  float inv;
};

__device__ __forceinline__ QScale block_scale(float amax) {
  QScale s;
  s.scale = fmaxf(amax, 1e-12f) / 127.0f;
  s.inv = 1.0f / s.scale;
  return s;
}

// Within this distance of a .5, v * inv may round to another integer than
// v / scale does (see q_bits).
constexpr float kNearHalf = 1.0f / 16384;

// clip(rint(v / scale), -127, 127), its int8 bits in the low byte.
//
// The quotient: t = v * inv gives the same integer as the IEEE quotient
// f = v / scale wherever t lies at least kNearHalf from every k + .5, and
// elsewhere t is the IEEE quotient itself.  Proof, with u = 2^-24: scale >=
// 1e-12 / 127 (1 - u) and scale <= FLT_MAX / 127, so inv is normal and
// within u of 1 / scale relatively; |v| <= amax gives |v / scale| <= 127 /
// (1 - u); so |t - v / scale| <= (2u + u^2) 127.00001 where t is normal,
// |f - v / scale| <= u 127.00001, and |t - f| < 2.3e-5 < kNearHalf (where t
// is subnormal both round to 0).  Then no k + .5 lies between t and f, nor
// at f, and rint(t) = rint(f).  The distance is exact where it decides:
// |t| < 128, so |t| - floor(|t|) is exact, and so is its difference with
// .5 once that is below .25.  A NaN or an infinite v gives NaN either way
// (inf * 0, inf / inf).  The multiply avoids the division's slow path,
// which zeros and subnormals take (most rows of an embedding gradient are
// zero).
//
// The rounding: clamped to [-127, 127] and added to 1.5 * 2^23, t lands in
// [2^23, 2^24), where floats are the integers, so the addition rounds it
// half to even (as rintf) and the float's low mantissa byte is the
// two's-complement int8 (a NaN clamps to -127, as rintf then fmaxf do):
// adds in place of a float-to-int conversion, which runs at a quarter of
// the float rate.
__device__ __forceinline__ unsigned q_bits(float v, QScale s) {
  float t = v * s.inv;
  const float a = fabsf(t);
  if (fabsf((a - floorf(a)) - 0.5f) < kNearHalf) t = v / s.scale;
  return __float_as_uint(fminf(fmaxf(t, -127.0f), 127.0f) + 12582912.0f);
}

__device__ __forceinline__ void q_store(int8_t* q, unsigned e, int avail,
                                        bool vec, const float v[4],
                                        QScale s) {
  if (vec && avail >= 4) {
    const unsigned lo =
        __byte_perm(q_bits(v[0], s), q_bits(v[1], s), 0x0040);
    const unsigned hi =
        __byte_perm(q_bits(v[2], s), q_bits(v[3], s), 0x0040);
    *reinterpret_cast<unsigned*>(q + e) = __byte_perm(lo, hi, 0x5410);
  } else {
    for (int i = 0; i < min(4, avail); ++i)
      q[e + i] = static_cast<int8_t>(q_bits(v[i], s) & 0xff);
  }
}

// The fields of the item a warp walks, read once from the parameter
// struct for all its steps of it.
struct QWalk {
  int8_t* q;
  float* s;
  unsigned units;
  unsigned n;
  unsigned nb;
  int log_lanes;
  int block;
  int j0;       // the lane's first element within its unit
  bool vec;     // whole groups of 4 are aligned for vector accesses
  bool whole;   // rows of whole blocks: unit u starts at element u * block
};

// The lane's unit at warp step `step`: its index, its first element and
// its length (0 past the item's units).
struct QUnit {
  unsigned unit;
  unsigned e0;
  int len;
};

__device__ __forceinline__ QUnit q_unit(const QWalk& k, unsigned step,
                                        int lane) {
  QUnit u;
  u.unit = (step << (5 - k.log_lanes)) + (lane >> k.log_lanes);
  u.e0 = 0;
  u.len = 0;
  if (u.unit < k.units) {
    if (k.whole) {
      u.e0 = u.unit * k.block;
      u.len = k.block;
    } else {
      const unsigned row = u.unit / k.nb;
      const unsigned c0 = (u.unit - row * k.nb) * k.block;
      u.e0 = row * k.n + c0;
      u.len = static_cast<int>(min(static_cast<unsigned>(k.block), k.n - c0));
    }
  }
  return u;
}

__device__ __forceinline__ void q_put_scale(const QWalk& k, const QUnit& u,
                                            int lane, QScale s) {
  if (u.unit < k.units && (lane & ((1 << k.log_lanes) - 1)) == 0)
    k.s[u.unit] = s.scale;
}

// Lanes of a unit, at most (a power of two: 8), and the groups of 4 a
// lane holds of a unit of up to 128 elements (4)
constexpr int kQLogLanes = 3;
constexpr int kQChunks = 32 >> kQLogLanes;

// The lane's groups of 4 of unit u: group c at element 4 * (c * lanes +
// the lane's place in the unit)
template <typename T>
__device__ __forceinline__ void q_load_unit(const T* x, const QWalk& k,
                                            const QUnit& u,
                                            float v[kQChunks][4]) {
#pragma unroll
  for (int c = 0; c < kQChunks; ++c) {
    const int j = (c << (k.log_lanes + 2)) + k.j0;
    q_load(x, u.e0 + j, u.len - j, k.vec, v[c]);
  }
}

__device__ __forceinline__ void q_unit_store(const QWalk& k, const QUnit& u,
                                             int lane,
                                             const float v[kQChunks][4]) {
  float a = absmax4(v[0]);
#pragma unroll
  for (int c = 1; c < kQChunks; ++c) a = fmaxf(a, absmax4(v[c]));
  const QScale s = block_scale(unit_absmax(a, k.log_lanes));
#pragma unroll
  for (int c = 0; c < kQChunks; ++c) {
    const int j = (c << (k.log_lanes + 2)) + k.j0;
    q_store(k.q, u.e0 + j, u.len - j, k.vec, v[c], s);
  }
  q_put_scale(k, u, lane, s);
}

// Steps [step, end) of one item (stride `warps`), block <= 128: a lane's
// groups of its unit stay in registers.  Returns the warp's first step at
// or past `end`.
template <typename T>
__device__ __forceinline__ unsigned q_steps(const T* x, const QWalk& k,
                                            unsigned step, unsigned end,
                                            unsigned warps, int lane) {
  for (; step < end; step += warps) {
    const QUnit u = q_unit(k, step, lane);
    float v[kQChunks][4];
    q_load_unit(x, k, u, v);
    q_unit_store(k, u, lane, v);
  }
  return step;
}

// The same for blocks above 128 elements: a lane takes every
// (4 << log_lanes)-th group of 4 of its unit, in two passes.
template <typename T>
__device__ __forceinline__ unsigned q_steps_wide(const T* x, const QWalk& k,
                                                 unsigned step, unsigned end,
                                                 unsigned warps, int lane) {
  const int stride = 4 << k.log_lanes;
  for (; step < end; step += warps) {
    const QUnit u = q_unit(k, step, lane);
    float v[4];
    float amax = 0.0f;
    for (int j = k.j0; j < u.len; j += stride) {
      q_load(x, u.e0 + j, u.len - j, k.vec, v);
      amax = fmaxf(amax, absmax4(v));
    }
    const QScale scale = block_scale(unit_absmax(amax, k.log_lanes));
    for (int j = k.j0; j < u.len; j += stride) {
      q_load(x, u.e0 + j, u.len - j, k.vec, v);
      q_store(k.q, u.e0 + j, u.len - j, k.vec, v, scale);
    }
    q_put_scale(k, u, lane, scale);
  }
  return step;
}

template <bool kWide, typename T>
__device__ __forceinline__ unsigned q_walk(const T* x, const QWalk& k,
                                           unsigned step, unsigned end,
                                           unsigned warps, int lane) {
  if constexpr (kWide)
    return q_steps_wide(x, k, step, end, warps, lane);
  else
    return q_steps(x, k, step, end, warps, lane);
}

// No minimum of resident blocks: at its 62 registers the SM holds 32 warps,
// each with 2 KB of loads in flight; capped at 40 or 32 registers (48 or
// 64 warps) it spilled and ran slower on an H100.
template <int kCap, bool kWide>
__global__ void __launch_bounds__(kDqThreads)
quantize_group_kernel(const __grid_constant__ QGroup<kCap> g) {
  const int lane = threadIdx.x & 31;
  const unsigned warps = gridDim.x * (kDqThreads / 32);
  long long w = static_cast<long long>(blockIdx.x) * (kDqThreads / 32) +
                (threadIdx.x >> 5);
  int item = 0;
  while (w < g.total_steps) {
    item = find_item(g, item, w);
    const QItem& it = g.items[item];
    const bool bf16 = it.in_bf16 != 0;
    QWalk k;
    k.q = it.q;
    k.s = it.s;
    k.units = static_cast<unsigned>(it.units);
    k.n = static_cast<unsigned>(it.n);
    k.nb = static_cast<unsigned>(it.nb);
    k.log_lanes = it.log_lanes;
    k.block = g.block;
    k.j0 = (lane & ((1 << k.log_lanes) - 1)) * 4;
    k.whole = k.n == k.nb * k.block;
    k.vec = k.n % 4 == 0 && k.block % 4 == 0 &&
            (reinterpret_cast<size_t>(it.q) & 3) == 0 &&
            (reinterpret_cast<size_t>(it.x) & (bf16 ? 7 : 15)) == 0;
    const long long last =
        item + 1 < g.count ? g.items[item + 1].step_start : g.total_steps;
    const unsigned end = static_cast<unsigned>(last - it.step_start);
    const unsigned step = static_cast<unsigned>(w - it.step_start);
    const unsigned next =
        bf16 ? q_walk<kWide>(static_cast<const __nv_bfloat16*>(it.x), k,
                             step, end, warps, lane)
             : q_walk<kWide>(static_cast<const float*>(it.x), k, step, end,
                             warps, lane);
    w = it.step_start + next;
  }
}

inline long long q_item(QItem& it, const void* x, void* q, void* s,
                        long long rows, int n, int in_bf16, int block,
                        long long steps) {
  it.x = x;
  it.q = static_cast<int8_t*>(q);
  it.s = static_cast<float*>(s);
  it.in_bf16 = in_bf16;
  return place_item(it, rows, n, block, steps, kQLogLanes);
}

template <int kCap>
int launch_qgroup(const QGroup<kCap>& g, void* stream) {
  const long long blocks = std::min<long long>(
      (g.total_steps + kDqThreads / 32 - 1) / (kDqThreads / 32),
      kSms * kDqBlocksPerSm);
  const auto st = static_cast<cudaStream_t>(stream);
  if (g.block > 128)
    quantize_group_kernel<kCap, true>
        <<<static_cast<unsigned>(blocks), kDqThreads, 0, st>>>(g);
  else
    quantize_group_kernel<kCap, false>
        <<<static_cast<unsigned>(blocks), kDqThreads, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Fills items[0, count) from the host table (x, q, s, rows, n, in_bf16
// per item, as int64) and launches.
int launch_qtable(const long long* table, int count, int block,
                  void* stream) {
  QGroup<kGroupCap> g;
  g.count = count;
  g.block = block;
  long long steps = 0;
  for (int i = 0; i < count; ++i) {
    const long long* t = table + 6 * i;
    steps = q_item(g.items[i], reinterpret_cast<const void*>(t[0]),
                   reinterpret_cast<void*>(t[1]),
                   reinterpret_cast<void*>(t[2]), t[3],
                   static_cast<int>(t[4]), static_cast<int>(t[5]), block,
                   steps);
  }
  g.total_steps = steps;
  return launch_qgroup(g, stream);
}

}  // namespace

extern "C" {

const char* quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One tensor: x (rows, n) float32 (is_bf16 0) or bfloat16 (1), q (rows,
// n) int8, scales (rows, ceil(n / block)) float32, all written; rows, n
// >= 1, rows * n < 2^31.  Any alignment of x and q.
int quantize_blockwise_launch(const void* x, void* q, void* scales,
                              long long rows, int n, int block, int is_bf16,
                              void* stream) {
  QGroup<1> g;
  g.count = 1;
  g.block = block;
  g.total_steps =
      q_item(g.items[0], x, q, scales, rows, n, is_bf16, block, 0);
  return launch_qgroup(g, stream);
}

// table: count rows of 6 int64 (x, q, scales addresses, rows >= 1, n >= 1,
// is_bf16), as quantize_blockwise_launch's arguments (rows * n < 2^31);
// 1 <= count <= dequantize_group_capacity() (the two structs hold items
// of one size).  One launch.
int quantize_group_launch(const void* table, int count, int block,
                          void* stream) {
  return launch_qtable(static_cast<const long long*>(table), count, block,
                       stream);
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
