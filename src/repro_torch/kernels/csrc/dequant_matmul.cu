// Fused dequantize-matmul: decompress on read.
//
//     out (M, N) = a (M, K) @ (float(qw (K, N) int8) * scale (K / block, N))
//
// Replaces the Pallas kernel _dequant_matmul_kernel of
// src/repro/kernels/dequant_matmul.py (l.29).  As there, the int8 weight
// never exists in floating point in device memory, and each K block's
// product is taken on the raw int8 values and multiplied by that block's
// scale row once: sum_k(a * q) * s per (K block, column).  This rounds
// differently from a @ (q * s), within the wrapper's stated tolerance.
//
// Two kernels, picked by M (kDecodeMaxM below is the one threshold):
//
// * Decode (M <= kDecodeMaxM: serving's slots, M = 4 on the main path).
//   Bound by the K * N int8 weight bytes (11.5 MB at 2048 x 5632: 3.4 us
//   at 3.35 TB/s); the float work is M FMAs per weight byte.  A block owns
//   256 columns of one K block: 16 lanes across N, each reading 16
//   contiguous int8 of a qw row with one 16-byte load, and 8 row groups
//   down the K block.  a's (M, K-slice) is staged in shared memory (a
//   broadcast read per row).  int8 becomes float by integer byte permutes
//   and one float add (2^23 + (q + 128) - (2^23 + 128) is exact), not by
//   the quarter-rate I2F conversion.  The row groups' partial sums meet in
//   a fixed tree in shared memory, are scaled once, and land in a
//   workspace (K / block, M, N) that the wrapper allocates with the output
//   in one call; a second kernel sums it over the K blocks in order.  So K
//   is split over the grid (352 blocks at both phase-5 decode shapes, two
//   or more per SM on 132 SMs) with a deterministic reduction and no
//   floating-point atomics: two calls give the same bits.
//
// * Prefill (larger M), on the tensor cores.  2 M N K operations (11.8
//   GFLOP at 512 x 2048 x 5632: 0.176 ms at the 67 TFLOP/s float32 rate,
//   0.0119 ms a pass at 989 TFLOP/s bf16).  q is exact in bf16 (|q| <=
//   127).  a is split into bf16 terms hi = bf16(a), lo = bf16(a - hi);
//   a - hi is exact in float32, and lo's rounding leaves |a - hi - lo| <=
//   2^-8 |a - hi| <= about 2^-17 |a|: two terms carry 16 significant bits,
//   so the product's error is about 2^-17 of sum |a w| (random in sign),
//   well inside 1e-4 at the main path's widths; a third term is not
//   needed.  Each hi * q and lo * q product is exact in the MMA's float32
//   accumulator (8-bit by 8-bit significands).  A block owns a 64 x 128
//   output tile, 8 warps of 32 x 32 (the tile constants below).  a
//   (float32) and qw (int8) tiles 32 deep stream into shared memory
//   through a 4-stage cp.async ring; each stage is converted once per
//   block into double-buffered bf16 tiles (a: hi and lo; q: exact), one
//   barrier a step, read by ldmatrix (.trans for the row-major q tile)
//   into mma.sync.m16n8k16 bf16 products, two passes (hi, lo) into one
//   float32 accumulator per 128-deep K block, which is folded into the
//   output accumulator times that block's scale row.  Rows of a beyond M
//   and columns beyond N are masked (zero-filled tiles, masked stores), so
//   any M and N work.
//
// K must be a multiple of `block`, and `block` a multiple of 32 (the
// wrapper checks both).  Where N is not a multiple of 16, or qw's address
// not 16-byte aligned, both kernels read qw a byte at a time (a template
// flag); the main path's N (2048, 5632) takes the 16-byte route.
//
// Build flags: this library is built WITHOUT -fmad=false (build.py), so
// the compiler contracts multiply-adds into FMAs.  The planner library
// keeps the flag: its kernels must evaluate one float expression with the
// same roundings in two kernels.  Here the result is held to a tolerance,
// not to bits, and each build's bits are deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// the one threshold: M up to this takes the decode kernel
constexpr int kDecodeMaxM = 8;

// four signed bytes -> four exact floats: byte b becomes the low byte of
// 2^23's significand as b + 128, then 2^23 + 128 is subtracted (exact)
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// four signed bytes -> four bf16 (two packed pairs, lower index in the low
// half): the floats above hold at most 8 significant bits, so their upper
// 16 bits are the exact bf16
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  float f[4];
  i8x4_to_f32(w, f);
  uint2 r;
  r.x = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  r.y = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  return r;
}

// 16 int8 of qw row `row` from column `col0`; zeros beyond N.  VEC: one
// 16-byte load (N % 16 == 0 and qw 16-byte aligned, so the 16 columns are
// all in or all out)
template <bool VEC>
__device__ __forceinline__ uint4 load_q16(const int8_t* __restrict__ qw,
                                          long long row, int col0, int n) {
  if (VEC) {
    if (col0 >= n) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(qw + row * n + col0));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + j;
    if (col < n) {
      const uint32_t b = static_cast<uint8_t>(qw[row * n + col]);
      w[j >> 2] |= b << (8 * (j & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// decode: split K, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecLanes = 16;                         // lanes across N
constexpr int kDecCols = 16 * kDecLanes;              // 256 columns a block
constexpr int kDecGroups = kDecThreads / kDecLanes;   // 8 row groups
constexpr int kDecChunk = 128;                        // rows of a staged

template <int MT, bool VEC>
__global__ void __launch_bounds__(kDecThreads)
dmm_decode_kernel(const float* __restrict__ a, const int8_t* __restrict__ qw,
                  const float* __restrict__ scale, float* __restrict__ ws,
                  int m, int n, int k, int block) {
  // rows of qw a thread has in flight at once: all 16 of its chunk rows,
  // or 8 where MT = 8 leaves fewer registers
  constexpr int kBatch = MT <= 4 ? 16 : 8;
  constexpr int kBatchRows = kBatch * kDecGroups;
  __shared__ __align__(16) float a_sm[kDecChunk][MT];
  // partial sums of the upper row groups, [group][row of a][16 columns of a
  // lane] laid out lane-fastest so that a warp's stores hit distinct banks
  __shared__ __align__(16) float4 red[kDecGroups / 2][MT][4][kDecLanes];

  const int tid = threadIdx.x;
  const int lane = tid % kDecLanes;
  const int grp = tid / kDecLanes;
  const int kb = blockIdx.y;
  const int col0 = blockIdx.x * kDecCols + lane * 16;
  const long long row0 = static_cast<long long>(kb) * block;

  float part[MT][16];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) part[i][j] = 0.0f;

  for (int c0 = 0; c0 < block; c0 += kDecChunk) {
    const int rows = min(kDecChunk, block - c0);   // a multiple of 32
    uint4 w[kBatch];
    auto load_batch = [&](int b0) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = b0 + grp + u * kDecGroups;
        w[u] = r < rows ? load_q16<VEC>(qw, row0 + c0 + r, col0, n)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    load_batch(0);     // in flight while a is staged
    __syncthreads();   // the previous chunk's readers are done with a_sm
    for (int e = tid; e < rows * MT; e += kDecThreads) {
      const int mm = e / rows;
      const int r = e - mm * rows;
      a_sm[r][mm] =
          mm < m ? a[static_cast<long long>(mm) * k + row0 + c0 + r] : 0.0f;
    }
    __syncthreads();
    for (int b0 = 0; b0 < rows; b0 += kBatchRows) {
      if (b0 > 0) load_batch(b0);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = b0 + grp + u * kDecGroups;
        if (r >= rows) break;
        float q[16];
        i8x4_to_f32(w[u].x, q);
        i8x4_to_f32(w[u].y, q + 4);
        i8x4_to_f32(w[u].z, q + 8);
        i8x4_to_f32(w[u].w, q + 12);
        const float* av = a_sm[r];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float x = av[i];
#pragma unroll
          for (int j = 0; j < 16; ++j) part[i][j] += x * q[j];
        }
      }
    }
  }

  // the 8 row groups' sums in a fixed tree: g += g + 4, g += g + 2, g += g + 1
#pragma unroll
  for (int half = kDecGroups / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (grp >= half && grp < 2 * half) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          red[grp - half][i][v][lane] =
              make_float4(part[i][4 * v], part[i][4 * v + 1],
                          part[i][4 * v + 2], part[i][4 * v + 3]);
    }
    __syncthreads();
    if (grp < half) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 o = red[grp][i][v][lane];
          part[i][4 * v] += o.x;
          part[i][4 * v + 1] += o.y;
          part[i][4 * v + 2] += o.z;
          part[i][4 * v + 3] += o.w;
        }
    }
  }
  if (grp != 0) return;

  // once per K block: times the block's scale row, into the workspace
  float s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    s[j] = col0 + j < n ? __ldg(scale + static_cast<long long>(kb) * n +
                                col0 + j)
                        : 0.0f;
  for (int i = 0; i < MT && i < m; ++i) {
    float* dst = ws + (static_cast<long long>(kb) * m + i) * n + col0;
    if (VEC) {
      if (col0 < n) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          reinterpret_cast<float4*>(dst)[v] = make_float4(
              part[i][4 * v] * s[4 * v], part[i][4 * v + 1] * s[4 * v + 1],
              part[i][4 * v + 2] * s[4 * v + 2],
              part[i][4 * v + 3] * s[4 * v + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (col0 + j < n) dst[j] = part[i][j] * s[j];
    }
  }
}

// out[i] = sum over K blocks of ws[kb][i], in K-block order
__global__ void dmm_splitk_sum_kernel(const float* __restrict__ ws,
                                      float* __restrict__ out, int mn,
                                      int nkb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = ws[i];
  int kb = 1;
  for (; kb + 8 <= nkb; kb += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = ws[static_cast<long long>(kb + j) * mn + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  for (; kb < nkb; ++kb) acc += ws[static_cast<long long>(kb) * mn + i];
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// prefill: bf16 tensor cores, a split hi + lo
// ---------------------------------------------------------------------------

constexpr int kBK = 32;
constexpr int kPadA = 8;           // bf16 row pads: ldmatrix rows hit
constexpr int kPadQ = 8;           // distinct banks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16 x 8 float32) += a (16 x 16 bf16, row) @ b (16 x 8 bf16, col); not
// volatile, so the compiler may interleave independent products
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The prefill tile: a block owns kBM x kBN = 64 x 128 outputs, eight warps
// (2 x 4) of 32 x 32 (four 8-column MMA tiles a warp); a 4-stage cp.async
// ring of the a (float32) and qw (int8) tiles, then two buffers of the
// bf16 tiles (a hi, a lo, q) that the MMAs read: 85 KB of shared memory,
// 127 registers, two blocks and 16 warps an SM.  At 512 x 2048 x 5632 and
// 512 x 5632 x 2048 it was faster than the same tile in four warps of
// 32 x 64 (224 registers, 8 warps an SM) and than 64 x 64, 64 x 256,
// 128 x 64 and 128 x 128 tiles: the bf16 conversion of each stage, not
// the MMAs, bounds this kernel, and here twice the threads share it and
// 16 warps an SM hide its latency.
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kWN = 4;                            // MMA tiles a warp
constexpr int kStages = 4;
constexpr int kPreThreads = 32 * kWarpsM * kWarpsN;
constexpr int kBM = 32 * kWarpsM;
constexpr int kBN = 8 * kWN * kWarpsN;
constexpr int kAStage = kBM * kBK * 4;
constexpr int kQStage = kBK * kBN;
constexpr int kATile = kBM * (kBK + kPadA) * 2;
constexpr int kQTile = kBK * (kBN + kPadQ) * 2;
constexpr int kOffA = 0;                          // shared memory layout
constexpr int kOffQ = kOffA + kStages * kAStage;
constexpr int kOffHi = kOffQ + kStages * kQStage;
constexpr int kOffLo = kOffHi + 2 * kATile;
constexpr int kOffQb = kOffLo + 2 * kATile;
constexpr int kPreBytes = kOffQb + 2 * kQTile;

template <bool VEC>
__global__ void __launch_bounds__(kPreThreads)
dmm_prefill_kernel(const float* __restrict__ a, const int8_t* __restrict__ qw,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int m, int n, int k, int block) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto a_st = reinterpret_cast<float (*)[kBM][kBK]>(smem + kOffA);
  auto q_st = reinterpret_cast<int8_t (*)[kBK][kBN]>(smem + kOffQ);
  auto a_hi = reinterpret_cast<__nv_bfloat16 (*)[kBM][kBK + kPadA]>(
      smem + kOffHi);
  auto a_lo = reinterpret_cast<__nv_bfloat16 (*)[kBM][kBK + kPadA]>(
      smem + kOffLo);
  auto q_bf = reinterpret_cast<__nv_bfloat16 (*)[kBK][kBN + kPadQ]>(
      smem + kOffQb);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / kWarpsN;    // this warp's 32 rows of the tile
  const int wn = warp % kWarpsN;    // and its 32 columns
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int ncol = n0 + wn * kWN * 8;   // this warp's first column
  constexpr int kAChunks = kBM * kBK / 4;       // 16-byte chunks of a tile
  constexpr int kQChunksRow = kBN / 16;
  constexpr int kQChunks = kBK * kQChunksRow;
  static_assert(kAChunks % kPreThreads == 0 && kQChunks % kPreThreads == 0,
                "every thread copies and converts whole chunks");

  auto load_stage = [&](int st, int k0) {
    // a: kBM rows x 32 floats, 16-byte chunks; rows beyond M zero-filled
#pragma unroll
    for (int i = 0; i < kAChunks / kPreThreads; ++i) {
      const int c = tid + i * kPreThreads;
      const int row = c >> 3;
      const int kc = (c & 7) * 4;
      const int gr = m0 + row;
      cp_async16(&a_st[st][row][kc],
                 a + static_cast<long long>(min(gr, m - 1)) * k + k0 + kc,
                 gr < m ? 16 : 0);
    }
    if (VEC) {   // qw: 32 rows x kBN int8, 16-byte chunks
#pragma unroll
      for (int i = 0; i < kQChunks / kPreThreads; ++i) {
        const int c = tid + i * kPreThreads;
        const int kr = c / kQChunksRow;
        const int cc = (c % kQChunksRow) * 16;
        const int gc = n0 + cc;
        cp_async16(&q_st[st][kr][cc],
                   qw + static_cast<long long>(k0 + kr) * n +
                       (gc < n ? gc : 0),
                   gc < n ? 16 : 0);
      }
    } else {
      for (int c = tid; c < kBK * kBN; c += kPreThreads) {
        const int kr = c / kBN;
        const int cc = c % kBN;
        const int gc = n0 + cc;
        q_st[st][kr][cc] =
            gc < n ? qw[static_cast<long long>(k0 + kr) * n + gc] : 0;
      }
    }
  };

  // stage `st` -> bf16 buffer `b`
  auto convert_stage = [&](int st, int b) {
    // a: each float4 -> 4 hi + 4 lo bf16
#pragma unroll
    for (int i = 0; i < kAChunks / kPreThreads; ++i) {
      const int c = tid + i * kPreThreads;
      const int row = c >> 3;
      const int kc = (c & 7) * 4;
      const float4 v = *reinterpret_cast<const float4*>(&a_st[st][row][kc]);
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
      const float2 f01 = __bfloat1622float2(h01);
      const float2 f23 = __bfloat1622float2(h23);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x,
                                                       v.y - f01.y);
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x,
                                                       v.w - f23.y);
      *reinterpret_cast<uint2*>(&a_hi[b][row][kc]) =
          make_uint2(bf16x2_bits(h01), bf16x2_bits(h23));
      *reinterpret_cast<uint2*>(&a_lo[b][row][kc]) =
          make_uint2(bf16x2_bits(l01), bf16x2_bits(l23));
    }
    // q: each 16 int8 -> 16 exact bf16
#pragma unroll
    for (int i = 0; i < kQChunks / kPreThreads; ++i) {
      const int c = tid + i * kPreThreads;
      const int kr = c / kQChunksRow;
      const int cc = (c % kQChunksRow) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(&q_st[st][kr][cc]);
      const uint2 b0 = i8x4_to_bf16x4(w.x);
      const uint2 b1 = i8x4_to_bf16x4(w.y);
      const uint2 b2 = i8x4_to_bf16x4(w.z);
      const uint2 b3 = i8x4_to_bf16x4(w.w);
      uint4* dst = reinterpret_cast<uint4*>(&q_bf[b][kr][cc]);
      dst[0] = make_uint4(b0.x, b0.y, b1.x, b1.y);
      dst[1] = make_uint4(b2.x, b2.y, b3.x, b3.y);
    }
  };

  float acc[2][kWN][4];   // output accumulator
  float blk[2][kWN][4];   // this K block's sum of a * q
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kWN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = blk[i][j][r] = 0.0f;

  const int nks = k / kBK;
  const int ks_per_block = block / kBK;
  float sc[kWN][2];   // the current K block's scales of this thread's columns

  // Pipeline: stages ks + 1 .. ks + kStages - 1 are in flight while step ks
  // multiplies; step ks issues its MMAs, then converts stage ks + 1 into
  // the other bf16 buffer while the tensor cores work through them (the
  // conversion needs no MMA result), so one barrier a step separates the
  // writers of each buffer from its readers.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nks) load_stage(st, st * kBK);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();   // stage 0 landed
  __syncthreads();
  convert_stage(0, 0);
  for (int ks = 0; ks < nks; ++ks) {
    if (ks % ks_per_block == 0) {
      const float* srow = scale + static_cast<long long>(ks / ks_per_block) * n;
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        const int c = ncol + j * 8 + 2 * t;
        sc[j][0] = c < n ? __ldg(srow + c) : 0.0f;
        sc[j][1] = c + 1 < n ? __ldg(srow + c + 1) : 0.0f;
      }
    }
    const int nx = ks + kStages - 1;
    if (nx < nks) load_stage(nx % kStages, nx * kBK);
    cp_async_commit();
    cp_async_wait<kStages - 2>();   // stage ks + 1 landed
    // buffer ks & 1 is written (last step), buffer (ks + 1) & 1 is no
    // longer read (last step's MMAs), and the stage loaded above is no
    // longer converted (the step before)
    __syncthreads();
    const int b = ks & 1;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(ah[i], &a_hi[b][row][col]);
        ldmatrix_x4(al[i], &a_lo[b][row][col]);
      }
      uint32_t bq[kWN / 2][4];
#pragma unroll
      for (int jp = 0; jp < kWN / 2; ++jp)
        ldmatrix_x4_trans(
            bq[jp], &q_bf[b][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                         [wn * kWN * 8 + jp * 16 + (lane >> 4) * 8]);
      // the hi pass over every accumulator, then the lo pass: 2 kWN
      // independent products between the two into one accumulator
#pragma unroll
      for (int pass = 0; pass < 2; ++pass)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jp = 0; jp < kWN / 2; ++jp) {
            const uint32_t* av = pass ? al[i] : ah[i];
            mma_bf16(blk[i][2 * jp], av, bq[jp][0], bq[jp][1]);
            mma_bf16(blk[i][2 * jp + 1], av, bq[jp][2], bq[jp][3]);
          }
    }
    if (ks + 1 < nks) convert_stage((ks + 1) % kStages, (ks + 1) & 1);
    if ((ks + 1) % ks_per_block == 0) {   // fold the K block, times scale
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kWN; ++j) {
          acc[i][j][0] += blk[i][j][0] * sc[j][0];
          acc[i][j][1] += blk[i][j][1] * sc[j][1];
          acc[i][j][2] += blk[i][j][2] * sc[j][0];
          acc[i][j][3] += blk[i][j][3] * sc[j][1];
#pragma unroll
          for (int r = 0; r < 4; ++r) blk[i][j][r] = 0.0f;
        }
    }
  }

  // C fragment: rows g and g + 8 of each 16-row tile, columns 2t and 2t + 1
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (row >= m) continue;
      float* orow = out + static_cast<long long>(row) * n;
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        const int c = ncol + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h];
        const float v1 = acc[i][j][2 * h + 1];
        if (pairs && c + 1 < n) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else {
          if (c < n) orow[c] = v0;
          if (c + 1 < n) orow[c + 1] = v1;
        }
      }
    }
}

template <int MT, bool VEC>
void launch_decode(const float* a, const int8_t* qw, const float* scale,
                   float* ws, int m, int n, int k, int block,
                   cudaStream_t stream) {
  const dim3 grid((n + kDecCols - 1) / kDecCols, k / block);
  dmm_decode_kernel<MT, VEC><<<grid, kDecThreads, 0, stream>>>(
      a, qw, scale, ws, m, n, k, block);
}

template <bool VEC>
void launch_decode_m(const float* a, const int8_t* qw, const float* scale,
                     float* ws, int m, int n, int k, int block,
                     cudaStream_t stream) {
  if (m <= 1)
    launch_decode<1, VEC>(a, qw, scale, ws, m, n, k, block, stream);
  else if (m <= 2)
    launch_decode<2, VEC>(a, qw, scale, ws, m, n, k, block, stream);
  else if (m <= 4)
    launch_decode<4, VEC>(a, qw, scale, ws, m, n, k, block, stream);
  else
    launch_decode<8, VEC>(a, qw, scale, ws, m, n, k, block, stream);
}

template <bool VEC>
cudaError_t launch_prefill(const float* a, const int8_t* qw,
                           const float* scale, float* out, int m, int n,
                           int k, int block, cudaStream_t stream) {
  static bool attr_set = false;   // above 48 KB only once allowed
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dmm_prefill_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPreBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  dmm_prefill_kernel<VEC><<<grid, kPreThreads, kPreBytes, stream>>>(
      a, qw, scale, out, m, n, k, block);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* dequant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int dequant_matmul_decode_max_m() { return kDecodeMaxM; }

// a: (m, k) float32, 16-byte aligned; qw: (k, n) int8; scale: (k / block,
// n) float32; out: (m, n) float32; all row-major and contiguous.  ws: for
// m <= kDecodeMaxM and k > block, a (k / block, m, n) float32 workspace,
// else unused.  vec: n % 16 == 0 and qw 16-byte aligned.
int dequant_matmul_launch(const void* a, const void* qw, const void* scale,
                          void* out, void* ws, int m, int n, int k,
                          int block, int vec, void* stream) {
  const float* a_ = static_cast<const float*>(a);
  const int8_t* q_ = static_cast<const int8_t*>(qw);
  const float* s_ = static_cast<const float*>(scale);
  float* o_ = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= kDecodeMaxM) {
    const int nkb = k / block;
    float* w_ = nkb > 1 ? static_cast<float*>(ws) : o_;
    if (vec)
      launch_decode_m<true>(a_, q_, s_, w_, m, n, k, block, st);
    else
      launch_decode_m<false>(a_, q_, s_, w_, m, n, k, block, st);
    if (nkb > 1) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      const int mn = m * n;
      dmm_splitk_sum_kernel<<<(mn + 255) / 256, 256, 0, st>>>(w_, o_, mn,
                                                               nkb);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e =
      vec ? launch_prefill<true>(a_, q_, s_, o_, m, n, k, block, st)
          : launch_prefill<false>(a_, q_, s_, o_, m, n, k, block, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
