// Codec-size kernels for SampleCF: payload bytes per row of an (m, n)
// int64 column stack (one row per (target, column) sizing job), one kernel
// per compression method of the paper's Section 2.1.
//
// Replaces the Pallas kernels of src/repro/kernels/codec_bytes.py:
//   ns_bytes_kernel     <- _ns_kernel (l.95)
//   gdict_bytes_kernel  <- _gdict_kernel (l.104); the row sort before it
//                          (lax.sort, l.179-180) stays a library sort
//                          (torch.sort), as it was XLA's on the TPU
//   ldict_bytes_kernel  <- _ldict_kernel (l.113) AND the per-page lax.sort
//                          pre-pass of _codec_call (l.187-191)
//   prefix_bytes_kernel <- _prefix_kernel (l.128)
//   rle_bytes_kernel    <- _rle_kernel (l.149)
// The TPU version split each int64 into two uint32 planes because the TPU
// path has no 64-bit integers; Hopper has them, so values are read as
// int64 directly and the result is exact for every int64 input (negative
// values reinterpret as uint64, as NumPy's astype(uint64) does).  PREFIX
// takes each page's min and max as SIGNED int64 and XORs them as uint64,
// which is what the NumPy formula computes (an unsigned min/max gives the
// same bytes: on a page that mixes signs the top bit differs either way).
//
// What bounds them on an H100: bytes read.  Each value is read once from
// device memory (8 bytes) and costs a handful of integer operations, far
// below the card's integer rate, so the floor is m * n * 8 bytes over
// 3.35 TB/s.  NS and GDICT: one block per row, a block-strided loop of
// coalesced loads and a block reduction.  LDICT, PREFIX and RLE: one block
// per (row, page), whose byte count is added to the row total with a 64-bit
// integer atomic (order-free, hence deterministic).  LDICT sorts its page
// (rpp <= 1638 rows, padded to a power of two <= 4096) in shared memory
// with a bitonic network and counts distinct values as adjacent unequal
// pairs; PREFIX reduces the page's min and max; RLE counts adjacent unequal
// pairs in the order given.  Only a page's real rows are read: the
// reference edge-pads the last page with its last value, which adds no
// distinct value, no run and no new min or max.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kPageMeta = 16;

__device__ __forceinline__ long long sig_bytes(long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  long long s = 1;
#pragma unroll
  for (int k = 1; k < 8; ++k) s += (u >= (1ull << (8 * k))) ? 1 : 0;
  return s;
}

__device__ __forceinline__ long long ptr_bytes(long long ndv) {
  return ndv <= 256 ? 1 : (ndv <= 65536 ? 2 : 3);
}

// Sum of `v` over the block; the result is valid in thread 0.
__device__ long long block_sum(long long v) {
  __shared__ long long warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < (kThreads / 32) ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Min and max of (mn, mx) over the block; the results are valid in
// thread 0.
__device__ void block_minmax(long long& mn, long long& mx) {
  __shared__ long long warp_mn[kThreads / 32];
  __shared__ long long warp_mx[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_mn[warp] = mn;
    warp_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < (kThreads / 32) ? warp_mn[lane] : warp_mn[0];
    mx = lane < (kThreads / 32) ? warp_mx[lane] : warp_mx[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_down_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    }
  }
}

__global__ void ns_bytes_kernel(const long long* __restrict__ cols,
                                const long long* __restrict__ widths,
                                long long* __restrict__ out, int n) {
  const int row = blockIdx.x;
  const long long w = widths[row];
  const long long* __restrict__ r = cols + static_cast<long long>(row) * n;
  long long acc = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const long long s = min(sig_bytes(r[j]), w);
    acc += min(2 * s + 1, 2 * w);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[row] = (acc + 1) / 2;
}

__global__ void ldict_bytes_kernel(const long long* __restrict__ cols,
                                   const long long* __restrict__ widths,
                                   unsigned long long* __restrict__ out,
                                   int n, int rpp, int npages, int p2) {
  extern __shared__ long long page[];
  const int row = blockIdx.x / npages;
  const int pg = blockIdx.x - row * npages;
  const long long w = widths[row];
  const int start = pg * rpp;
  const int rows = (pg == npages - 1) ? n - start : rpp;
  const long long* __restrict__ src =
      cols + static_cast<long long>(row) * n + start;
  // pad with the int64 maximum: pads sort last, and only the first `rows`
  // sorted entries are counted (a real maximum value among them still
  // counts once, since pads and it compare equal)
  for (int i = threadIdx.x; i < p2; i += kThreads)
    page[i] = i < rows ? src[i] : 0x7fffffffffffffffll;
  __syncthreads();
  // bitonic sort, ascending, of p2 (a power of two) keys
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (p2 >> 1); t += kThreads) {
        const int i = 2 * t - (t & (j - 1));
        const int ixj = i + j;
        const long long a = page[i];
        const long long b = page[ixj];
        const bool up = (i & k) == 0;
        if ((a > b) == up) {
          page[i] = b;
          page[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
  long long neq = 0;
  for (int i = 1 + threadIdx.x; i < rows; i += kThreads)
    neq += page[i] != page[i - 1] ? 1 : 0;
  neq = block_sum(neq);
  if (threadIdx.x == 0) {
    const long long ndv = 1 + neq;
    const long long per_page = ndv * w + rows * ptr_bytes(ndv) + kPageMeta;
    const long long cap = rows * w + kPageMeta;
    atomicAdd(out + row,
              static_cast<unsigned long long>(min(per_page, cap)));
  }
}

// rows arrive sorted (torch.sort); ndv = 1 + #(adjacent unequal)
__global__ void gdict_bytes_kernel(const long long* __restrict__ sorted,
                                   const long long* __restrict__ widths,
                                   long long* __restrict__ out, int n) {
  const int row = blockIdx.x;
  const long long* __restrict__ r = sorted + static_cast<long long>(row) * n;
  long long neq = 0;
  for (int j = 1 + threadIdx.x; j < n; j += kThreads)
    neq += r[j] != r[j - 1] ? 1 : 0;
  neq = block_sum(neq);
  if (threadIdx.x == 0) {
    const long long ndv = 1 + neq;
    out[row] = ndv * widths[row] + static_cast<long long>(n) * ptr_bytes(ndv);
  }
}

__global__ void prefix_bytes_kernel(const long long* __restrict__ cols,
                                    const long long* __restrict__ widths,
                                    unsigned long long* __restrict__ out,
                                    int n, int rpp, int npages) {
  const int row = blockIdx.x / npages;
  const int pg = blockIdx.x - row * npages;
  const long long w = widths[row];
  const int start = pg * rpp;
  const int rows = (pg == npages - 1) ? n - start : rpp;
  const long long* __restrict__ src =
      cols + static_cast<long long>(row) * n + start;
  // every thread starts from the page's first value, so threads with no
  // row of their own leave the reduction unchanged
  long long mn = src[0];
  long long mx = mn;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const long long v = src[i];
    mn = min(mn, v);
    mx = max(mx, v);
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    const long long x = static_cast<long long>(
        static_cast<unsigned long long>(mn) ^
        static_cast<unsigned long long>(mx));
    const long long diff = x == 0 ? 0 : sig_bytes(x);
    const long long common = max(w - diff, 0ll);
    const long long per_page = common + rows * (1 + w - common) + kPageMeta;
    const long long cap = rows * w + kPageMeta;
    atomicAdd(out + row,
              static_cast<unsigned long long>(min(per_page, cap)));
  }
}

__global__ void rle_bytes_kernel(const long long* __restrict__ cols,
                                 const long long* __restrict__ widths,
                                 unsigned long long* __restrict__ out,
                                 int n, int rpp, int npages) {
  const int row = blockIdx.x / npages;
  const int pg = blockIdx.x - row * npages;
  const long long w = widths[row];
  const int start = pg * rpp;
  const int rows = (pg == npages - 1) ? n - start : rpp;
  const long long* __restrict__ src =
      cols + static_cast<long long>(row) * n + start;
  long long neq = 0;
  for (int i = 1 + threadIdx.x; i < rows; i += kThreads)
    neq += src[i] != src[i - 1] ? 1 : 0;
  neq = block_sum(neq);
  if (threadIdx.x == 0) {
    const long long runs = 1 + neq;
    const long long per_page = runs * (w + 2) + kPageMeta;
    const long long cap = rows * w + kPageMeta;
    atomicAdd(out + row,
              static_cast<unsigned long long>(min(per_page, cap)));
  }
}

}  // namespace

extern "C" {

const char* codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out: (m,) int64, written.  m >= 1, n >= 1.
int ns_bytes_launch(const void* cols, const void* widths, void* out, int m,
                    int n, void* stream) {
  ns_bytes_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cols),
      static_cast<const long long*>(widths), static_cast<long long*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

// out: (m,) int64, zeroed by the caller; pages are added into it.
// m * ceil(n / rpp) < 2^31 blocks.
// p2: power of two >= min(rpp, n), at most 4096 (32 KB of shared memory).
int ldict_bytes_launch(const void* cols, const void* widths, void* out, int m,
                       int n, int rpp, int p2, void* stream) {
  const int npages = (n + rpp - 1) / rpp;
  ldict_bytes_kernel<<<m * npages, kThreads, p2 * sizeof(long long),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cols),
      static_cast<const long long*>(widths),
      static_cast<unsigned long long*>(out), n, rpp, npages, p2);
  return static_cast<int>(cudaGetLastError());
}

// sorted: (m, n) int64, each row sorted ascending.  out: (m,) int64,
// written.  m >= 1, n >= 1.
int gdict_bytes_launch(const void* sorted, const void* widths, void* out,
                       int m, int n, void* stream) {
  gdict_bytes_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted),
      static_cast<const long long*>(widths), static_cast<long long*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

// out: (m,) int64, zeroed by the caller; pages are added into it.
// m * ceil(n / rpp) < 2^31 blocks.
int prefix_bytes_launch(const void* cols, const void* widths, void* out,
                        int m, int n, int rpp, void* stream) {
  const int npages = (n + rpp - 1) / rpp;
  prefix_bytes_kernel<<<m * npages, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cols),
      static_cast<const long long*>(widths),
      static_cast<unsigned long long*>(out), n, rpp, npages);
  return static_cast<int>(cudaGetLastError());
}

// out: as prefix_bytes_launch.
int rle_bytes_launch(const void* cols, const void* widths, void* out, int m,
                     int n, int rpp, void* stream) {
  const int npages = (n + rpp - 1) / rpp;
  rle_bytes_kernel<<<m * npages, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cols),
      static_cast<const long long*>(widths),
      static_cast<unsigned long long*>(out), n, rpp, npages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
