// Codec-size kernels for SampleCF: payload bytes per row of an (m, n)
// int64 column stack (one row per (target, column) sizing job), one kernel
// per compression method of the paper's Section 2.1.
//
// Replaces the Pallas kernels of src/repro/kernels/codec_bytes.py:
//   ns_bytes_kernel     <- _ns_kernel (l.95)
//   gdict_bytes_kernel  <- _gdict_kernel (l.104); the row sort before it
//                          (lax.sort, l.179-180) stays a library sort
//                          (torch.sort), as it was XLA's on the TPU
//   ldict_warp_kernel,  <- _ldict_kernel (l.113) AND the per-page lax.sort
//   ldict_block_kernel     pre-pass of _codec_call (l.187-191)
//   prefix_warp_kernel, <- _prefix_kernel (l.128)
//   prefix_block_kernel
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
// coalesced loads and a block reduction.  RLE: one block per (row, page),
// counting adjacent unequal pairs in the order given, its byte count added
// to the row total with a 64-bit integer atomic (order-free, hence
// deterministic).
//
// PREFIX needs each page's min and max.  With many pages (>= 1,024) of up
// to 512 rows, each warp of a persistent grid (as many warps as the card
// holds at once) takes an equal run of consecutive pages of the flattened
// (row, page) space and streams them: per page every lane loads pairs of
// values with 16-byte loads from the page's first 16-byte-aligned value on
// (a page of 273 rows starts 8-byte aligned, so one value may come
// before them and one after), keeps a running signed min and max, and the
// page closes with a shuffle reduction, no barrier; the warp adds its bytes
// to a row total with one atomic per row it touched.  Fewer pages, or
// larger ones, take one 256-thread block per page and a block reduction:
// there a page's latency decides.
//
// LDICT counts each page's distinct values with a hash set in shared
// memory, not a sort: a sort of a 273-row page in shared memory, padded to
// 512 keys, is a bitonic network of 45 stages, each ending in a block-wide
// barrier, for 2.2 KB of input.  Each page gets an open-addressing table
// (linear probing, Fibonacci hashing, at least 7 slots per 4 rows).  With
// many pages (>= 1,024), pages of up to 512 rows go one to a warp, four
// warps to a block, each warp with a table of its own of 64..1024 slots:
// the warp loads its page with coalesced 8-byte loads into registers and
// places the values without atomics, in rounds of read, write if empty,
// __syncwarp, read back (ldict_warp_kernel says why that is exact); ndv is
// the number of filled slots, counted as the warp empties its table.  No
// barrier but __syncwarp, no shared-memory atomic.  Pages of 513..4096
// rows, and any pages when there are too few to give each SM several warps
// (a page's latency decides there), take one 256-thread block per page,
// a table of up to 8192 slots in dynamic shared memory and 64-bit
// atomicCAS inserts that count the values that claimed an empty slot.
// A team (warp or block) walks a run of up to 8 consecutive pages and adds
// its bytes to the row total with one atomic per row it touched.
// Every int64 is a legal value, so "empty" is INT64_MIN and a real INT64_MIN
// is kept out of the table and counted with a flag.  Only a page's real
// rows are read: the reference edge-pads the last page with its last
// value, which adds no distinct value, no run and no new min or max.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

constexpr unsigned long long kEmpty = 0x8000000000000000ull;   // INT64_MIN
constexpr int kLdictTeams = 4;          // warps (one page each) per block
constexpr int kLdictMaxGroup = 8;       // pages a team walks, at most
constexpr long long kLdictBlockPages = 1024;   // fewer: a block per page

__device__ __forceinline__ long long ldict_page_bytes(long long ndv,
                                                      long long rows,
                                                      long long w) {
  return min(ndv * w + rows * ptr_bytes(ndv) + kPageMeta,
             rows * w + kPageMeta);
}

__device__ __forceinline__ unsigned ldict_hash(unsigned long long v,
                                               int log_slots) {
  return static_cast<unsigned>(
      ((v ^ (v >> 32)) * 0x9E3779B97F4A7C15ull) >> (64 - log_slots));
}

// Inserts v (!= kEmpty) into an open-addressing table of 2^log_slots
// slots shared by a block (linear probing).  Returns the slot v claimed,
// or -1 when v was there already.  Slots are only ever claimed while a
// page is inserted, so a slot that holds another value stays that way
// and probing past it is safe; the table is never more than 4/7 full, so
// the probe ends.
__device__ __forceinline__ int ldict_insert(unsigned long long* table,
                                            int log_slots,
                                            unsigned long long v) {
  const unsigned mask = (1u << log_slots) - 1;
  unsigned h = ldict_hash(v, log_slots);
  for (;;) {
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(table + h);
    if (cur == v) return -1;
    if (cur == kEmpty) {
      cur = atomicCAS(table + h, kEmpty, v);
      if (cur == kEmpty) return static_cast<int>(h);
      if (cur == v) return -1;
    }
    h = (h + 1) & mask;
  }
}

// One warp per page of <= 32 * kPerLane rows, kLdictTeams warps per
// block; pages [team * group, team * group + group) of the flattened
// (row, page) space go to one warp in turn.  A warp inserts without
// atomics, in rounds: every lane with a value still to place reads its
// probe slot; lanes that found it empty write their value; after a
// __syncwarp each re-reads the slot: its own value there (written by it
// or by a lane holding the same value) means placed, another value means
// probe on.  A value once placed is never overwritten (writes go only to
// slots read as empty in the same round), so each distinct value ends in
// exactly one slot, and ndv is the count of filled slots, which the warp
// counts while it empties the table for the next page.
template <int kLogSlots, int kPerLane>
__global__ void __launch_bounds__(kLdictTeams * 32)
ldict_warp_kernel(const long long* __restrict__ cols,
                  const long long* __restrict__ widths,
                  unsigned long long* __restrict__ out, int n, int rpp,
                  int npages, long long total_pages, int group) {
  constexpr unsigned kMask = (1u << kLogSlots) - 1;
  __shared__ unsigned long long tables[kLdictTeams][1 << kLogSlots];
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* table = tables[threadIdx.x >> 5];
  for (int i = lane; i < (1 << kLogSlots); i += 32) table[i] = kEmpty;
  __syncwarp();
  long long gp =
      (static_cast<long long>(blockIdx.x) * kLdictTeams + (threadIdx.x >> 5)) *
      group;
  const long long stop = min(gp + group, total_pages);
  long long run_row = -1;
  long long run_bytes = 0;
  for (; gp < stop; ++gp) {
    const long long row = gp / npages;
    const int pg = static_cast<int>(gp - row * npages);
    const int start = pg * rpp;
    const int rows = (pg == npages - 1) ? n - start : rpp;
    const long long* __restrict__ src = cols + row * n + start;
    unsigned long long v[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      v[i] = lane + 32 * i < rows
                 ? static_cast<unsigned long long>(src[lane + 32 * i])
                 : 0ull;
    bool has_min = false;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      bool todo = lane + 32 * i < rows;
      if (todo && v[i] == kEmpty) {
        has_min = true;
        todo = false;
      }
      unsigned h = ldict_hash(v[i], kLogSlots);
      while (__any_sync(0xffffffffu, todo)) {
        unsigned long long cur = todo ? table[h] : 0ull;
        const bool write = todo && cur == kEmpty;
        __syncwarp();
        if (write) table[h] = v[i];
        __syncwarp();
        if (write) cur = table[h];
        if (todo) {
          if (cur == v[i]) todo = false;
          else h = (h + 1) & kMask;
        }
      }
    }
    __syncwarp();                 // every value placed
    int filled = 0;
    for (int i = lane; i < (1 << kLogSlots); i += 32) {
      if (table[i] != kEmpty) {
        ++filled;
        table[i] = kEmpty;
      }
    }
    const long long ndv = __reduce_add_sync(0xffffffffu, filled) +
                          (__any_sync(0xffffffffu, has_min) ? 1 : 0);
    __syncwarp();                 // the table is empty again
    if (row != run_row) {
      if (lane == 0 && run_row >= 0)
        atomicAdd(out + run_row, static_cast<unsigned long long>(run_bytes));
      run_row = row;
      run_bytes = 0;
    }
    run_bytes += ldict_page_bytes(ndv, rows, widths[row]);
  }
  if (lane == 0 && run_row >= 0)
    atomicAdd(out + run_row, static_cast<unsigned long long>(run_bytes));
}

// One page per kThreads-thread block at a time (16 values a thread at
// most, so up to 4096 rows), a table of 2^log_slots slots in dynamic
// shared memory, values inserted with atomicCAS; pages [blockIdx.x *
// group, ... + group) in turn.  Pages of more than 512 rows, and any pages
// when there are too few to fill the card one warp each, take it.
constexpr int kLdictBlockPerThread = 4096 / kThreads;

__global__ void __launch_bounds__(kThreads)
ldict_block_kernel(const long long* __restrict__ cols,
                   const long long* __restrict__ widths,
                   unsigned long long* __restrict__ out, int n, int rpp,
                   int npages, long long total_pages, int group,
                   int log_slots) {
  extern __shared__ unsigned long long table[];
  for (int i = threadIdx.x; i < (1 << log_slots); i += kThreads)
    table[i] = kEmpty;
  __syncthreads();
  long long gp = static_cast<long long>(blockIdx.x) * group;
  const long long stop = min(gp + group, total_pages);
  long long run_row = -1;
  long long run_bytes = 0;
  for (; gp < stop; ++gp) {
    const long long row = gp / npages;
    const int pg = static_cast<int>(gp - row * npages);
    const int start = pg * rpp;
    const int rows = (pg == npages - 1) ? n - start : rpp;
    const long long* __restrict__ src = cols + row * n + start;
    unsigned long long v[kLdictBlockPerThread];
#pragma unroll
    for (int i = 0; i < kLdictBlockPerThread; ++i) {
      const int j = threadIdx.x + kThreads * i;
      v[i] = j < rows ? static_cast<unsigned long long>(src[j]) : 0ull;
    }
    int slot[kLdictBlockPerThread];
    long long fresh = 0;
    int has_min = 0;
#pragma unroll
    for (int i = 0; i < kLdictBlockPerThread; ++i) {
      slot[i] = -1;
      const bool mine = threadIdx.x + kThreads * i < rows;
      if (mine && v[i] == kEmpty) has_min = 1;
      // one lane inserts each value the warp holds, the lowest holding it:
      // a page of few distinct values would otherwise queue a warp's
      // atomics on one slot
      const unsigned live =
          __ballot_sync(0xffffffffu, mine && v[i] != kEmpty);
      const unsigned peers = __match_any_sync(0xffffffffu, v[i]) & live;
      if (((live >> (threadIdx.x & 31)) & 1) &&
          __ffs(peers) - 1 == static_cast<int>(threadIdx.x & 31)) {
        slot[i] = ldict_insert(table, log_slots, v[i]);
        fresh += slot[i] >= 0 ? 1 : 0;
      }
    }
    has_min = __syncthreads_or(has_min);   // every insert done
#pragma unroll
    for (int i = 0; i < kLdictBlockPerThread; ++i)
      if (slot[i] >= 0) table[slot[i]] = kEmpty;
    fresh = block_sum(fresh);              // its barrier orders the clears
    if (threadIdx.x == 0) {
      if (row != run_row) {
        if (run_row >= 0)
          atomicAdd(out + run_row,
                    static_cast<unsigned long long>(run_bytes));
        run_row = row;
        run_bytes = 0;
      }
      run_bytes += ldict_page_bytes(fresh + has_min, rows, widths[row]);
    }
  }
  if (threadIdx.x == 0 && run_row >= 0)
    atomicAdd(out + run_row, static_cast<unsigned long long>(run_bytes));
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

// PREFIX bytes of one page from its signed min and max
__device__ __forceinline__ long long prefix_page_bytes(long long mn,
                                                       long long mx,
                                                       long long rows,
                                                       long long w) {
  const long long x = static_cast<long long>(
      static_cast<unsigned long long>(mn) ^
      static_cast<unsigned long long>(mx));
  const long long diff = x == 0 ? 0 : sig_bytes(x);
  const long long common = max(w - diff, 0ll);
  const long long per_page = common + rows * (1 + w - common) + kPageMeta;
  return min(per_page, rows * w + kPageMeta);
}

constexpr int kPrefixTeams = 4;                // warps per block
constexpr long long kPrefixBlockPages = 1024;  // fewer: a block per page
constexpr long long kInt64Max = 0x7fffffffffffffffll;

// A warp per run of `chunk` consecutive pages of the flattened (row,
// page) space, pages of <= 64 * kPairs rows: per page, lane i loads pairs
// i, i + 32, ... (16-byte loads, all issued before the min and max use
// them), lane 0 the value before the first aligned pair and lane 1 the
// one after the last; a shuffle reduction closes the page.
template <int kPairs>
__global__ void __launch_bounds__(kPrefixTeams * 32)
prefix_warp_kernel(const long long* __restrict__ cols,
                   const long long* __restrict__ widths,
                   unsigned long long* __restrict__ out, int n, int rpp,
                   int npages, long long total_pages, long long chunk) {
  const int lane = threadIdx.x & 31;
  long long gp =
      (static_cast<long long>(blockIdx.x) * kPrefixTeams + (threadIdx.x >> 5)) *
      chunk;
  const long long stop = min(gp + chunk, total_pages);
  long long run_row = -1;
  long long run_bytes = 0;
  long long w = 0;
  for (; gp < stop; ++gp) {
    const long long row = gp / npages;
    const int pg = static_cast<int>(gp - row * npages);
    const int start = pg * rpp;
    const int rows = (pg == npages - 1) ? n - start : rpp;
    const long long* __restrict__ src = cols + row * n + start;
    const int head = (reinterpret_cast<size_t>(src) & 15) ? 1 : 0;
    const int pairs = (rows - head) >> 1;
    const longlong2* __restrict__ p2 =
        reinterpret_cast<const longlong2*>(src + head);
    long long mn = kInt64Max;
    long long mx = -kInt64Max - 1;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int i = lane + 32 * k;
      if (i < pairs) {
        const longlong2 t = __ldg(p2 + i);
        mn = min(mn, min(t.x, t.y));
        mx = max(mx, max(t.x, t.y));
      }
    }
    const int single = lane == 0 && head ? 0
                       : lane == 1 && ((rows - head) & 1) ? rows - 1
                                                          : -1;
    if (single >= 0) {
      const long long v = __ldg(src + single);
      mn = min(mn, v);
      mx = max(mx, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (row != run_row) {
      if (lane == 0 && run_row >= 0)
        atomicAdd(out + run_row, static_cast<unsigned long long>(run_bytes));
      run_row = row;
      run_bytes = 0;
      w = widths[row];
    }
    run_bytes += prefix_page_bytes(mn, mx, rows, w);
  }
  if (lane == 0 && run_row >= 0)
    atomicAdd(out + run_row, static_cast<unsigned long long>(run_bytes));
}

// One block per page: few pages, or pages of more than 512 rows.
__global__ void prefix_block_kernel(const long long* __restrict__ cols,
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
  if (threadIdx.x == 0)
    atomicAdd(out + row, static_cast<unsigned long long>(
                             prefix_page_bytes(mn, mx, rows, w)));
}

// The warp kernel on a persistent grid: as many warps as the card holds at
// once, each taking an equal run of pages.
template <int kPairs>
int launch_prefix_warp(const long long* cols, const long long* widths,
                       unsigned long long* out, int n, int rpp, int npages,
                       long long pages, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, prefix_warp_kernel<kPairs>, kPrefixTeams * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps =
      static_cast<long long>(sms) * std::max(per_sm, 1) * kPrefixTeams;
  const long long chunk = (pages + warps - 1) / warps;
  const long long teams = (pages + chunk - 1) / chunk;
  prefix_warp_kernel<kPairs>
      <<<static_cast<unsigned>((teams + kPrefixTeams - 1) / kPrefixTeams),
         kPrefixTeams * 32, 0, st>>>(cols, widths, out, n, rpp, npages,
                                     pages, chunk);
  return static_cast<int>(cudaGetLastError());
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
// m * ceil(n / rpp) < 2^31 pages; min(rpp, n) <= 4096 rows.
int ldict_bytes_launch(const void* cols, const void* widths, void* out, int m,
                       int n, int rpp, void* stream) {
  const int npages = (n + rpp - 1) / rpp;
  const int rows = std::min(rpp, n);
  const long long pages = static_cast<long long>(m) * npages;
  // at least 7 slots per 4 rows, 64 at least
  int log_slots = 6;
  while ((1 << log_slots) < (7 * rows + 3) / 4) ++log_slots;
  // a run of up to 8 pages per team once there are pages enough to fill
  // the card (132 SMs x ~64 resident warps)
  const int group = static_cast<int>(
      std::max(1ll, std::min(static_cast<long long>(kLdictMaxGroup),
                             pages / 8192)));
  const long long teams = (pages + group - 1) / group;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const long long*>(cols);
  const auto* w = static_cast<const long long*>(widths);
  auto* o = static_cast<unsigned long long*>(out);
  // a warp per page needs many pages: under ~1,000 (132 SMs x 8) a page's
  // latency decides, and 256 threads per page shorten it
  if (rows > 512 || pages < kLdictBlockPages) {
    const int smem = static_cast<int>(sizeof(unsigned long long)) << log_slots;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ldict_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ldict_block_kernel<<<static_cast<unsigned>(teams), kThreads, smem, st>>>(
        c, w, o, n, rpp, npages, pages, group, log_slots);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks =
      static_cast<unsigned>((teams + kLdictTeams - 1) / kLdictTeams);
  switch (log_slots) {   // rows <= 4/7 of the slots, <= 32 * kPerLane
    case 6:
      ldict_warp_kernel<6, 2><<<blocks, kLdictTeams * 32, 0, st>>>(
          c, w, o, n, rpp, npages, pages, group);
      break;
    case 7:
      ldict_warp_kernel<7, 3><<<blocks, kLdictTeams * 32, 0, st>>>(
          c, w, o, n, rpp, npages, pages, group);
      break;
    case 8:
      ldict_warp_kernel<8, 6><<<blocks, kLdictTeams * 32, 0, st>>>(
          c, w, o, n, rpp, npages, pages, group);
      break;
    case 9:
      ldict_warp_kernel<9, 11><<<blocks, kLdictTeams * 32, 0, st>>>(
          c, w, o, n, rpp, npages, pages, group);
      break;
    default:
      ldict_warp_kernel<10, 16><<<blocks, kLdictTeams * 32, 0, st>>>(
          c, w, o, n, rpp, npages, pages, group);
      break;
  }
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
// m * ceil(n / rpp) < 2^31 pages.
int prefix_bytes_launch(const void* cols, const void* widths, void* out,
                        int m, int n, int rpp, void* stream) {
  const int npages = (n + rpp - 1) / rpp;
  const int rows = std::min(rpp, n);
  const long long pages = static_cast<long long>(m) * npages;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const long long*>(cols);
  const auto* w = static_cast<const long long*>(widths);
  auto* o = static_cast<unsigned long long*>(out);
  if (rows > 512 || pages < kPrefixBlockPages) {
    prefix_block_kernel<<<static_cast<unsigned>(pages), kThreads, 0, st>>>(
        c, w, o, n, rpp, npages);
    return static_cast<int>(cudaGetLastError());
  }
  // pairs a lane loads per page, at most: rows / 2 over 32 lanes
  if (rows <= 64)
    return launch_prefix_warp<1>(c, w, o, n, rpp, npages, pages, st);
  if (rows <= 128)
    return launch_prefix_warp<2>(c, w, o, n, rpp, npages, pages, st);
  if (rows <= 256)
    return launch_prefix_warp<4>(c, w, o, n, rpp, npages, pages, st);
  return launch_prefix_warp<8>(c, w, o, n, rpp, npages, pages, st);
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
