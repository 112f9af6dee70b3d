// Codec-size kernels for SampleCF: payload bytes per row of an (m, n)
// int64 column stack (one row per (target, column) sizing job), one kernel
// per compression method of the paper's Section 2.1.
//
// Replaces the Pallas kernels of src/repro/kernels/codec_bytes.py:
//   ns_bytes_kernel     <- _ns_kernel (l.95)
//   gdict_kernel        <- _gdict_kernel (l.104) AND the row sort before
//                          it (lax.sort, l.179-180): no sort at all
//   ldict_warp_kernel,  <- _ldict_kernel (l.113) AND the per-page lax.sort
//   ldict_block_kernel     pre-pass of _codec_call (l.187-191)
//   page_warp_kernel,   <- _prefix_kernel (l.128) with PrefixPage,
//   page_block_kernel      _rle_kernel (l.149) with RlePage
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
// 3.35 TB/s.
//
// GDICT counts each row's distinct values with a hash set, LDICT's
// (open addressing, linear probing, Fibonacci hashing, INT64_MIN as the
// empty slot and a flag for a real INT64_MIN, never more than 4/7 full),
// of next_pow2(ceil(7n / 4)) slots a row: a sort of 60,000 keys (the TPU
// path's lax.sort, a torch.sort before) was 87 % of the time.  Values are
// read with 16-byte loads, four in flight a thread; a warp's equal values are
// merged with __match_any_sync and one lane inserts each (a column of few
// distinct values would otherwise queue a warp's 64-bit atomicCAS on one
// slot); a slot is read before any atomicCAS, and the CAS is tried only
// on a slot read as empty; ndv is the number of slots claimed.  Three classes by the
// table's size, one template (gdict_kernel), chosen by the wrapper
// (codec_bytes.gdict_plan):
//  1. up to 8,192 slots (64 KB, rows <= 4,681): one 256-thread block a
//     row, the table in its shared memory, several blocks to an SM;
//  2. up to 131,072 slots (1 MiB, rows <= 74,898): one logical table
//     split over a thread-block cluster of up to 8 blocks of 1,024
//     threads, <= 128 KB each; slot h lives in block rank h >> log_share
//     and is reached through cluster.map_shared_rank (atomics on
//     distributed shared memory); each block reads its share of the row
//     and counts the slots its threads claimed, and block rank 0 sums the
//     counts through distributed shared memory: no atomic in global
//     memory, no zeroed output.  The cluster doubles (NS's rule) while
//     the rows alone would leave SMs idle; a cluster of one is a plain
//     launch.  At (11, 60000): 8 x 128 KB, 88 blocks;
//  3. longer rows: a table in global memory (the wrapper's scratch, few
//     enough tables to stay in the 50 MB L2 where they can) per cluster
//     of 8 blocks of a persistent grid; the cluster fills its table with
//     the empty marker before each of its rows and inserts the row as in
//     class 2, with atomics in global memory.
//
// NS spreads each row over a thread-block cluster of up to 8 blocks
// (more blocks per row while the grid would leave SMs idle and each block
// keeps >= 1,024 values), launched with cudaLaunchKernelEx: each block
// reads its share of the row's 16-byte pairs, four loads a thread in
// flight, reduces it with shuffles and shared memory, and block rank 0
// sums the blocks' partials through distributed shared memory and writes
// the row's bytes.  No atomic, no zeroed output, one launch.  Rows that
// fill the card alone, or of fewer than 2,048 values, take one block each
// in a plain launch.
//
// PREFIX (each page's min and max) and RLE (each page's adjacent unequal
// pairs, in the order given) walk pages the same way, one template each,
// instantiated with the per-page operation.  With many pages (>= 1,024)
// of up to 512 rows, each warp of a persistent grid (as many warps as the
// card holds at once) takes an equal run of consecutive pages of the
// flattened (row, page) space and streams them: per page every lane loads
// pairs of values with 16-byte loads from the page's first 16-byte-aligned
// value on (a page of 273 rows starts 8-byte aligned, so one value may
// come before them and one after), all loads issued before any is used;
// the page closes with a shuffle reduction, no barrier; the warp adds its
// bytes to a row total with one atomic per row it touched.  RLE compares
// each pair inside itself and with the value to its left, which a
// __shfl_up brings from the lane before (lane 0 keeps lane 31's from the
// step before, or the page's odd first value), never from another page.
// Fewer pages, or larger ones, take one 256-thread block per page and a
// block reduction: there a page's latency decides.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr long long kPageMeta = 16;

// Significant bytes of v read as uint64, 1..8: a value of b significant
// bits (b = 64 - clz, 1 <= b <= 64) takes ceil(b / 8) = (71 - clz) >> 3
// bytes, and 0 (clz = 64) gives 0, raised to 1; a negative value has
// clz = 0 and takes 8.
__device__ __forceinline__ int sig_bytes(long long v) {
  return max(1, (71 - __clzll(v)) >> 3);
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

// blocks a row may take (the portable cluster size), and the values a
// block keeps at least
constexpr int kNsMaxCluster = 8;
constexpr int kNsMinBlockValues = 1024;

// Half-bytes of one value of a column of width wc = min(w, 9): for w >= 9
// min(2s + 1, 2w) = 2s + 1 (s <= 8), so the cap changes nothing.
__device__ __forceinline__ unsigned ns_half(long long v, int wc) {
  const int s = min(sig_bytes(v), wc);
  return static_cast<unsigned>(min(2 * s + 1, 2 * wc));
}

// kCluster: a cluster of P blocks per row (grid m * P, cluster P): block
// rank r sums the half-bytes of pairs [r * pairs / P, (r + 1) * pairs / P)
// of the row's 16-byte pairs (rank 0 also the odd value before them, rank
// P - 1 the one after), and rank 0 sums the P partials through distributed
// shared memory.  Otherwise one block per row, launched without a cluster:
// a cluster launch and its barriers cost a short row more than they save.
// A thread adds at most n / 256 + 2 values of <= 17 half-bytes in 32 bits
// (n < 2^31); the block sums in 64.  Widths >= 1.
template <bool kCluster>
__global__ void __launch_bounds__(kThreads)
ns_bytes_kernel(const long long* __restrict__ cols,
                const long long* __restrict__ widths,
                long long* __restrict__ out, int n) {
  namespace cg = cooperative_groups;
  int parts = 1, rank = 0;
  if constexpr (kCluster) {
    parts = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const long long row = blockIdx.x / parts;
  const int wc = static_cast<int>(min(widths[row], 9ll));
  const long long* __restrict__ r = cols + row * n;
  const int head = (reinterpret_cast<size_t>(r) & 15) ? 1 : 0;
  const int pairs = (n - head) >> 1;
  const int lo =
      static_cast<int>(static_cast<long long>(pairs) * rank / parts);
  const int hi =
      static_cast<int>(static_cast<long long>(pairs) * (rank + 1) / parts);
  const longlong2* __restrict__ p2 =
      reinterpret_cast<const longlong2*>(r + head);
  unsigned acc = 0;
  int i = lo + static_cast<int>(threadIdx.x);
  for (; i + 3 * kThreads < hi; i += 4 * kThreads) {
    const longlong2 a = __ldg(p2 + i);
    const longlong2 b = __ldg(p2 + i + kThreads);
    const longlong2 c = __ldg(p2 + i + 2 * kThreads);
    const longlong2 d = __ldg(p2 + i + 3 * kThreads);
    acc += ns_half(a.x, wc) + ns_half(a.y, wc) + ns_half(b.x, wc) +
           ns_half(b.y, wc) + ns_half(c.x, wc) + ns_half(c.y, wc) +
           ns_half(d.x, wc) + ns_half(d.y, wc);
  }
  for (; i < hi; i += kThreads) {
    const longlong2 a = __ldg(p2 + i);
    acc += ns_half(a.x, wc) + ns_half(a.y, wc);
  }
  if (threadIdx.x == 0 && rank == 0 && head) acc += ns_half(__ldg(r), wc);
  if (threadIdx.x == 1 && rank == parts - 1 && ((n - head) & 1))
    acc += ns_half(__ldg(r + n - 1), wc);
  const long long sum = block_sum(acc);
  if constexpr (!kCluster) {
    if (threadIdx.x == 0) out[row] = (sum + 1) / 2;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ long long part;
    if (threadIdx.x == 0) part = sum;
    cluster.sync();
    if (rank == 0 && threadIdx.x < 32) {
      long long total =
          static_cast<int>(threadIdx.x) < parts
              ? *cluster.map_shared_rank(&part, threadIdx.x)
              : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        total += __shfl_xor_sync(0xffffffffu, total, off);
      if (threadIdx.x == 0) out[row] = (total + 1) / 2;
    }
    cluster.sync();   // every partial stays until rank 0 has read it
  }
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

// A table of 2^log_slots slots in one piece: a block's shared memory, or
// a region of global memory.
struct FlatTable {
  unsigned long long* t;
  int log_slots;
  __device__ __forceinline__ unsigned long long* slot(unsigned h) const {
    return t + h;
  }
};

// One table of 2^log_slots slots split over the blocks of a cluster, each
// holding 2^log_share of them at the same shared-memory offset `t`: slot h
// lives in block rank h >> log_share.
struct ClusterTable {
  unsigned long long* t;
  int log_slots, log_share;
  __device__ __forceinline__ unsigned long long* slot(unsigned h) const {
    return cooperative_groups::this_cluster().map_shared_rank(
        t + (h & ((1u << log_share) - 1)), h >> log_share);
  }
};

// Inserts v (!= kEmpty) into an open-addressing table of 2^log_slots <=
// 2^31 slots (linear probing).  Returns the slot v claimed, or -1 when v
// was there already.  Slots are only ever claimed while a page or row is
// inserted, so a slot that holds another value stays that way and probing
// past it is safe; each distinct value ends in exactly one slot (a value
// placed further along would have passed its own slot); the table is
// never more than 4/7 full, so the probe ends.
template <class Table>
__device__ __forceinline__ int hash_insert(const Table& tb,
                                           unsigned long long v) {
  const unsigned mask = (1u << tb.log_slots) - 1;
  unsigned h = ldict_hash(v, tb.log_slots);
  for (;;) {
    unsigned long long* s = tb.slot(h);
    unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(s);
    if (cur == v) return -1;
    if (cur == kEmpty) {
      cur = atomicCAS(s, kEmpty, v);
      if (cur == kEmpty) return static_cast<int>(h);
      if (cur == v) return -1;
    }
    h = (h + 1) & mask;
  }
}

// hash_insert into a block's table in shared memory
__device__ __forceinline__ int ldict_insert(unsigned long long* table,
                                            int log_slots,
                                            unsigned long long v) {
  return hash_insert(FlatTable{table, log_slots}, v);
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

constexpr int kGdictBlockThreads = 256;    // class 1: a block a row
constexpr int kGdictWideThreads = 1024;    // classes 2 and 3
constexpr int kGdictLoads = 4;             // 16-byte loads a thread in flight
constexpr int kGdictMaxBlockLog = 13;      // class 1: <= 8,192 slots (64 KB)
constexpr int kGdictMaxShareLog = 14;      // class 2: <= 16,384 slots a block
constexpr int kGdictMaxCluster = 8;        //   (128 KB) in <= 8 blocks

// The table's layout: one block's shared memory (a plain launch), split
// over a cluster's shared memory, or a region of global memory that a
// cluster shares.
enum GdictTable { kGdictBlock, kGdictCluster, kGdictGlobal };

// Warp-collective (all 32 lanes, converged): the lanes where `mine` offer
// v; a real INT64_MIN only sets has_min; of the lanes offering one value
// the lowest inserts it.  Returns 1 where this lane claimed a slot.
template <class Table>
__device__ __forceinline__ int gdict_put(const Table& tb,
                                         unsigned long long v, bool mine,
                                         bool& has_min) {
  if (mine && v == kEmpty) {
    has_min = true;
    mine = false;
  }
  const unsigned live = __ballot_sync(0xffffffffu, mine);
  if (live == 0) return 0;
  const unsigned peers = __match_any_sync(0xffffffffu, v) & live;
  const int lane = static_cast<int>(threadIdx.x & 31);
  return (mine && __ffs(peers) - 1 == lane && hash_insert(tb, v) >= 0) ? 1
                                                                       : 0;
}

// Inserts pairs [lo, hi) of row r's 16-byte pairs (from its first 16-byte
// aligned value), `first`: also the odd value before them, `last`: the odd
// value after them.  Every thread of the block calls it (the loop's trip
// count is the block's).  Returns the slots this thread claimed.
template <class Table>
__device__ __forceinline__ int gdict_insert_span(
    const Table& tb, const long long* __restrict__ r, int n, int lo, int hi,
    bool first, bool last, bool& has_min) {
  const int head = (reinterpret_cast<size_t>(r) & 15) ? 1 : 0;
  const longlong2* __restrict__ p2 =
      reinterpret_cast<const longlong2*>(r + head);
  const int nt = static_cast<int>(blockDim.x);
  const int tid = static_cast<int>(threadIdx.x);
  int fresh = 0;
  for (int base = lo; base < hi; base += kGdictLoads * nt) {
    longlong2 a[kGdictLoads];
#pragma unroll
    for (int u = 0; u < kGdictLoads; ++u) {
      const int i = base + u * nt + tid;
      a[u] = i < hi ? __ldg(p2 + i) : make_longlong2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < kGdictLoads; ++u) {
      const bool ok = base + u * nt + tid < hi;
      fresh += gdict_put(tb, static_cast<unsigned long long>(a[u].x), ok,
                         has_min);
      fresh += gdict_put(tb, static_cast<unsigned long long>(a[u].y), ok,
                         has_min);
    }
  }
  if (tid < 32) {
    const bool h = tid == 0 && first && head;
    const bool t = tid == 1 && last && ((n - head) & 1);
    const long long v = h ? __ldg(r) : (t ? __ldg(r + n - 1) : 0);
    fresh += gdict_put(tb, static_cast<unsigned long long>(v), h || t,
                       has_min);
  }
  return fresh;
}

__device__ __forceinline__ long long gdict_row_bytes(long long ndv, int n,
                                                     long long w) {
  return ndv * w + static_cast<long long>(n) * ptr_bytes(ndv);
}

// kKind kGdictBlock: one block a row (a plain launch), its table of
// 2^log_slots slots in the block's shared memory.  kGdictCluster: a
// cluster of P blocks a row (grid m * P), 2^log_share slots in each
// block's shared memory, slot h in block rank h >> log_share.
// kGdictGlobal: cluster c of a grid of `tables` clusters owns the table of
// 2^log_slots slots at scratch + (c << log_slots) in global memory and
// takes rows c, c + tables, ...; its block of rank b fills slots [b, b +
// 1) * 2^log_slots / P with the empty marker before each row.
// A cluster's block of rank b inserts pairs [b * pairs / P, (b + 1) *
// pairs / P) of the row (rank 0 also the odd value before them, rank P -
// 1 the one after) and counts the slots its threads claimed; rank 0 sums
// the blocks' counts and INT64_MIN flags through distributed shared
// memory.
template <int kKind>
__global__ void __launch_bounds__(kGdictWideThreads)
gdict_kernel(const long long* __restrict__ cols,
             const long long* __restrict__ widths,
             long long* __restrict__ out, int m, int n, int log_slots,
             int log_share, unsigned long long* __restrict__ scratch) {
  namespace cg = cooperative_groups;
  extern __shared__ unsigned long long table[];
  __shared__ unsigned count;
  __shared__ int any_min;
  int parts = 1, rank = 0;
  if constexpr (kKind != kGdictBlock) {
    parts = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const long long group = blockIdx.x / parts;
  const long long groups = gridDim.x / parts;
  unsigned long long* gtable = nullptr;
  if constexpr (kKind == kGdictGlobal) gtable = scratch + (group << log_slots);
  for (long long row = group; row < m; row += groups) {
    if constexpr (kKind == kGdictGlobal) {
      const long long share = (1ll << log_slots) / parts;
      ulonglong2* t2 = reinterpret_cast<ulonglong2*>(gtable + rank * share);
      for (long long i = threadIdx.x; i < share / 2; i += blockDim.x)
        t2[i] = make_ulonglong2(kEmpty, kEmpty);
    } else {
      for (int i = threadIdx.x; i < (1 << log_share); i += blockDim.x)
        table[i] = kEmpty;
    }
    if (threadIdx.x == 0) count = 0;
    if constexpr (kKind == kGdictBlock)
      __syncthreads();
    else
      cg::this_cluster().sync();   // the whole table empty before inserts
    const long long* __restrict__ r = cols + row * n;
    const int head = (reinterpret_cast<size_t>(r) & 15) ? 1 : 0;
    const int pairs = (n - head) >> 1;
    const int lo =
        static_cast<int>(static_cast<long long>(pairs) * rank / parts);
    const int hi =
        static_cast<int>(static_cast<long long>(pairs) * (rank + 1) / parts);
    bool has_min = false;
    int fresh;
    if constexpr (kKind == kGdictCluster)
      fresh = gdict_insert_span(ClusterTable{table, log_slots, log_share}, r,
                                n, lo, hi, rank == 0, rank == parts - 1,
                                has_min);
    else
      fresh = gdict_insert_span(
          FlatTable{kKind == kGdictGlobal ? gtable : table, log_slots}, r, n,
          lo, hi, rank == 0, rank == parts - 1, has_min);
    fresh = static_cast<int>(
        __reduce_add_sync(0xffffffffu, static_cast<unsigned>(fresh)));
    if ((threadIdx.x & 31) == 0 && fresh)
      atomicAdd(&count, static_cast<unsigned>(fresh));
    const int saw_min = __syncthreads_or(has_min);   // count complete
    if constexpr (kKind == kGdictBlock) {
      if (threadIdx.x == 0)
        out[row] = gdict_row_bytes(static_cast<long long>(count) + saw_min,
                                   n, widths[row]);
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) any_min = saw_min;
      cluster.sync();   // every insert done, every block's count written
      if (rank == 0 && threadIdx.x < 32) {
        const bool mine = static_cast<int>(threadIdx.x) < parts;
        long long ndv =
            mine ? *cluster.map_shared_rank(&count, threadIdx.x) : 0u;
        int flag =
            mine ? *cluster.map_shared_rank(&any_min, threadIdx.x) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          ndv += __shfl_xor_sync(0xffffffffu, ndv, off);
          flag |= __shfl_xor_sync(0xffffffffu, flag, off);
        }
        if (threadIdx.x == 0)
          out[row] = gdict_row_bytes(ndv + (flag ? 1 : 0), n, widths[row]);
      }
      cluster.sync();   // the counts and tables stay until rank 0 read them
    }
  }
}

constexpr int kPageTeams = 4;                // warps per block
constexpr long long kPageBlockPages = 1024;   // fewer: a block per page
constexpr long long kInt64Max = 0x7fffffffffffffffll;

// One page of <= 64 * kPairs values in a warp's registers: lane i holds
// pairs i, i + 32, ... of 16-byte loads from the page's first
// 16-byte-aligned value, lane 0 the odd value before them (`head`), and the
// lane that holds the last pair the odd value after it (`tail`; lane 0 when
// there is no pair).  Every load is issued before any value is used.
template <int kPairs>
struct WarpPage {
  longlong2 t[kPairs];
  long long head, tail;
  int pairs;
  bool has_head, has_tail;   // this lane holds them

  __device__ __forceinline__ void load(const long long* __restrict__ src,
                                       int rows, int lane) {
    const int h = (reinterpret_cast<size_t>(src) & 15) ? 1 : 0;
    pairs = (rows - h) >> 1;
    const longlong2* __restrict__ p2 =
        reinterpret_cast<const longlong2*>(src + h);
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int i = lane + 32 * k;
      t[k] = i < pairs ? __ldg(p2 + i) : make_longlong2(0, 0);
    }
    has_head = lane == 0 && h;
    has_tail = ((rows - h) & 1) && lane == (pairs > 0 ? (pairs - 1) & 31 : 0);
    head = has_head ? __ldg(src) : 0;
    tail = has_tail ? __ldg(src + rows - 1) : 0;
  }
};

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

// RLE bytes of one page of `runs` runs
__device__ __forceinline__ long long rle_page_bytes(long long runs,
                                                    long long rows,
                                                    long long w) {
  return min(runs * (w + 2) + kPageMeta, rows * w + kPageMeta);
}

// The per-page operations of page_warp_kernel (warp_page: the page in the
// warp's registers, bytes valid in every lane) and page_block_kernel
// (block_page: the page read by a block, bytes computed by thread 0 only:
// a block per page is short, and the other warps' share of it counts).
struct PrefixPage {
  template <int kPairs>
  static __device__ __forceinline__ long long warp_page(
      const WarpPage<kPairs>& p, int rows, long long w, int lane) {
    long long mn = kInt64Max;
    long long mx = -kInt64Max - 1;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if (lane + 32 * k < p.pairs) {
        mn = min(mn, min(p.t[k].x, p.t[k].y));
        mx = max(mx, max(p.t[k].x, p.t[k].y));
      }
    }
    if (p.has_head) {
      mn = min(mn, p.head);
      mx = max(mx, p.head);
    }
    if (p.has_tail) {
      mn = min(mn, p.tail);
      mx = max(mx, p.tail);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    return prefix_page_bytes(mn, mx, rows, w);
  }

  static __device__ __forceinline__ long long block_page(
      const long long* __restrict__ src, int rows, long long w) {
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
    return threadIdx.x == 0 ? prefix_page_bytes(mn, mx, rows, w) : 0;
  }
};

struct RlePage {
  // runs = 1 + #(v[i] != v[i - 1]) over the page: each lane compares its
  // pair inside and with the value to its left -- the previous pair's .y,
  // from the lane before (__shfl_up), for lane 0 from lane 31 of the step
  // before, on the first step the page's odd first value (`head`) or
  // nothing: the page's first value starts a run -- and the last pair's
  // lane its .y with the odd value after it.
  template <int kPairs>
  static __device__ __forceinline__ long long warp_page(
      const WarpPage<kPairs>& p, int rows, long long w, int lane) {
    int neq = 0;
    long long carry = p.head;   // lane 0: the value left of its pair
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int i = lane + 32 * k;
      const long long up = __shfl_up_sync(0xffffffffu, p.t[k].y, 1);
      const long long last = __shfl_sync(0xffffffffu, p.t[k].y, 31);
      if (i < p.pairs) {
        const bool has_left = lane > 0 || k > 0 || p.has_head;
        neq += (p.t[k].x != p.t[k].y) +
               (has_left && (lane > 0 ? up : carry) != p.t[k].x);
        if (p.has_tail && i == p.pairs - 1) neq += p.t[k].y != p.tail;
      }
      carry = last;
    }
    // two values, neither in a pair: lane 0 holds both
    if (p.pairs == 0 && p.has_head && p.has_tail) neq += p.head != p.tail;
    return rle_page_bytes(1 + __reduce_add_sync(0xffffffffu, neq), rows, w);
  }

  static __device__ __forceinline__ long long block_page(
      const long long* __restrict__ src, int rows, long long w) {
    long long neq = 0;
    for (int i = 1 + threadIdx.x; i < rows; i += kThreads)
      neq += src[i] != src[i - 1] ? 1 : 0;
    neq = block_sum(neq);
    return threadIdx.x == 0 ? rle_page_bytes(1 + neq, rows, w) : 0;
  }
};

// A warp per run of `chunk` consecutive pages of the flattened (row, page)
// space, pages of <= 64 * kPairs rows; the warp adds its bytes to a row's
// total once per row it touched.
template <class Op, int kPairs>
__global__ void __launch_bounds__(kPageTeams * 32)
page_warp_kernel(const long long* __restrict__ cols,
                 const long long* __restrict__ widths,
                 unsigned long long* __restrict__ out, int n, int rpp,
                 int npages, long long total_pages, long long chunk) {
  const int lane = threadIdx.x & 31;
  long long gp =
      (static_cast<long long>(blockIdx.x) * kPageTeams + (threadIdx.x >> 5)) *
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
    WarpPage<kPairs> page;
    page.load(cols + row * n + start, rows, lane);
    if (row != run_row) {
      if (lane == 0 && run_row >= 0)
        atomicAdd(out + run_row, static_cast<unsigned long long>(run_bytes));
      run_row = row;
      run_bytes = 0;
      w = widths[row];
    }
    run_bytes += Op::warp_page(page, rows, w, lane);
  }
  if (lane == 0 && run_row >= 0)
    atomicAdd(out + run_row, static_cast<unsigned long long>(run_bytes));
}

// One block per page: few pages, or pages of more than 512 rows.
template <class Op>
__global__ void page_block_kernel(const long long* __restrict__ cols,
                                  const long long* __restrict__ widths,
                                  unsigned long long* __restrict__ out,
                                  int n, int rpp, int npages) {
  const int row = blockIdx.x / npages;
  const int pg = blockIdx.x - row * npages;
  const long long w = widths[row];
  const int start = pg * rpp;
  const int rows = (pg == npages - 1) ? n - start : rpp;
  const long long bytes = Op::block_page(
      cols + static_cast<long long>(row) * n + start, rows, w);
  if (threadIdx.x == 0)
    atomicAdd(out + row, static_cast<unsigned long long>(bytes));
}

// The warp kernel on a persistent grid: as many warps as the card holds at
// once, each taking an equal run of pages.
template <class Op, int kPairs>
int launch_page_warp(const long long* cols, const long long* widths,
                     unsigned long long* out, int n, int rpp, int npages,
                     long long pages, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, page_warp_kernel<Op, kPairs>, kPageTeams * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps =
      static_cast<long long>(sms) * std::max(per_sm, 1) * kPageTeams;
  const long long chunk = (pages + warps - 1) / warps;
  const long long teams = (pages + chunk - 1) / chunk;
  page_warp_kernel<Op, kPairs>
      <<<static_cast<unsigned>((teams + kPageTeams - 1) / kPageTeams),
         kPageTeams * 32, 0, st>>>(cols, widths, out, n, rpp, npages, pages,
                                   chunk);
  return static_cast<int>(cudaGetLastError());
}

// out: (m,) int64, zeroed by the caller; pages are added into it.
// m * ceil(n / rpp) < 2^31 pages.
template <class Op>
int page_launch(const void* cols, const void* widths, void* out, int m,
                int n, int rpp, void* stream) {
  const int npages = (n + rpp - 1) / rpp;
  const int rows = std::min(rpp, n);
  const long long pages = static_cast<long long>(m) * npages;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const long long*>(cols);
  const auto* w = static_cast<const long long*>(widths);
  auto* o = static_cast<unsigned long long*>(out);
  if (rows > 512 || pages < kPageBlockPages) {
    page_block_kernel<Op><<<static_cast<unsigned>(pages), kThreads, 0, st>>>(
        c, w, o, n, rpp, npages);
    return static_cast<int>(cudaGetLastError());
  }
  // pairs a lane loads per page, at most: rows / 2 over 32 lanes
  if (rows <= 64)
    return launch_page_warp<Op, 1>(c, w, o, n, rpp, npages, pages, st);
  if (rows <= 128)
    return launch_page_warp<Op, 2>(c, w, o, n, rpp, npages, pages, st);
  if (rows <= 256)
    return launch_page_warp<Op, 4>(c, w, o, n, rpp, npages, pages, st);
  return launch_page_warp<Op, 8>(c, w, o, n, rpp, npages, pages, st);
}

}  // namespace

extern "C" {

const char* codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out: (m,) int64, written.  m >= 1, n >= 1, widths >= 1.  Blocks per row
// (the cluster size) double from 1 while the grid has fewer blocks than
// the card has SMs and each block keeps >= kNsMinBlockValues values, up to
// kNsMaxCluster; one block per row takes a plain launch.  A launch the card
// refuses is returned as an error.
int ns_bytes_launch(const void* cols, const void* widths, void* out, int m,
                    int n, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int parts = 1;
  while (parts < kNsMaxCluster && static_cast<long long>(m) * parts < sms &&
         n / (2 * parts) >= kNsMinBlockValues)
    parts *= 2;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const long long*>(cols);
  const auto* w = static_cast<const long long*>(widths);
  auto* o = static_cast<long long*>(out);
  if (parts == 1) {
    ns_bytes_kernel<false><<<m, kThreads, 0, st>>>(c, w, o, n);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m) * parts);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ns_bytes_kernel<true>, c, w, o, n);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// out: (m,) int64, written.  m >= 1, n >= 1, a table of 2^log_slots >=
// 7n / 4 slots a row.  route 0: a block a row (parts 1, log_slots <=
// kGdictMaxBlockLog); 1: a cluster of `parts` blocks a row (1: a plain
// launch), 2^log_slots / parts <= 2^kGdictMaxShareLog slots a block; 2:
// `tables` clusters of `parts` blocks, scratch holding tables <<
// log_slots slots.  A size the card refuses, or a refused launch, is
// returned as an error.
int gdict_bytes_launch(const void* cols, const void* widths, void* out,
                       int m, int n, int route, int log_slots, int parts,
                       void* scratch, int tables, void* stream) {
  int log_parts = 0;
  while ((1 << log_parts) < parts) ++log_parts;
  const int log_share = log_slots - log_parts;
  bool ok = (1 << log_parts) == parts && parts <= kGdictMaxCluster &&
            log_share >= 1 && log_slots <= 31;
  if (route == 0)
    ok = ok && parts == 1 && log_slots <= kGdictMaxBlockLog;
  else if (route == 1)
    ok = ok && log_share <= kGdictMaxShareLog;
  else
    ok = ok && route == 2 && parts > 1 && scratch != nullptr && tables >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      route == 2 ? 0 : static_cast<int>(sizeof(unsigned long long))
                           << log_share;
  auto kernel = route == 2 ? gdict_kernel<kGdictGlobal>
                : parts > 1 ? gdict_kernel<kGdictCluster>
                            : gdict_kernel<kGdictBlock>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const long long*>(cols);
  const auto* w = static_cast<const long long*>(widths);
  auto* o = static_cast<long long*>(out);
  auto* sc = static_cast<unsigned long long*>(scratch);
  const int threads = route == 0 ? kGdictBlockThreads : kGdictWideThreads;
  if (parts == 1) {
    kernel<<<m, threads, smem, st>>>(c, w, o, m, n, log_slots, log_share, sc);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>(route == 2 ? tables : m) * parts);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, c, w, o, m, n,
                                             log_slots, log_share, sc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out: (m,) int64, zeroed by the caller; pages are added into it.
// m * ceil(n / rpp) < 2^31 pages.
int prefix_bytes_launch(const void* cols, const void* widths, void* out,
                        int m, int n, int rpp, void* stream) {
  return page_launch<PrefixPage>(cols, widths, out, m, n, rpp, stream);
}

// out: as prefix_bytes_launch.
int rle_bytes_launch(const void* cols, const void* widths, void* out, int m,
                     int n, int rpp, void* stream) {
  return page_launch<RlePage>(cols, widths, out, m, n, rpp, stream);
}

}  // extern "C"
