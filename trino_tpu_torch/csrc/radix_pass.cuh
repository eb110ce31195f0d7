// Stable counting passes of an LSD radix sort over a row-index
// permutation, and the gather of columns by a permutation: shared by
// group_sort.cu (the one-sweep pass below, over eight-bit digits of packed
// 64-bit sort keys) and partition_epilogue.cu (the tile ranking of the
// one-sweep pass and the tile-count scan, up to 256 destinations; past
// that, one three-launch pass over n_parts + 1 destination bins).
//
// The three-launch pass orders n rows stably by a digit of their key:
//   (a) radix_count:   a histogram of digits per tile of kTileRows rows;
//                      each warp aggregates equal digits with
//                      __match_any_sync, so a tile adds one shared atomic
//                      per distinct digit and warp step;
//   (b) radix_scan:    one block per digit scans that digit's tile counts
//                      in tile order (exclusive, in place) and writes the
//                      digit's total;
//   (c) radix_scatter: each tile scans the digit totals (digit-major
//                      order: digit d starts after every row of digits
//                      < d) and ranks its rows per digit in row order:
//                      each warp owns a contiguous chunk of the tile,
//                      finds the lanes that share its digit with
//                      __match_any_sync and counts the lower ones with
//                      __popc, keeps a running count per digit in shared
//                      memory, and the warps' counts are combined in warp
//                      order. A row goes to
//                          start[digit] + tile_prefix[digit][tile] + rank.
// Within a digit, earlier tiles come first and a tile keeps its rows'
// order, so the pass is stable.
//
// The one-sweep pass (Adinets & Merrill, "Onesweep: A Faster Least
// Significant Digit Radix Sort for GPUs", 2022) is one launch over eight-bit
// digits of 64-bit keys, after one count of every digit place (the caller's:
// digit counts do not depend on the rows' order). Each block takes its tile
// id from an atomic counter (so it waits only on tiles that running blocks
// hold), loads kSweepRows keys and row indices, ranks them per digit as the
// scatter above does, publishes its per-digit counts in 64-bit status words
// (flag in the top two bits, as hash_expand.cu's scan), and thread d walks
// back over earlier tiles' words for digit d, kSweepWindow tiles a step,
// until one holds an inclusive prefix (decoupled look-back), then publishes
// its own. The tile is staged in shared memory in digit order and written
// out from there, so each digit's run of the tile leaves as consecutive
// positions. Each pass reads its keys once and writes them once. On a
// 2,097,152-row page a pass takes about 32 us on an H100: tiles of 4,096
// rows beat 2,048 and 3,072 (trino_tpu_torch/tools/sort_pass_variants.py),
// and neither the look-back's window nor ranking by ballots moved it.
//
// Row indices are int32 (the wrappers raise at 2^31 rows). No library sort
// is called.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace hopper {

// Columns per perm_gather launch, and one column of it: dst[i] =
// src[perm[i]] for whole elements of 1, 2, 4 or 8 bytes, and the same for
// validity unless src_valid is null.
constexpr int kMaxPermCols = 16;

struct PermCol {
  const void* src;
  const bool* src_valid;
  void* dst;
  bool* dst_valid;
  int elem_bytes;
};

// Passed by value as a kernel parameter.
struct PermGatherSet {
  PermCol col[kMaxPermCols];
  int n;
};

namespace radix {
namespace {

constexpr int kItems = 8;                      // rows per lane per tile
constexpr int kWarpRows = 32 * kItems;         // the contiguous rows of one warp
constexpr int kTileRows = kWarps * kWarpRows;  // rows per tile (one block)
constexpr uint32_t kNoDigit = 0xffffffffu;     // lanes past the last row

inline int64_t tiles_for(int64_t n) { return (n + kTileRows - 1) / kTileRows; }

template <typename K>
__device__ __forceinline__ uint32_t digit_of(K key, int shift, uint32_t mask) {
  return static_cast<uint32_t>(key >> shift) & mask;
}

// Block-wide exclusive scan of one int32 per thread (kThreads threads);
// writes the block total to *total.
__device__ __forceinline__ int32_t block_scan_excl(int32_t v, int32_t* total) {
  __shared__ int32_t sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < kWarps) sums[lane] = w;  // inclusive warp prefixes
  }
  __syncthreads();
  const int32_t prefix = warp == 0 ? 0 : sums[warp - 1];
  *total = sums[kWarps - 1];
  __syncthreads();  // sums is reused by the next call
  return prefix + inc - v;
}

// (a) hist[d * n_tiles + tile] = rows of the tile whose digit is d.
template <int MAXB, typename K>
__global__ void __launch_bounds__(kThreads)
radix_count(const K* __restrict__ keys, int64_t n, int shift, uint32_t mask, int nb,
            int32_t* __restrict__ hist, int64_t n_tiles) {
  __shared__ int32_t h[MAXB];
  for (int b = threadIdx.x; b < nb; b += kThreads) h[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileRows + warp * kWarpRows;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = base + it * 32 + lane;
    const uint32_t d = i < n ? digit_of(keys[i], shift, mask) : kNoDigit;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d != kNoDigit && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    hist[static_cast<int64_t>(b) * n_tiles + blockIdx.x] = h[b];
  }
}

// (b) One block per digit: its row of hist becomes the exclusive scan in
// tile order, and totals[d] its sum.
__global__ void __launch_bounds__(kThreads)
radix_scan(int32_t* __restrict__ hist, int64_t n_tiles, int32_t* __restrict__ totals) {
  int32_t* row = hist + static_cast<int64_t>(blockIdx.x) * n_tiles;
  int32_t carry = 0;
  for (int64_t b0 = 0; b0 < n_tiles; b0 += kThreads) {
    const int64_t t = b0 + threadIdx.x;
    const int32_t v = t < n_tiles ? row[t] : 0;
    int32_t total;
    const int32_t ex = block_scan_excl(v, &total);
    if (t < n_tiles) row[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// (c) The stable scatter. keys_out is written only with kMoveKeys;
// idx_in null reads as the identity. Block 0 also writes each digit's
// start and total as int64 to bin_offsets / bin_counts when they are not
// null (the epilogue's offsets and counts).
template <int MAXB, typename K, bool kMoveKeys>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const K* __restrict__ keys_in, const int32_t* __restrict__ idx_in,
              K* __restrict__ keys_out, int32_t* __restrict__ idx_out, int64_t n, int shift,
              uint32_t mask, int nb, const int32_t* __restrict__ hist,
              const int32_t* __restrict__ totals, int64_t n_tiles,
              int64_t* __restrict__ bin_offsets, int64_t* __restrict__ bin_counts) {
  constexpr int kPer = (MAXB + kThreads - 1) / kThreads;  // digits per thread in the scan
  __shared__ int32_t start[MAXB];
  __shared__ int32_t warp_cnt[kWarps][MAXB];
  {
    int32_t local[kPer];
    int32_t s = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = threadIdx.x * kPer + j;
      local[j] = b < nb ? totals[b] : 0;
      s += local[j];
    }
    int32_t total;
    int32_t run = block_scan_excl(s, &total);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = threadIdx.x * kPer + j;
      if (b < nb) {
        start[b] = run;
        if (bin_offsets != nullptr && blockIdx.x == 0) {
          bin_offsets[b] = run;
          bin_counts[b] = local[j];
        }
      }
      run += local[j];
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    start[b] += hist[static_cast<int64_t>(b) * n_tiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_cnt[w][b] = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileRows + warp * kWarpRows;
  K key[kItems];
  uint32_t dig[kItems];
  int32_t rank[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = base + it * 32 + lane;
    const bool ok = i < n;
    key[it] = ok ? keys_in[i] : K(0);
    const uint32_t d = ok ? digit_of(key[it], shift, mask) : kNoDigit;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int32_t before = ok ? warp_cnt[warp][d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) warp_cnt[warp][d] = before + __popc(peers);
    __syncwarp();
    dig[it] = d;
    rank[it] = before + __popc(peers & lower);
  }
  __syncthreads();
  // each digit's count per warp becomes the rows of earlier warps
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    int32_t run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = warp_cnt[w][b];
      warp_cnt[w][b] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = base + it * 32 + lane;
    if (i < n) {
      const uint32_t d = dig[it];
      const int32_t pos = start[d] + warp_cnt[warp][d] + rank[it];
      if (kMoveKeys) keys_out[pos] = key[it];
      idx_out[pos] = idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i);
    }
  }
}

// One pass: count, scan, scatter on ``s``. hist holds nb * tiles_for(n)
// int32, totals nb int32. Returns the first launch error.
template <int MAXB, typename K, bool kMoveKeys>
cudaError_t radix_pass(const K* keys_in, const int32_t* idx_in, K* keys_out, int32_t* idx_out,
                       int64_t n, int shift, uint32_t mask, int nb, int32_t* hist,
                       int32_t* totals, int64_t* bin_offsets, int64_t* bin_counts,
                       cudaStream_t s) {
  const int64_t n_tiles = tiles_for(n);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  radix_count<MAXB, K><<<grid, kThreads, 0, s>>>(keys_in, n, shift, mask, nb, hist, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  radix_scan<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(hist, n_tiles, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  radix_scatter<MAXB, K, kMoveKeys><<<grid, kThreads, 0, s>>>(
      keys_in, idx_in, keys_out, idx_out, n, shift, mask, nb, hist, totals, n_tiles,
      bin_offsets, bin_counts);
  return cudaGetLastError();
}

// The one-sweep pass: 16 rows a thread, 4,096 a tile; the tile's keys and
// indices take 48 KB of dynamic shared memory, so two blocks fit an SM.
constexpr int kDigits = 256;
constexpr int kSweepItems = 16;
constexpr int kSweepWarpRows = 32 * kSweepItems;
constexpr int kSweepRows = kWarps * kSweepWarpRows;
constexpr int kSweepSmem = kSweepRows * (8 + 4);
constexpr int kSweepWindow = 4;  // earlier tiles a look-back step reads at once
static_assert(kThreads == kDigits, "one thread per digit in the look-back");

// Status word of a (tile, digit): flag in the top two bits, a row count
// below (< 2^31).
constexpr int kSweepFlagShift = 62;
constexpr unsigned long long kSweepAggregate = 1ull << kSweepFlagShift;  // the tile's count
constexpr unsigned long long kSweepPrefix = 2ull << kSweepFlagShift;     // inclusive prefix
constexpr unsigned long long kSweepValue = (1ull << kSweepFlagShift) - 1;

// Single 64-bit relaxed accesses at device scope: flag and count travel
// together, so no fence is needed.
__device__ __forceinline__ unsigned long long sweep_load(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void sweep_store(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// The ranking of a tile that group_sort.cu's sweep_pass and
// partition_epilogue.cu's sweep share.

// Ranks a lane's ITEMS rows within its warp by digit, in row order:
// digit(it) is row it's digit (kNoDigit for a lane past the last row), cnt
// the warp's running count of each digit in shared memory; rank[it] gets
// the warp's rows of the same digit before row it.
template <int ITEMS, typename DigitOf>
__device__ __forceinline__ void warp_rank(DigitOf digit, int32_t* cnt, int32_t (&rank)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const uint32_t d = digit(it);
    const bool ok = d != kNoDigit;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int32_t before = ok ? cnt[d] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) cnt[d] = before + __popc(peers);
    __syncwarp();
    rank[it] = before + __popc(peers & lower);
  }
}

// Thread d, after every warp ranked its rows: digit d's count in each warp
// becomes that digit's rows in earlier warps; returns the tile's count.
__device__ __forceinline__ int32_t warp_offsets(int32_t (*warp_cnt)[kDigits], int d) {
  int32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int32_t c = warp_cnt[w][d];
    warp_cnt[w][d] = count;
    count += c;
  }
  return count;
}

// One stable pass by the eight-bit digit at ``shift``. Row i's key is
// keys_in[i], or keys_in[idx_in[i]] with gather_keys (the first pass of a
// later composite, whose keys lie in row order); idx_in null reads as the
// identity. place_hist holds the digit counts of this place over all rows;
// status ([tiles][kDigits]) and *counter are zero before the launch.
__global__ void __launch_bounds__(kThreads, 2)
sweep_pass(const uint64_t* __restrict__ keys_in, const int32_t* __restrict__ idx_in,
           int gather_keys, uint64_t* __restrict__ keys_out, int32_t* __restrict__ idx_out,
           int64_t n, int shift, const int32_t* __restrict__ place_hist,
           unsigned long long* __restrict__ status, unsigned int* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(sweep_smem);
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_keys + kSweepRows);
  __shared__ int32_t warp_cnt[kWarps][kDigits];
  __shared__ int32_t s_start[kDigits];  // each digit's first staged row
  __shared__ int32_t s_base[kDigits];   // output position of staged row 0, per digit
  __shared__ unsigned int s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  for (int b = threadIdx.x; b < kWarps * kDigits; b += kThreads) (&warp_cnt[0][0])[b] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t row0 = tile * kSweepRows + warp * kSweepWarpRows;
  uint64_t key[kSweepItems];
  int32_t idx[kSweepItems];
  int32_t rank[kSweepItems];
#pragma unroll
  for (int it = 0; it < kSweepItems; ++it) {
    const int64_t i = row0 + it * 32 + lane;
    idx[it] = i < n ? (idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i)) : 0;
  }
#pragma unroll
  for (int it = 0; it < kSweepItems; ++it) {
    const int64_t i = row0 + it * 32 + lane;
    key[it] = i < n ? keys_in[gather_keys ? static_cast<int64_t>(idx[it]) : i] : 0;
  }
  warp_rank<kSweepItems>(
      [&](int it) {
        return row0 + it * 32 + lane < n ? digit_of(key[it], shift, kDigits - 1) : kNoDigit;
      },
      warp_cnt[warp], rank);
  __syncthreads();
  // thread d: digit d's rows in earlier warps, and the tile's count
  const int d = threadIdx.x;
  const int32_t count = warp_offsets(warp_cnt, d);
  unsigned long long* mine = status + tile * kDigits + d;
  sweep_store(mine, (tile == 0 ? kSweepPrefix : kSweepAggregate) |
                        static_cast<unsigned long long>(count));
  int32_t unused;
  const int32_t local = block_scan_excl(count, &unused);
  const int32_t first = block_scan_excl(place_hist[d], &unused);
  // digit d's rows in earlier tiles: the look-back reads kSweepWindow
  // earlier tiles' words at once, then adds them from the nearest back,
  // waiting on any still unpublished, until one holds a prefix
  int64_t before_tile = 0;
  for (int64_t j = tile - 1; j >= 0; j -= kSweepWindow) {
    unsigned long long w[kSweepWindow];
#pragma unroll
    for (int k = 0; k < kSweepWindow; ++k) {
      w[k] = j - k >= 0 ? sweep_load(status + (j - k) * kDigits + d) : kSweepPrefix;
    }
    bool done = false;
#pragma unroll
    for (int k = 0; k < kSweepWindow; ++k) {
      if (!done) {
        while ((w[k] >> kSweepFlagShift) == 0) w[k] = sweep_load(status + (j - k) * kDigits + d);
        before_tile += static_cast<int64_t>(w[k] & kSweepValue);
        done = (w[k] >> kSweepFlagShift) == 2;
      }
    }
    if (done) break;
  }
  if (tile > 0) {
    sweep_store(mine, kSweepPrefix | static_cast<unsigned long long>(before_tile + count));
  }
  s_start[d] = local;
  s_base[d] = first + static_cast<int32_t>(before_tile) - local;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kSweepItems; ++it) {
    if (row0 + it * 32 + lane < n) {
      const uint32_t dg = digit_of(key[it], shift, kDigits - 1);
      const int32_t p = s_start[dg] + warp_cnt[warp][dg] + rank[it];
      s_keys[p] = key[it];
      s_idx[p] = idx[it];
    }
  }
  __syncthreads();
  const int64_t left = n - tile * kSweepRows;
  const int rows = left < kSweepRows ? static_cast<int>(left) : kSweepRows;
  for (int j = threadIdx.x; j < rows; j += kThreads) {
    const uint64_t k = s_keys[j];
    const int32_t pos = s_base[digit_of(k, shift, kDigits - 1)] + j;
    keys_out[pos] = k;
    idx_out[pos] = s_idx[j];
  }
}

template <typename T>
__device__ __forceinline__ void copy_at(const void* src, void* dst, int64_t from, int64_t to) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

// dst[i] = src[perm[i]] for every column of the set (perm null: identity).
__global__ void __launch_bounds__(kThreads)
perm_gather_kernel(PermGatherSet cols, const int32_t* __restrict__ perm, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = perm != nullptr ? perm[i] : i;
    for (int k = 0; k < cols.n; ++k) {
      const PermCol& c = cols.col[k];
      switch (c.elem_bytes) {
        case 1: copy_at<uint8_t>(c.src, c.dst, r, i); break;
        case 2: copy_at<uint16_t>(c.src, c.dst, r, i); break;
        case 4: copy_at<uint32_t>(c.src, c.dst, r, i); break;
        default: copy_at<uint64_t>(c.src, c.dst, r, i); break;
      }
      if (c.src_valid != nullptr) c.dst_valid[i] = c.src_valid[r];
    }
  }
}

cudaError_t perm_gather(const PermGatherSet* sets, int n_sets, const int32_t* perm, int64_t n,
                        cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  for (int g = 0; g < n_sets && err == cudaSuccess; ++g) {
    perm_gather_kernel<<<grid_for(n), kThreads, 0, s>>>(sets[g], perm, n);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
}  // namespace radix
}  // namespace hopper
