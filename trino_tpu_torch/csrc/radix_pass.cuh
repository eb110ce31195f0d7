// One stable counting pass of an LSD radix sort over a row-index
// permutation, and the gather of columns by a permutation: shared by
// group_sort.cu (eight-bit digits of packed 64-bit sort keys) and
// partition_epilogue.cu (one pass over n_parts + 1 destination bins).
//
// A pass orders n rows stably by a digit of their key, in three launches:
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
// order, so the pass is stable. Row indices are int32 (the wrappers raise
// at 2^31 rows). No library sort is called.

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
