// Row-level pieces of the re-sorting aggregates' kernels (segment_sort.cu,
// hll.cu): a row's weight as the AND of up to kMaxWeights bool columns
// (the page's activity, the argument's validity, an aggregate's FILTER and
// its validity), and each row's group index max(cumsum(new_group) - 1, 0)
// from per-tile head counts and their scan, as segment_agg.cu's count and
// scan passes find each tile's first group.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace hopper {

constexpr int kMaxWeights = 6;

// Passed by value as a kernel parameter.
struct WeightSet {
  const bool* w[kMaxWeights];
  int n;
};

namespace rows {
namespace {

constexpr int kItems = 8;                    // consecutive rows a thread
constexpr int kTileRows = kThreads * kItems;  // rows a tile (one block)

// Every column is read whatever the others hold, so the loads go out
// together; the columns are indexed by constants (a kernel parameter
// indexed at run time would be copied to the stack).
__device__ __forceinline__ bool weighted(const WeightSet& ws, int64_t i) {
  bool w = true;
#pragma unroll
  for (int k = 0; k < kMaxWeights; ++k) {
    if (k < ws.n) w = w & ws.w[k][i];
  }
  return w;
}

// Exclusive block scan of int64s; *total gets the block's sum. Inlined: a
// call would keep the caller's live registers on the stack across it.
__device__ __forceinline__ int64_t block_exclusive(int64_t x, int64_t* total) {
  __shared__ int64_t warp_s[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_s[warp] = inc;
  __syncthreads();
  int64_t before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_s[w];
    all += warp_s[w];
  }
  __syncthreads();  // warp_s is read before the next call writes it
  *total = all;
  return before + inc - x;
}


// The tile bases in two passes of one block a chunk of kChunkTiles tiles:
// each chunk's heads summed, then each chunk's tiles scanned after the
// sum of the chunks before it (a block adds up at most a few hundred
// sums), so no pass waits on one SM.
constexpr int kChunkTiles = kThreads * kItems;

inline int64_t chunks_of(int64_t n_tiles) { return (n_tiles + kChunkTiles - 1) / kChunkTiles; }

// sums[c] = the heads of chunk c's tiles.
__global__ void __launch_bounds__(kThreads)
chunk_sum_kernel(const int64_t* __restrict__ heads, int64_t n_tiles, int64_t* __restrict__ sums) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChunkTiles;
  int64_t sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t t = c0 + j * kThreads + threadIdx.x;
    sum += t < n_tiles ? heads[t] : 0;
  }
  int64_t total;
  block_exclusive(sum, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// base[t] = the heads of the tiles before t, for chunk blockIdx.x's tiles;
// the last chunk's block writes base[n_tiles] = all.
__global__ void __launch_bounds__(kThreads)
tile_base_kernel(const int64_t* __restrict__ heads, int64_t n_tiles,
                 const int64_t* __restrict__ sums, int64_t* __restrict__ base) {
  int64_t before = 0;
  for (int64_t c = threadIdx.x; c < blockIdx.x; c += kThreads) before += sums[c];
  int64_t carry;
  block_exclusive(before, &carry);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kChunkTiles + threadIdx.x * kItems;
  int64_t v[kItems], sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    v[j] = t0 + j < n_tiles ? heads[t0 + j] : 0;
    sum += v[j];
  }
  int64_t total;
  int64_t run = carry + block_exclusive(sum, &total);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (t0 + j < n_tiles) base[t0 + j] = run;
    run += v[j];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) base[n_tiles] = carry + total;
}

// chunk_sum_kernel then tile_base_kernel on ``s``: base (n_tiles + 1) from
// heads (n_tiles), sums (chunks_of(n_tiles)) the passes' own.
inline void scan_bases(const int64_t* heads, int64_t n_tiles, int64_t* base, int64_t* sums,
                       cudaStream_t s, cudaError_t* err) {
  const unsigned chunks = static_cast<unsigned>(chunks_of(n_tiles));
  chunk_sum_kernel<<<chunks, kThreads, 0, s>>>(heads, n_tiles, sums);
  *err = cudaGetLastError();
  if (*err != cudaSuccess) return;
  tile_base_kernel<<<chunks, kThreads, 0, s>>>(heads, n_tiles, sums, base);
  *err = cudaGetLastError();
}

// The kItems consecutive bools from p + r0 (r0 a multiple of kItems) as
// bits, bit j for row r0 + j, 0 past n: one 8-byte load where the column
// is 8-byte aligned and the rows are all below n (a bool is 0 or 1).
__device__ __forceinline__ unsigned flag_bits(const bool* __restrict__ p, int64_t n, int64_t r0) {
  unsigned bits = 0;
  if (r0 + kItems <= n && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + r0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits |= ((v.x >> (8 * j)) & 1u) << j;
      bits |= ((v.y >> (8 * j)) & 1u) << (j + 4);
    }
    return bits;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) bits |= (r0 + j < n && p[r0 + j] ? 1u : 0u) << j;
  return bits;
}

// heads[tile] = the new_group rows of the tile.
__global__ void __launch_bounds__(kThreads)
tile_heads_kernel(const bool* __restrict__ new_group, int64_t n, int64_t* __restrict__ heads) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileRows + threadIdx.x * kItems;
  int64_t total;
  block_exclusive(__popc(flag_bits(new_group, n, r0)), &total);
  if (threadIdx.x == 0) heads[blockIdx.x] = total;
}

// The group index of the kItems consecutive rows of a tile whose heads are
// ``heads`` (bit j: new_group of the thread's row j) and whose base is
// ``tile_base`` (every thread of the block calls it: a block scan). G may
// be int where the page has fewer than 2^31 rows.
template <typename G>
__device__ __forceinline__ void tile_groups(unsigned heads, int64_t tile_base,
                                               G (&gid)[kItems]) {
  int64_t unused;
  G g = static_cast<G>(tile_base + block_exclusive(__popc(heads), &unused) - 1);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    g += (heads >> j) & 1u;
    gid[j] = g < 0 ? 0 : g;
  }
}

// Words of a tile_bases scratch over n_tiles tiles: the head counts, the
// n_tiles + 1 bases, the chunk sums.
inline int64_t bases_scratch_words(int64_t n_tiles) { return 2 * n_tiles + 1 + chunks_of(n_tiles); }

// tile_heads_kernel then scan_bases on ``s`` (three launches): scratch
// (bases_scratch_words) holds n_tiles head counts, then the n_tiles + 1
// bases, which it returns, then the chunk sums.
inline int64_t* tile_bases(const bool* new_group, int64_t n, int64_t* scratch, cudaStream_t s,
                           cudaError_t* err) {
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  int64_t* base = scratch + n_tiles;
  tile_heads_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(new_group, n, scratch);
  *err = cudaGetLastError();
  if (*err != cudaSuccess) return base;
  scan_bases(scratch, n_tiles, base, base + n_tiles + 1, s, err);
  return base;
}

}  // namespace
}  // namespace rows
}  // namespace hopper
