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
// together.
__device__ __forceinline__ bool weighted(const WeightSet& ws, int64_t i) {
  bool w = true;
  for (int k = 0; k < ws.n; ++k) w = w & ws.w[k][i];
  return w;
}

// Exclusive block scan of int64s; *total gets the block's sum.
__device__ int64_t block_exclusive(int64_t x, int64_t* total) {
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

// heads[tile] = the new_group rows of the tile.
__global__ void __launch_bounds__(kThreads)
tile_heads_kernel(const bool* __restrict__ new_group, int64_t n, int64_t* __restrict__ heads) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = t0 + threadIdx.x + j * kThreads;
    c += i < n && new_group[i];
  }
  int64_t total;
  block_exclusive(c, &total);
  if (threadIdx.x == 0) heads[blockIdx.x] = total;
}

// One block: base[t] = the heads of the tiles before t, base[n_tiles] = all.
__global__ void __launch_bounds__(kThreads)
tile_base_kernel(const int64_t* __restrict__ heads, int64_t n_tiles, int64_t* __restrict__ base) {
  int64_t carry = 0;
  for (int64_t c0 = 0; c0 < n_tiles; c0 += kTileRows) {
    int64_t v[kItems], sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t t = c0 + threadIdx.x * kItems + j;
      v[j] = t < n_tiles ? heads[t] : 0;
      sum += v[j];
    }
    int64_t total;
    int64_t run = carry + block_exclusive(sum, &total);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t t = c0 + threadIdx.x * kItems + j;
      if (t < n_tiles) base[t] = run;
      run += v[j];
    }
    carry += total;
  }
  if (threadIdx.x == 0) base[n_tiles] = carry;
}

// The group index of the kItems consecutive rows from r0 of tile ``tile``
// (every thread of the block calls it: a block scan).
__device__ __forceinline__ void tile_groups(const bool* __restrict__ new_group, int64_t n,
                                            int64_t r0, const int64_t* __restrict__ base,
                                            int64_t tile, int64_t (&gid)[kItems]) {
  bool h[kItems];
  int nh = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    h[j] = r0 + j < n && new_group[r0 + j];
    nh += h[j];
  }
  int64_t unused;
  int64_t g = base[tile] + block_exclusive(nh, &unused) - 1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    g += h[j];
    gid[j] = g < 0 ? 0 : g;
  }
}

// tile_heads_kernel then tile_base_kernel on ``s``: scratch holds n_tiles
// head counts, then the n_tiles + 1 bases, which it returns.
inline int64_t* tile_bases(const bool* new_group, int64_t n, int64_t* scratch, cudaStream_t s,
                           cudaError_t* err) {
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  int64_t* base = scratch + n_tiles;
  tile_heads_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(new_group, n, scratch);
  *err = cudaGetLastError();
  if (*err != cudaSuccess) return base;
  tile_base_kernel<<<1, kThreads, 0, s>>>(scratch, n_tiles, base);
  *err = cudaGetLastError();
  return base;
}

}  // namespace
}  // namespace rows
}  // namespace hopper
