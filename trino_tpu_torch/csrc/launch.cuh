// Launch-grid policy shared by the port's Hopper kernels: 256-thread blocks
// over a grid-stride loop, at most as many blocks as fill every SM.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hopper {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// SMs of the current device (read once).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks for a grid-stride pass over n rows: one per 256 rows, capped at 8
// per SM (8 blocks of 256 threads fill an SM's 2048 thread slots).
inline int grid_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// Blocks of ``kernel`` (kThreads threads, no dynamic shared memory) that
// one SM holds at once, as its registers allow.
inline int blocks_per_sm(const void* kernel) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return blocks > 0 ? blocks : 1;
}

// grid_for(n) capped at ``per_sm`` blocks an SM: a grid-stride pass whose
// blocks all fit the card at once, so none runs in a second, thinner wave.
inline int resident_grid(int64_t n, int per_sm) {
  const int cap = sm_count() * per_sm;
  return grid_for(n) < cap ? grid_for(n) : cap;
}

}  // namespace hopper
