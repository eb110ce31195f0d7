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

}  // namespace hopper
