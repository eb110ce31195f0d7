// Grouped exact int64 sums over a dense group id, for the direct-indexed
// aggregation (Q1's sums and counts).
//
// Replaces: trino_tpu/ops/pallas_kernels.py _gsum_kernel / _grouped_limb_sums,
// reached through grouped_sum_i64 and grouped_sum_i32. The TPU kernel splits
// every value into 16-bit limbs held in int32 lanes because the TPU's VPU has
// no int64; Hopper has native 64-bit integer adds and atomics, so the limb
// split is not carried over.
//
// out[g] = sum(values[i] for gid[i] == g and weight[i]) mod 2^64, for
// 1 <= num_groups <= 64. Rows whose gid lies outside [0, num_groups) are
// skipped, as the wrapper's plain version (hopper_kernels.grouped_sum_plain)
// skips them, so both devices keep one contract.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each row is read once: 8 (int64
// value) or 4 (int32 value) + 1 (weight) + 4 (gid) bytes, so 13 bytes a row
// for the i64 form; the adds are a few integer operations per row.
//
// Design against that bound: one grid-stride pass with every load coalesced,
// so each byte crosses HBM once. Sums accumulate in shared memory, one copy of
// the G accumulators per warp (Q1 has only 4 live groups, so per-warp copies
// cut the contention on each address to one warp's lanes); after the pass the
// block folds its warp copies and issues one global atomicAdd per group. Sums
// are unsigned 64-bit adds, which are associative and commutative mod 2^64,
// so the result is bit-identical whatever the order of the atomics.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kMaxGroups = 64;
using hopper::grid_for;
using hopper::kThreads;
using hopper::kWarps;

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_sum_kernel(const T* __restrict__ values, const bool* __restrict__ weight,
                   const int32_t* __restrict__ gid, int64_t n, int num_groups,
                   unsigned long long* __restrict__ out) {
  __shared__ unsigned long long acc[kWarps][kMaxGroups];
  for (int i = threadIdx.x; i < kWarps * kMaxGroups; i += kThreads) {
    (&acc[0][0])[i] = 0ull;
  }
  __syncthreads();
  unsigned long long* mine = acc[threadIdx.x / 32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const unsigned g = static_cast<unsigned>(gid[i]);
    if (weight[i] && g < static_cast<unsigned>(num_groups)) {
      // sign-extend to 64 bits, then add as unsigned (wraps mod 2^64)
      atomicAdd(&mine[g], static_cast<unsigned long long>(
                              static_cast<long long>(values[i])));
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < num_groups; g += kThreads) {
    unsigned long long s = 0ull;
    for (int w = 0; w < kWarps; ++w) s += acc[w][g];
    if (s != 0ull) atomicAdd(&out[g], s);
  }
}

template <typename T>
int launch(const void* values, const void* weight, const void* gid, int64_t n,
           int num_groups, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long) * num_groups, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_sum_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(values), static_cast<const bool*>(weight),
      static_cast<const int32_t*>(gid), n, num_groups,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grouped_sum_i64(const void* values, const void* weight, const void* gid,
                               int64_t n, int num_groups, void* out, void* stream) {
  return launch<int64_t>(values, weight, gid, n, num_groups, out, stream);
}

extern "C" int grouped_sum_i32(const void* values, const void* weight, const void* gid,
                               int64_t n, int num_groups, void* out, void* stream) {
  return launch<int32_t>(values, weight, gid, n, num_groups, out, stream);
}
