// Fused TPC-H Q6: the predicate, then the exact sum of price * discount.
//
// Replaces: trino_tpu/ops/pallas_kernels.py _q6_kernel / q6_fused. The TPU
// kernel multiplies in int32 and sums the products as two 16-bit limb lanes,
// exact only while each product stays below 2^31; here every product is
// formed in int64, as the reference's plain formulation q6_reference does,
// and the sum is an int64 sum (mod 2^64).
//
// keep = shipdate >= lo_date && shipdate < hi_date && discount >= lo_disc &&
//        discount <= hi_disc && quantity < hi_qty && mask != 0
// out  = sum(keep ? (int64)price * (int64)discount : 0)
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Five int32 columns are read once,
// 20 bytes a row; the predicate and the product are a handful of integer
// operations per row.
//
// Design against that bound: one grid-stride pass with coalesced loads, the
// running sum in a register, a warp-shuffle reduce, a block reduce through
// shared memory, and one 64-bit atomicAdd per block into a zeroed output.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

using hopper::grid_for;
using hopper::kThreads;
using hopper::kWarps;

__global__ void __launch_bounds__(kThreads)
q6_kernel(const int32_t* __restrict__ shipdate, const int32_t* __restrict__ discount,
          const int32_t* __restrict__ quantity, const int32_t* __restrict__ price,
          const int32_t* __restrict__ mask, int64_t n, int lo_date, int hi_date,
          int lo_disc, int hi_disc, int hi_qty, unsigned long long* __restrict__ out) {
  unsigned long long acc = 0ull;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int32_t sd = shipdate[i];
    const int32_t disc = discount[i];
    const bool keep = sd >= lo_date && sd < hi_date && disc >= lo_disc &&
                      disc <= hi_disc && quantity[i] < hi_qty && mask[i] != 0;
    if (keep) {
      acc += static_cast<unsigned long long>(static_cast<long long>(price[i]) *
                                             static_cast<long long>(disc));
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ unsigned long long partial[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? partial[lane] : 0ull;
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0 && acc != 0ull) atomicAdd(out, acc);
  }
}

}  // namespace

extern "C" int q6_fused(const void* shipdate, const void* discount, const void* quantity,
                        const void* price, const void* mask, int64_t n, int lo_date,
                        int hi_date, int lo_disc, int hi_disc, int hi_qty, void* out,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  q6_kernel<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(shipdate), static_cast<const int32_t*>(discount),
      static_cast<const int32_t*>(quantity), static_cast<const int32_t*>(price),
      static_cast<const int32_t*>(mask), n, lo_date, hi_date, lo_disc, hi_disc, hi_qty,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
