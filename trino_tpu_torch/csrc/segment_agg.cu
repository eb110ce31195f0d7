// Segment sums over a group-sorted page: the sort-path aggregation's
// integer sums and counts.
//
// Replaces: the reductions of trino_tpu/ops/megakernels.py _agg_phase_body
// + aggregate_phase, which run executor._aggregate_impl's reduce_fn
// (kernels.segment_reduce's cumsum-at-boundaries form) inside one Pallas
// launch. The key gathers and the finalization of that body run after this
// kernel as the port's torch operators.
//
// out[g] = sum(values[i] for i in [starts[g], ends[g]] if weight[i]) mod 2^64
// for g < out_cap, where the rows are sorted by group, starts holds each
// group's first row ascending (padded with n past the last group) and
// ends[g] = starts[g+1] - 1 (n - 1 for the last slot). Values are int64,
// int32 (sign-extended) or bool (as 0/1, which makes the sum a count). A
// padding slot (starts[g] = n) reads row n - 1, as the reference's clipped
// csum[end] - csum[start] + v[start] does; its output row is inactive.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each row reads its value and its
// weight once (9 bytes for int64); each group reads its start and writes
// 8 bytes.
//
// Design: rows, not segments, are spread over the threads, so one long
// segment costs what many short ones do. Each thread finds its row's group
// by a binary search of starts (which L2 holds at the sizes the engine
// produces); a warp's 32 consecutive rows cover nondecreasing groups, so a
// segmented shuffle scan sums each run of equal groups and the run's last
// lane adds it to the output with one 64-bit atomicAdd. Unsigned adds mod
// 2^64 commute, so the result is bit-identical to the plain cumsum form in
// any order of the atomics.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

using hopper::grid_for;
using hopper::kThreads;

enum ValueType : int { kI64 = 0, kI32 = 1, kBool = 2 };

__device__ __forceinline__ unsigned long long weighted(const void* values, int type,
                                                       const bool* weight, int64_t i) {
  if (!weight[i]) return 0ull;
  switch (type) {
    case kI64:
      return static_cast<unsigned long long>(static_cast<const int64_t*>(values)[i]);
    case kI32:
      return static_cast<unsigned long long>(
          static_cast<long long>(static_cast<const int32_t*>(values)[i]));
    default:
      return static_cast<const uint8_t*>(values)[i] ? 1ull : 0ull;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const void* __restrict__ values, int type, const bool* __restrict__ weight,
                   const int64_t* __restrict__ starts, int64_t n, int64_t out_cap,
                   unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  // every lane of a warp runs the same iterations, so the shuffles see all 32
  for (int64_t base = warp * 32; base < n; base += n_warps * 32) {
    const int64_t i = base + lane;
    unsigned long long v = 0ull;
    int64_t g = -1;
    if (i < n) {
      v = weighted(values, type, weight, i);
      int64_t lo = 0, hi = out_cap;  // the first slot with starts > i
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (starts[mid] <= i) lo = mid + 1; else hi = mid;
      }
      g = lo - 1;  // -1: a row before the first group, in no group
    }
    const int64_t g_prev = __shfl_up_sync(0xffffffffu, g, 1);
    const int64_t g_next = __shfl_down_sync(0xffffffffu, g, 1);
    int head = lane == 0 || g != g_prev;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long t = __shfl_up_sync(0xffffffffu, v, o);
      const int th = __shfl_up_sync(0xffffffffu, head, o);
      if (lane >= o && !head) {
        v += t;
        head = th;
      }
    }
    const bool tail = lane == 31 || g != g_next;
    if (tail && g >= 0 && v != 0ull) atomicAdd(&out[g], v);
  }
}

// Padding slots (starts[g] >= n) read row n - 1, as the clipped cumsum form.
__global__ void __launch_bounds__(kThreads)
padding_kernel(const void* __restrict__ values, int type, const bool* __restrict__ weight,
               const int64_t* __restrict__ starts, int64_t n, int64_t out_cap,
               unsigned long long* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < out_cap;
       g += stride) {
    if (starts[g] >= n) out[g] = weighted(values, type, weight, n - 1);
  }
}

}  // namespace

// out (int64 [out_cap]) is zeroed and written on ``stream``; returns the
// first CUDA error, 0 on success.
extern "C" int segment_sum(const void* values, int type, const void* weight,
                           const void* starts, int64_t n, int64_t out_cap, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long) * out_cap, s);
  if (err != cudaSuccess || n <= 0 || out_cap <= 0) return static_cast<int>(err);
  const bool* w = static_cast<const bool*>(weight);
  const int64_t* st = static_cast<const int64_t*>(starts);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  segment_sum_kernel<<<grid_for(n), kThreads, 0, s>>>(values, type, w, st, n, out_cap, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  padding_kernel<<<grid_for(out_cap), kThreads, 0, s>>>(values, type, w, st, n, out_cap, o);
  return static_cast<int>(cudaGetLastError());
}
