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
// Design: one memset of out, then one launch; no row searches starts.
// Each block takes a tile of kSegRows rows, eight consecutive rows a
// thread. One warp finds the group of the tile's first row by one search
// of starts (rounds of 32 probes, so about four L2 round trips at the
// engine's sizes) while a second finds the first padding slot; the block
// then reads the starts that fall inside the tile (a contiguous run of
// slots after the first group, 1,024 a round) and marks them as heads in
// shared memory.
// A block scan of the heads gives each thread its first row's group, and
// a segmented block scan of (has a head, sum since its last head) gives
// the sum carried into each thread. A group wholly inside the tile is
// written with a plain store by the thread that holds its end; only the
// tile's first and last groups, which may span tiles, are added with one
// 64-bit atomicAdd each. The padding slots are filled by every block, a
// stripe each. Unsigned adds mod 2^64 commute, so the result is
// bit-identical to the plain cumsum form in any order of the atomics.
// Rows before the first group belong to no slot.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

using hopper::kThreads;
using hopper::kWarps;

constexpr int kSegItems = 8;                     // consecutive rows a thread
constexpr int kSegRows = kThreads * kSegItems;   // rows a tile
constexpr int kHeadReads = 4;                    // starts a thread reads at once

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

// The slots g < cap with starts[g] <= x (starts ascending), found by one
// warp: each round the 32 lanes probe evenly spaced slots of the interval
// that holds the answer, which shrinks it 32-fold. Every lane gets it.
__device__ int64_t count_le(const int64_t* __restrict__ starts, int64_t cap, int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = cap;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * step - 1;
    const bool le = p < hi && starts[p] <= x;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    const int64_t top = lo + (c + 1) * step - 1;
    lo += c * step;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// Inclusive block scan of (flag, value) pairs in thread order under the
// segmented sum: a flag restarts the sum at its own value. Returns the
// thread's inclusive value.
__device__ unsigned long long seg_scan(bool flag, unsigned long long v) {
  __shared__ unsigned long long warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int f = flag;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long vu = __shfl_up_sync(0xffffffffu, v, o);
    const int fu = __shfl_up_sync(0xffffffffu, f, o);
    if (lane >= o) {
      if (!f) v += vu;
      f |= fu;
    }
  }
  if (lane == 31) {
    warp_v[warp] = v;
    warp_f[warp] = f;
  }
  __syncthreads();
  if (!f) {  // no flag in this warp up to this lane: add the earlier warps' run
    for (int w = warp - 1; w >= 0; --w) {
      v += warp_v[w];
      if (warp_f[w]) break;
    }
  }
  __syncthreads();  // warp_v and warp_f are read before the next call writes them
  return v;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const void* __restrict__ values, int type, const bool* __restrict__ weight,
                   const int64_t* __restrict__ starts, int64_t n, int64_t out_cap,
                   unsigned long long* __restrict__ out) {
  __shared__ int32_t heads[kSegRows];  // slots starting at each row of the tile after its first
  __shared__ unsigned long long incl[kThreads];
  __shared__ int64_t s_first;          // group of the tile's first row (-1: none)
  __shared__ int64_t s_pad;            // the first padding slot
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kSegRows;
  const int64_t left = n - t0;
  const int rows = left < kSegRows ? static_cast<int>(left) : kSegRows;
  for (int b = threadIdx.x; b < kSegRows; b += kThreads) heads[b] = 0;
  if (warp == 0) {
    const int64_t g = count_le(starts, out_cap, t0);
    if (lane == 0) s_first = g - 1;
  } else if (warp == 1) {
    const int64_t g = count_le(starts, out_cap, n - 1);
    if (lane == 0) s_pad = g;
  }
  const int r0 = threadIdx.x * kSegItems;
  unsigned long long v[kSegItems];
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    v[j] = r0 + j < rows ? weighted(values, type, weight, t0 + r0 + j) : 0ull;
  }
  __syncthreads();
  const int64_t first = s_first;
  // the slots after the first group that start inside the tile, as heads
  // (st > t0 from slot first + 1 on), kHeadReads a thread at a time; the
  // loop goes on while the round's last slot still starts inside
  for (int64_t g0 = first + 1;; g0 += kThreads * kHeadReads) {
    int64_t st[kHeadReads];
#pragma unroll
    for (int r = 0; r < kHeadReads; ++r) {
      const int64_t g = g0 + r * kThreads + threadIdx.x;
      st[r] = g < out_cap ? starts[g] : n;
    }
#pragma unroll
    for (int r = 0; r < kHeadReads; ++r) {
      if (st[r] < t0 + rows) atomicAdd(&heads[st[r] - t0], 1);
    }
    const bool more = threadIdx.x == kThreads - 1 && st[kHeadReads - 1] < t0 + rows;
    if (!__syncthreads_or(more)) break;
  }
  // the padding slots read row n - 1, as the clipped cumsum form does
  const int64_t pad = s_pad;
  if (pad < out_cap) {
    const unsigned long long last = weighted(values, type, weight, n - 1);
    for (int64_t g = pad + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         g < out_cap; g += static_cast<int64_t>(gridDim.x) * kThreads) {
      out[g] = last;
    }
  }
  int h[kSegItems];
  int n_heads = 0;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    h[j] = heads[r0 + j];
    n_heads += h[j];
  }
  // group of this thread's first row
  const int64_t g0 =
      first + static_cast<int64_t>(seg_scan(false, static_cast<unsigned long long>(n_heads))) -
      n_heads;
  // runs inside the thread: complete groups are stored
  int64_t g = g0;
  unsigned long long run = 0ull, before_head = 0ull;
  bool seen = false;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    if (h[j] != 0) {
      if (!seen) {
        before_head = run;
        seen = true;
      } else if (run != 0ull) {
        out[g] = run;
      }
      g += h[j];
      run = 0ull;
    }
    run += v[j];
  }
  // the sum carried in: the run that reaches this thread's first row (each
  // thread contributes its rows since its last head, or all its rows)
  incl[threadIdx.x] = seg_scan(seen, run);
  __syncthreads();
  const unsigned long long carry = threadIdx.x == 0 ? 0ull : incl[threadIdx.x - 1];
  if (seen && g0 >= 0) {
    // the run that ends before this thread's first head: the tile's first
    // group (which may begin in an earlier tile) is added, any other stored
    const unsigned long long total = carry + before_head;
    if (total != 0ull) {
      if (g0 == first) {
        atomicAdd(&out[g0], total);
      } else {
        out[g0] = total;
      }
    }
  }
  if (threadIdx.x == kThreads - 1) {
    // the tile's last group, which may run into the next tile
    const unsigned long long total = seen ? run : carry + run;
    if (g >= 0 && total != 0ull) atomicAdd(&out[g], total);
  }
}

}  // namespace

extern "C" int segment_sum_tile_rows() { return kSegRows; }

// Kernel launches and memsets issued by segment_sum since the library was
// loaded (chip_smoke.py reads the difference over one call).
static int64_t g_stream_ops = 0;

extern "C" int64_t segment_sum_stream_ops() { return g_stream_ops; }

// out (int64 [out_cap]) is zeroed and written on ``stream``; returns the
// first CUDA error, 0 on success.
extern "C" int segment_sum(const void* values, int type, const void* weight,
                           const void* starts, int64_t n, int64_t out_cap, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long) * out_cap, s);
  ++g_stream_ops;
  if (err != cudaSuccess || n <= 0 || out_cap <= 0) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((n + kSegRows - 1) / kSegRows);
  segment_sum_kernel<<<tiles, kThreads, 0, s>>>(
      values, type, static_cast<const bool*>(weight), static_cast<const int64_t*>(starts), n,
      out_cap, static_cast<unsigned long long*>(out));
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
