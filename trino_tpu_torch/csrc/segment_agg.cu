// The sort-path aggregation over a group-sorted page: segment_agg, the
// whole reduction stage, and segment_sum, its one-request form (an integer
// sum or a count).
//
// Replaces: trino_tpu/ops/megakernels.py _agg_phase_body + aggregate_phase
// (one Pallas launch of executor._aggregate_impl: the group boundaries, the
// key gathers at the group starts, every sum, count, min, max and
// arbitrary, the finishing of avg), and the epi_spec stage at the end of
// that body (its _partition_dest call) where every exchange key is a group
// key. The long tail of _aggregate_impl (variance finishing, covar, corr
// and regr, bitwise, distinct counts, approx_distinct, percentiles,
// min_by/max_by) runs after this kernel as the port's torch operators.
//
// segment_agg, bit-identical to hopper_kernels.segment_agg_plain (float64
// sums within rounding: they are added in another order), on n rows and
// out_cap output slots:
//   starts[g]  = the row of the (g+1)-th new_group row, n past the last
//                (kernels.boundary_positions)
//   each group's rows run from its start to the next start (n for the
//   last); rows before the first group belong to no slot
//   request r, on the rows where active & filter & valid & its predicate
//   hold ("weighted"): a wrapping int64 sum of int64, int32, int16, int8
//   or bool values or a count; a float64 sum of the values as doubles
//   (divided by a decimal scale, squared); the min or max of integer, bool
//   or float values (NaN wins, as torch's scatter_reduce); the last
//   weighted row's index (arbitrary's row). An empty group holds the
//   request's identity.
//   group_exists[g] = g < num_groups; each key at min(starts[g], n - 1),
//   its validity & group_exists; each output finished as
//   executor._eval_aggregate finishes it (validity nonempty > 0, decimal
//   avg's round-half-up division, double avg's two divisions, bool_and and
//   bool_or from their counts, arbitrary's gather); the destination of
//   each slot from its gathered keys (partition_hash.cuh), n_parts where
//   the group does not exist. The data of a slot past num_groups is left
//   to the kernel (its validity and the keys' validity are false).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each request's values and its
// weight's columns read once, new_group read once, starts written and read
// once, the keys' bytes at out_cap rows, every output written once.
//
// Design: five launches, no memset and no atomic.
// - count: one block a tile of kSegRows rows counts the tile's new_group.
// - scan: one block scans the tiles' counts into each tile's first group.
// - reduce: one block a tile (8 consecutive rows a thread) reads new_group
//   again, block-scans the head counts (each thread's first group), writes
//   starts for the tile's heads, then serves every request in turn over
//   the same tile: a segmented block scan of (has a head, the reduction
//   since the thread's last head). A group that starts and ends inside the
//   tile is stored into its slot; the rows of the tile before its first
//   head go to the tile's head partial and the rows from its last head to
//   the tile's tail partial (per request and tile).
// - span: one block a request scans the head partials over the tiles,
//   restarting after each tile with a head, so a group that spans tiles
//   (the last group of a sorted page runs over its inactive tail) reads
//   two partials however many tiles it covers.
// - finish: one thread a slot combines a tile-spanning group's tail
//   partial with the scanned head partials (in one fixed order, so a
//   float sum gives the same bits in every run), gathers the keys,
//   finishes every output and writes the destination from the keys in
//   registers. A division by a scalar (a decimal scale) is a product with
//   its reciprocal, as torch computes it on the card.
//
// segment_sum: out[g] = sum(values[i] for i in [starts[g], ends[g]] if
// weight[i]) mod 2^64 for g < out_cap, ends[g] = starts[g+1] - 1 (n - 1
// for the last slot); a padding slot (starts[g] = n) reads row n - 1, as
// the reference's clipped csum[end] - csum[start] + v[start] does. One
// memset of out, then one launch: each block takes a tile, finds the group
// of its first row by a warp search of starts and reads the starts inside
// the tile as heads; a group wholly inside the tile is stored, the tile's
// first and last groups added with one 64-bit atomicAdd each (unsigned
// adds commute, so the result is bit-identical in any order).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "agg_common.cuh"
#include "join_keys.cuh"
#include "launch.cuh"
#include "partition_hash.cuh"

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
static std::atomic<int64_t> g_stream_ops{0};

extern "C" int64_t segment_sum_stream_ops() { return g_stream_ops.load(); }

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

// --------------------------------------------------------------------------
// segment_agg
// --------------------------------------------------------------------------

namespace {

using hopper::AggCombine;
using hopper::AggOutput;
using hopper::AggOutputSet;
using hopper::AggRequest;
using hopper::AggRequestSet;
using hopper::GroupKeySet;
using namespace hopper::agg;

// Inclusive block scan of (flag, value) pairs in thread order: a flag
// restarts the reduction at its own value.
__device__ uint64_t seg_scan_op(int kind, bool flag, uint64_t v) {
  __shared__ uint64_t warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int f = flag;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t vu = __shfl_up_sync(0xffffffffu, v, o);
    const int fu = __shfl_up_sync(0xffffffffu, f, o);
    if (lane >= o) {
      if (!f) v = combine(kind, vu, v);
      f |= fu;
    }
  }
  if (lane == 31) {
    warp_v[warp] = v;
    warp_f[warp] = f;
  }
  __syncthreads();
  if (!f) {  // no flag in this warp up to this lane: the earlier warps' run
    for (int w = warp - 1; w >= 0; --w) {
      v = combine(kind, warp_v[w], v);
      if (warp_f[w]) break;
    }
  }
  __syncthreads();  // warp_v and warp_f are read before the next call writes them
  return v;
}

// Exclusive block scan of ints; *total gets the block's sum.
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

// Each tile's new_group count.
__global__ void __launch_bounds__(kThreads)
agg_count_kernel(const bool* __restrict__ new_group, int64_t n, int64_t* __restrict__ heads) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kSegRows;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    const int64_t i = t0 + threadIdx.x + j * kThreads;
    c += i < n && new_group[i];
  }
  int64_t total;
  block_exclusive(c, &total);
  if (threadIdx.x == 0) heads[blockIdx.x] = total;
}

// One block: base[t] = the heads of the tiles before t, base[n_tiles] = all.
__global__ void __launch_bounds__(kThreads)
agg_scan_kernel(const int64_t* __restrict__ heads, int64_t n_tiles, int64_t* __restrict__ base) {
  int64_t carry = 0;
  for (int64_t c0 = 0; c0 < n_tiles; c0 += kThreads * kSegItems) {
    int64_t v[kSegItems], sum = 0;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      const int64_t t = c0 + threadIdx.x * kSegItems + j;
      v[j] = t < n_tiles ? heads[t] : 0;
      sum += v[j];
    }
    int64_t total;
    int64_t run = carry + block_exclusive(sum, &total);
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      const int64_t t = c0 + threadIdx.x * kSegItems + j;
      if (t < n_tiles) base[t] = run;
      run += v[j];
    }
    carry += total;
  }
  if (threadIdx.x == 0) base[n_tiles] = carry;
}

// The reduction pass over one tile: starts of its heads, then every
// request's complete groups into res, its head and tail partials.
__global__ void __launch_bounds__(kThreads)
agg_reduce_kernel(AggRequestSet reqs, const bool* __restrict__ new_group,
                  const bool* __restrict__ active, int64_t n, int64_t out_cap, int64_t n_tiles,
                  const int64_t* __restrict__ base, int64_t* __restrict__ starts,
                  uint64_t* __restrict__ res, uint64_t* __restrict__ head,
                  uint64_t* __restrict__ tail) {
  __shared__ uint64_t incl[kThreads];
  const int64_t tile = blockIdx.x;
  const int64_t t0 = tile * kSegRows;
  const int64_t r0 = t0 + static_cast<int64_t>(threadIdx.x) * kSegItems;
  bool h[kSegItems];
  int nh = 0;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    h[j] = r0 + j < n && new_group[r0 + j];
    nh += h[j];
  }
  int64_t tile_heads;
  const int64_t excl = block_exclusive(nh, &tile_heads);
  const int64_t b = base[tile];
  const int64_t g0 = b + excl - 1;  // group of this thread's first row (-1: none yet)
  {
    int64_t g = g0;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      if (h[j] && ++g <= out_cap) starts[g] = r0 + j;
    }
  }
  for (int r = 0; r < reqs.n; ++r) {
    const AggRequest& q = reqs.req[r];
    const uint64_t ident = static_cast<uint64_t>(q.identity);
    uint64_t c[kSegItems];
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) c[j] = r0 + j < n ? contribution(q, active, r0 + j) : ident;
    // runs inside the thread: a group between two of its heads is complete
    int64_t g = g0;
    uint64_t run = ident, before = ident;
    bool seen = false;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      if (h[j]) {
        if (!seen) {
          before = run;
          seen = true;
        } else if (g < out_cap) {
          res[r * out_cap + g] = run;
        }
        ++g;
        run = ident;
      }
      run = combine(q.kind, run, c[j]);
    }
    const uint64_t inc = seg_scan_op(q.kind, seen, run);
    incl[threadIdx.x] = inc;
    __syncthreads();
    const uint64_t carry = threadIdx.x == 0 ? ident : incl[threadIdx.x - 1];
    if (seen) {
      // the group that ends at this thread's first head: complete if its
      // head lies in this tile, else the tile's head partial
      const uint64_t total = combine(q.kind, carry, before);
      if (g0 >= b) {
        if (g0 < out_cap) res[r * out_cap + g0] = total;
      } else {
        head[r * n_tiles + tile] = total;
      }
    }
    if (threadIdx.x == kThreads - 1) {
      if (tile_heads > 0) {
        tail[r * n_tiles + tile] = inc;  // from the tile's last head to its end
      } else {
        head[r * n_tiles + tile] = inc;  // the whole tile
      }
    }
    __syncthreads();  // incl is read before the next request writes it
  }
}

// One block a request: the head partials in place become, for each tile t,
// the combination of the head partials of the tiles since the last tile
// with a head before t (a segmented scan over the tiles, restarting after
// each tile with a head), so a group that runs from tile ts to tile te
// reads its tail partial and the scan at te: two loads however many tiles
// it spans.
__global__ void __launch_bounds__(kThreads)
agg_span_kernel(AggCombine reqs, const int64_t* __restrict__ base, int64_t n_tiles,
                uint64_t* __restrict__ head) {
  __shared__ uint64_t incl[kThreads];
  const int kind = reqs.kind[blockIdx.x];
  const uint64_t ident = static_cast<uint64_t>(reqs.identity[blockIdx.x]);
  uint64_t* h = head + static_cast<int64_t>(blockIdx.x) * n_tiles;
  uint64_t carry = ident;
  for (int64_t c0 = 0; c0 < n_tiles; c0 += kThreads * kSegItems) {
    uint64_t v[kSegItems];
    bool f[kSegItems];
    uint64_t run = ident;
    bool any = false;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      const int64_t t = c0 + static_cast<int64_t>(threadIdx.x) * kSegItems + j;
      v[j] = t < n_tiles ? h[t] : ident;
      // a restart: the tile before t has a head
      f[j] = t < n_tiles && t > 0 && base[t] > base[t - 1];
      if (threadIdx.x == 0 && j == 0 && !f[0]) v[0] = combine(kind, carry, v[0]);
      if (f[j]) {
        run = v[j];
        any = true;
      } else {
        run = combine(kind, run, v[j]);
      }
      v[j] = run;
      f[j] = any;  // from here on: whether a restart lies in this thread up to j
    }
    const uint64_t inc = seg_scan_op(kind, any, run);
    incl[threadIdx.x] = inc;
    __syncthreads();
    const uint64_t prefix = threadIdx.x == 0 ? ident : incl[threadIdx.x - 1];
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      const int64_t t = c0 + static_cast<int64_t>(threadIdx.x) * kSegItems + j;
      if (t < n_tiles) h[t] = f[j] ? v[j] : combine(kind, prefix, v[j]);
    }
    carry = incl[kThreads - 1];
    __syncthreads();  // incl is read before the next chunk writes it
  }
}


// One thread a slot: the group's value of every request, the keys, the
// outputs, group_exists and the destination.
__global__ void __launch_bounds__(kThreads)
agg_finish_kernel(AggCombine reqs, AggOutputSet outs, GroupKeySet keys, int64_t n,
                  int64_t out_cap, int64_t n_tiles, const int64_t* __restrict__ base,
                  const int64_t* __restrict__ num_groups, int64_t* __restrict__ starts,
                  const uint64_t* __restrict__ res, const uint64_t* __restrict__ head,
                  const uint64_t* __restrict__ tail, bool* __restrict__ group_exists,
                  int32_t* __restrict__ dest) {
  const int64_t total = base[n_tiles];
  const int64_t ng = *num_groups;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < out_cap;
       g += stride) {
    const bool exists = g < ng;
    const bool real = g < total;
    const int64_t s = real ? starts[g] : n;
    if (!real) starts[g] = n;
    const int64_t e = g + 1 < total ? starts[g + 1] : n;
    const int64_t at = s < n - 1 ? s : n - 1;
    group_exists[g] = exists;
    uint64_t acc = hopper::partition::kHashSeed;
    for (int k = 0; k < keys.n; ++k) {
      const hopper::KeyCol& c = keys.col[k];
      copy_bytes(c.data, at, keys.dst[k], g, keys.elem_bytes[k]);
      keys.dst_valid[k][g] = c.valid[at] && exists;
    }
    if (keys.n_dest > 0) {
      for (int k = 0; k < keys.n_dest; ++k) {
        const hopper::KeyCol& c = keys.col[keys.dest_key[k]];
        acc = hopper::partition::fold_key(
            acc, hopper::partition::key_bits(c, at, c.valid[at] && exists));
      }
      dest[g] = hopper::partition::dest_of(acc, exists, keys.n_parts);
    }
    // the tile of the group's start, and whether its next group starts in it
    const int64_t ts = s / kSegRows;
    const bool inside = g + 1 < total && e < (ts + 1) * kSegRows;
    const int64_t te = (e - 1) / kSegRows;
    uint64_t v[hopper::kMaxAggRequests];
    for (int r = 0; r < reqs.n; ++r) {
      if (!real) {
        v[r] = static_cast<uint64_t>(reqs.identity[r]);
      } else if (inside) {
        v[r] = res[r * out_cap + g];
      } else {
        // the tail partial of the start's tile, then the scanned head
        // partials of the tiles up to the end's
        const uint64_t x = tail[r * n_tiles + ts];
        v[r] = te > ts ? combine(reqs.kind[r], x, head[r * n_tiles + te]) : x;
      }
    }
    for (int o = 0; o < outs.n; ++o) {
      hopper::agg::finish_output(outs.out[o], v, g, n);
    }
  }
}

}  // namespace

extern "C" int segment_agg_max_requests() { return hopper::kMaxAggRequests; }

extern "C" int segment_agg_max_outputs() { return hopper::kMaxAggOutputs; }

// Kernel launches issued by segment_agg since the library was loaded.
static std::atomic<int64_t> g_agg_stream_ops{0};

extern "C" int64_t segment_agg_stream_ops() { return g_agg_stream_ops.load(); }

// The whole reduction on ``stream``. ``scratch`` (int64 [2 * n_tiles + 1])
// holds the tiles' head counts and bases; ``starts`` (int64 [out_cap + 1]);
// ``partials`` (uint64 [requests * (out_cap + 2 * n_tiles)]): the complete
// groups' values, then the head and the tail partials. Every output is
// written for all out_cap slots. Returns the first CUDA error, 0 on success.
extern "C" int segment_agg(const hopper::AggRequestSet* reqs, const hopper::AggOutputSet* outs,
                           const hopper::GroupKeySet* keys, const void* new_group,
                           const void* active, const void* num_groups, int64_t n,
                           int64_t out_cap, void* scratch, void* starts, void* partials,
                           void* group_exists, void* dest, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || out_cap <= 0) return 0;
  const int64_t n_tiles = (n + kSegRows - 1) / kSegRows;
  int64_t* heads = static_cast<int64_t*>(scratch);
  int64_t* base = heads + n_tiles;
  uint64_t* res = static_cast<uint64_t*>(partials);
  const int64_t nr = reqs->n;
  uint64_t* head = res + nr * out_cap;
  uint64_t* tail = head + nr * n_tiles;
  const bool* ng = static_cast<const bool*>(new_group);
  agg_count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(ng, n, heads);
  ++g_agg_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  agg_scan_kernel<<<1, kThreads, 0, s>>>(heads, n_tiles, base);
  ++g_agg_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  agg_reduce_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      *reqs, ng, static_cast<const bool*>(active), n, out_cap, n_tiles, base,
      static_cast<int64_t*>(starts), res, head, tail);
  ++g_agg_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  AggCombine comb{};
  comb.n = reqs->n;
  for (int r = 0; r < reqs->n; ++r) {
    comb.identity[r] = reqs->req[r].identity;
    comb.kind[r] = reqs->req[r].kind;
  }
  if (nr > 0) {
    agg_span_kernel<<<static_cast<unsigned>(nr), kThreads, 0, s>>>(comb, base, n_tiles, head);
    ++g_agg_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  agg_finish_kernel<<<hopper::grid_for(out_cap), kThreads, 0, s>>>(
      comb, *outs, *keys, n, out_cap, n_tiles, base, static_cast<const int64_t*>(num_groups),
      static_cast<int64_t*>(starts), res, head, tail, static_cast<bool*>(group_exists),
      static_cast<int32_t*>(dest));
  ++g_agg_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
