// The re-sort of a group-sorted page's rows by value within each group:
// segment_sort.
//
// Replaces: the cosorts of trino_tpu/runtime/executor.py _aggregate_impl
// (distinct_count_fn, percentile_fn, tdigest_fn), which run inside
// trino_tpu/ops/megakernels.py aggregate_phase's Pallas launch. Each sorts
// the rows stably by (gid, [~weight], order_key(value)), gid =
// max(cumsum(new_group) - 1, 0): rows before the first group belong to
// group 0, the inactive tail to the last group, and since gid never
// decreases each group's rows keep their positions (its start does not
// move). The weight key (participants first) is the percentile's and the
// digest's; the exact distinct count sorts by value alone and reads the run
// heads: the first row of each (gid, order key) run, whatever the weight of
// its neighbour.
//
// Bit-identical to the plain version (hopper_kernels.segment_sort_plain):
// the permutation is the unique stable sort by that lexicographic key.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. new_group, the values and the
// weight columns read once; the sorted values, weight and run heads
// written once. An LSD sort adds its passes' own traffic: each pass reads
// and writes an 8-byte key and a 4-byte row index.
//
// Design, three entry points around group_sort.cu's one-sweep passes (the
// wrapper calls them in turn, as group_sort's):
//   1. segment_sort_stats: over tiles of kTileRows rows, each tile's head
//      count, and the least and largest order key and the weighted rows
//      over all rows; one block scans the head counts into each tile's
//      first group (the group count last). The wrapper reads the stats (one
//      host sync) and packs the key into 64-bit composites, least
//      significant first and no field split (hopper_kernels
//      .segment_sort_plan): (value - least) in bit_length(largest - least)
//      bits, ~weight in one bit where the weight sorts and is not constant,
//      the group index in bit_length(groups - 1) bits; a field that is the
//      same on every row is left out.
//   2. segment_sort_compose: one memset zeroes the passes' digit counts,
//      look-back words and tile counters; one block a tile block-scans its
//      new_group rows from the tile's first group into each row's group
//      index, writes every composite of each row in row order and counts
//      its digits at every place (shared atomics, each block's counts added
//      once into HBM).
//   3. group_sort_passes (group_sort.cu, radix_pass.cuh's one-sweep pass):
//      ceil(bits / 8) passes per composite, least significant first.
//   4. segment_sort_finish: one thread a sorted row gathers the value and
//      the weight at its source row and marks a run head where its order
//      key differs from the row before it (shared memory holds the block's
//      keys, and the one before them) or its group does: the group index is
//      the last field of the last composite, read from the sorted keys.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "agg_common.cuh"
#include "launch.cuh"
#include "radix_pass.cuh"
#include "segment_rows.cuh"

namespace {

using hopper::Composite;
using hopper::kThreads;
using hopper::kWarps;
using hopper::WeightSet;
using hopper::radix::kDigits;
using hopper::rows::kItems;
using hopper::rows::kTileRows;

// The kinds of a segment_sort field (hopper_kernels._SORT_FIELDS).
enum SortField : int { kValue = 0, kUnweighted = 1, kGroup = 2 };

constexpr int kDigitBits = 8;
constexpr int kMaxPlaces = 64 / kDigitBits;
// value, ~weight and group: at most three composites
constexpr int kMaxComps = 3;

std::atomic<int64_t> g_stream_ops{0};

__device__ __forceinline__ int64_t okey(int type, const void* values, int64_t i) {
  return hopper::agg::order_key(type, values, i);
}

__global__ void sort_stats_init_kernel(int64_t* stats) {
  stats[0] = INT64_MAX;
  stats[1] = INT64_MIN;
  stats[2] = 0;
  stats[3] = 0;
}

// One block a tile: heads[tile], and the tile's least and largest order
// key and weighted rows folded into stats with one atomic each.
__global__ void __launch_bounds__(kThreads)
sort_stats_kernel(const bool* __restrict__ new_group, const void* __restrict__ values, int type,
                  WeightSet ws, int64_t n, int64_t* __restrict__ heads,
                  int64_t* __restrict__ stats) {
  __shared__ int64_t part[3][kWarps];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  int64_t lo = INT64_MAX, hi = INT64_MIN, nw = 0, nh = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = t0 + threadIdx.x + j * kThreads;
    if (i < n) {
      const int64_t k = okey(type, values, i);
      lo = k < lo ? k : lo;
      hi = k > hi ? k : hi;
      nw += hopper::rows::weighted(ws, i);
      nh += new_group[i];
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t l = __shfl_down_sync(0xffffffffu, lo, o);
    const int64_t h = __shfl_down_sync(0xffffffffu, hi, o);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
    nw += __shfl_down_sync(0xffffffffu, nw, o);
    nh += __shfl_down_sync(0xffffffffu, nh, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ int64_t part_h[kWarps];
  if (lane == 0) {
    part[0][warp] = lo;
    part[1][warp] = hi;
    part[2][warp] = nw;
    part_h[warp] = nh;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo = part[0][w] < lo ? part[0][w] : lo;
      hi = part[1][w] > hi ? part[1][w] : hi;
      nw += part[2][w];
      nh += part_h[w];
    }
    heads[blockIdx.x] = nh;
    atomicMin(reinterpret_cast<long long*>(stats), static_cast<long long>(lo));
    atomicMax(reinterpret_cast<long long*>(stats + 1), static_cast<long long>(hi));
    if (nw) atomicAdd(reinterpret_cast<unsigned long long*>(stats + 2),
                      static_cast<unsigned long long>(nw));
  }
}

__global__ void sort_groups_kernel(const int64_t* __restrict__ base, int64_t n_tiles,
                                   int64_t* __restrict__ stats) {
  stats[3] = base[n_tiles];
}

// Plans are passed by value.
struct CompSet {
  Composite comp[kMaxComps];
  int n;
};

__host__ __device__ int places_of(const Composite& c) {
  return (c.bits + kDigitBits - 1) / kDigitBits;
}

// One block a tile: each row's group index, then every composite of the
// row into keys + c * n, its digits counted into hist ([place][kDigits],
// the places of all composites in order).
__global__ void __launch_bounds__(kThreads)
sort_compose_kernel(const bool* __restrict__ new_group, const void* __restrict__ values,
                    int type, WeightSet ws, int64_t n, const int64_t* __restrict__ base,
                    CompSet cs, uint64_t* __restrict__ keys, int32_t* __restrict__ hist) {
  __shared__ int32_t h[kMaxComps * kMaxPlaces][kDigits];
  int places = 0;
  for (int c = 0; c < cs.n; ++c) places += places_of(cs.comp[c]);
  for (int b = threadIdx.x; b < places * kDigits; b += kThreads) (&h[0][0])[b] = 0;
  const int64_t tile = blockIdx.x;
  const int64_t r0 = tile * kTileRows + static_cast<int64_t>(threadIdx.x) * kItems;
  int64_t gid[kItems];
  hopper::rows::tile_groups(new_group, n, r0, base, tile, gid);  // syncs the block
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = r0 + j;
    if (i >= n) break;
    const int64_t k = okey(type, values, i);
    const bool w = hopper::rows::weighted(ws, i);
    int place0 = 0;
    for (int c = 0; c < cs.n; ++c) {
      const Composite& cp = cs.comp[c];
      uint64_t v = 0;
      for (int f = 0; f < cp.n_fields; ++f) {
        const hopper::Field& fd = cp.field[f];
        uint64_t x;
        if (fd.kind == kValue) {
          x = static_cast<uint64_t>(k) - static_cast<uint64_t>(fd.offset);
        } else if (fd.kind == kUnweighted) {
          x = w ? 0 : 1;
        } else {
          x = static_cast<uint64_t>(gid[j]);
        }
        v |= x << fd.pos;
      }
      keys[c * n + i] = v;
      for (int p = 0; p < places_of(cp); ++p) {
        atomicAdd(&h[place0 + p][static_cast<uint32_t>(v >> (kDigitBits * p)) & (kDigits - 1)],
                  1);
      }
      place0 += places_of(cp);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < places * kDigits; b += kThreads) {
    const int32_t x = (&h[0][0])[b];
    if (x != 0) atomicAdd(hist + b, x);
  }
}

// One thread a sorted row i (blocks of kThreads consecutive rows): the
// value and weight of source row perm[i] (the identity without perm), and
// whether i heads a (group, order key) run.
__global__ void __launch_bounds__(kThreads)
sort_finish_kernel(const void* __restrict__ values, int type, int elem_bytes, WeightSet ws,
                   int64_t n, const int32_t* __restrict__ perm,
                   const uint64_t* __restrict__ sorted_last, int group_pos,
                   void* __restrict__ out_values, bool* __restrict__ out_weight,
                   bool* __restrict__ heads) {
  __shared__ int64_t key[kThreads + 1];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) {
    const int64_t r = perm != nullptr ? perm[i] : i;
    key[threadIdx.x + 1] = okey(type, values, r);
    hopper::agg::copy_bytes(values, r, out_values, i, elem_bytes);
    out_weight[i] = hopper::rows::weighted(ws, r);
    if (threadIdx.x == 0 && i > 0) {
      key[0] = okey(type, values, perm != nullptr ? perm[i - 1] : i - 1);
    }
  }
  __syncthreads();
  if (i < n) {
    bool head = i == 0 || key[threadIdx.x + 1] != key[threadIdx.x];
    if (!head && group_pos >= 0) {
      head = (sorted_last[i] >> group_pos) != (sorted_last[i - 1] >> group_pos);
    }
    heads[i] = head;
  }
}

}  // namespace

extern "C" int segment_sort_max_weights() { return hopper::kMaxWeights; }
extern "C" int segment_sort_tile_rows() { return kTileRows; }
extern "C" int segment_sort_max_composites() { return kMaxComps; }
extern "C" int64_t segment_sort_stream_ops() { return g_stream_ops.load(); }

// stats (int64 [4]): the least and largest order key of the values and the
// weighted rows over all n rows, and the group count; scratch (int64
// [2 * n_tiles + 1], n_tiles = ceil(n / kTileRows)) gets the tiles' head
// counts and each tile's first group, which segment_sort_compose reads.
extern "C" int segment_sort_stats(const void* new_group, const void* values, int type,
                                  const WeightSet* ws, int64_t n, void* scratch, void* stats,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* st = static_cast<int64_t*>(stats);
  sort_stats_init_kernel<<<1, 1, 0, s>>>(st);
  ++g_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  int64_t* heads = static_cast<int64_t*>(scratch);
  sort_stats_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const bool*>(new_group), values, type, *ws, n, heads, st);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int64_t* base = heads + n_tiles;
  hopper::rows::tile_base_kernel<<<1, kThreads, 0, s>>>(heads, n_tiles, base);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sort_groups_kernel<<<1, 1, 0, s>>>(base, n_tiles, st);
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}

// Zeroes ``sweep_scratch`` (group_sort_scratch_words int64 for the plan's
// passes), then writes composite c of every row, in row order, to
// comp_keys + c * n and counts its digits where group_sort_passes reads
// them (after one int64 tile counter per pass).
extern "C" int segment_sort_compose(const void* new_group, const void* values, int type,
                                    const WeightSet* ws, int64_t n, const Composite* comps,
                                    int n_comps, const void* scratch, void* comp_keys,
                                    void* sweep_scratch, int64_t sweep_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_comps <= 0 || n <= 0) return 0;
  if (n_comps > kMaxComps) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(sweep_scratch, 0, sizeof(int64_t) * sweep_words, s);
  ++g_stream_ops;
  if (err != cudaSuccess) return static_cast<int>(err);
  CompSet cs{};
  cs.n = n_comps;
  int passes = 0;
  for (int c = 0; c < n_comps; ++c) {
    cs.comp[c] = comps[c];
    passes += places_of(comps[c]);
  }
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t* base = static_cast<const int64_t*>(scratch) + n_tiles;
  int32_t* hist = reinterpret_cast<int32_t*>(static_cast<int64_t*>(sweep_scratch) + passes);
  sort_compose_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const bool*>(new_group), values, type, *ws, n, base, cs,
      static_cast<uint64_t*>(comp_keys), hist);
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}

// The sorted values (elem_bytes each), weight and run heads from the
// passes' permutation (null: no pass ran, the identity) and the last
// composite's sorted keys, whose group field starts at bit group_pos (-1:
// one group).
extern "C" int segment_sort_finish(const void* values, int type, int elem_bytes,
                                   const WeightSet* ws, int64_t n, const void* perm,
                                   const void* sorted_last, int group_pos, void* out_values,
                                   void* out_weight, void* heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sort_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      values, type, elem_bytes, *ws, n, static_cast<const int32_t*>(perm),
      static_cast<const uint64_t*>(sorted_last), group_pos, out_values,
      static_cast<bool*>(out_weight), static_cast<bool*>(heads));
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
