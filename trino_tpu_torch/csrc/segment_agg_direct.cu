// The direct-indexed aggregation: segment_agg's requests and outputs over
// small static key domains, with no sort and no group boundaries.
//
// Replaces: the direct-aggregation stage of trino_tpu/ops/megakernels.py
// _expand_phase_body (its _direct_aggregate_impl(..., "off") call inside
// the one Pallas launch of expand_phase): each row's group index from its
// dictionary codes and booleans, the masked reductions over G <= 256
// groups, the key columns rebuilt from the flat group index and each
// output's finishing, the variance family's among them (agg_common.cuh's
// finish_output, shared with segment_agg.cu). It takes no min_by/max_by
// request: those are not direct aggregates.
//
// For n rows, keys k with domains D_k (NULL in the last slot of each) and
// G = prod D_k <= kMaxDirectGroups, as hopper_kernels.segment_agg_direct_plain
// (executor._direct_aggregate) computes it:
//   gid[i]      = fold over the keys of gid * D_k + code_k, code_k the key's
//                 value as int32 clamped to [0, max(D_k - 2, 0)], D_k - 1
//                 where NULL
//   request r   = the reduction of the rows with gid g whose activity,
//                 filter, validity and predicate hold (agg_common.cuh's
//                 contribution), the identity where there is none; ``last``
//                 is the largest such row (kernels.direct_group_first)
//   exists[g]   = some active row has gid g
//   key k at g  = its code in g's mixed-radix digits, cast to the key's
//                 storage, valid where the code is not the NULL slot
//   outputs     = agg_common.cuh's finish_output, segment_agg's finishing
// Integer results are bit-identical; float sums add in a fixed order (row
// order inside a warp's run, then warps, then the blocks in a fixed tree),
// so two runs give the same bits, within rounding of the plain scatter's
// blocked order.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The keys, the activity and each
// request's columns are read once; the outputs are G rows.
//
// Design: two launches.
// - reduce: a fixed grid (two blocks an SM, so the order of the float sums
//   depends only on n and the card) over contiguous chunks of rows; each
//   warp takes a contiguous run of its block's chunk, 32 rows a step. The
//   first pass over the run computes each row's gid (kMaxDirectGroups for an
//   inactive row) into an int16 scratch, which later passes read instead of
//   the keys. For each request (and first, the active count that gives
//   exists), a step's lanes are grouped by gid (__match_any_sync); the
//   lowest lane of each group folds its peers' contributions in lane order
//   into the warp's own accumulator for that gid in shared memory
//   (kWarps x G words, 16 KB at G = 256, under the 48 KB default, so the
//   request set is not split). No atomic: the warp owns its accumulators.
//   The block then folds its warps' accumulators in warp order into its
//   partial of the request.
// - finish: one block a group; its threads fold the blocks' partials of
//   each request in one fixed order (strided over the blocks, then a
//   shuffle tree and the warps in order), so the G groups' folds run in
//   parallel rather than one thread walking every block; then exists, the
//   rebuilt keys (a thread a key) and every output (a thread an output).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "agg_common.cuh"
#include "join_keys.cuh"
#include "launch.cuh"

namespace hopper {

constexpr int kMaxDirectGroups = 256;
constexpr int kMaxDirectKeys = 8;

// The group keys: their columns (data, valid, type), domains, and the
// rebuilt key columns written at the G groups.
struct DirectKeySet {
  KeyCol col[kMaxDirectKeys];
  int domain[kMaxDirectKeys];
  void* dst[kMaxDirectKeys];
  bool* dst_valid[kMaxDirectKeys];
  int n;
};

}  // namespace hopper

namespace {

using hopper::AggCombine;
using hopper::AggOutputSet;
using hopper::AggRequest;
using hopper::AggRequestSet;
using hopper::DirectKeySet;
using hopper::kThreads;
using hopper::kWarps;
using namespace hopper::agg;

constexpr int kDirectBlocksPerSm = 2;

__device__ __forceinline__ int group_of(const DirectKeySet& keys, int64_t i) {
  int gid = 0;
  for (int k = 0; k < keys.n; ++k) {
    const hopper::KeyCol& c = keys.col[k];
    const int d = keys.domain[k];
    const int size = d - 1;
    int code = size;
    if (c.valid[i]) {
      code = static_cast<int32_t>(load_int(c.type, c.data, i));
      const int hi = size - 1 > 0 ? size - 1 : 0;
      code = code < 0 ? 0 : (code > hi ? hi : code);
    }
    gid = gid * d + code;
  }
  return gid;
}

__global__ void __launch_bounds__(kThreads)
direct_reduce_kernel(AggRequestSet reqs, DirectKeySet keys, const bool* __restrict__ active,
                     int64_t n, int G, int64_t chunk, int16_t* __restrict__ gids,
                     uint64_t* __restrict__ partials) {
  extern __shared__ uint64_t acc[];  // [kWarps][G]
  __shared__ uint64_t lanes[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t b1 = b0 + chunk < n ? b0 + chunk : n;
  // the warp's run: a contiguous share of the block's chunk, whole steps
  const int64_t share = ((chunk + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int64_t w0 = b0 + warp * share < b1 ? b0 + warp * share : b1;
  const int64_t w1 = w0 + share < b1 ? w0 + share : b1;
  AggRequest count_active{};
  count_active.kind = hopper::kCount;
  for (int r = -1; r < reqs.n; ++r) {
    const AggRequest& q = r < 0 ? count_active : reqs.req[r];
    const int kind = q.kind;
    const uint64_t ident = static_cast<uint64_t>(q.identity);
    for (int k = threadIdx.x; k < kWarps * G; k += kThreads) acc[k] = ident;
    __syncthreads();
    uint64_t* mine = acc + warp * G;
    for (int64_t base = w0; base < w1; base += 32) {
      const int64_t i = base + lane;
      int gid = hopper::kMaxDirectGroups;
      if (i < w1) {
        if (r < 0) {
          gid = active[i] ? group_of(keys, i) : hopper::kMaxDirectGroups;
          gids[i] = static_cast<int16_t>(gid);
        } else {
          gid = gids[i];
        }
      }
      uint64_t c = ident;
      if (gid < G) c = r < 0 ? 1ull : contribution(q, active, i);
      const unsigned peers = __match_any_sync(0xffffffffu, gid);
      lanes[warp][lane] = c;
      __syncwarp();
      if (gid < G && lane == __ffs(peers) - 1) {
        uint64_t x = mine[gid];
        for (unsigned m = peers; m != 0; m &= m - 1) {
          x = combine(kind, x, lanes[warp][__ffs(m) - 1]);
        }
        mine[gid] = x;
      }
      __syncwarp();
    }
    __syncthreads();
    uint64_t* out = partials + (static_cast<int64_t>(r + 1) * gridDim.x + blockIdx.x) * G;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      uint64_t x = ident;
      for (int w = 0; w < kWarps; ++w) x = combine(kind, x, acc[w * G + g]);
      out[g] = x;
    }
    __syncthreads();  // acc is read before the next request resets it
  }
}

// One block's threads' values folded in one fixed order (a shuffle tree in
// each warp, then the warps in order), returned to thread 0.
__device__ uint64_t block_fold(int kind, uint64_t x) {
  __shared__ uint64_t warp_x[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = combine(kind, x, __shfl_down_sync(0xffffffffu, x, o));
  if (lane == 0) warp_x[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) x = combine(kind, x, warp_x[w]);
  }
  __syncthreads();  // warp_x is read before the next fold writes it
  return x;
}

// One block a group: its threads fold the blocks' partials of each request
// (blocks t, t + kThreads, ... in order, then block_fold), then the group's
// existence, keys and outputs.
__global__ void __launch_bounds__(kThreads)
direct_finish_kernel(AggCombine reqs, AggOutputSet outs, DirectKeySet keys, int64_t n, int G,
                     int blocks, const uint64_t* __restrict__ partials,
                     bool* __restrict__ group_exists) {
  __shared__ uint64_t v[hopper::kMaxAggRequests + 1];  // the active count, then each request
  const int g = blockIdx.x;
  for (int r = -1; r < reqs.n; ++r) {
    const int kind = r < 0 ? hopper::kCount : reqs.kind[r];
    const uint64_t ident = r < 0 ? 0ull : static_cast<uint64_t>(reqs.identity[r]);
    const uint64_t* p = partials + static_cast<int64_t>(r + 1) * blocks * G + g;
    uint64_t x = ident;
    for (int b = threadIdx.x; b < blocks; b += kThreads) {
      x = combine(kind, x, p[static_cast<int64_t>(b) * G]);
    }
    x = block_fold(kind, x);
    if (threadIdx.x == 0) v[r + 1] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) group_exists[g] = v[0] > 0;
  if (threadIdx.x < keys.n) {
    const int k = threadIdx.x;
    int rem = g;
    for (int j = keys.n - 1; j > k; --j) rem /= keys.domain[j];
    const int d = keys.domain[k];
    const int code = rem % d;
    store_value(keys.dst[k], keys.col[k].type, g, static_cast<uint64_t>(code), false);
    keys.dst_valid[k][g] = code < d - 1;
  }
  for (int o = threadIdx.x; o < outs.n; o += kThreads) finish_output(outs.out[o], v + 1, g, n, 0);
}

}  // namespace

extern "C" int segment_agg_direct_max_groups() { return hopper::kMaxDirectGroups; }

extern "C" int segment_agg_direct_max_keys() { return hopper::kMaxDirectKeys; }

// Blocks of the reduce pass for n rows (the partials hold one row of G
// words per block and request, the active count first).
extern "C" int64_t segment_agg_direct_blocks(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(hopper::sm_count()) * kDirectBlocksPerSm;
  return want < 1 ? 1 : (want < cap ? want : cap);
}

static std::atomic<int64_t> g_direct_stream_ops{0};

extern "C" int64_t segment_agg_direct_stream_ops() { return g_direct_stream_ops.load(); }

// The whole direct aggregation on ``stream``: ``gids`` (int16 [n]) and
// ``partials`` (uint64 [(requests + 1) * blocks * G]) are scratch; every
// key and output column and group_exists (bool [G]) are written for all G
// groups. Returns the first CUDA error, 0 on success.
extern "C" int segment_agg_direct(const hopper::AggRequestSet* reqs,
                                  const hopper::AggOutputSet* outs,
                                  const hopper::DirectKeySet* keys, const void* active, int64_t n,
                                  int G, void* gids, void* partials, void* group_exists,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || G <= 0 || G > hopper::kMaxDirectGroups) return 0;
  const int64_t blocks = segment_agg_direct_blocks(n);
  const int64_t chunk = (n + blocks - 1) / blocks;
  const size_t smem = sizeof(uint64_t) * kWarps * static_cast<size_t>(G);
  direct_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      *reqs, *keys, static_cast<const bool*>(active), n, G, chunk,
      static_cast<int16_t*>(gids), static_cast<uint64_t*>(partials));
  ++g_direct_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  AggCombine comb{};
  comb.n = reqs->n;
  for (int r = 0; r < reqs->n; ++r) {
    comb.identity[r] = reqs->req[r].identity;
    comb.kind[r] = reqs->req[r].kind;
  }
  direct_finish_kernel<<<G, kThreads, 0, s>>>(
      comb, *outs, *keys, n, G, static_cast<int>(blocks),
      static_cast<const uint64_t*>(partials), static_cast<bool*>(group_exists));
  ++g_direct_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
