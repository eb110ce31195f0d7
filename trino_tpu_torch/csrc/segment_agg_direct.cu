// The direct-indexed aggregation: segment_agg's requests and outputs over
// small static key domains, with no sort and no group boundaries.
//
// Replaces: the direct-aggregation stage of trino_tpu/ops/megakernels.py
// _expand_phase_body (its _direct_aggregate_impl(..., "off") call inside
// the one Pallas launch of expand_phase): each row's group index from its
// dictionary codes and booleans, the masked reductions over G <= 256
// groups, the key columns rebuilt from the flat group index and each
// output's finishing, the variance family's among them (agg_common.cuh's
// finish_output, shared with segment_agg.cu), and the tied lo limb of a
// long decimal's min or max (agg_common.cuh's kTied) in a second round. It
// takes no min_by/max_by request: those are not direct aggregates.
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
//                 is the largest such row (kernels.direct_group_first);
//                 a tied request reduces the rows whose values2 is the
//                 group's result of its ref
//   exists[g]   = some active row has gid g
//   key k at g  = its code in g's mixed-radix digits, cast to the key's
//                 storage, valid where the code is not the NULL slot
//   outputs     = agg_common.cuh's finish_output, segment_agg's finishing
// Integer results are bit-identical; float sums add in a fixed order (a
// fixed tree over a step's lanes of one group, a warp's steps in row
// order, the warps in order, then the blocks in a fixed tree), so two runs
// give the same bits, within rounding of the plain scatter's blocked order.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The keys, the activity and each
// request's columns are read once; the outputs are G rows.
//
// Design: two launches; four with a tied request (resolve and a second
// reduce between them).
// - reduce: a grid sized for occupancy at a fixed shared memory budget (so
//   the order of the float sums depends only on n and the card), each
//   block a contiguous chunk of rows. A pass serves as many requests (the
//   active count, which gives exists, first) as the budget holds (kWarps x
//   G accumulator words a request: 512 / G requests);
//   after the first pass each row's gid comes from an int16 scratch the
//   first pass wrote, not from the keys. Each request's contribution and
//   reduction are specialised on its kind, a row's columns read together.
//   No lane folds its peers in turn, and no atomic.
//   The warps take 32 rows a step, each warp owning its G accumulator
//   words of a request; a step's lanes are grouped by gid
//   (__match_any_sync) and each group's contributions reduced in a fixed
//   tree over the group's ranks (round d: rank r, a multiple of 2d, takes
//   rank r + d's partial by a shuffle; as many rounds as the warp's
//   largest group needs), then the group's lowest lane adds the result to
//   the warp's accumulator for that gid. The block folds its warps'
//   accumulators in warp order into its partial of the request.
// - finish: one block a group; its threads fold the blocks' partials of
//   each request in one fixed order (strided over the blocks, then a
//   shuffle tree and the warps in order), so the G groups' folds run in
//   parallel rather than one thread walking every block; then exists, the
//   rebuilt keys (a thread a key) and every output (a thread an output).
// - with a tied request: after the first reduce (the active count and
//   every other request), a resolve pass folds each group's result of the
//   requests the tied ones read, as the finish folds it, into an extreme a
//   group and request; a second reduce serves the tied requests alone,
//   each row's gid from the scratch the first wrote. The finish then folds
//   every request's partials.

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

// Bytes of warp-private accumulators a reduce block holds (a pass serves
// as many requests as fit).
constexpr int kDirectSmemBudget = 32 * 1024;
constexpr int kNoGroup = hopper::kMaxDirectGroups;

// The requests a reduce launch serves, in order (-1: the active count),
// and whether its first pass writes each row's gid to the scratch.
struct DirectRound {
  int8_t order[hopper::kMaxAggRequests + 1];
  int n;
  int write_gids;
};

__device__ __forceinline__ int group_of(const DirectKeySet& keys, int64_t i) {
  int gid = 0;
  for (int k = 0; k < keys.n; ++k) {
    const hopper::KeyCol& c = keys.col[k];
    const int d = keys.domain[k];
    const int size = d - 1;
    // the data is read beside its validity, not after it
    int code = static_cast<int32_t>(load_int(c.type, c.data, i));
    const int hi = size - 1 > 0 ? size - 1 : 0;
    code = code < 0 ? 0 : (code > hi ? hi : code);
    gid = gid * d + (c.valid[i] ? code : size);
  }
  return gid;
}

// Requests a reduce pass serves at G groups (the active count counts as one).
__host__ __device__ __forceinline__ int direct_per_pass(int G) {
  const int k = kDirectSmemBudget / (kWarps * G * static_cast<int>(sizeof(uint64_t)));
  return k < 1 ? 1 : k;
}

// One step of a request of kind KIND for a lane of gid ``gid``: its
// contribution c reduced over its group's lanes in the fixed tree (bits
// 5k..5k+4 of ``src``: the lane of rank rank + 2^k in the group), added by
// the group's lowest lane to the warp's accumulator.
template <int KIND>
__device__ __forceinline__ void direct_step(uint64_t c, int gid, int G, int rank, int cnt,
                                            int top, uint32_t src, uint64_t* __restrict__ acc) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    if (d >= top) break;  // uniform over the warp
    const bool take = (rank & (2 * d - 1)) == 0 && rank + d < cnt;
    const uint64_t other = __shfl_sync(0xffffffffu, c, static_cast<int>(src >> (5 * k) & 31u));
    if (take) c = combine_of<KIND>(c, other);
  }
  if (gid < G && rank == 0) acc[gid] = combine_of<KIND>(acc[gid], c);
}

// ROUND 0: the active count and every request but the tied ones, each
// row's gid from its keys; ROUND 1: the tied requests, gids from the
// scratch (each round's kernel holds only its own code).
template <int ROUND>
__global__ void __launch_bounds__(kThreads)
direct_reduce_kernel(AggRequestSet reqs, DirectRound rd, DirectKeySet keys,
                     const bool* __restrict__ active, int64_t n, int G, int64_t chunk,
                     int16_t* __restrict__ gids, uint64_t* __restrict__ partials,
                     const uint64_t* __restrict__ extremes) {
  extern __shared__ uint64_t acc[];  // [per pass][kWarps][G]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the block's rows from b0: a 32-bit count (a chunk is n over the grid,
  // far below 2^31), so no 64-bit bound stays live through the steps
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int rows = static_cast<int>(b0 + chunk < n ? chunk : (n > b0 ? n - b0 : 0));
  const int total = rd.n;
  const int per_pass = direct_per_pass(G);
  const bool scratch = rd.write_gids;
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = lane == 31 ? 0u : ~((2u << lane) - 1u);
  for (int p0 = 0; p0 < total; p0 += per_pass) {
    const int np = total - p0 < per_pass ? total - p0 : per_pass;
    for (int k = threadIdx.x; k < np * kWarps * G; k += kThreads) {
      const int r = rd.order[p0 + k / (kWarps * G)];
      acc[k] = r < 0 ? 0ull : static_cast<uint64_t>(reqs.req[r].identity);
    }
    __syncthreads();
    for (int step = warp * 32; step < rows; step += kThreads) {
      const int64_t i = b0 + step + lane;
      int gid = kNoGroup;
      if (step + lane < rows) {
        if (ROUND == 0 && p0 == 0) {
          gid = active[i] ? group_of(keys, i) : kNoGroup;
          if (scratch) gids[i] = static_cast<int16_t>(gid);
        } else {
          gid = gids[i];
        }
      }
      const unsigned peers = __match_any_sync(0xffffffffu, gid);
      const int rank = __popc(peers & below);
      const int cnt = __popc(peers);
      uint32_t src = 0;  // 5 bits a round: the lane to take from (this one: none)
      unsigned m = peers & above;  // the group's lanes after this one, in rank order
#pragma unroll
      for (int k = 0, stripped = 0; k < 5; ++k) {
        for (; stripped < (1 << k) - 1; ++stripped) m &= m - 1;
        src |= static_cast<uint32_t>(m != 0 ? __ffs(m) - 1 : lane) << (5 * k);
      }
      const int top = static_cast<int>(__reduce_max_sync(0xffffffffu, gid < G ? cnt : 1));
      for (int p = 0; p < np; ++p) {
        const int r = rd.order[p0 + p];
        uint64_t* a = acc + (p * kWarps + warp) * G;
        if (r < 0) {
          direct_step<hopper::kCount>(gid < G ? 1ull : 0ull, gid, G, rank, cnt, top, src, a);
          continue;
        }
        const AggRequest& q = reqs.req[r];
        if constexpr (ROUND == 1) {
          // a tied request: its value where the row's values2 is its
          // group's extreme of its ref (a min or a max of the values)
          bool w = false;
          uint64_t x = 0;
          if (gid < G) {
            const int64_t hi = load_int(q.type2, q.values2, i);
            x = static_cast<uint64_t>(load_int(q.type, q.values, i));
            w = weighted(q, active, i) && static_cast<uint64_t>(hi) == extremes[q.ref * G + gid];
          }
          const uint64_t c = w ? x : static_cast<uint64_t>(q.identity);
          if (q.identity == INT64_MAX) {
            direct_step<hopper::kMinInt>(c, gid, G, rank, cnt, top, src, a);
          } else {
            direct_step<hopper::kMaxInt>(c, gid, G, rank, cnt, top, src, a);
          }
        } else {
          with_kind(q.kind, [=, &q](auto tag) {
            constexpr int K = decltype(tag)::kind;
            const uint64_t c = gid < G ? contribution_of<K>(q, active, i)
                                       : static_cast<uint64_t>(q.identity);
            direct_step<K>(c, gid, G, rank, cnt, top, src, a);
          });
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < np * G; k += kThreads) {
      const int p = k / G, g = k % G;
      const int r = rd.order[p0 + p];
      const int kind = r < 0 ? hopper::kCount
                             : ROUND == 0 ? reqs.req[r].kind
                                          : hopper::combine_kind(reqs.req[r].kind,
                                                                 reqs.req[r].identity);
      uint64_t x = acc[(p * kWarps) * G + g];
      for (int w = 1; w < kWarps; ++w) x = combine(kind, x, acc[(p * kWarps + w) * G + g]);
      partials[(static_cast<int64_t>(r + 1) * gridDim.x + blockIdx.x) * G + g] = x;
    }
    __syncthreads();  // acc is read before the next pass resets it
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
// existence, keys and outputs; given ``extremes``, the resolve pass
// instead: the fold of each request a tied request reads, into extremes
// (the same fold, so the finish gives the extreme the tied rows matched).
__global__ void __launch_bounds__(kThreads)
direct_finish_kernel(AggCombine reqs, AggOutputSet outs, DirectKeySet keys, int64_t n, int G,
                     int blocks, const uint64_t* __restrict__ partials,
                     bool* __restrict__ group_exists, uint64_t* __restrict__ extremes) {
  __shared__ uint64_t v[hopper::kMaxAggRequests + 1];  // the active count, then each request
  const int g = blockIdx.x;
  if (extremes != nullptr) {
    // the resolve pass: the group's result of each request a tied one reads
    for (int t = 0; t < reqs.n; ++t) {
      const int r = reqs.ref[t];
      if (r < 0) continue;
      const uint64_t* p = partials + static_cast<int64_t>(r + 1) * blocks * G + g;
      uint64_t x = static_cast<uint64_t>(reqs.identity[r]);
      for (int b = threadIdx.x; b < blocks; b += kThreads) {
        x = combine(reqs.kind[r], x, p[static_cast<int64_t>(b) * G]);
      }
      x = block_fold(reqs.kind[r], x);
      if (threadIdx.x == 0) extremes[r * G + g] = x;
    }
    return;
  }
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
// words per block and request, the active count first): as many as the
// card holds at once at the pass's shared memory budget, at most one a
// 256 rows.
extern "C" int64_t segment_agg_direct_blocks(int64_t n) {
  static const int per_sm = [] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, direct_reduce_kernel<0>, kThreads,
                                                  kDirectSmemBudget);
    return blocks > 0 ? blocks : 1;
  }();
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(hopper::sm_count()) * per_sm;
  return want < 1 ? 1 : (want < cap ? want : cap);
}

static std::atomic<int64_t> g_direct_stream_ops{0};

extern "C" int64_t segment_agg_direct_stream_ops() { return g_direct_stream_ops.load(); }

// Records event k of ``events`` (none where null) on stream s.
static void mark(void* const* events, int k, cudaStream_t s) {
  if (events != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(events[k]), s);
}

// The whole direct aggregation on ``stream``: ``gids`` (int16 [n]) and
// ``partials`` (uint64 [(requests + 1) * blocks * G], then with a tied
// request requests * G extremes) are scratch; every
// key and output column and group_exists (bool [G]) are written for all G
// groups. ``events`` (3, or null) are recorded at the bounds of the reduce
// and the finish. Returns the first CUDA error, 0 on success.
extern "C" int segment_agg_direct(const hopper::AggRequestSet* reqs,
                                  const hopper::AggOutputSet* outs,
                                  const hopper::DirectKeySet* keys, const void* active, int64_t n,
                                  int G, void* gids, void* partials, void* group_exists,
                                  void* const* events, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || G <= 0 || G > hopper::kMaxDirectGroups) return 0;
  const int64_t blocks = segment_agg_direct_blocks(n);
  // each block's chunk whole steps of the block, so its loads are coalesced
  const int64_t chunk = ((n + blocks - 1) / blocks + kThreads - 1) / kThreads * kThreads;
  AggCombine comb{};
  comb.n = reqs->n;
  DirectRound rounds[2] = {};
  rounds[0].order[rounds[0].n++] = -1;  // the active count
  for (int r = 0; r < reqs->n; ++r) {
    const hopper::AggRequest& q = reqs->req[r];
    comb.identity[r] = q.identity;
    comb.kind[r] = hopper::combine_kind(q.kind, q.identity);
    comb.ref[r] = q.kind == hopper::kTied ? q.ref : -1;
    DirectRound& d = rounds[q.kind == hopper::kTied ? 1 : 0];
    d.order[d.n++] = static_cast<int8_t>(r);
  }
  const bool tied = rounds[1].n > 0;
  rounds[0].write_gids = tied || rounds[0].n > direct_per_pass(G);
  uint64_t* part = static_cast<uint64_t*>(partials);
  uint64_t* extremes = part + (reqs->n + 1) * blocks * G;
  auto reduce = [&](int round) {
    const DirectRound& d = rounds[round];
    const int np = d.n < direct_per_pass(G) ? d.n : direct_per_pass(G);
    const size_t smem = sizeof(uint64_t) * kWarps * static_cast<size_t>(G) * np;
    auto kernel = round == 0 ? direct_reduce_kernel<0> : direct_reduce_kernel<1>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        *reqs, d, *keys, static_cast<const bool*>(active), n, G, chunk,
        static_cast<int16_t*>(gids), part, extremes);
    ++g_direct_stream_ops;
    return cudaGetLastError();
  };
  mark(events, 0, s);
  cudaError_t err = reduce(0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tied) {
    direct_finish_kernel<<<G, kThreads, 0, s>>>(
        comb, *outs, *keys, n, G, static_cast<int>(blocks), part,
        static_cast<bool*>(group_exists), extremes);
    ++g_direct_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if ((err = reduce(1)) != cudaSuccess) return static_cast<int>(err);
  }
  mark(events, 1, s);
  direct_finish_kernel<<<G, kThreads, 0, s>>>(
      comb, *outs, *keys, n, G, static_cast<int>(blocks), part,
      static_cast<bool*>(group_exists), nullptr);
  ++g_direct_stream_ops;
  mark(events, 2, s);
  return static_cast<int>(cudaGetLastError());
}
