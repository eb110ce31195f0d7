// The sort-path aggregation over a group-sorted page: segment_agg, the
// whole reduction stage.
//
// Replaces: trino_tpu/ops/megakernels.py _agg_phase_body + aggregate_phase
// (one Pallas launch of executor._aggregate_impl: the group boundaries, the
// key gathers at the group starts, every sum, count, min, max and
// arbitrary, the finishing of avg, and the long tail: the variance family,
// covar, corr and regr, skewness, kurtosis, geometric_mean, entropy, the
// bitwise aggregates, checksum and min_by/max_by), and the epi_spec stage
// at the end of that body (its _partition_dest call) where every exchange
// key is a group key. Of the re-sorting aggregates (distinct_count_fn,
// percentile_fn, tdigest_fn) it runs what follows segment_sort.cu's re-sort
// of each group's rows: the exact distinct count (a count of the weighted
// run heads), the percentile's rank gather and the digest's centroids;
// hll.cu takes approx_distinct's HyperLogLog path.
//
// segment_agg, bit-identical to hopper_kernels.segment_agg_plain (float64
// sums within rounding: they are added in another order), on n rows and
// out_cap output slots:
//   starts[g]  = the row of the (g+1)-th new_group row, n past the last
//                (kernels.boundary_positions)
//   each group's rows run from its start to the next start (n for the
//   last); rows before the first group belong to no slot
//   request r, on the rows where active & filter & valid & valid2 & its
//   predicate hold ("weighted"): a wrapping int64 sum of int64, int32,
//   int16, int8 or bool values or a count; a float64 sum of a per-row
//   double (the value divided by a decimal scale, its log, max(x, 0) or
//   c log2 c, a power up to 4, times a second factor); the min or max of
//   integer, bool or float values (NaN wins, as torch's scatter_reduce) or
//   of order keys; a bitwise AND, OR or XOR; a checksum (the wrapping sum
//   of each row's splitmix64(order key), through a dictionary's value-key
//   LUT, a constant for a NULL row); the last weighted row's index
//   (arbitrary's row); the last weighted row whose order key is the
//   group's extreme of an earlier request (min_by/max_by's row); the min
//   (or max) of a long decimal's lo limb in unsigned order among the
//   weighted rows whose hi limb is the group's extreme of an earlier min
//   (or max) request (the tied lo limb). An empty group holds the
//   request's identity.
//   group_exists[g] = g < num_groups; each key at min(starts[g], n - 1),
//   its validity & group_exists; each output finished as
//   executor._eval_aggregate finishes it (agg_common.cuh's finish_output:
//   avg, bool_and/or, the gathers at a row, the moments operation by
//   operation); the destination of each slot from its gathered keys
//   (partition_hash.cuh), n_parts where the group does not exist. The data
//   of a slot past num_groups is left to the kernel (its validity and the
//   keys' validity are false).
//   A percentile output gathers segment_sort's sorted values at the
//   group's start plus the quantile's rank among its participants; a
//   digest output holds, per slot, the 64 centroids of the group's
//   participants (segment_sort put them first in the group, in value
//   order): centroid k takes the participants of rank r whose bucket
//   clip(int((0.5 + asin(clip(2 q - 1, -1, 1)) / pi) * 64), 0, 63), q =
//   (r + 0.5) / count, is k, its mean and its count (float64), r counted
//   from the group's start.
//
//   A float64 sum takes the class (NaN, +inf or -inf) of the plain
//   version's cumsum difference where that difference is not finite, and
//   keeps its own sum everywhere else. Where out_cap > 1 the plain version
//   sums a group as csum[end] - csum[start] + vals[start] over the
//   weighted doubles of the page (rows before the first group included).
//   Its cumsum (kernels.cumsum, as the reference's) is one scan up to
//   4 * 2048 rows; past that, a scan within blocks of 2048 rows (a tile)
//   plus the exclusive prefix of the block totals taken as their cumsum
//   less the block's own total. So a value that is not finite at or before
//   a group's start makes it NaN, and so does a finite prefix that leaves
//   the finite range (csum[start] and csum[end] both infinite), or a tile
//   total that does (its prefix inf - inf). The passes carry, per float
//   request and tile, the largest high word of its weighted doubles; only
//   where the page's bound on the sum of their magnitudes (kSegRows times
//   each tile's largest, summed) passes 2^1022, or is not finite, does the
//   span pass compute the plain version's csum at each group's start and
//   end: the tile totals in tile order (head partial, the groups inside,
//   tail partial), their exclusive prefix as the plain version takes it,
//   and within a tile the head partial and the groups before, all in
//   group order (the page as one tile up to 8,192 rows); the group takes
//   that difference's class where it is not finite. A page within the
//   bound reads no column again and makes no extra pass.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each request's columns read
// once, new_group read once, starts written and read once, the keys' bytes
// at out_cap rows, every output written once.
//
// Design: five launches, no memset and no atomic.
// - count: one block a tile of kSegRows rows counts the tile's new_group.
// - scan: one block scans the tiles' counts into each tile's first group.
// - reduce: one block a tile, 8 consecutive rows a thread, every column
//   read with 8- or 16-byte loads. The tile's new_group and each distinct
//   bool column the requests' weights read (the activity first, at most
//   kMaxMasks a call: the caller splits wider sets into calls) are loaded
//   once into per-thread bit masks, and a block scan of the head counts
//   gives each thread's first group and the starts of its heads. The
//   requests are then served in batches of kBatch (one a warp): (A) each
//   thread computes its rows' contributions of every request of the batch
//   (a loop specialised on the request's kind), stores the groups complete
//   inside it, and leaves the run before its first head and the run from
//   its last head in shared memory; (B) warp w carries request w's runs
//   over the tile's threads (a segmented scan, lanes over 8 threads each,
//   restarting at each thread with a head), writes the tile's tail (or
//   whole-tile head) partial and, for a float sum, the largest high word
//   of its doubles over the tile; (C) each thread with a head finishes
//   the group that ends at its first head: into its slot, or the tile's
//   head partial if that group began in an earlier tile. Two block
//   barriers a batch, none a request.
// - span: one block a request scans the head partials over the tiles,
//   restarting after each tile with a head, so a group that spans tiles
//   (the last group of a sorted page runs over its inactive tail) reads
//   two partials however many tiles it covers; a float sum's block also
//   bounds its doubles' magnitudes and, past the bound, follows the plain
//   cumsum (above).
// - finish: one thread a slot combines a tile-spanning group's tail
//   partial with the scanned head partials (in one fixed order, so a
//   float sum gives the same bits in every run), gathers the keys,
//   finishes every output and writes the destination from the keys in
//   registers; a slot past num_groups writes zero data and no validity
//   (its data is the kernel's to choose) without finishing. A division by
//   a scalar (a decimal scale) is a product with its reciprocal, as torch
//   computes it on the card; every product, sum and quotient of a
//   finishing is rounded on its own (no contraction into a fused
//   multiply-add), as torch's one-operation kernels round them.
// A min_by/max_by request (kMatchLast) and a long decimal's tied lo limb
// (kTied) read their group's extreme of an earlier request, so their rows
// are served by a second round: after the first reduce and span, a
// resolve pass (one thread a slot) writes each group's extreme, then a
// second reduce and span serve those requests alone (eight launches).
// A digest output adds one launch after the finish: one block a slot finds
// the 64 bucket boundaries among the group's participants by binary search
// (the bucket never decreases with the rank), then each warp sums its
// centroids' contiguous runs of values lane by lane and across the lanes in
// one fixed tree, so a digest gives the same bits in every run; asin is
// CUDA's, as torch's kernel on the card calls it, and every other
// operation is rounded on its own.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>

#include "agg_common.cuh"
#include "join_keys.cuh"
#include "launch.cuh"
#include "partition_hash.cuh"

namespace {

using hopper::kThreads;
using hopper::kWarps;

constexpr int kSegItems = 8;                     // consecutive rows a thread
constexpr int kSegRows = kThreads * kSegItems;   // rows a tile
constexpr int kBatch = kWarps;                   // requests a batch: one a warp
constexpr int kMaxMasks = 16;                    // distinct bool columns a call
constexpr int kRunStride = kThreads + kThreads / kSegItems;  // padded: no bank conflicts
constexpr uint64_t kNaNBits = 0x7FF8000000000000ull;
// Rows the plain version's float cumsum scans in one pass (kernels.cumsum:
// 4 blocks of CUMSUM_BLOCK = kSegRows rows); past them it scans by tiles.
// The NaN rule reads the plain version's blocks as tiles, so a tile is
// kernels.CUMSUM_BLOCK rows (hopper_kernels.bind checks it too).
static_assert(kSegRows == 2048, "a tile is kernels.CUMSUM_BLOCK rows");
constexpr int64_t kOneScanRows = 4 * kSegRows;

}  // namespace

extern "C" int segment_agg_tile_rows() { return kSegRows; }

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

// The reduce pass's plan, made on the host: the distinct bool columns the
// requests' weights read (col[0] the page's activity), the columns each
// request ANDs into its weight, a checksum's validity column, and the
// requests of each round in order (round 0's, then round 1's min_by/max_by
// rows).
struct TilePlan {
  const bool* col[kMaxMasks];
  uint32_t bits[hopper::kMaxAggRequests];
  int8_t null_col[hopper::kMaxAggRequests];  // -1: none
  int8_t order[hopper::kMaxAggRequests];
  int n_cols;
  int n_round[2];
  uint32_t round_cols[2];  // bit k: a request of the round reads column k
};

// Inclusive block scan of (flag, value) pairs in thread order: a flag
// restarts the reduction (of kind KIND) at its own value.
template <int KIND>
__device__ uint64_t seg_scan_op(bool flag, uint64_t v) {
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
      if (!f) v = combine_of<KIND>(vu, v);
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
      v = combine_of<KIND>(warp_v[w], v);
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

// Bit j set where row r0 + j (< n) of a bool column holds true: one 8-byte
// load where the thread's rows are whole and aligned.
__device__ __forceinline__ uint32_t load_bits(const bool* __restrict__ p, int64_t r0, int64_t n) {
  const uint8_t* a = reinterpret_cast<const uint8_t*>(p) + r0;
  uint32_t m = 0;
  if (r0 + kSegItems <= n && (reinterpret_cast<uintptr_t>(a) & 7) == 0) {
    const uint64_t w = *reinterpret_cast<const uint64_t*>(a);
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) m |= ((w >> (8 * j)) & 0xff) != 0 ? 1u << j : 0u;
  } else {
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) m |= r0 + j < n && a[j] ? 1u << j : 0u;
  }
  return m;
}

// Each tile's new_group count (a thread's 8 rows in one load).
__global__ void __launch_bounds__(kThreads)
agg_count_kernel(const bool* __restrict__ new_group, int64_t n, int64_t* __restrict__ heads) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kSegRows + threadIdx.x * kSegItems;
  const int c = __popc(load_bits(new_group, r0, n));
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

// Whether request kind ``kind`` is served in round ``phase`` (1: the
// min_by/max_by rows and the tied lo limbs, which read the first round's
// extremes).
__device__ __forceinline__ bool in_phase(int kind, int phase) {
  return hopper::second_round(kind) == (phase == 1);
}

// The thread's 8 rows of a column of S-byte elements as S 64-bit words
// (element j at byte j * S, rows past n 0): 16-byte loads (one 8-byte load
// for S = 1) where the rows are whole and aligned, else one load a row.
template <int S>
__device__ __forceinline__ void load_words(const void* p, int64_t r0, int64_t n,
                                           uint64_t (&w)[S]) {
  constexpr int kAlign = S == 1 ? 8 : 16;
  const unsigned char* a = static_cast<const unsigned char*>(p) + r0 * S;
  if (r0 + kSegItems <= n && (reinterpret_cast<uintptr_t>(a) & (kAlign - 1)) == 0) {
    if constexpr (S == 1) {
      w[0] = *reinterpret_cast<const uint64_t*>(a);
    } else {
#pragma unroll
      for (int k = 0; k < S / 2; ++k) {
        const ulonglong2 x = reinterpret_cast<const ulonglong2*>(a)[k];
        w[2 * k] = x.x;
        w[2 * k + 1] = x.y;
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < S; ++k) w[k] = 0;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    if (r0 + j >= n) break;
    uint64_t e;
    if constexpr (S == 8) {
      e = reinterpret_cast<const uint64_t*>(a)[j];
    } else if constexpr (S == 4) {
      e = reinterpret_cast<const uint32_t*>(a)[j];
    } else if constexpr (S == 2) {
      e = reinterpret_cast<const uint16_t*>(a)[j];
    } else {
      e = a[j];
    }
    w[(j * S) / 8] |= e << (((j * S) % 8) * 8);
  }
}

// Element j of load_words' words, as the column's raw bits.
template <int S>
__device__ __forceinline__ uint64_t word_elem(const uint64_t (&w)[S], int j) {
  if constexpr (S == 8) {
    return w[j];
  } else {
    return (w[(j * S) / 8] >> (((j * S) % 8) * 8)) & ((1ull << (8 * S)) - 1);
  }
}

// The thread's 8 raw values of a column of KeyType ``type``: int64 for an
// integer or bool column, a double's bits for a float one (a float32
// widened), as load_int and load_double read them.
__device__ __forceinline__ void load_raw(int type, const void* p, int64_t r0, int64_t n,
                                         uint64_t (&v)[kSegItems]) {
  switch (type) {
    case hopper::kI64:
    case hopper::kF64: {
      uint64_t w[8];
      load_words<8>(p, r0, n, w);
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) v[j] = w[j];
      break;
    }
    case hopper::kI32:
    case hopper::kF32: {
      uint64_t w[4];
      load_words<4>(p, r0, n, w);
      const bool f = type == hopper::kF32;
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) {
        const uint32_t e = static_cast<uint32_t>(word_elem<4>(w, j));
        v[j] = f ? bits_of(static_cast<double>(__uint_as_float(e)))
                 : static_cast<uint64_t>(static_cast<int64_t>(static_cast<int32_t>(e)));
      }
      break;
    }
    case hopper::kI16: {
      uint64_t w[2];
      load_words<2>(p, r0, n, w);
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) {
        v[j] = static_cast<uint64_t>(
            static_cast<int64_t>(static_cast<int16_t>(word_elem<2>(w, j))));
      }
      break;
    }
    default: {  // kI8, kBool
      uint64_t w[1];
      load_words<1>(p, r0, n, w);
      const bool b = type == hopper::kBool;
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) {
        const uint64_t e = word_elem<1>(w, j);
        v[j] = b ? (e != 0 ? 1ull : 0ull)
                 : static_cast<uint64_t>(static_cast<int64_t>(static_cast<int8_t>(e)));
      }
      break;
    }
  }
}

// Request r's weight bits over the thread's rows (and, for a checksum, the
// bits where its value is not NULL): its columns' masks from the tile's
// table. The predicate on the value is applied by the caller.
__device__ __forceinline__ uint32_t weight_bits(const TilePlan& plan, int r,
                                                const uint8_t (*mask_s)[kThreads],
                                                uint32_t inrange, uint32_t* not_null) {
  uint32_t w = inrange, nn = 0xffu;
  for (uint32_t b = plan.bits[r]; b != 0; b &= b - 1) w &= mask_s[__ffs(b) - 1][threadIdx.x];
  if (plan.null_col[r] >= 0) nn = mask_s[plan.null_col[r]][threadIdx.x];
  *not_null = nn;
  return w;
}

// The second round's contributions of request q over the thread's rows
// (x its raw values): for a min_by/max_by row its order key against its
// group's extreme, for a tied request its value where its values2 is its
// group's extreme; the identity elsewhere.
__device__ __forceinline__ void second_contribs(const AggRequest& q, uint32_t w, uint32_t h,
                                                int64_t r0, int64_t n, int64_t g0,
                                                int64_t out_cap,
                                                const uint64_t* __restrict__ ext,
                                                const uint64_t (&x)[kSegItems],
                                                uint64_t (&c)[kSegItems]) {
  const uint64_t ident = static_cast<uint64_t>(q.identity);
  if (q.kind == hopper::kMatchLast) {
    const bool f = is_float_type(q.type);
    int64_t gj = g0;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      gj += h >> j & 1u;
      c[j] = (w >> j & 1u) && gj >= 0 && gj < out_cap && raw_order_key(x[j], f) == ext[gj]
                 ? static_cast<uint64_t>(r0 + j) : ident;
    }
    return;
  }
  uint64_t x2[kSegItems];  // kTied: the ref's values
  load_raw(q.type2, q.values2, r0, n, x2);
  int64_t gj = g0;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    gj += h >> j & 1u;
    c[j] = (w >> j & 1u) && gj >= 0 && gj < out_cap && x2[j] == ext[gj] ? x[j] : ident;
  }
}

// Phase A's contributions of request q over the thread's rows (rows past n
// and unweighted rows hold the identity) from its raw values x (read with
// wide loads; contribs may overwrite them): contribs in the first round,
// second_contribs in the second (each round's kernel holds only its own
// code). For a float sum, the largest high word (sign cleared) of its
// doubles.
template <int PHASE>
__device__ __forceinline__ void thread_contribs(const AggRequest& q, uint32_t w,
                                                uint32_t not_null, uint32_t h, int64_t r0,
                                                int64_t n, int64_t g0, int64_t out_cap,
                                                const uint64_t* __restrict__ ext,
                                                uint64_t (&x)[kSegItems],
                                                uint64_t (&c)[kSegItems], uint32_t* top) {
  if constexpr (PHASE == 1) {
    second_contribs(q, w, h, r0, n, g0, out_cap, ext, x, c);
  } else {
    contribs<kSegItems>(
        q, w, not_null, x, [&](int j) { return r0 + j; },
        [&](uint64_t (&x2)[kSegItems]) { load_raw(q.type2, q.values2, r0, n, x2); }, c);
    if (q.kind == hopper::kSumFloat) {
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) {
        const uint32_t hi = static_cast<uint32_t>(c[j] >> 32) & 0x7fffffffu;
        m = hi > m ? hi : m;
      }
      *top = m;
    }
  }
}

// Phase A's runs of a request of kind KIND over the thread's rows: the
// groups complete inside the thread into res_r, the run before the
// thread's first head and the run from its last head.
template <int KIND>
__device__ __forceinline__ void thread_runs(const uint64_t (&c)[kSegItems], uint64_t ident,
                                            uint32_t h, int64_t g0, int64_t out_cap,
                                            uint64_t* __restrict__ res_r, uint64_t* before,
                                            uint64_t* run) {
  uint64_t acc = ident;
  if (h == 0) {  // most threads: no group starts in their rows
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) acc = combine_of<KIND>(acc, c[j]);
    *before = ident;
    *run = acc;
    return;
  }
  int64_t g = g0;
  uint64_t first = ident;
  bool seen = false;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    if (h >> j & 1u) {
      if (!seen) {
        first = acc;
        seen = true;
      } else if (g < out_cap) {
        res_r[g] = acc;
      }
      ++g;
      acc = ident;
    }
    acc = combine_of<KIND>(acc, c[j]);
  }
  *before = first;
  *run = acc;
}

// Phase B of one request (kind KIND) by one warp: the runs of the tile's
// threads (run_col, padded) become in place each thread's carry, the
// combination of the runs since the last thread with a head before it
// (the identity where none), in one fixed order: each lane's 8 threads in
// turn, then a segmented shuffle scan over the lanes. Returns, to lane 31,
// the tile's inclusive run at its last thread.
template <int KIND>
__device__ __forceinline__ uint64_t carry_scan(uint64_t* run_col, const uint8_t* seen_s,
                                               uint64_t ident) {
  const int lane = threadIdx.x & 31;
  uint64_t x[kSegItems];
  bool f[kSegItems];
  uint64_t acc = ident;
  bool lf = false;
#pragma unroll
  for (int i = 0; i < kSegItems; ++i) {
    const int t = lane * kSegItems + i;
    x[i] = run_col[t + lane];
    f[i] = seen_s[t] != 0;
    acc = f[i] ? x[i] : combine_of<KIND>(acc, x[i]);
    lf = lf || f[i];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t up = __shfl_up_sync(0xffffffffu, acc, o);
    const int uf = __shfl_up_sync(0xffffffffu, static_cast<int>(lf), o);
    if (lane >= o) {
      if (!lf) acc = combine_of<KIND>(up, acc);
      lf = lf || uf;
    }
  }
  uint64_t carry = __shfl_up_sync(0xffffffffu, acc, 1);
  if (lane == 0) carry = ident;
#pragma unroll
  for (int i = 0; i < kSegItems; ++i) {
    run_col[lane * kSegItems + i + lane] = carry;
    carry = f[i] ? x[i] : combine_of<KIND>(carry, x[i]);
  }
  return carry;
}

// The reduction pass over one tile: starts of its heads, then each round's
// requests in batches (phases A, B and C above): complete groups into res,
// the tile's head and tail partials, and each float sum's largest high
// word of its doubles over the tile into tiletop.
template <int PHASE>
__global__ void __launch_bounds__(kThreads)
agg_reduce_kernel(AggRequestSet reqs, TilePlan plan,
                  const bool* __restrict__ new_group, int64_t n, int64_t out_cap,
                  int64_t n_tiles, const int64_t* __restrict__ base,
                  int64_t* __restrict__ starts, uint64_t* __restrict__ res,
                  uint64_t* __restrict__ head, uint64_t* __restrict__ tail,
                  int64_t* __restrict__ tiletop, const uint64_t* __restrict__ extremes) {
  __shared__ uint64_t run_s[kBatch][kRunStride];
  __shared__ uint64_t before_s[kBatch][kThreads];
  __shared__ uint32_t top_s[kBatch][kWarps];
  __shared__ uint8_t mask_s[kMaxMasks][kThreads];
  __shared__ uint8_t seen_s[kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t t0 = tile * kSegRows;
  const int64_t r0 = t0 + static_cast<int64_t>(threadIdx.x) * kSegItems;
  const int first = PHASE == 0 ? 0 : plan.n_round[0];
  const int count = plan.n_round[PHASE];
  const uint32_t h = load_bits(new_group, r0, n);
  const int nh = __popc(h);
  int64_t tile_heads;
  const int64_t excl = block_exclusive(nh, &tile_heads);
  const int64_t b = base[tile];
  const int64_t g0 = b + excl - 1;  // group of this thread's first row (-1: none yet)
  if (PHASE == 0) {
    int64_t g = g0;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      if (h >> j & 1u && ++g <= out_cap) starts[g] = r0 + j;
    }
  }
  seen_s[threadIdx.x] = nh > 0;
  for (int k = 0; k < plan.n_cols; ++k) {
    if (plan.round_cols[PHASE] >> k & 1u) mask_s[k][threadIdx.x] = load_bits(plan.col[k], r0, n);
  }
  const uint32_t inrange =
      r0 >= n ? 0u : (n - r0 >= kSegItems ? 0xffu : (1u << (n - r0)) - 1u);
  for (int k0 = 0; k0 < count; k0 += kBatch) {
    const int nb = count - k0 < kBatch ? count - k0 : kBatch;
    for (int bi = 0; bi < nb; ++bi) {  // A
      const int r = plan.order[first + k0 + bi];
      const AggRequest& q = reqs.req[r];
      uint32_t not_null;
      const uint32_t w = weight_bits(plan, r, mask_s, inrange, &not_null);
      uint64_t x[kSegItems], c[kSegItems];
      if (q.values != nullptr) {
        load_raw(q.type, q.values, r0, n, x);
      } else {
#pragma unroll
        for (int j = 0; j < kSegItems; ++j) x[j] = 0;
      }
      uint32_t top = 0;
      thread_contribs<PHASE>(q, w, not_null, h, r0, n, g0, out_cap, extremes + r * out_cap, x, c,
                             &top);
      if (q.kind == hopper::kSumFloat) {
        top = __reduce_max_sync(0xffffffffu, top);
        if (lane == 0) top_s[bi][warp] = top;
      }
      uint64_t before, run;
      with_kind(PHASE == 0 ? q.kind : hopper::combine_kind(q.kind, q.identity), [&](auto tag) {
        thread_runs<decltype(tag)::kind>(c, static_cast<uint64_t>(q.identity), h, g0, out_cap,
                                         res + r * out_cap, &before, &run);
      });
      run_s[bi][threadIdx.x + (threadIdx.x >> 3)] = run;
      before_s[bi][threadIdx.x] = before;
    }
    __syncthreads();
    if (warp < nb) {  // B
      const int r = plan.order[first + k0 + warp];
      const AggRequest& q = reqs.req[r];
      uint64_t incl = 0;
      with_kind(PHASE == 0 ? q.kind : hopper::combine_kind(q.kind, q.identity), [&](auto tag) {
        incl = carry_scan<decltype(tag)::kind>(run_s[warp], seen_s,
                                               static_cast<uint64_t>(q.identity));
      });
      if (lane == 31) {
        if (tile_heads > 0) {
          tail[r * n_tiles + tile] = incl;  // from the tile's last head to its end
        } else {
          head[r * n_tiles + tile] = incl;  // the whole tile
        }
      }
      if (q.kind == hopper::kSumFloat) {
        const uint32_t m = __reduce_max_sync(0xffffffffu, lane < kWarps ? top_s[warp][lane] : 0u);
        if (lane == 0) tiletop[r * n_tiles + tile] = m;
      }
    }
    __syncthreads();
    if (nh > 0) {  // C
      for (int bi = 0; bi < nb; ++bi) {
        // the group that ends at this thread's first head: complete if its
        // head lies in this tile, else the tile's head partial
        const int r = plan.order[first + k0 + bi];
        const uint64_t total = combine(hopper::combine_kind(reqs.req[r].kind,
                                                            reqs.req[r].identity),
                                       run_s[bi][threadIdx.x + (threadIdx.x >> 3)],
                                       before_s[bi][threadIdx.x]);
        if (g0 >= b) {
          if (g0 < out_cap) res[r * out_cap + g0] = total;
        } else {
          head[r * n_tiles + tile] = total;
        }
      }
    }
  }
}

// The span pass's scan of one request's head partials h over the tiles
// into hs (the kind's reduction, a restart after each tile with a head).
template <int KIND>
__device__ __forceinline__ void span_scan(uint64_t ident, const uint64_t* __restrict__ h,
                                          uint64_t* __restrict__ hs,
                                          const int64_t* __restrict__ base, int64_t n_tiles,
                                          uint64_t* incl) {
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
      if (threadIdx.x == 0 && j == 0 && !f[0]) v[0] = combine_of<KIND>(carry, v[0]);
      if (f[j]) {
        run = v[j];
        any = true;
      } else {
        run = combine_of<KIND>(run, v[j]);
      }
      v[j] = run;
      f[j] = any;  // from here on: whether a restart lies in this thread up to j
    }
    const uint64_t inc = seg_scan_op<KIND>(any, run);
    incl[threadIdx.x] = inc;
    __syncthreads();
    const uint64_t prefix = threadIdx.x == 0 ? ident : incl[threadIdx.x - 1];
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      const int64_t t = c0 + static_cast<int64_t>(threadIdx.x) * kSegItems + j;
      if (t < n_tiles) hs[t] = f[j] ? v[j] : combine_of<KIND>(prefix, v[j]);
    }
    carry = incl[kThreads - 1];
    __syncthreads();  // incl is read before the next chunk writes it
  }
}

// Where slot g's group lies among the tiles: whether it is a group, and
// whether it ends in the tile ts of its start (else in tile te).
struct SlotSpan {
  bool real;
  bool inside;
  int64_t start;
  int64_t ts;
  int64_t te;
};

__device__ __forceinline__ SlotSpan slot_span(int64_t g, int64_t total, int64_t n,
                                              const int64_t* __restrict__ starts) {
  SlotSpan sp;
  sp.real = g < total;
  sp.start = sp.real ? starts[g] : n;
  const int64_t e = g + 1 < total ? starts[g + 1] : n;
  sp.ts = sp.start / kSegRows;
  sp.inside = g + 1 < total && e < (sp.ts + 1) * kSegRows;
  sp.te = (e - 1) / kSegRows;
  return sp;
}

// Request r's value of slot g: its identity past the groups, a group
// complete inside a tile from its slot, else the tail partial of the
// start's tile, then the scanned head partials (hs) of the tiles up to the
// end's.
__device__ __forceinline__ uint64_t slot_value(const AggCombine& reqs, int r, int64_t g,
                                               const SlotSpan& sp, int64_t out_cap,
                                               int64_t n_tiles, const uint64_t* __restrict__ res,
                                               const uint64_t* __restrict__ hs,
                                               const uint64_t* __restrict__ tail) {
  if (!sp.real) return static_cast<uint64_t>(reqs.identity[r]);
  if (sp.inside) return res[r * out_cap + g];
  const uint64_t x = tail[r * n_tiles + sp.ts];
  return sp.te > sp.ts ? combine(reqs.kind[r], x, hs[r * n_tiles + sp.te]) : x;
}

// One request's partials, as the span pass reads them for the plain
// version's cumsum (its slices of res, head, hs, tail).
struct FloatParts {
  uint64_t* res;
  const uint64_t* head;
  const uint64_t* hs;
  const uint64_t* tail;
};

// A float sum's own value of real slot g (slot_value's).
__device__ __forceinline__ double own_sum(const FloatParts& fp, int64_t g, const SlotSpan& sp) {
  using hopper::agg::dadd;  // not CUDA's dadd of the global namespace
  if (sp.inside) return as_double(fp.res[g]);
  const double x = as_double(fp.tail[sp.ts]);
  return sp.te > sp.ts ? dadd(x, as_double(fp.hs[sp.te])) : x;
}

// A group's float sum from the plain version's csum at its start (cs) and
// end (ce) rows and its start row's double vs: the class of ce - cs + vs
// where that is not finite, else its own sum.
__device__ __forceinline__ uint64_t plain_class(double ce, double cs, double vs, double own) {
  using hopper::agg::dadd;
  using hopper::agg::dsub;
  const double d = dadd(dsub(ce, cs), vs);
  if (isnan(d)) return kNaNBits;
  return bits_of(isinf(d) ? d : own);
}

// The float sum request q's overflow path (one block): each real slot's
// value into res (see the header). tt (n_tiles doubles) takes the tile
// totals, then their exclusive prefix.
__device__ void follow_plain_cumsum(const AggRequest& q, const bool* __restrict__ active,
                                    const FloatParts& fp, const int64_t* __restrict__ base,
                                    const int64_t* __restrict__ starts, int64_t n,
                                    int64_t out_cap, int64_t n_tiles, double* __restrict__ tt) {
  using hopper::agg::dadd;
  using hopper::agg::dsub;
  const int64_t total = base[n_tiles];
  const int64_t slots = total < out_cap ? total : out_cap;
  if (n <= kOneScanRows) {  // one scan: the page in group order
    if (threadIdx.x != 0 || slots == 0) return;
    double run = 0.0;  // the rows before the first group
    for (int64_t t = 0; t < n_tiles; ++t) {
      run = dadd(run, as_double(fp.head[t]));
      if (base[t + 1] > base[t]) break;
    }
    for (int64_t g = 0; g < slots; ++g) {
      const SlotSpan sp = slot_span(g, total, n, starts);
      const double vs = as_double(contribution_of<hopper::kSumFloat>(q, active, sp.start));
      const double own = own_sum(fp, g, sp);
      const double ce = dadd(run, own);
      fp.res[g] = plain_class(ce, dadd(run, vs), vs, own);
      run = ce;
    }
    return;
  }
  // each tile's total: its head partial, the groups inside it, its tail
  for (int64_t b = threadIdx.x; b < n_tiles; b += kThreads) {
    double x = as_double(fp.head[b]);
    if (base[b + 1] > base[b]) {
      const int64_t last = base[b + 1] - 1 < out_cap ? base[b + 1] - 1 : out_cap;
      for (int64_t g = base[b]; g < last; ++g) x = dadd(x, as_double(fp.res[g]));
      x = dadd(x, as_double(fp.tail[b]));
    }
    tt[b] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // their exclusive prefix: cumsum less the total
    double c = 0.0;
    for (int64_t b = 0; b < n_tiles; ++b) {
      const double x = tt[b];
      c = dadd(c, x);
      tt[b] = dsub(c, x);
    }
  }
  __syncthreads();
  for (int64_t b = threadIdx.x; b < n_tiles; b += kThreads) {
    double within = as_double(fp.head[b]);
    const int64_t end = base[b + 1] < out_cap ? base[b + 1] : out_cap;
    for (int64_t g = base[b]; g < end; ++g) {
      const SlotSpan sp = slot_span(g, total, n, starts);
      const double vs = as_double(contribution_of<hopper::kSumFloat>(q, active, sp.start));
      const double own = own_sum(fp, g, sp);
      const double cs = dadd(tt[b], dadd(within, vs));
      double ce;
      if (sp.te == b) {
        within = dadd(within, own);
        ce = dadd(tt[b], within);
      } else {  // its rows in its end tile are that tile's head partial
        ce = dadd(tt[sp.te], as_double(fp.head[sp.te]));
      }
      fp.res[g] = plain_class(ce, cs, vs, own);
    }
  }
}

// One block a request: the head partials scanned into hs, for each tile t
// the combination of the head partials of the tiles since the last tile
// with a head before t (a segmented scan over the tiles, restarting after
// each tile with a head), so a group that runs from tile ts to tile te
// reads its tail partial and the scan at te: two loads however many tiles
// it spans. A float sum's block (out_cap > 1) also bounds the magnitudes
// of its doubles from the tiles' largest high words (tiletop); where the
// bound passes 2^1022 or is not finite, it sets big[r] and writes every
// real slot's value into res by follow_plain_cumsum, tiletop taking its
// tile totals.
__global__ void __launch_bounds__(kThreads)
agg_span_kernel(AggRequestSet reqs, const bool* __restrict__ active, int phase,
                const int64_t* __restrict__ base, const int64_t* __restrict__ starts, int64_t n,
                int64_t out_cap, int64_t n_tiles, uint64_t* __restrict__ res,
                const uint64_t* __restrict__ head, uint64_t* __restrict__ hs,
                const uint64_t* __restrict__ tail, int64_t* __restrict__ tiletop,
                int64_t* __restrict__ big) {
  __shared__ uint64_t incl[kThreads];
  __shared__ double warp_sum[kWarps];
  const int r = blockIdx.x;
  const AggRequest& q = reqs.req[r];
  const int kind = q.kind;
  if (!in_phase(kind, phase)) return;  // the other round's request
  const int64_t off = static_cast<int64_t>(r) * n_tiles;
  with_kind(hopper::combine_kind(kind, q.identity), [&](auto tag) {
    span_scan<decltype(tag)::kind>(static_cast<uint64_t>(q.identity), head + off, hs + off,
                                   base, n_tiles, incl);
  });
  if (kind != hopper::kSumFloat) return;
  // kSegRows times the largest double of each tile's high word, summed
  double bound = 0.0;
  for (int64_t t = threadIdx.x; t < n_tiles; t += kThreads) {
    const uint64_t top = static_cast<uint64_t>(tiletop[off + t]);
    bound += as_double(top << 32 | 0xffffffffull) * kSegRows;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bound += __shfl_down_sync(0xffffffffu, bound, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = bound;
  __syncthreads();
  bound = 0.0;
  for (int w = 0; w < kWarps; ++w) bound += warp_sum[w];
  const bool follow = out_cap > 1 && !(bound <= 0x1p1022);
  if (threadIdx.x == 0) big[r] = follow;
  if (!follow) return;
  FloatParts fp;
  fp.res = res + static_cast<int64_t>(r) * out_cap;
  fp.head = head + off;
  fp.hs = hs + off;
  fp.tail = tail + off;
  follow_plain_cumsum(q, active, fp, base, starts, n, out_cap, n_tiles,
                      reinterpret_cast<double*>(tiletop + off));
}


// One thread a slot: each second-round request's extreme (its ref's value:
// min_by/max_by's order key, a tied request's hi limb) for the second
// round.
__global__ void __launch_bounds__(kThreads)
agg_resolve_kernel(AggCombine reqs, int64_t n, int64_t out_cap, int64_t n_tiles,
                   const int64_t* __restrict__ base, const int64_t* __restrict__ starts,
                   const uint64_t* __restrict__ res, const uint64_t* __restrict__ hs,
                   const uint64_t* __restrict__ tail, uint64_t* __restrict__ extremes) {
  const int64_t total = base[n_tiles];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < out_cap;
       g += stride) {
    const SlotSpan sp = slot_span(g, total, n, starts);
    for (int r = 0; r < reqs.n; ++r) {
      if (reqs.ref[r] < 0) continue;
      extremes[r * out_cap + g] =
          slot_value(reqs, reqs.ref[r], g, sp, out_cap, n_tiles, res, hs, tail);
    }
  }
}

// One thread a slot: the group's value of every request (a float sum
// whose span pass followed the plain cumsum, big[r], from its slot), the
// keys, the outputs, group_exists and the destination. A slot past
// num_groups writes zero data and no validity, without finishing.
__global__ void __launch_bounds__(kThreads)
agg_finish_kernel(AggCombine reqs, AggOutputSet outs, GroupKeySet keys, int64_t n,
                  int64_t out_cap, int64_t n_tiles, const int64_t* __restrict__ base,
                  const int64_t* __restrict__ num_groups, int64_t* __restrict__ starts,
                  const uint64_t* __restrict__ res, const uint64_t* __restrict__ hs,
                  const uint64_t* __restrict__ tail, const int64_t* __restrict__ big,
                  bool* __restrict__ group_exists, int32_t* __restrict__ dest) {
  const int64_t total = base[n_tiles];
  const int64_t ng = *num_groups;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < out_cap;
       g += stride) {
    const bool exists = g < ng;
    const SlotSpan sp = slot_span(g, total, n, starts);
    if (!sp.real) starts[g] = n;
    const int64_t at = sp.start < n - 1 ? sp.start : n - 1;
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
    if (!exists) {
      for (int o = 0; o < outs.n; ++o) {
        const AggOutput& out = outs.out[o];
        if (out.op == hopper::kDigest) continue;  // the digest pass writes it
        if (out.op == hopper::kInt128) {
          static_cast<int64_t*>(out.data)[2 * g] = 0;
          static_cast<int64_t*>(out.data)[2 * g + 1] = 0;
        } else {
          store_value(out.data, out.out_type, g, 0ull, false);
        }
        out.valid[g] = false;
      }
      continue;
    }
    uint64_t v[hopper::kMaxAggRequests];
    for (int r = 0; r < reqs.n; ++r) {
      v[r] = reqs.kind[r] == hopper::kSumFloat && big[r] && sp.real
                 ? res[r * out_cap + g]
                 : slot_value(reqs, r, g, sp, out_cap, n_tiles, res, hs, tail);
    }
    for (int o = 0; o < outs.n; ++o) {
      hopper::agg::finish_output(outs.out[o], v, g, n, sp.start);
    }
  }
}

// The bucket of the participant at row p of a group that starts at row
// ``start`` and has ``cnt`` participants (executor's tdigest_fn): each
// operation rounded on its own, the division by pi a product with its
// reciprocal (torch divides by a scalar so on the card).
__device__ __forceinline__ int digest_bucket(int64_t p, int64_t start, double cnt) {
  // the rounding helpers, not CUDA's dadd/dmul of the global namespace
  using hopper::agg::dadd;
  using hopper::agg::ddiv;
  using hopper::agg::dmul;
  using hopper::agg::dsub;
  const double q = ddiv(dadd(static_cast<double>(p - start), 0.5), cnt);
  double t = dsub(dmul(2.0, q), 1.0);
  t = t < -1.0 ? -1.0 : (t > 1.0 ? 1.0 : t);
  const double scale = dadd(0.5, dmul(asin(t), 1.0 / 3.141592653589793));
  const int b = static_cast<int>(dmul(scale, static_cast<double>(hopper::kDigestCentroids)));
  return b < 0 ? 0 : (b > hopper::kDigestCentroids - 1 ? hopper::kDigestCentroids - 1 : b);
}

// One block a slot: the digest output ``out`` (its count request
// out.reads[0]) from the sorted values, whose participants are the first
// rows of the group's rows (from row 0 for the first group, whose rows
// before its start are never weighted).
__global__ void __launch_bounds__(kThreads)
agg_digest_kernel(AggCombine reqs, AggOutput out, int64_t n, int64_t out_cap, int64_t n_tiles,
                  const int64_t* __restrict__ base, const int64_t* __restrict__ starts,
                  const uint64_t* __restrict__ res, const uint64_t* __restrict__ hs,
                  const uint64_t* __restrict__ tail) {
  using hopper::agg::dadd;
  using hopper::agg::ddiv;
  using hopper::agg::dmul;
  constexpr int kC = hopper::kDigestCentroids;
  __shared__ int64_t bound[kC + 1];
  const int64_t g = blockIdx.x;
  const SlotSpan sp = slot_span(g, base[n_tiles], n, starts);
  const int64_t cnt = sp.real ? static_cast<int64_t>(
                                    slot_value(reqs, out.reads[0], g, sp, out_cap, n_tiles, res,
                                               hs, tail))
                              : 0;
  double* data = static_cast<double*>(out.data) + g * 2 * kC;
  if (cnt <= 0) {
    for (int k = threadIdx.x; k < 2 * kC; k += kThreads) data[k] = 0.0;
    if (threadIdx.x == 0) out.valid[g] = false;
    return;
  }
  const int64_t begin = g == 0 ? 0 : sp.start;
  const double n_g = static_cast<double>(cnt);
  if (threadIdx.x <= kC) {
    // boundary k: the first participant whose bucket is k or more
    const int k = threadIdx.x;
    int64_t lo = begin, hi = begin + cnt;
    if (k > 0 && k < kC) {
      while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (digest_bucket(mid, sp.start, n_g) >= k) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
    }
    bound[k] = k == kC ? begin + cnt : lo;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = warp; k < kC; k += kWarps) {
    const int64_t b0 = bound[k], b1 = bound[k + 1];
    double s = 0.0;
    for (int64_t p = b0 + lane; p < b1; p += 32) {
      double x = load_double(out.values_type, out.first_values, p);
      if (out.divisor != 1.0) x = dmul(x, 1.0 / out.divisor);
      s = dadd(s, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = dadd(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      const int64_t c = b1 - b0;
      data[k] = c > 0 ? ddiv(s, static_cast<double>(c)) : 0.0;
      data[kC + k] = static_cast<double>(c);
    }
  }
  if (threadIdx.x == 0) out.valid[g] = true;
}

}  // namespace

extern "C" int segment_agg_max_requests() { return hopper::kMaxAggRequests; }

extern "C" int segment_agg_max_outputs() { return hopper::kMaxAggOutputs; }

extern "C" int segment_agg_max_reads() { return hopper::kMaxAggReads; }

// The plan structs' sizes, which the wrapper's ctypes layouts must match.
extern "C" int segment_agg_request_bytes() { return sizeof(hopper::AggRequest); }

extern "C" int segment_agg_output_bytes() { return sizeof(hopper::AggOutput); }

// Kernel launches issued by segment_agg since the library was loaded.
static std::atomic<int64_t> g_agg_stream_ops{0};

extern "C" int64_t segment_agg_stream_ops() { return g_agg_stream_ops.load(); }

// Words of segment_agg's ``partials`` for ``nr`` requests: each request's
// complete groups (out_cap), head partials, their scan, tail partials and
// largest high words (n_tiles each), whether it followed the plain cumsum,
// then with a min_by/max_by or tied request (``match``) its extremes
// (out_cap).
extern "C" int64_t segment_agg_partial_words(int nr, int64_t n, int64_t out_cap, int match) {
  const int64_t n_tiles = (n + kSegRows - 1) / kSegRows;
  return static_cast<int64_t>(nr) * (out_cap + 4 * n_tiles + 1 + (match ? out_cap : 0));
}

extern "C" int segment_agg_max_masks() { return kMaxMasks; }

// The reduce pass's plan: the distinct bool columns of the requests'
// weights (the activity first) and each round's requests. False where the
// columns are more than kMaxMasks (the wrapper raises before that).
static bool tile_plan(const hopper::AggRequestSet* reqs, const bool* active, TilePlan* out) {
  TilePlan plan{};
  plan.col[0] = active;
  plan.n_cols = 1;
  auto column = [&](const bool* c) {
    for (int k = 0; k < plan.n_cols; ++k) {
      if (plan.col[k] == c) return k;
    }
    if (plan.n_cols == kMaxMasks) return -1;
    plan.col[plan.n_cols] = c;
    return plan.n_cols++;
  };
  int at = 0;
  for (int round = 0; round < 2; ++round) {
    for (int r = 0; r < reqs->n; ++r) {
      const hopper::AggRequest& q = reqs->req[r];
      if (hopper::second_round(q.kind) != (round == 1)) continue;
      plan.order[at++] = static_cast<int8_t>(r);
      ++plan.n_round[round];
      const bool checksum = q.kind == hopper::kChecksum;
      uint32_t bits = q.resorted ? 0u : 1u;
      for (const bool* c : {q.filter, q.filter_valid, checksum ? nullptr : q.valid, q.valid2}) {
        if (c == nullptr) continue;
        const int k = column(c);
        if (k < 0) return false;
        bits |= 1u << k;
      }
      plan.null_col[r] = -1;
      if (checksum && q.valid != nullptr) {
        const int k = column(q.valid);
        if (k < 0) return false;
        plan.null_col[r] = static_cast<int8_t>(k);
      }
      plan.bits[r] = bits;
      plan.round_cols[round] |= bits | (plan.null_col[r] >= 0 ? 1u << plan.null_col[r] : 0u);
    }
  }
  *out = plan;
  return true;
}

// Records event k of ``events`` (none where null) on stream s.
static void mark(void* const* events, int k, cudaStream_t s) {
  if (events != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(events[k]), s);
}

// The whole reduction on ``stream``. ``scratch`` (int64 [2 * n_tiles + 1])
// holds the tiles' head counts and bases; ``starts`` (int64 [out_cap + 1]);
// ``partials`` (segment_agg_partial_words). Every output is written for all
// out_cap slots. ``events`` (7, or null) are recorded at the bounds of the
// count, scan, reduce, span, second round (resolve, reduce, span; empty
// without a min_by/max_by request) and finish (with the digest passes).
// Returns the first CUDA error, 0 on success.
extern "C" int segment_agg(const hopper::AggRequestSet* reqs, const hopper::AggOutputSet* outs,
                           const hopper::GroupKeySet* keys, const void* new_group,
                           const void* active, const void* num_groups, int64_t n,
                           int64_t out_cap, void* scratch, void* starts, void* partials,
                           void* group_exists, void* dest, void* const* events, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || out_cap <= 0) return 0;
  const int64_t n_tiles = (n + kSegRows - 1) / kSegRows;
  int64_t* heads = static_cast<int64_t*>(scratch);
  int64_t* base = heads + n_tiles;
  uint64_t* res = static_cast<uint64_t*>(partials);
  const int64_t nr = reqs->n;
  uint64_t* head = res + nr * out_cap;
  uint64_t* hs = head + nr * n_tiles;
  uint64_t* tail = hs + nr * n_tiles;
  int64_t* tiletop = reinterpret_cast<int64_t*>(tail + nr * n_tiles);
  int64_t* big = tiletop + nr * n_tiles;
  uint64_t* extremes = reinterpret_cast<uint64_t*>(big + nr);
  const bool* ng = static_cast<const bool*>(new_group);
  int64_t* st = static_cast<int64_t*>(starts);
  TilePlan plan;
  if (!tile_plan(reqs, static_cast<const bool*>(active), &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AggCombine comb{};
  comb.n = reqs->n;
  bool match = false;
  for (int r = 0; r < reqs->n; ++r) {
    comb.identity[r] = reqs->req[r].identity;
    comb.kind[r] = hopper::combine_kind(reqs->req[r].kind, reqs->req[r].identity);
    comb.ref[r] = hopper::second_round(reqs->req[r].kind) ? reqs->req[r].ref : -1;
    match = match || hopper::second_round(reqs->req[r].kind);
  }
  mark(events, 0, s);
  agg_count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(ng, n, heads);
  ++g_agg_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mark(events, 1, s);
  agg_scan_kernel<<<1, kThreads, 0, s>>>(heads, n_tiles, base);
  ++g_agg_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  mark(events, 2, s);
  for (int phase = 0; phase < (match ? 2 : 1); ++phase) {
    if (phase == 1) {
      agg_resolve_kernel<<<hopper::grid_for(out_cap), kThreads, 0, s>>>(
          comb, n, out_cap, n_tiles, base, st, res, hs, tail, extremes);
      ++g_agg_stream_ops;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    if (phase == 0) {
      agg_reduce_kernel<0><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
          *reqs, plan, ng, n, out_cap, n_tiles, base, st, res, head, tail, tiletop, extremes);
    } else {
      agg_reduce_kernel<1><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
          *reqs, plan, ng, n, out_cap, n_tiles, base, st, res, head, tail, tiletop, extremes);
    }
    ++g_agg_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (phase == 0) mark(events, 3, s);
    if (nr > 0) {
      agg_span_kernel<<<static_cast<unsigned>(nr), kThreads, 0, s>>>(
          *reqs, static_cast<const bool*>(active), phase, base, st, n, out_cap, n_tiles, res,
          head, hs, tail, tiletop, big);
      ++g_agg_stream_ops;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    if (phase == 0) mark(events, 4, s);
  }
  mark(events, 5, s);
  agg_finish_kernel<<<hopper::grid_for(out_cap), kThreads, 0, s>>>(
      comb, *outs, *keys, n, out_cap, n_tiles, base, static_cast<const int64_t*>(num_groups),
      st, res, hs, tail, big, static_cast<bool*>(group_exists),
      static_cast<int32_t*>(dest));
  ++g_agg_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int o = 0; o < outs->n; ++o) {
    if (outs->out[o].op != hopper::kDigest) continue;
    agg_digest_kernel<<<static_cast<unsigned>(out_cap), kThreads, 0, s>>>(
        comb, outs->out[o], n, out_cap, n_tiles, base, st, res, hs, tail);
    ++g_agg_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  mark(events, 6, s);
  return 0;
}
