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
//   group's extreme of an earlier request (min_by/max_by's row). An empty
//   group holds the request's identity.
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
// Bound on an H100 SXM (3.35 TB/s): bytes. Each request's columns read
// once, new_group read once, starts written and read once, the keys' bytes
// at out_cap rows, every output written once.
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
//   its reciprocal, as torch computes it on the card; every product, sum
//   and quotient of a finishing is rounded on its own (no contraction into
//   a fused multiply-add), as torch's one-operation kernels round them.
// A min_by/max_by request (kMatchLast) reads its group's extreme, so its
// rows are served by a second round: after the first reduce and span, a
// resolve pass (one thread a slot) writes each group's extreme, then a
// second reduce and span serve the match requests alone (eight launches).
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

#include "agg_common.cuh"
#include "join_keys.cuh"
#include "launch.cuh"
#include "partition_hash.cuh"

namespace {

using hopper::kThreads;
using hopper::kWarps;

constexpr int kSegItems = 8;                     // consecutive rows a thread
constexpr int kSegRows = kThreads * kSegItems;   // rows a tile

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
// Whether request kind ``kind`` is served in round ``phase`` (1: the
// min_by/max_by rows, which read the first round's extremes).
__device__ __forceinline__ bool in_phase(int kind, int phase) {
  return (kind == hopper::kMatchLast) == (phase == 1);
}

__global__ void __launch_bounds__(kThreads)
agg_reduce_kernel(AggRequestSet reqs, int phase, const bool* __restrict__ new_group,
                  const bool* __restrict__ active, int64_t n, int64_t out_cap, int64_t n_tiles,
                  const int64_t* __restrict__ base, int64_t* __restrict__ starts,
                  uint64_t* __restrict__ res, uint64_t* __restrict__ head,
                  uint64_t* __restrict__ tail, const uint64_t* __restrict__ extremes) {
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
  if (phase == 0) {
    int64_t g = g0;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      if (h[j] && ++g <= out_cap) starts[g] = r0 + j;
    }
  }
  for (int r = 0; r < reqs.n; ++r) {
    const AggRequest& q = reqs.req[r];
    if (!in_phase(q.kind, phase)) continue;  // uniform over the block
    const uint64_t ident = static_cast<uint64_t>(q.identity);
    uint64_t c[kSegItems];
    if (phase == 1) {
      // each row against its group's extreme (a row of no group: none)
      const uint64_t* ext = extremes + static_cast<int64_t>(r) * out_cap;
      int64_t gj = g0;
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) {
        gj += h[j];
        c[j] = r0 + j < n && gj >= 0 && gj < out_cap ? contribution(q, active, r0 + j, ext + gj)
                                                     : ident;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) {
        c[j] = r0 + j < n ? contribution(q, active, r0 + j) : ident;
      }
    }
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
agg_span_kernel(AggCombine reqs, int phase, const int64_t* __restrict__ base, int64_t n_tiles,
                uint64_t* __restrict__ head) {
  __shared__ uint64_t incl[kThreads];
  const int kind = reqs.kind[blockIdx.x];
  if (!in_phase(kind, phase)) return;  // the other round's request
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
// start's tile, then the scanned head partials of the tiles up to the
// end's.
__device__ __forceinline__ uint64_t slot_value(const AggCombine& reqs, int r, int64_t g,
                                               const SlotSpan& sp, int64_t out_cap,
                                               int64_t n_tiles, const uint64_t* __restrict__ res,
                                               const uint64_t* __restrict__ head,
                                               const uint64_t* __restrict__ tail) {
  if (!sp.real) return static_cast<uint64_t>(reqs.identity[r]);
  if (sp.inside) return res[r * out_cap + g];
  const uint64_t x = tail[r * n_tiles + sp.ts];
  return sp.te > sp.ts ? combine(reqs.kind[r], x, head[r * n_tiles + sp.te]) : x;
}

// One thread a slot: each min_by/max_by request's extreme (its ref's value)
// for the second round.
__global__ void __launch_bounds__(kThreads)
agg_resolve_kernel(AggCombine reqs, int64_t n, int64_t out_cap, int64_t n_tiles,
                   const int64_t* __restrict__ base, const int64_t* __restrict__ starts,
                   const uint64_t* __restrict__ res, const uint64_t* __restrict__ head,
                   const uint64_t* __restrict__ tail, uint64_t* __restrict__ extremes) {
  const int64_t total = base[n_tiles];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < out_cap;
       g += stride) {
    const SlotSpan sp = slot_span(g, total, n, starts);
    for (int r = 0; r < reqs.n; ++r) {
      if (reqs.kind[r] != hopper::kMatchLast) continue;
      extremes[r * out_cap + g] =
          slot_value(reqs, reqs.ref[r], g, sp, out_cap, n_tiles, res, head, tail);
    }
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
    uint64_t v[hopper::kMaxAggRequests];
    for (int r = 0; r < reqs.n; ++r) {
      v[r] = slot_value(reqs, r, g, sp, out_cap, n_tiles, res, head, tail);
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
                  const uint64_t* __restrict__ res, const uint64_t* __restrict__ head,
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
                                               head, tail))
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

// The whole reduction on ``stream``. ``scratch`` (int64 [2 * n_tiles + 1])
// holds the tiles' head counts and bases; ``starts`` (int64 [out_cap + 1]);
// ``partials`` (uint64 [requests * (out_cap + 2 * n_tiles)], and requests *
// out_cap more with a min_by/max_by request): the complete groups' values,
// the head and the tail partials, then the extremes the second round
// reads. Every output is written for all out_cap slots. Returns the first
// CUDA error, 0 on success.
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
  uint64_t* extremes = tail + nr * n_tiles;
  const bool* ng = static_cast<const bool*>(new_group);
  const bool* act = static_cast<const bool*>(active);
  int64_t* st = static_cast<int64_t*>(starts);
  AggCombine comb{};
  comb.n = reqs->n;
  bool match = false;
  for (int r = 0; r < reqs->n; ++r) {
    comb.identity[r] = reqs->req[r].identity;
    comb.kind[r] = reqs->req[r].kind;
    comb.ref[r] = reqs->req[r].ref;
    match = match || reqs->req[r].kind == hopper::kMatchLast;
  }
  agg_count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(ng, n, heads);
  ++g_agg_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  agg_scan_kernel<<<1, kThreads, 0, s>>>(heads, n_tiles, base);
  ++g_agg_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int phase = 0; phase < (match ? 2 : 1); ++phase) {
    if (phase == 1) {
      agg_resolve_kernel<<<hopper::grid_for(out_cap), kThreads, 0, s>>>(
          comb, n, out_cap, n_tiles, base, st, res, head, tail, extremes);
      ++g_agg_stream_ops;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    agg_reduce_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
        *reqs, phase, ng, act, n, out_cap, n_tiles, base, st, res, head, tail, extremes);
    ++g_agg_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (nr > 0) {
      agg_span_kernel<<<static_cast<unsigned>(nr), kThreads, 0, s>>>(comb, phase, base, n_tiles,
                                                                      head);
      ++g_agg_stream_ops;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  agg_finish_kernel<<<hopper::grid_for(out_cap), kThreads, 0, s>>>(
      comb, *outs, *keys, n, out_cap, n_tiles, base, static_cast<const int64_t*>(num_groups),
      st, res, head, tail, static_cast<bool*>(group_exists), static_cast<int32_t*>(dest));
  ++g_agg_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int o = 0; o < outs->n; ++o) {
    if (outs->out[o].op != hopper::kDigest) continue;
    agg_digest_kernel<<<static_cast<unsigned>(out_cap), kThreads, 0, s>>>(
        comb, outs->out[o], n, out_cap, n_tiles, base, st, res, head, tail);
    ++g_agg_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
