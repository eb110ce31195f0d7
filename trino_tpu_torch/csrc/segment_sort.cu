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
// written once.
//
// Design: each group's rows are a segment of the page (the first one from
// row 0), and only a segment's rows are sorted, by its key (w, v): w the
// one bit ~weight where the weight sorts (participants first and neither
// all nor no rows weighted), v = order key - least order key in
// bit_length(largest - least) bits. No key holds the group.
//   1. segment_sort_stats, five launches: over tiles of kTileRows rows the
//      least and largest order key, the weighted rows and each tile's
//      head count; one block scans the counts into each tile's first
//      group; a pass writes each segment's first row (int32) and the
//      page's first head; one thread a segment appends each segment of
//      more than kCap rows to the large segments of level 0. The wrapper
//      reads the stats (one host read).
//   2. segment_sort_small, one launch: one block a tile takes the
//      segments of at most kCap rows whose first row lies in the tile
//      (reading past its end to its last segment's end), in batches of
//      whole consecutive segments of at most kCap rows: it loads each
//      row's v and a 32-bit word (its row in the batch, its weight, and
//      above them the key's high part: its segment in the batch, then w)
//      into shared memory, sorts them by (high part, v) with a stable LSD
//      radix sort of eight-bit digits (block_sort: each warp ranks its
//      contiguous rows by digit (eight ballots a step), the warps' counts are
//      combined in warp order), and writes the sorted values (gathered at
//      their rows), the weight and the run heads (a row against the one
//      before it in the batch; a batch starts a segment).
//   3. segment_sort_large, for the segments over kCap rows (none: no
//      launch): levels of a stable MSD pass over eight-bit digits of (w,
//      v), most significant first. A level takes its items (ranges of rows
//      whose keys share every digit above the level's) in chunks of kChunk
//      rows: a count (each chunk's digit counts, and whether the chunk's
//      keys of a digit are all equal), a bucket pass (one block an item:
//      the chunks' offsets of each digit in place, then the item's buckets
//      in digit order: consecutive buckets of at most kCap rows packed
//      into batches of at most kCap rows, a bucket over kCap rows whose
//      keys are all equal (or that the last digit ends) copied as it stands
//      in pieces of kCap rows, any other an item of the next level), and a
//      scatter (each chunk ranks its rows by digit as block_sort does,
//      stages them in digit order in shared memory and writes each
//      digit's run to its bucket in the level's buffer of v and the weight
//      byte: v is the value's bits, as the order key is a bijection). Then
//      one block a batch sorts it by block_sort, by (the row's digit less
//      the batch's first, the bits below the digit), writes each value
//      from its v, and a last pass sets the run head of each batch that
//      does not open its segment from the row before it in the sorted
//      page. The levels' sizes live on the card: their launches are
//      grid-stride loops over counts that the passes before them wrote.
// Row indices are int32 (the wrapper raises at 2^31 rows). No library sort
// is called.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "agg_common.cuh"
#include "launch.cuh"
#include "radix_pass.cuh"
#include "segment_rows.cuh"

namespace {

using hopper::kThreads;
using hopper::kWarps;
using hopper::WeightSet;
using hopper::radix::block_scan_excl;
using hopper::radix::kDigits;
using hopper::radix::kNoDigit;
using hopper::radix::warp_offsets;
using hopper::rows::kItems;
using hopper::rows::kTileRows;

// rows one block sorts at once: a row's place in its batch takes kIdxBits
// bits of its word, its weight the next bit, the key's high part the rest
constexpr int kCap = 4096;
constexpr int kIdxBits = 12;
static_assert(kCap == 1 << kIdxBits, "a batch row's index fills kIdxBits bits");
constexpr uint32_t kIdxMask = kCap - 1;
constexpr int kWeightBit = kIdxBits;
constexpr int kHighShift = kIdxBits + 1;
// 32 rows a warp step: at most kSortSteps steps a warp
constexpr int kSortSteps = kCap / kThreads;
// rows a thread loads or writes at once (its loads in flight together)
constexpr int kRound = 8;
static_assert(kTileRows <= kCap, "a segment that starts and ends in a tile fits a batch");
// rows of one block of a large segment's count and scatter passes
constexpr int kChunk = 4096;
constexpr int kChunkSteps = kChunk / kThreads;
// (w, v) takes at most 65 bits: nine eight-bit levels
constexpr int kMaxLevels = 9;
constexpr int kChunkShift = 40;            // a list word: items << 40 | chunks
constexpr unsigned long long kChunkMask = (1ull << kChunkShift) - 1;

// The stats words (int64): the order keys' least and largest, the weighted
// rows, the groups, the rows of the large segments, the page's first head
// row (-1: none), whether any segment is small, each level's list word
// (items << kChunkShift | chunks), the batches of the large segments.
enum StatWord : int {
  kLo = 0, kHi = 1, kWeighted = 2, kGroups = 3, kLargeRows = 4, kFirstHead = 5, kAnySmall = 6,
  kList = 8, kEntries = kList + kMaxLevels + 1, kStatWords = kEntries + 1,
};

// A range of rows of a level: its first row (in the level's input), its
// rows, its first chunk, and whether it opens its segment.
struct Item {
  int64_t start;
  int32_t len;
  int32_t opens;
  int64_t chunk0;
};

// A batch of a large segment: its rows, the bits below its level's digit
// (sh) and the digit's width, its first bucket's digit (d0) and
// bit_length(last digit - d0) (span: 0 for one bucket), the buffer that
// holds it (flag bit 0), whether it opens its segment (bit 1) and the span
// (bits 4-7). It sorts by (digit - d0, the low sh bits of v); a copied
// bucket has sh and span 0.
struct Entry {
  int64_t start;
  int32_t len;
  uint8_t sh;
  uint8_t width;
  uint8_t d0;
  uint8_t flags;
};

std::atomic<int64_t> g_stream_ops{0};

__device__ __forceinline__ int64_t okey(int type, const void* values, int64_t i) {
  return hopper::agg::order_key(type, values, i);
}

__device__ __forceinline__ int bit_length(uint64_t x) { return x == 0 ? 0 : 64 - __clzll(x); }

// kernels.order_key of element i of a column of T (a bool as a byte).
template <typename T>
__device__ __forceinline__ int64_t key_as(const void* p, int64_t i) {
  const T x = static_cast<const T*>(p)[i];
  if constexpr (std::is_same_v<T, double>) {
    return hopper::float_order_key(x);
  } else if constexpr (std::is_same_v<T, float>) {
    return hopper::float_order_key(static_cast<double>(x));
  } else if constexpr (std::is_same_v<T, uint8_t>) {
    return x ? 1 : 0;
  } else {
    return static_cast<int64_t>(x);
  }
}

// Rows at(s), s < S, of the page (at(s) a row of it, past the rows wanted
// the last one): v = order key - lo and the weight. The value's type is
// chosen once, so every load of the S rows is issued before any is used.
template <typename K, int S, typename At>
__device__ __forceinline__ void load_rows(const void* values, int type, const WeightSet& ws,
                                          int64_t lo, At at, K (&v)[S], bool (&w)[S]) {
  auto keys = [&](auto tag) {
    using T = decltype(tag);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v[s] = static_cast<K>(static_cast<uint64_t>(key_as<T>(values, at(s))) -
                            static_cast<uint64_t>(lo));
    }
  };
  switch (type) {
    case hopper::kF64: keys(double{}); break;
    case hopper::kF32: keys(float{}); break;
    case hopper::kI64: keys(int64_t{}); break;
    case hopper::kI32: keys(int32_t{}); break;
    case hopper::kI16: keys(int16_t{}); break;
    case hopper::kI8: keys(int8_t{}); break;
    default: keys(uint8_t{}); break;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) w[s] = true;
  for (int k = 0; k < ws.n; ++k) {
    const bool* c = ws.w[k];
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = w[s] & c[at(s)];
  }
}

// Row ``row`` of a column of KeyType ``type`` from its order key: the
// inverse of hopper::float_order_key for a double (a float32 through the
// double it widens to), the integer itself otherwise.
__device__ __forceinline__ void store_key(void* out, int type, int64_t row, int64_t key) {
  const long long bits = key >= 0 ? key : ~(key ^ static_cast<long long>(1ull << 63));
  switch (type) {
    case hopper::kF64: static_cast<double*>(out)[row] = __longlong_as_double(bits); break;
    case hopper::kF32:
      static_cast<float*>(out)[row] = static_cast<float>(__longlong_as_double(bits));
      break;
    case hopper::kI64: static_cast<int64_t*>(out)[row] = key; break;
    case hopper::kI32: static_cast<int32_t*>(out)[row] = static_cast<int32_t>(key); break;
    case hopper::kI16: static_cast<int16_t*>(out)[row] = static_cast<int16_t>(key); break;
    case hopper::kI8: static_cast<int8_t*>(out)[row] = static_cast<int8_t>(key); break;
    default: static_cast<uint8_t*>(out)[row] = key != 0; break;
  }
}

// out[dst(s)] = values[src(s)] for s < S where ok(s), elements of
// elem_bytes (src(s) a row of values whatever ok(s)): the S loads go out
// before the stores.
template <int S, typename Src, typename Dst, typename Ok>
__device__ __forceinline__ void move_rows(const void* values, void* out, int elem_bytes, Src src,
                                          Dst dst, Ok ok) {
  auto go = [&](auto tag) {
    using T = decltype(tag);
    T x[S];
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = static_cast<const T*>(values)[src(s)];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (ok(s)) static_cast<T*>(out)[dst(s)] = x[s];
    }
  };
  switch (elem_bytes) {
    case 1: go(uint8_t{}); break;
    case 2: go(uint16_t{}); break;
    case 4: go(uint32_t{}); break;
    default: go(uint64_t{}); break;
  }
}

// bits [sh, sh + width) of (w << vb) | v (width <= 8, sh < vb + 1)
template <typename K>
__device__ __forceinline__ uint32_t key_digit(uint32_t w, K v, int vb, int sh, int width) {
  const uint32_t mask = (1u << width) - 1u;
  if (sh >= vb) return (w >> (sh - vb)) & mask;
  uint32_t d = static_cast<uint32_t>(v >> sh);
  if (sh + width > vb) d |= w << (vb - sh);
  return d & mask;
}

__global__ void sort_stats_init_kernel(int64_t* stats) {
  for (int k = threadIdx.x; k < kStatWords; k += blockDim.x) {
    stats[k] = k == kLo ? INT64_MAX : (k == kHi ? INT64_MIN : (k == kFirstHead ? -1 : 0));
  }
}

// One block a tile: heads[tile], and the tile's least and largest order
// key and weighted rows folded into stats with one atomic each.
__global__ void __launch_bounds__(kThreads)
sort_stats_kernel(const bool* __restrict__ new_group, const void* __restrict__ values, int type,
                  WeightSet ws, int64_t n, int64_t* __restrict__ heads,
                  int64_t* __restrict__ stats) {
  __shared__ int64_t part[4][kWarps];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  auto at = [&](int j) {
    const int64_t i = t0 + threadIdx.x + j * kThreads;
    return i < n ? i : n - 1;
  };
  uint64_t key[kItems];
  bool w[kItems], h[kItems];
  load_rows<uint64_t, kItems>(values, type, ws, 0, at, key, w);
#pragma unroll
  for (int j = 0; j < kItems; ++j) h[j] = new_group[at(j)];
  int64_t lo = INT64_MAX, hi = INT64_MIN, nw = 0, nh = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (t0 + threadIdx.x + j * kThreads < n) {
      const int64_t k = static_cast<int64_t>(key[j]);
      lo = k < lo ? k : lo;
      hi = k > hi ? k : hi;
      nw += w[j];
      nh += h[j];
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
  if (lane == 0) {
    part[0][warp] = lo;
    part[1][warp] = hi;
    part[2][warp] = nw;
    part[3][warp] = nh;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo = part[0][w] < lo ? part[0][w] : lo;
      hi = part[1][w] > hi ? part[1][w] : hi;
      nw += part[2][w];
      nh += part[3][w];
    }
    heads[blockIdx.x] = nh;
    atomicMin(reinterpret_cast<long long*>(stats + kLo), static_cast<long long>(lo));
    atomicMax(reinterpret_cast<long long*>(stats + kHi), static_cast<long long>(hi));
    if (nw) atomicAdd(reinterpret_cast<unsigned long long*>(stats + kWeighted),
                      static_cast<unsigned long long>(nw));
  }
}

// One block a tile: segment k >= 1 starts at head k (seg_start[k], int32);
// segment 0 at row 0, and seg_start[segments] = n; the page's first head
// row and the group count into stats.
__global__ void __launch_bounds__(kThreads)
sort_starts_kernel(const bool* __restrict__ new_group, int64_t n,
                   const int64_t* __restrict__ base, int64_t n_tiles,
                   int32_t* __restrict__ seg_start, int64_t* __restrict__ stats) {
  const int64_t tile = blockIdx.x;
  const int64_t r0 = tile * kTileRows + static_cast<int64_t>(threadIdx.x) * kItems;
  bool h[kItems];
  int nh = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    h[j] = r0 + j < n && new_group[r0 + j];
    nh += h[j];
  }
  int64_t unused;
  int64_t k = base[tile] + hopper::rows::block_exclusive(nh, &unused);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!h[j]) continue;
    if (k == 0) {
      stats[kFirstHead] = r0 + j;
    } else {
      seg_start[k] = static_cast<int32_t>(r0 + j);
    }
    ++k;
  }
  if (tile == 0 && threadIdx.x == 0) {
    const int64_t total = base[n_tiles];
    seg_start[0] = 0;
    seg_start[total > 1 ? total : 1] = static_cast<int32_t>(n);
    stats[kGroups] = total;
  }
}

// One thread a segment: a segment of more than kCap rows becomes an item of
// level 0 (its chunks counted with it in one atomic word, so the items'
// first chunks ascend with their index); whether any is small.
__global__ void __launch_bounds__(kThreads)
sort_classify_kernel(const int32_t* __restrict__ seg_start, const int64_t* __restrict__ base,
                     int64_t n_tiles, Item* __restrict__ items, int64_t* __restrict__ stats) {
  const int64_t total = base[n_tiles];
  const int64_t segs = total > 1 ? total : 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  bool small = false;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; k < segs;
       k += stride) {
    const int64_t len = static_cast<int64_t>(seg_start[k + 1]) - seg_start[k];
    if (len <= kCap) {
      small = true;
      continue;
    }
    const unsigned long long chunks = (len + kChunk - 1) / kChunk;
    const unsigned long long old = atomicAdd(
        reinterpret_cast<unsigned long long*>(stats + kList), (1ull << kChunkShift) | chunks);
    Item it;
    it.start = seg_start[k];
    it.len = static_cast<int32_t>(len);
    it.opens = 1;
    it.chunk0 = static_cast<int64_t>(old & kChunkMask);
    items[old >> kChunkShift] = it;
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + kLargeRows),
              static_cast<unsigned long long>(len));
  }
  // segment_sort_small has work: one store a block
  if (__syncthreads_or(small) && threadIdx.x == 0) stats[kAnySmall] = 1;
}

// The lanes of the warp whose eight-bit digit d equals this lane's (eight
// ballots; a lane past the rows, kNoDigit, matches none that is not).
__device__ __forceinline__ unsigned digit_peers(uint32_t d) {
  unsigned peers = __ballot_sync(0xffffffffu, d != kNoDigit);
  if (d == kNoDigit) peers = ~peers;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned bal = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? bal : ~bal;
  }
  return peers;
}

// The warp's rows of digit d before this step's: the lowest lane of the
// step's peers adds them to the warp's running count cnt[d] and hands the
// old count to the others (a lane past the rows, !ok, adds nothing). The
// warp's steps go in order: each ends with __syncwarp, so the next step's
// atomic sees this one's.
__device__ __forceinline__ int32_t rank_of(int32_t* cnt, uint32_t d, unsigned peers, bool ok) {
  const int leader = __ffs(peers) - 1;
  int32_t before = 0;
  if (ok && (threadIdx.x & 31) == leader) before = atomicAdd(cnt + d, __popc(peers));
  before = __shfl_sync(0xffffffffu, before, leader);
  __syncwarp();
  return before;
}

// Shared memory of block_sort beside the rows: each warp's digit counts
// and the digits' starts.
struct SortShared {
  int32_t warp_cnt[kWarps][kDigits];
  int32_t start[kDigits];
};

// A stable LSD radix sort of ``rows`` (<= kCap) rows in shared memory by
// (high part, v): v_s[i] the row's v (lo_bits significant bits), word_s[i]
// its word, whose bits from kHighShift hold the high part (hi_bits bits).
// Eight-bit digits of v, then of the high part; each pass: every warp
// ranks its contiguous rows (a multiple of 32, in row order) by digit
// (digit_peers), the warps' counts of each digit become offsets in
// warp order, and every row moves to its place (its v and word held in
// registers across the pass).
template <typename K>
__device__ void block_sort(K* v_s, uint32_t* word_s, int rows, int lo_bits, int hi_bits,
                           SortShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int per = (rows + kThreads - 1) / kThreads * 32;  // rows a warp
  const int w0 = warp * per;
  const int lo_passes = (lo_bits + 7) / 8;
  const int passes = lo_passes + (hi_bits + 7) / 8;
  for (int p = 0; p < passes; ++p) {
    const bool high = p >= lo_passes;
    const int shift = high ? kHighShift + 8 * (p - lo_passes) : 8 * p;
    auto digit = [&](K v, uint32_t word) {
      return high ? (word >> shift) & 0xffu : static_cast<uint32_t>(v >> shift) & 0xffu;
    };
    for (int b = lane; b < kDigits; b += 32) sh.warp_cnt[warp][b] = 0;
    __syncwarp();
    K v[kSortSteps];
    uint32_t word[kSortSteps];
    int32_t rank[kSortSteps];
#pragma unroll
    for (int it = 0; it < kSortSteps; ++it) {
      if (it * 32 >= per) break;
      const int i = w0 + it * 32 + lane;
      v[it] = i < rows ? v_s[i] : K(0);
      word[it] = i < rows ? word_s[i] : 0u;
    }
#pragma unroll
    for (int it = 0; it < kSortSteps; ++it) {
      if (it * 32 >= per) break;
      const bool ok = w0 + it * 32 + lane < rows;
      const uint32_t d = ok ? digit(v[it], word[it]) : kNoDigit;
      const unsigned peers = digit_peers(d);
      rank[it] = rank_of(&sh.warp_cnt[warp][0], d, peers, ok) + __popc(peers & lower);
    }
    __syncthreads();
    {
      int32_t total;
      const int32_t count = warp_offsets(sh.warp_cnt, threadIdx.x);
      sh.start[threadIdx.x] = block_scan_excl(count, &total);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kSortSteps; ++it) {
      if (it * 32 >= per) break;
      if (w0 + it * 32 + lane < rows) {
        const uint32_t d = digit(v[it], word[it]);
        const int pos = sh.start[d] + sh.warp_cnt[warp][d] + rank[it];
        v_s[pos] = v[it];
        word_s[pos] = word[it];
      }
    }
    __syncthreads();
  }
}

template <typename K>
constexpr int batch_smem() {
  return kCap * static_cast<int>(sizeof(K) + sizeof(uint32_t));
}

// sort_batch_kernel's: beside them each row's whole v
template <typename K>
constexpr int batch_full_smem() {
  return batch_smem<K>() + kCap * static_cast<int>(sizeof(K));
}

// One block a tile of kTileRows rows: its small segments, batch by batch.
// Blocks an SM holds of a kernel that sorts rows of K in block_sort (the
// small segments' kernel with fewer registers a thread: 4 blocks were
// faster there, and 3 for the batches of the large ones).
template <typename K>
constexpr int sort_blocks(bool small) {
  return sizeof(K) == 4 ? (small ? 4 : 3) : 2;
}

template <typename K>
__global__ void __launch_bounds__(kThreads, sort_blocks<K>(true))
sort_small_kernel(const bool* __restrict__ new_group, const void* __restrict__ values, int type,
                  int elem_bytes, WeightSet ws, int64_t n, const int64_t* __restrict__ base,
                  int64_t n_tiles, const int64_t* __restrict__ stats,
                  const int32_t* __restrict__ seg_start, int vb, int wb,
                  void* __restrict__ out_values, bool* __restrict__ out_weight,
                  bool* __restrict__ heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* v_s = reinterpret_cast<K*>(smem);
  uint32_t* word_s = reinterpret_cast<uint32_t*>(v_s + kCap);
  __shared__ SortShared sh;
  __shared__ uint8_t opens_s[kCap];
  const int64_t tile = blockIdx.x;
  // the segments whose first row lies in the tile: each but the last lies
  // inside it (fewer than kTileRows rows); the last may run past it. So at
  // most two batches: all of them, or all but the last and the last, or
  // all but the last where the last is segment_sort_large's
  const int64_t k0 = tile == 0 ? 0 : (base[tile] > 1 ? base[tile] : 1);
  const int64_t k1 = base[tile + 1] > 1 ? base[tile + 1] : 1;
  if (k0 >= k1) return;
  const int64_t first = seg_start[k0], last = seg_start[k1 - 1], stop = seg_start[k1];
  const int64_t lo = stats[kLo];
  const int64_t h0 = stats[kFirstHead];
  const bool large = stop - last > kCap;
  const bool whole = !large && stop - first <= kCap;
  for (int b = 0; b < 2; ++b) {
    const int64_t k = b == 0 ? k0 : k1 - 1;
    const int64_t j = b == 0 && !whole ? k1 - 1 : k1;
    if (k >= j || (b == 1 && (whole || large))) continue;
    const int64_t a = b == 0 ? first : last;
    const int64_t rows = (j == k1 ? stop : last) - a;
    const int r = static_cast<int>(rows);
    const int segs = static_cast<int>(j - k);
    const int hb = bit_length(static_cast<uint64_t>(segs - 1)) + wb;
    constexpr int kPer = kCap / kThreads;
    for (int q0 = 0; q0 < kPer && q0 * kThreads < r; q0 += kRound) {
      auto at = [&](int q) {
        const int i = threadIdx.x + (q0 + q) * kThreads;
        return a + (i < r ? i : r - 1);
      };
      K v[kRound];
      bool w[kRound], ng[kRound];
      load_rows<K, kRound>(values, type, ws, lo, at, v, w);
#pragma unroll
      for (int q = 0; q < kRound; ++q) ng[q] = new_group[at(q)];
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int i = threadIdx.x + (q0 + q) * kThreads;
        if (i < r) {
          v_s[i] = v[q];
          word_s[i] = (w[q] ? 1u << kWeightBit : 0u) | static_cast<uint32_t>(i);
          opens_s[i] = i > 0 && ng[q] && a + i != h0;
        }
      }
    }
    __syncthreads();
    // each row's segment in the batch: a scan of the opening rows
    int c = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = threadIdx.x * kPer + q;
      c += i < r ? opens_s[i] : 0;
    }
    int32_t total;
    int32_t seg = block_scan_excl(c, &total);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = threadIdx.x * kPer + q;
      if (i < r) {
        seg += opens_s[i];
        const uint32_t word = word_s[i];
        const uint32_t w = wb && !(word >> kWeightBit & 1u) ? 1u : 0u;
        word_s[i] = word | ((static_cast<uint32_t>(seg) << wb | w) << kHighShift);
      }
    }
    __syncthreads();
    block_sort<K>(v_s, word_s, r, vb, hb, sh);
    for (int q0 = 0; q0 < kPer && q0 * kThreads < r; q0 += kRound) {
      uint32_t word[kRound];
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int i = threadIdx.x + (q0 + q) * kThreads;
        word[q] = word_s[i < r ? i : r - 1];
      }
      move_rows<kRound>(
          values, out_values, elem_bytes, [&](int q) { return a + (word[q] & kIdxMask); },
          [&](int q) { return a + threadIdx.x + (q0 + q) * kThreads; },
          [&](int q) { return static_cast<int>(threadIdx.x) + (q0 + q) * kThreads < r; });
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int i = threadIdx.x + (q0 + q) * kThreads;
        if (i < r) {
          const int64_t row = a + i;
          out_weight[row] = word[q] >> kWeightBit & 1u;
          heads[row] = i == 0 ||
                       (word[q] >> (kHighShift + wb)) != (word_s[i - 1] >> (kHighShift + wb)) ||
                       v_s[i] != v_s[i - 1];
        }
      }
    }
    __syncthreads();  // the batch's rows are read before the next one loads
  }
}

// The item whose chunks hold chunk c (the items' first chunks ascend).
__device__ __forceinline__ const Item& item_of(const Item* items, int64_t n_items, int64_t c) {
  int64_t lo = 0, hi = n_items - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (items[mid].chunk0 <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return items[lo];
}

// Where a level reads its rows: the page's columns (level 0) or the
// buffer the level before wrote.
template <typename K>
struct LevelIn {
  const void* values;
  int type;
  WeightSet ws;
  int64_t lo;
  const K* v;       // null: the page's columns
  const uint8_t* w;
};

// This thread's rows of a chunk of a level's item (from row ``first``,
// ``rows`` of them, kChunk / kWarps contiguous rows a warp in steps of 32;
// past ``rows`` the last one): v and the weight, every load issued before
// any is used.
template <typename K>
__device__ __forceinline__ void level_rows(const LevelIn<K>& in, int64_t first, int rows,
                                           K (&v)[kChunkSteps], uint32_t (&wt)[kChunkSteps]) {
  const int base = (threadIdx.x >> 5) * (kChunk / kWarps) + (threadIdx.x & 31);
  auto at = [&](int s) {
    const int i = base + s * 32;
    return first + (i < rows ? i : rows - 1);
  };
  if (in.v != nullptr) {
#pragma unroll
    for (int s = 0; s < kChunkSteps; ++s) v[s] = in.v[at(s)];
#pragma unroll
    for (int s = 0; s < kChunkSteps; ++s) wt[s] = in.w[at(s)];
    return;
  }
  bool w[kChunkSteps];
  load_rows<K, kChunkSteps>(in.values, in.type, in.ws, in.lo, at, v, w);
#pragma unroll
  for (int s = 0; s < kChunkSteps; ++s) wt[s] = w[s];
}

// A level's digit: bits [sh, sh + width) of (w, v).
struct LevelDigit {
  int vb;
  int wb;
  int sh;
  int width;
};

template <typename K>
__device__ __forceinline__ uint32_t level_digit(const LevelDigit& ld, K v, uint32_t wt) {
  const uint32_t w = ld.wb && !wt ? 1u : 0u;
  return key_digit<K>(w, v, ld.vb, ld.sh, ld.width);
}

// The chunk's rows of level ``level``: [*first, *first + return).
__device__ __forceinline__ int chunk_rows(const Item& it, int64_t c, int64_t* first) {
  *first = it.start + (c - it.chunk0) * kChunk;
  const int64_t left = it.start + it.len - *first;
  return static_cast<int>(left < kChunk ? left : kChunk);
}

// (a) One block a chunk: hist[c][d] the chunk's rows of digit d, and
// where it has some, eq_key[c][d] the key (v) of its first such row and bit
// d of eq_flag[c] whether every such row has that key.
template <typename K>
__global__ void __launch_bounds__(kThreads, 3)
sort_count_kernel(LevelIn<K> in, LevelDigit ld, const Item* __restrict__ items,
                  const int64_t* __restrict__ list, int32_t* __restrict__ hist,
                  uint64_t* __restrict__ eq_key, uint32_t* __restrict__ eq_flag) {
  __shared__ int32_t cnt_s[kDigits];
  __shared__ int32_t first_s[kDigits];
  __shared__ K rep_s[kDigits];
  __shared__ uint32_t same_s[kDigits];
  const unsigned long long word = static_cast<unsigned long long>(*list);
  const int64_t n_items = static_cast<int64_t>(word >> kChunkShift);
  const int64_t n_chunks = static_cast<int64_t>(word & kChunkMask);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Item it = item_of(items, n_items, c);
    int64_t first;
    const int rows = chunk_rows(it, c, &first);
    cnt_s[threadIdx.x] = 0;
    first_s[threadIdx.x] = kChunk;
    same_s[threadIdx.x] = 1;
    __syncthreads();
    K v[kChunkSteps];
    uint32_t dg[kChunkSteps];
    level_rows(in, first, rows, v, dg);
#pragma unroll
    for (int s = 0; s < kChunkSteps; ++s) {
      const int i = warp * (kChunk / kWarps) + s * 32 + lane;
      dg[s] = i < rows ? level_digit(ld, v[s], dg[s]) : kNoDigit;
    }
#pragma unroll
    for (int s = 0; s < kChunkSteps; ++s) {
      const int i = warp * (kChunk / kWarps) + s * 32 + lane;
      const uint32_t d = dg[s];
      const unsigned peers = digit_peers(d);
      if (d != kNoDigit && lane == __ffs(peers) - 1) {
        atomicAdd(&cnt_s[d], __popc(peers));
        atomicMin(&first_s[d], i);
      }
    }
    __syncthreads();
    // each digit's first row's key, from the level's input
    if (cnt_s[threadIdx.x] > 0) {
      const int64_t at = first + first_s[threadIdx.x];
      rep_s[threadIdx.x] = in.v != nullptr
                               ? in.v[at]
                               : static_cast<K>(static_cast<uint64_t>(okey(in.type, in.values, at)) -
                                                static_cast<uint64_t>(in.lo));
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kChunkSteps; ++s) {
      if (dg[s] != kNoDigit && v[s] != rep_s[dg[s]]) same_s[dg[s]] = 0;
    }
    __syncthreads();
    const int d = threadIdx.x;
    const int32_t count = cnt_s[d];
    hist[c * kDigits + d] = count;
    if (count > 0) eq_key[c * kDigits + d] = static_cast<uint64_t>(rep_s[d]);
    const unsigned same = __ballot_sync(0xffffffffu, count > 0 && same_s[d]);
    if (lane == 0) eq_flag[c * kWarps + warp] = same;
    __syncthreads();  // the shared counts are read before the next chunk
  }
}

// What a bucket pass writes: the next level's items and the batches.
struct BucketOut {
  Item* next;
  int64_t* next_list;
  Entry* entries;
  int64_t* n_entries;
  int buf;    // the buffer this level writes
  int last;   // the level's digit ends the key
  int sh;     // bits below the level's digit
  int width;  // the digit's bits
};

// Thread 0's walk over an item's buckets in digit order (see the header):
// with ``write`` false it only counts the batches and the next level's
// items and chunks; with it, it writes them from the first indices given.
__device__ void walk_buckets(const BucketOut& out, const Item& it, const int32_t* total,
                             const int32_t* start, const uint8_t* same, bool write,
                             int64_t* entries, int64_t* items, int64_t* chunks) {
  // a batch of the buckets of digits d0 to d1, or a piece of a copied one
  auto emit = [&](int64_t off, int64_t len, int d0, int d1, bool copy) {
    if (write) {
      Entry e;
      e.start = it.start + off;
      e.len = static_cast<int32_t>(len);
      e.sh = static_cast<uint8_t>(copy ? 0 : out.sh);
      e.width = static_cast<uint8_t>(copy ? 0 : out.width);
      e.d0 = static_cast<uint8_t>(d0);
      e.flags = static_cast<uint8_t>(out.buf | (it.opens && off == 0 ? 2 : 0) |
                                     bit_length(static_cast<uint64_t>(d1 - d0)) << 4);
      out.entries[*entries] = e;
    }
    ++*entries;
  };
  int64_t b_off = 0, b_len = 0;
  int b_d0 = 0, b_d1 = 0;
  constexpr int kAhead = 8;  // the digits' shared words read at once
  for (int q0 = 0; q0 < kDigits; q0 += kAhead) {
    int32_t cnts[kAhead], offs[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cnts[u] = total[q0 + u];
      offs[u] = start[q0 + u];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int q = q0 + u;
      const int64_t cnt = cnts[u];
      if (cnt == 0) continue;
      const int64_t off = offs[u];
      if (cnt <= kCap) {
        if (b_len + cnt > kCap) {
          emit(b_off, b_len, b_d0, b_d1, false);
          b_len = 0;
        }
        if (b_len == 0) {
          b_off = off;
          b_d0 = q;
        }
        b_len += cnt;
        b_d1 = q;
        continue;
      }
      if (b_len > 0) {
        emit(b_off, b_len, b_d0, b_d1, false);
        b_len = 0;
      }
      if (same[q] || out.last) {  // copied as it stands
        if (!write) {
          *entries += (cnt + kCap - 1) / kCap;
          continue;
        }
        for (int64_t x = 0; x < cnt; x += kCap) {
          emit(off + x, cnt - x < kCap ? cnt - x : kCap, q, q, true);
        }
        continue;
      }
      if (write) {
        Item nx;
        nx.start = it.start + off;
        nx.len = static_cast<int32_t>(cnt);
        nx.opens = it.opens && off == 0;
        nx.chunk0 = *chunks;
        out.next[*items] = nx;
      }
      ++*items;
      *chunks += (cnt + kChunk - 1) / kChunk;
    }
  }
  if (b_len > 0) emit(b_off, b_len, b_d0, b_d1, false);
}

// (b) One block an item, kParts threads a digit, each part of them a
// contiguous quarter of the item's chunks: part p's thread d sums digit d's
// counts over its chunks (kUnroll at a time) and whether its keys are all
// one; the parts are combined and the digits scanned into each digit's
// bucket; each chunk's count becomes the offset of its rows of the digit
// in the item; thread 0 walks the buckets in digit order (see the header),
// once to count what it emits, once to write it after one atomic each for
// the batches and for the next level's items and chunks.
constexpr int kParts = 4;
constexpr int kBucketThreads = kDigits * kParts;

__global__ void __launch_bounds__(kBucketThreads)
sort_bucket_kernel(const Item* __restrict__ items, const int64_t* __restrict__ list,
                   int32_t* __restrict__ hist, const uint64_t* __restrict__ eq_key,
                   const uint32_t* __restrict__ eq_flag, BucketOut out) {
  constexpr int kUnroll = 8;
  __shared__ int32_t part_s[kParts][kDigits];
  __shared__ uint64_t ref_s[kParts][kDigits];
  __shared__ uint8_t seen_s[kParts][kDigits];
  __shared__ uint8_t psame_s[kParts][kDigits];
  __shared__ int32_t total_s[kDigits];
  __shared__ int32_t start_s[kDigits];
  __shared__ uint8_t same_s[kDigits];
  __shared__ int32_t warp_s[kWarps];
  const unsigned long long word = static_cast<unsigned long long>(*list);
  const int64_t n_items = static_cast<int64_t>(word >> kChunkShift);
  const int d = threadIdx.x % kDigits;
  const int part = threadIdx.x / kDigits;
  const int lane = threadIdx.x & 31;
  for (int64_t p = blockIdx.x; p < n_items; p += gridDim.x) {
    const Item it = items[p];
    const int64_t chunks = (it.len + kChunk - 1) / kChunk;
    const int64_t j_lo = chunks * part / kParts, j_hi = chunks * (part + 1) / kParts;
    int32_t total = 0;
    bool same = true, seen = false;
    uint64_t ref = 0;
    for (int64_t j0 = j_lo; j0 < j_hi; j0 += kUnroll) {
      int32_t cnt[kUnroll];
      uint64_t key[kUnroll];
      uint32_t flag[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c = it.chunk0 + j0 + u;
        const bool ok = j0 + u < j_hi;
        cnt[u] = ok ? hist[c * kDigits + d] : 0;
        key[u] = ok ? eq_key[c * kDigits + d] : 0;
        flag[u] = ok ? eq_flag[c * kWarps + d / 32] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (cnt[u] == 0) continue;
        same = same && (flag[u] >> (d & 31) & 1u) && (!seen || key[u] == ref);
        ref = seen ? ref : key[u];
        seen = true;
        total += cnt[u];
      }
    }
    part_s[part][d] = total;
    ref_s[part][d] = ref;
    seen_s[part][d] = seen;
    psame_s[part][d] = same;
    __syncthreads();
    int32_t incl = 0, all = 0;
    if (part == 0) {  // the parts combined, and an inclusive scan in each warp
      bool any = false;
      uint64_t first = 0;
      same = true;
      for (int q = 0; q < kParts; ++q) {
        all += part_s[q][d];
        if (!seen_s[q][d]) continue;
        same = same && psame_s[q][d] && (!any || ref_s[q][d] == first);
        first = any ? first : ref_s[q][d];
        any = true;
      }
      incl = all;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      if (lane == 31) warp_s[threadIdx.x >> 5] = incl;
    }
    __syncthreads();
    if (part == 0) {
      int32_t before = 0;
      for (int w = 0; w < (threadIdx.x >> 5); ++w) before += warp_s[w];
      total_s[d] = all;
      start_s[d] = before + incl - all;
      same_s[d] = same;
    }
    __syncthreads();
    // each chunk's rows of digit d: after the bucket's earlier chunks
    int32_t run = start_s[d];
    for (int q = 0; q < part; ++q) run += part_s[q][d];
    for (int64_t j0 = j_lo; j0 < j_hi; j0 += kUnroll) {
      int32_t cnt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        cnt[u] = j0 + u < j_hi ? hist[(it.chunk0 + j0 + u) * kDigits + d] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u < j_hi) hist[(it.chunk0 + j0 + u) * kDigits + d] = run;
        run += cnt[u];
      }
    }
    if (threadIdx.x == 0) {
      int64_t n_entries = 0, n_next = 0, n_chunks = 0;
      walk_buckets(out, it, total_s, start_s, same_s, false, &n_entries, &n_next, &n_chunks);
      int64_t e0 = 0, i0 = 0, c0 = 0;
      if (n_entries > 0) {
        e0 = static_cast<int64_t>(atomicAdd(
            reinterpret_cast<unsigned long long*>(out.n_entries),
            static_cast<unsigned long long>(n_entries)));
      }
      if (n_next > 0) {
        const unsigned long long old = atomicAdd(
            reinterpret_cast<unsigned long long*>(out.next_list),
            (static_cast<unsigned long long>(n_next) << kChunkShift) |
                static_cast<unsigned long long>(n_chunks));
        i0 = static_cast<int64_t>(old >> kChunkShift);
        c0 = static_cast<int64_t>(old & kChunkMask);
      }
      walk_buckets(out, it, total_s, start_s, same_s, true, &e0, &i0, &c0);
    }
    __syncthreads();  // the shared buckets are read before the next item
  }
}

template <typename K>
constexpr int chunk_smem() {
  return kChunk * static_cast<int>(sizeof(K) + 1);
}

// (c) One block a chunk: its rows ranked by digit in row order, staged in
// digit order, each digit's run written to its bucket.
template <typename K>
__global__ void __launch_bounds__(kThreads, 3)
sort_scatter_kernel(LevelIn<K> in, LevelDigit ld, const Item* __restrict__ items,
                    const int64_t* __restrict__ list, const int32_t* __restrict__ hist,
                    K* __restrict__ out_v, uint8_t* __restrict__ out_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* v_s = reinterpret_cast<K*>(smem);
  uint8_t* w_s = reinterpret_cast<uint8_t*>(v_s + kChunk);
  __shared__ int32_t warp_cnt[kWarps][kDigits];
  __shared__ int32_t start_s[kDigits];
  __shared__ int64_t base_s[kDigits];
  const unsigned long long word = static_cast<unsigned long long>(*list);
  const int64_t n_items = static_cast<int64_t>(word >> kChunkShift);
  const int64_t n_chunks = static_cast<int64_t>(word & kChunkMask);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Item it = item_of(items, n_items, c);
    int64_t first;
    const int rows = chunk_rows(it, c, &first);
    for (int b = lane; b < kDigits; b += 32) warp_cnt[warp][b] = 0;
    __syncwarp();
    K v[kChunkSteps];
    uint32_t wt[kChunkSteps], dg[kChunkSteps];
    int32_t rank[kChunkSteps];
    level_rows(in, first, rows, v, wt);
#pragma unroll
    for (int s = 0; s < kChunkSteps; ++s) {
      const int i = warp * (kChunk / kWarps) + s * 32 + lane;
      const bool ok = i < rows;
      const uint32_t d = ok ? level_digit(ld, v[s], wt[s]) : kNoDigit;
      dg[s] = d;
      const unsigned peers = digit_peers(d);
      rank[s] = rank_of(warp_cnt[warp], d, peers, ok) + __popc(peers & lower);
    }
    __syncthreads();
    {
      const int d = threadIdx.x;
      int32_t total;
      const int32_t count = warp_offsets(warp_cnt, d);
      const int32_t local = block_scan_excl(count, &total);
      start_s[d] = local;
      base_s[d] = it.start + hist[c * kDigits + d] - local;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kChunkSteps; ++s) {
      if (dg[s] == kNoDigit) continue;
      const int pos = start_s[dg[s]] + warp_cnt[warp][dg[s]] + rank[s];
      v_s[pos] = v[s];
      w_s[pos] = static_cast<uint8_t>(wt[s]);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += kThreads) {
      const K x = v_s[j];
      const uint8_t w = w_s[j];
      const int64_t pos = base_s[level_digit(ld, x, w)] + j;
      out_v[pos] = x;
      out_w[pos] = w;
    }
    __syncthreads();  // the staged rows are read before the next chunk
  }
}

// One block a batch of a large segment: sorted by block_sort by (its
// row's digit - d0, the low sh bits of v) (the two in v where they fit K,
// else the first in the word's high part), written out from each row's v
// (order key - lo: the value's bits, store_key) kept beside it in shared
// memory; its first row's head where it opens its segment (else
// sort_fix_heads_kernel's), the others from the rows' v.
template <typename K>
__global__ void __launch_bounds__(kThreads, sort_blocks<K>(false))
sort_batch_kernel(int type, int64_t lo, const K* __restrict__ v0, const uint8_t* __restrict__ w0,
                  const K* __restrict__ v1, const uint8_t* __restrict__ w1,
                  const Entry* __restrict__ entries, const int64_t* __restrict__ n_entries,
                  int vb, int wb, void* __restrict__ out_values, bool* __restrict__ out_weight,
                  bool* __restrict__ heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* v_s = reinterpret_cast<K*>(smem);
  K* full_s = v_s + kCap;
  uint32_t* word_s = reinterpret_cast<uint32_t*>(full_s + kCap);
  __shared__ SortShared sh;
  constexpr int kBits = 8 * static_cast<int>(sizeof(K));
  constexpr int kPer = kCap / kThreads;
  const int64_t count = *n_entries;
  for (int64_t e = blockIdx.x; e < count; e += gridDim.x) {
    const Entry en = entries[e];
    const K* bv = en.flags & 1 ? v1 : v0;
    const uint8_t* bw = en.flags & 1 ? w1 : w0;
    const int low_bits = en.sh, span = en.flags >> 4, d0 = en.d0;
    const bool in_v = low_bits + span <= kBits;  // the digit beside the low bits
    const K low = low_bits >= kBits ? ~K(0) : (K(1) << low_bits) - K(1);
    const int len = en.len;
    for (int q0 = 0; q0 < kPer && q0 * kThreads < len; q0 += kRound) {
      auto at = [&](int q) {
        const int i = threadIdx.x + (q0 + q) * kThreads;
        return en.start + (i < len ? i : len - 1);
      };
      K v[kRound];
      uint8_t wt[kRound];
#pragma unroll
      for (int q = 0; q < kRound; ++q) v[q] = bv[at(q)];
#pragma unroll
      for (int q = 0; q < kRound; ++q) wt[q] = bw[at(q)];
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int i = threadIdx.x + (q0 + q) * kThreads;
        if (i >= len) continue;
        const uint32_t w = wb && !wt[q] ? 1u : 0u;
        const uint32_t dd =
            span > 0 ? key_digit<K>(w, v[q], vb, low_bits, en.width) - d0 : 0u;
        v_s[i] = (v[q] & low) | (in_v ? static_cast<K>(dd) << (low_bits % kBits) : K(0));
        full_s[i] = v[q];
        word_s[i] = static_cast<uint32_t>(i) | (wt[q] ? 1u << kWeightBit : 0u) |
                    (in_v ? 0u : dd << kHighShift);
      }
    }
    __syncthreads();
    block_sort<K>(v_s, word_s, len, in_v ? low_bits + span : low_bits, in_v ? 0 : span, sh);
    for (int q0 = 0; q0 < kPer && q0 * kThreads < len; q0 += kRound) {
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int i = threadIdx.x + (q0 + q) * kThreads;
        if (i >= len) continue;
        const int64_t row = en.start + i;
        const uint32_t word = word_s[i];
        const K x = full_s[word & kIdxMask];
        store_key(out_values, type, row, static_cast<int64_t>(static_cast<uint64_t>(x) +
                                                              static_cast<uint64_t>(lo)));
        out_weight[row] = word >> kWeightBit & 1u;
        if (i > 0) {
          heads[row] = x != full_s[word_s[i - 1] & kIdxMask];
        } else if (en.flags & 2) {
          heads[row] = true;
        }
      }
    }
    __syncthreads();  // the batch's rows are read before the next one loads
  }
}

// One thread a batch that does not open its segment: its first row's head
// from the row before it in the sorted page (the same group).
__global__ void __launch_bounds__(kThreads)
sort_fix_heads_kernel(const Entry* __restrict__ entries, const int64_t* __restrict__ n_entries,
                      const void* __restrict__ out_values, int type,
                      bool* __restrict__ heads) {
  const int64_t count = *n_entries;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < count;
       e += stride) {
    const Entry en = entries[e];
    if (en.flags & 2) continue;
    heads[en.start] = okey(type, out_values, en.start) != okey(type, out_values, en.start - 1);
  }
}

template <typename K>
cudaError_t launch_small(const bool* ng, const void* values, int type, int elem_bytes,
                         const WeightSet& ws, int64_t n, const int64_t* base, int64_t n_tiles,
                         const int64_t* stats, const int32_t* seg_start, int vb, int wb,
                         void* out_values, bool* out_weight, bool* heads, cudaStream_t s) {
  static const cudaError_t sized = cudaFuncSetAttribute(
      sort_small_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, batch_smem<K>());
  if (sized != cudaSuccess) return sized;
  sort_small_kernel<K><<<static_cast<unsigned>(n_tiles), kThreads, batch_smem<K>(), s>>>(
      ng, values, type, elem_bytes, ws, n, base, n_tiles, stats, seg_start, vb, wb, out_values,
      out_weight, heads);
  ++g_stream_ops;
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_large(const void* values, int type, int elem_bytes, const WeightSet& ws,
                         int64_t lo, int vb, int wb, int64_t* stats, Item* items0, Item* items1,
                         int64_t items0_n, int64_t chunks0, K* v0, uint8_t* w0, K* v1,
                         uint8_t* w1, int32_t* hist, uint64_t* eq_key, uint32_t* eq_flag,
                         Entry* entries, void* out_values, bool* out_weight, bool* heads,
                         cudaStream_t s) {
  static const cudaError_t sized_scatter = cudaFuncSetAttribute(
      sort_scatter_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_smem<K>());
  static const cudaError_t sized_batch = cudaFuncSetAttribute(
      sort_batch_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, batch_full_smem<K>());
  if (sized_scatter != cudaSuccess) return sized_scatter;
  if (sized_batch != cudaSuccess) return sized_batch;
  const int bits = vb + wb;
  const int levels = bits > 0 ? (bits + 7) / 8 : 1;
  // the later levels' sizes are on the card: grid-stride loops whose
  // blocks are all resident at once (three of the chunk passes' and two of
  // the bucket pass's 1,024-thread blocks an SM)
  const unsigned wide = static_cast<unsigned>(hopper::sm_count() * 3);
  const unsigned two = static_cast<unsigned>(hopper::sm_count() * 2);
  cudaError_t err = cudaSuccess;
  for (int level = 0; level < levels; ++level) {
    const int top = bits - 8 * level;
    LevelDigit ld;
    ld.vb = vb;
    ld.wb = wb;
    ld.sh = top > 8 ? top - 8 : 0;
    ld.width = top - ld.sh;
    LevelIn<K> in;
    in.values = values;
    in.type = type;
    in.ws = ws;
    in.lo = lo;
    in.v = level == 0 ? nullptr : (level % 2 ? v0 : v1);
    in.w = level == 0 ? nullptr : (level % 2 ? w0 : w1);
    Item* cur = level % 2 ? items1 : items0;
    const int64_t* list = stats + kList + level;
    const unsigned chunk_grid =
        level == 0 ? static_cast<unsigned>(chunks0) : wide;
    const unsigned item_grid =
        level == 0 ? static_cast<unsigned>(items0_n) : two;
    sort_count_kernel<K><<<chunk_grid, kThreads, 0, s>>>(in, ld, cur, list, hist, eq_key,
                                                          eq_flag);
    ++g_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    BucketOut out;
    out.next = level % 2 ? items0 : items1;
    out.next_list = stats + kList + level + 1;
    out.entries = entries;
    out.n_entries = stats + kEntries;
    out.buf = level % 2;
    out.last = ld.sh == 0;
    out.sh = ld.sh;
    out.width = ld.width;
    sort_bucket_kernel<<<item_grid, kBucketThreads, 0, s>>>(cur, list, hist, eq_key, eq_flag,
                                                             out);
    ++g_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sort_scatter_kernel<K><<<chunk_grid, kThreads, chunk_smem<K>(), s>>>(
        in, ld, cur, list, hist, level % 2 ? v1 : v0, level % 2 ? w1 : w0);
    ++g_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // every batch block resident at once
  static const int batch_blocks = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, sort_batch_kernel<K>, kThreads,
                                                  batch_full_smem<K>());
    return b > 0 ? b : 1;
  }();
  sort_batch_kernel<K><<<static_cast<unsigned>(hopper::sm_count() * batch_blocks), kThreads,
                         batch_full_smem<K>(), s>>>(
      type, lo, v0, w0, v1, w1, entries, stats + kEntries, vb, wb, out_values,
      out_weight, heads);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sort_fix_heads_kernel<<<two, kThreads, 0, s>>>(entries, stats + kEntries, out_values, type,
                                                 heads);
  ++g_stream_ops;
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_sort_max_weights() { return hopper::kMaxWeights; }
extern "C" int segment_sort_tile_rows() { return kTileRows; }
extern "C" int segment_sort_batch_rows() { return kCap; }
extern "C" int segment_sort_chunk_rows() { return kChunk; }
extern "C" int segment_sort_stat_words() { return kStatWords; }
extern "C" int segment_sort_item_bytes() { return sizeof(Item); }
extern "C" int segment_sort_entry_bytes() { return sizeof(Entry); }
extern "C" int64_t segment_sort_stream_ops() { return g_stream_ops.load(); }

// stats (int64 [segment_sort_stat_words]): the least and largest order key,
// the weighted rows, the groups, the large segments' rows, the first head,
// level 0's list word (items << 40 | chunks). scratch (int64 [2 * n_tiles +
// 1], n_tiles = ceil(n / kTileRows)): the tiles' head counts and each
// tile's first group; seg_start (int32 [n + 1]); items (Item [n / (kCap +
// 1) + 1]): level 0's items.
extern "C" int segment_sort_stats(const void* new_group, const void* values, int type,
                                  const WeightSet* ws, int64_t n, void* scratch, void* stats,
                                  void* seg_start, void* items, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* st = static_cast<int64_t*>(stats);
  sort_stats_init_kernel<<<1, 32, 0, s>>>(st);
  ++g_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  int64_t* heads = static_cast<int64_t*>(scratch);
  const bool* ng = static_cast<const bool*>(new_group);
  sort_stats_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(ng, values, type, *ws,
                                                                        n, heads, st);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int64_t* base = heads + n_tiles;
  hopper::rows::tile_base_kernel<<<1, kThreads, 0, s>>>(heads, n_tiles, base);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int32_t* starts = static_cast<int32_t*>(seg_start);
  sort_starts_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(ng, n, base, n_tiles,
                                                                         starts, st);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sort_classify_kernel<<<hopper::grid_for(n_tiles * kTileRows / kCap + 1), kThreads, 0, s>>>(
      starts, base, n_tiles, static_cast<Item*>(items), st);
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}

// Every segment of at most kCap rows sorted and written out; vb the bits of
// v (a 64-bit v past 32), wb 1 where the weight sorts.
extern "C" int segment_sort_small(const void* new_group, const void* values, int type,
                                  int elem_bytes, const WeightSet* ws, int64_t n,
                                  const void* scratch, const void* stats, const void* seg_start,
                                  int vb, int wb, void* out_values, void* out_weight,
                                  void* heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t* base = static_cast<const int64_t*>(scratch) + n_tiles;
  const bool* ng = static_cast<const bool*>(new_group);
  const int64_t* st = static_cast<const int64_t*>(stats);
  const int32_t* starts = static_cast<const int32_t*>(seg_start);
  bool* ow = static_cast<bool*>(out_weight);
  bool* oh = static_cast<bool*>(heads);
  cudaError_t err =
      vb > 32 ? launch_small<uint64_t>(ng, values, type, elem_bytes, *ws, n, base, n_tiles, st,
                                       starts, vb, wb, out_values, ow, oh, s)
              : launch_small<uint32_t>(ng, values, type, elem_bytes, *ws, n, base, n_tiles, st,
                                       starts, vb, wb, out_values, ow, oh, s);
  return static_cast<int>(err);
}

// The segments over kCap rows (items0: level 0's items0_n items in chunks0
// chunks) sorted and written out. Buffers: v0, v1 (n values of 4 bytes, 8
// past vb = 32), w0, w1 (uint8 [n]); hist (int32 [chunks * 256]),
// eq_key (int64 [chunks * 256]), eq_flag (int32 [chunks * 8]) for the most
// chunks of a level; items1 as items0; entries (Entry) for every batch; the
// stats' level words and batch count zero.
extern "C" int segment_sort_large(const void* values, int type, int elem_bytes,
                                  const WeightSet* ws, int64_t lo, int vb, int wb, void* stats,
                                  void* items0, void* items1, int64_t items0_n, int64_t chunks0,
                                  void* v0, void* w0, void* v1, void* w1, void* hist,
                                  void* eq_key, void* eq_flag, void* entries, void* out_values,
                                  void* out_weight, void* heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items0_n <= 0) return 0;
  int64_t* st = static_cast<int64_t*>(stats);
  Item* i0 = static_cast<Item*>(items0);
  Item* i1 = static_cast<Item*>(items1);
  uint8_t* s0 = static_cast<uint8_t*>(w0);
  uint8_t* s1 = static_cast<uint8_t*>(w1);
  int32_t* h = static_cast<int32_t*>(hist);
  uint64_t* ek = static_cast<uint64_t*>(eq_key);
  uint32_t* ef = static_cast<uint32_t*>(eq_flag);
  Entry* en = static_cast<Entry*>(entries);
  bool* ow = static_cast<bool*>(out_weight);
  bool* oh = static_cast<bool*>(heads);
  cudaError_t err =
      vb > 32
          ? launch_large<uint64_t>(values, type, elem_bytes, *ws, lo, vb, wb, st, i0, i1,
                                   items0_n, chunks0, static_cast<uint64_t*>(v0), s0,
                                   static_cast<uint64_t*>(v1), s1, h, ek, ef, en, out_values, ow,
                                   oh, s)
          : launch_large<uint32_t>(values, type, elem_bytes, *ws, lo, vb, wb, st, i0, i1,
                                   items0_n, chunks0, static_cast<uint32_t*>(v0), s0,
                                   static_cast<uint32_t*>(v1), s1, h, ek, ef, en, out_values, ow,
                                   oh, s);
  return static_cast<int>(err);
}
