// Stable co-sort of a page by its group keys, then group boundaries.
//
// Replaces: trino_tpu/ops/megakernels.py group_sort_phase (the Pallas
// launch of runtime/executor._group_sort_impl) and the fused ``sort``
// stage of expand_phase, which traces the same body. That body sorts by
// one pass key at a time, least significant first: for each group key
// from the last to the first, its normalized value (kernels.order_key,
// INT64_MAX where NULL) and then its validity byte (NULL rows first);
// finally ~active, so inactive rows go last. It gathers every needed
// column, and marks new_group = active & (first row | a key differs from
// the previous row | the previous row is inactive).
//
// Bit-identical to the plain version (hopper_kernels.group_sort_plain):
// the permutation is the unique stable sort by the lexicographic key
// (inactive, valid_0, value_0, valid_1, value_1, ...), with ties in row
// order, which is what the chain of stable passes computes.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The page is read once and
// written once in its new order, with new_group beside it. An LSD sort
// cannot avoid its passes' own traffic on top: each pass reads and writes
// an 8-byte key and a 4-byte row index, 24 bytes a row.
//
// Design, four entry points the wrapper calls in turn (so it can time
// each):
//   1. group_sort_stats: one reduction gives each key's least and largest
//      normalized value over its valid rows, its valid-row count and the
//      rows where its validity differs from the row's activity, and the
//      active-row count. The wrapper reads them (one host sync) and packs
//      the sort into as few 64-bit composite keys as it can: each key
//      contributes its value as (value - min) in bit_length(max - min)
//      bits (0 for NULL rows, which its validity bit separates) and its
//      validity as one bit, unless either is the same on every row (a
//      stable pass over equal digits is the identity) or the validity
//      equals the activity on every row (the inactive bit, more
//      significant than every validity bit, already orders those rows, and
//      among rows of one activity the validity is constant); ~active adds
//      one bit when the page has both kinds of rows. Fields are packed
//      least significant first and never split. The order of a composite
//      is the lexicographic order of its fields, so this is exact. On
//      TPC-H Q10's joined page (three keys of about 21 bits each, NULL
//      exactly on the inactive slots) that is one composite of 64 bits:
//      eight passes, where the reference's chain has 3 * 9 + 1 = 28.
//   2. group_sort_compose: one memset zeroes the passes' digit counts,
//      look-back words and tile counters; then one launch per composite
//      writes every row's composite in row order and counts its digits
//      at every place (a shared atomic per row and place, each block's
//      counts added once into HBM).
//   3. group_sort_passes: ceil(bits / 8) one-sweep passes of
//      radix_pass.cuh per composite, least significant first, one launch
//      each, moving (composite, row index) pairs. A later composite's
//      first pass reads its keys through the permutation so far.
//   4. group_sort_finish: with one composite, new_group and active come
//      from the sorted composite alone: two rows are in one group iff both
//      are active and their composites are equal (every field left out is
//      constant over the rows compared, or implied by the activity), and a
//      row is active iff its inactive bit is clear (or, without that bit,
//      as every row is). That reads adjacent words in order, with no
//      random key reads. The carried columns that are integer or bool
//      group keys are written from the composite as well (value field plus
//      offset where valid); only their NULL rows read the column at the
//      row's old place. With more composites (or none) the kernel compares
//      the keys of rows perm[i] and perm[i-1]. num_groups sums the ballots
//      of new_group, one atomic per block; perm_gather then writes the
//      other carried columns in sorted order, reading each row at random.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"
#include "radix_pass.cuh"

namespace hopper {

// a value and a validity per key, then ~active
static_assert(kMaxFields == 2 * kMaxWideKeys + 1, "radix_pass.cuh's Composite holds the fields");

// The kinds of a Field (radix_pass.cuh): for kValueField the key's
// normalized value minus ``offset`` (0 where NULL), for kValidField its
// validity, for kInactiveField the row's inactivity.
enum FieldKind : int { kValueField = 0, kValidField = 1, kInactiveField = 2 };

// A carried column that is an integer or bool group key, written from the
// one sorted composite: where valid, the key's value field plus its offset
// (or the offset alone, for a key with one value); where NULL, its own bits,
// read at the row's place before the sort. Its validity is a composite bit,
// the activity, or constant.
enum ValidMode : int { kValidBit = 0, kValidActive = 1, kValidAlways = 2, kValidNever = 3 };

struct DecodeCol {
  const void* src;
  void* dst;
  bool* dst_valid;
  int type;  // KeyType: kI64, kI32, kI16, kI8 or kBool
  int value_pos;
  int value_bits;  // 0: no value field
  int64_t offset;
  int valid_mode;
  int valid_pos;
};

// Passed by value as a kernel parameter.
struct DecodeSet {
  DecodeCol col[kMaxWideKeys];
  int n;
};

}  // namespace hopper

namespace {

using hopper::Composite;
using hopper::grid_for;
using hopper::kThreads;
using hopper::kWarps;
using hopper::PermGatherSet;
using hopper::radix::kDigits;
using hopper::radix::kSweepRows;
using hopper::radix::kSweepSmem;

constexpr int kDigitBits = 8;
constexpr int kMaxPlaces = 64 / kDigitBits;  // digit places of one composite
constexpr int kStatsPerKey = 4;             // min, max, valid rows, valid != active rows
constexpr int kUnroll = 4;                  // rows a thread reads at once (stats, compose)

// Kernel launches and memsets issued by this file's entry points since the
// library was loaded (chip_smoke.py reads the difference over one call).
std::atomic<int64_t> g_stream_ops{0};

// Blocks of the reductions over rows (stats, compose): four an SM keep
// enough rows in flight, and few blocks make few atomics into HBM.
int rows_grid(int64_t n) {
  const int cap = hopper::sm_count() * 4;
  return grid_for(n) < cap ? grid_for(n) : cap;
}

__host__ __device__ int places_of(const Composite& c) {
  return (c.bits + kDigitBits - 1) / kDigitBits;
}

// The passes' scratch, in int64 words: a tile counter per pass, the digit
// counts of every place (int32 [passes][kDigits]), then the look-back
// status words ([passes][tiles][kDigits]).
int64_t sweep_tiles(int64_t n) { return (n + kSweepRows - 1) / kSweepRows; }
int64_t hist_offset(int passes) { return passes; }
int64_t status_offset(int passes) { return passes + static_cast<int64_t>(passes) * kDigits / 2; }

__global__ void stats_init_kernel(int64_t* stats, int nk, int64_t* num_groups) {
  const int i = threadIdx.x;
  if (i < nk) {
    stats[i] = INT64_MAX;
    stats[nk + i] = INT64_MIN;
    stats[2 * nk + i] = 0;
    stats[3 * nk + i] = 0;
  }
  if (i == 0) {
    stats[kStatsPerKey * nk] = 0;
    *num_groups = 0;
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ int64_t warp_min(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v = min64(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max64(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Adds the block's groups (each warp's lane 0 holds its warp's) to
// *num_groups with one atomic.
__device__ __forceinline__ void add_groups(int64_t warp_groups, int64_t* num_groups) {
  __shared__ int64_t block_groups;
  if (threadIdx.x == 0) block_groups = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && warp_groups != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(&block_groups),
              static_cast<unsigned long long>(warp_groups));
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_groups != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(num_groups),
              static_cast<unsigned long long>(block_groups));
  }
}

// stats = [min_k..., max_k..., valid_rows_k..., valid_ne_active_rows_k...,
// active_rows] over all rows (active or not: inactive rows are sorted too).
// One streaming loop per key (and one for the activity), kUnroll rows a
// thread in flight.
__global__ void __launch_bounds__(kThreads)
stats_kernel(hopper::WideKeySet ks, const bool* __restrict__ active, int64_t n,
             int64_t* __restrict__ stats) {
  __shared__ int64_t part[kWarps][kStatsPerKey * hopper::kMaxWideKeys + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nk = ks.n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int k = 0; k <= nk; ++k) {
    int64_t lo = INT64_MAX, hi = INT64_MIN, cnt = 0, differ = 0;
    for (int64_t i0 = first; i0 < n; i0 += kUnroll * stride) {
      int64_t v[kUnroll];
      bool ok[kUnroll], a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + u * stride;
        const bool in = i < n;
        a[u] = in && active[i];
        ok[u] = in && k < nk && hopper::load_key(ks.col[k], i, &v[u]);
        if (!in) a[u] = ok[u];  // rows past n count nowhere
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k == nk) {
          cnt += a[u] ? 1 : 0;
        } else {
          if (ok[u]) {
            lo = min64(lo, v[u]);
            hi = max64(hi, v[u]);
            ++cnt;
          }
          differ += ok[u] != a[u] ? 1 : 0;
        }
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    cnt = warp_sum(cnt);
    differ = warp_sum(differ);
    if (lane == 0) {
      if (k == nk) {
        part[warp][kStatsPerKey * nk] = cnt;
      } else {
        part[warp][k] = lo;
        part[warp][nk + k] = hi;
        part[warp][2 * nk + k] = cnt;
        part[warp][3 * nk + k] = differ;
      }
    }
  }
  __syncthreads();
  const int n_stats = kStatsPerKey * nk + 1;
  for (int j = threadIdx.x; j < n_stats; j += kThreads) {
    int64_t v = part[0][j];
    for (int w = 1; w < kWarps; ++w) {
      const int64_t x = part[w][j];
      v = j < nk ? min64(v, x) : (j < 2 * nk ? max64(v, x) : v + x);
    }
    if (j < nk) {
      atomicMin(reinterpret_cast<long long*>(stats + j), static_cast<long long>(v));
    } else if (j < 2 * nk) {
      atomicMax(reinterpret_cast<long long*>(stats + j), static_cast<long long>(v));
    } else if (v != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + j),
                static_cast<unsigned long long>(v));
    }
  }
}

// keys_out[i] = the composite of row i; hist[p][d] += the rows whose digit
// at place p is d, for every place of the composite. kUnroll rows a thread
// at a time, each field read for all of them at once.
__global__ void __launch_bounds__(kThreads)
compose_kernel(hopper::WideKeySet ks, const bool* __restrict__ active, Composite c, int64_t n,
               uint64_t* __restrict__ keys_out, int32_t* __restrict__ hist) {
  __shared__ int32_t h[kMaxPlaces][kDigits];
  const int places = places_of(c);
  for (int b = threadIdx.x; b < places * kDigits; b += kThreads) (&h[0][0])[b] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i0 < n;
       i0 += kUnroll * stride) {
    uint64_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = 0;
    for (int f = 0; f < c.n_fields; ++f) {
      const hopper::Field& fd = c.field[f];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + u * stride;
        if (i < n) {
          uint64_t x;
          if (fd.kind == hopper::kValueField) {
            int64_t k;
            const bool valid = hopper::load_key(ks.col[fd.key], i, &k);
            x = valid ? static_cast<uint64_t>(k) - static_cast<uint64_t>(fd.offset) : 0;
          } else if (fd.kind == hopper::kValidField) {
            x = ks.col[fd.key].valid[i] ? 1 : 0;
          } else {
            x = active[i] ? 0 : 1;
          }
          v[u] |= x << fd.pos;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < n) {
        keys_out[i] = v[u];
        for (int p = 0; p < places; ++p) {
          atomicAdd(&h[p][static_cast<uint32_t>(v[u] >> (kDigitBits * p)) & (kDigits - 1)], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < places * kDigits; b += kThreads) {
    const int32_t x = (&h[0][0])[b];
    if (x != 0) atomicAdd(hist + b, x);
  }
}

// Element bytes of a key column's storage type.
__device__ __forceinline__ int key_bytes(int type) {
  switch (type) {
    case hopper::kI64: return 8;
    case hopper::kI32: return 4;
    case hopper::kI16: return 2;
    default: return 1;
  }
}

// Writes key value v (or, raw, the element at row r of src) into dst[i].
__device__ __forceinline__ void put_key(const hopper::DecodeCol& c, int64_t i, bool raw,
                                        int64_t r, int64_t v) {
  switch (key_bytes(c.type)) {
    case 8:
      static_cast<int64_t*>(c.dst)[i] = raw ? static_cast<const int64_t*>(c.src)[r] : v;
      break;
    case 4:
      static_cast<int32_t*>(c.dst)[i] =
          raw ? static_cast<const int32_t*>(c.src)[r] : static_cast<int32_t>(v);
      break;
    case 2:
      static_cast<int16_t*>(c.dst)[i] =
          raw ? static_cast<const int16_t*>(c.src)[r] : static_cast<int16_t>(v);
      break;
    default:
      static_cast<uint8_t*>(c.dst)[i] =
          raw ? static_cast<const uint8_t*>(c.src)[r] : static_cast<uint8_t>(v);
      break;
  }
}

// Group boundaries from the one sorted composite: row i is active iff its
// inactive bit (at inactive_pos, or -1 for none: every row is all_active)
// is clear, and starts a group iff active and its composite differs from
// row i-1's or row i-1 is inactive. The decoded key columns are written
// from the composite too; only their NULL rows read row perm[i].
__global__ void __launch_bounds__(kThreads)
finish_sorted_kernel(const uint64_t* __restrict__ keys, const int32_t* __restrict__ perm,
                     int64_t n, int inactive_pos, int all_active, hopper::DecodeSet ds,
                     bool* __restrict__ active_out, bool* __restrict__ new_group,
                     int64_t* __restrict__ num_groups) {
  int64_t groups = 0;  // the warp's, counted by a ballot each step
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // every lane of a warp runs the same iterations, so the ballot is whole
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    bool ng = false;
    if (i < n) {
      const uint64_t k = keys[i];
      const bool a = inactive_pos >= 0 ? ((k >> inactive_pos) & 1) == 0 : all_active != 0;
      active_out[i] = a;
      if (a) {
        if (i == 0) {
          ng = true;
        } else {
          const uint64_t p = keys[i - 1];
          const bool pa = inactive_pos >= 0 ? ((p >> inactive_pos) & 1) == 0 : true;
          ng = !pa || p != k;
        }
      }
      new_group[i] = ng;
      for (int j = 0; j < ds.n; ++j) {
        const hopper::DecodeCol& c = ds.col[j];
        bool valid;
        switch (c.valid_mode) {
          case hopper::kValidBit: valid = ((k >> c.valid_pos) & 1) != 0; break;
          case hopper::kValidActive: valid = a; break;
          case hopper::kValidAlways: valid = true; break;
          default: valid = false; break;
        }
        uint64_t field = 0;
        if (c.value_bits > 0) {
          field = k >> c.value_pos;
          if (c.value_bits < 64) field &= (1ull << c.value_bits) - 1;
        }
        put_key(c, i, !valid, valid ? 0 : perm[i],
                static_cast<int64_t>(field + static_cast<uint64_t>(c.offset)));
        c.dst_valid[i] = valid;
      }
    }
    groups += __popc(__ballot_sync(0xffffffffu, ng));
  }
  add_groups(groups, num_groups);
}

// Normalized key k of row r as the reference compares it: order_key, and
// INT64_MAX where NULL; *valid gets the validity.
__device__ __forceinline__ int64_t norm_key(const hopper::KeyCol& c, int64_t r, bool* valid) {
  int64_t v;
  *valid = hopper::load_key(c, r, &v);
  return *valid ? v : INT64_MAX;
}

// Group boundaries by comparing the keys of rows perm[i] and perm[i-1]
// (perm null: the identity), for plans of no or several composites.
__global__ void __launch_bounds__(kThreads)
finish_kernel(hopper::WideKeySet ks, const bool* __restrict__ active,
              const int32_t* __restrict__ perm, int64_t n, bool* __restrict__ active_out,
              bool* __restrict__ new_group, int64_t* __restrict__ num_groups) {
  int64_t groups = 0;  // the warp's, counted by a ballot each step
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // every lane of a warp runs the same iterations, so the ballot is whole
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    bool ng = false;
    if (i < n) {
      const int64_t r = perm != nullptr ? perm[i] : i;
      const bool a = active[r];
      active_out[i] = a;
      if (a) {
        if (i == 0) {
          ng = true;
        } else {
          const int64_t p = perm != nullptr ? perm[i - 1] : i - 1;
          ng = !active[p];
          for (int k = 0; k < ks.n && !ng; ++k) {
            bool vr, vp;
            const int64_t xr = norm_key(ks.col[k], r, &vr);
            const int64_t xp = norm_key(ks.col[k], p, &vp);
            ng = vr != vp || xr != xp;
          }
        }
      }
      new_group[i] = ng;
    }
    groups += __popc(__ballot_sync(0xffffffffu, ng));
  }
  add_groups(groups, num_groups);
}

}  // namespace

extern "C" int64_t group_sort_stream_ops() { return g_stream_ops.load(); }
extern "C" int wide_key_limit() { return hopper::kMaxWideKeys; }
extern "C" int radix_tile_rows() { return hopper::radix::kTileRows; }
extern "C" int group_sort_tile_rows() { return kSweepRows; }
extern "C" int radix_perm_cols() { return hopper::kMaxPermCols; }

// int64 words of the scratch group_sort_compose zeroes for ``passes``
// passes over n rows.
extern "C" int64_t group_sort_scratch_words(int64_t n, int passes) {
  return status_offset(passes) + static_cast<int64_t>(passes) * sweep_tiles(n) * kDigits;
}

// Each key's value range, valid-row count and rows where its validity
// differs from the activity, and the active-row count, into ``stats``
// (int64 [4 * nk + 1]) on ``stream``; num_groups (int64) is zeroed.
extern "C" int group_sort_stats(const hopper::WideKeySet* keys, const void* active, int64_t n,
                                void* stats, void* num_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* st = static_cast<int64_t*>(stats);
  stats_init_kernel<<<1, 32, 0, s>>>(st, keys->n, static_cast<int64_t*>(num_groups));
  ++g_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  stats_kernel<<<rows_grid(n), kThreads, 0, s>>>(*keys, static_cast<const bool*>(active), n, st);
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}

// Zeroes ``scratch`` (group_sort_scratch_words int64), then writes composite
// c of every row, in row order, to comp_keys + c * n (uint64 [n_comps * n])
// and counts its digits into the scratch.
extern "C" int group_sort_compose(const hopper::WideKeySet* keys, const void* active, int64_t n,
                                  const Composite* comps, int n_comps, void* comp_keys,
                                  void* scratch, int64_t scratch_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_comps <= 0 || n <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int64_t) * scratch_words, s);
  ++g_stream_ops;
  if (err != cudaSuccess) return static_cast<int>(err);
  int passes = 0;
  for (int c = 0; c < n_comps; ++c) passes += places_of(comps[c]);
  int32_t* hist =
      reinterpret_cast<int32_t*>(static_cast<int64_t*>(scratch) + hist_offset(passes));
  for (int c = 0; c < n_comps; ++c) {
    compose_kernel<<<rows_grid(n), kThreads, 0, s>>>(
        *keys, static_cast<const bool*>(active), comps[c], n,
        static_cast<uint64_t*>(comp_keys) + c * n, hist);
    ++g_stream_ops;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hist += places_of(comps[c]) * kDigits;
  }
  return 0;
}

// The passes of every composite, least significant first, over the keys
// group_sort_compose wrote: alt_keys (uint64 [n]) and idx_a / idx_b (int32
// [n]) are the other buffers. result[0] and result[1] get the sorted keys
// of the last composite and the permutation (null: no pass ran).
extern "C" int group_sort_passes(const Composite* comps, int n_comps, int64_t n, void* comp_keys,
                                 void* alt_keys, void* idx_a, void* idx_b, void* scratch,
                                 void** result, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  result[0] = nullptr;
  result[1] = nullptr;
  if (n_comps <= 0 || n <= 0) return 0;
  // the pass takes the tile's dynamic shared memory (set once, thread-safe)
  static const cudaError_t sized = cudaFuncSetAttribute(
      hopper::radix::sweep_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, kSweepSmem);
  if (sized != cudaSuccess) return static_cast<int>(sized);
  int passes = 0;
  for (int c = 0; c < n_comps; ++c) passes += places_of(comps[c]);
  int64_t* words = static_cast<int64_t*>(scratch);
  const int64_t tiles = sweep_tiles(n);
  uint64_t* a = static_cast<uint64_t*>(comp_keys);
  uint64_t* b = static_cast<uint64_t*>(alt_keys);
  int32_t* ib[2] = {static_cast<int32_t*>(idx_a), static_cast<int32_t*>(idx_b)};
  const uint64_t* kin = a;
  const int32_t* perm = nullptr;
  int place = 0;
  for (int c = 0; c < n_comps; ++c) {
    kin = a + c * n;  // composite c in row order
    for (int p = 0; p < places_of(comps[c]); ++p, ++place) {
      uint64_t* kout = kin == a ? b : a;
      int32_t* iout = perm == ib[0] ? ib[1] : ib[0];
      hopper::radix::sweep_pass<<<static_cast<unsigned>(tiles), kThreads, kSweepSmem, s>>>(
          kin, perm, c > 0 && p == 0, kout, iout, n, kDigitBits * p,
          reinterpret_cast<const int32_t*>(words + hist_offset(passes)) + place * kDigits,
          reinterpret_cast<unsigned long long*>(words + status_offset(passes)) +
              place * tiles * kDigits,
          reinterpret_cast<unsigned int*>(words + place));
      ++g_stream_ops;
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      kin = kout;
      perm = iout;
    }
  }
  result[0] = const_cast<uint64_t*>(kin);
  result[1] = const_cast<int32_t*>(perm);
  return 0;
}

// active_out, new_group and num_groups (zeroed by group_sort_stats), then the
// gathers by ``perm`` (null: the identity). With n_comps == 1, sorted_keys
// holds the sorted composite, whose inactive bit is at inactive_pos (-1: none,
// and every row is all_active), and the ``decode`` columns are written from
// it (none otherwise).
extern "C" int group_sort_finish(const hopper::WideKeySet* keys, const void* active, int64_t n,
                                 int n_comps, const void* sorted_keys, const void* perm,
                                 int inactive_pos, int all_active,
                                 const hopper::DecodeSet* decode, const PermGatherSet* gather,
                                 int n_gather, void* active_out, void* new_group,
                                 void* num_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int32_t* pm = static_cast<const int32_t*>(perm);
  bool* ao = static_cast<bool*>(active_out);
  bool* ng = static_cast<bool*>(new_group);
  int64_t* cnt = static_cast<int64_t*>(num_groups);
  if (n_comps == 1) {
    finish_sorted_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const uint64_t*>(sorted_keys), pm, n, inactive_pos, all_active, *decode, ao,
        ng, cnt);
  } else {
    finish_kernel<<<grid_for(n), kThreads, 0, s>>>(*keys, static_cast<const bool*>(active), pm,
                                                  n, ao, ng, cnt);
  }
  ++g_stream_ops;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int sets = 0;  // the gather sets that hold columns
  while (sets < n_gather && gather[sets].n > 0) ++sets;
  err = hopper::radix::perm_gather(gather, sets, pm, n, s);
  g_stream_ops += sets;
  return static_cast<int>(err);
}
