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
// written once in its new order, with new_group beside it; the sort's own
// traffic (keys and indices per pass) is what this kernel adds above it.
//
// Design:
//   1. group_sort_stats: one reduction gives each key's least and largest
//      normalized value over its valid rows and its valid-row count, and
//      the active-row count. The wrapper reads them (one host sync) and
//      packs the sort into as few 64-bit composite keys as it can: each
//      key contributes its value as (value - min) in bit_length(max - min)
//      bits (0 for NULL rows, which its validity bit separates) and its
//      validity as one bit, unless either is the same on every row (a
//      stable pass over equal digits is the identity); ~active adds one
//      bit when the page has both kinds of rows. Fields are packed least
//      significant first and never split. The order of a composite is the
//      lexicographic order of its fields, so this is exact.
//   2. For each composite, least significant first: compose_kernel writes
//      every row's composite in the current order (reading each key through
//      the permutation so far), then ceil(bits / 8) eight-bit passes of
//      radix_pass.cuh move (composite, row index) pairs.
//   3. finish_kernel sets active and new_group in sorted order and counts
//      num_groups (a ballot's population count, one atomic per warp);
//      perm_gather writes every needed column in sorted order.
// On TPC-H Q10 at SF10 (three keys of about 21 bits each, build-side keys
// NULL on the inactive slots) that is two composites and nine passes,
// where the reference's chain has 3 * 9 + 1 = 28.

#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"
#include "radix_pass.cuh"

namespace hopper {

// a value and a validity per key, then ~active
constexpr int kMaxFields = 2 * kMaxWideKeys + 1;

enum FieldKind : int { kValueField = 0, kValidField = 1, kInactiveField = 2 };

// Bits [pos, pos + bits) of a composite: for kValueField the key's
// normalized value minus ``offset`` (0 where NULL), for kValidField its
// validity, for kInactiveField the row's inactivity.
struct Field {
  int kind;
  int key;
  int64_t offset;
  int bits;
  int pos;
};

struct Composite {
  Field field[kMaxFields];
  int n_fields;
  int bits;
};

}  // namespace hopper

namespace {

using hopper::Composite;
using hopper::grid_for;
using hopper::kThreads;
using hopper::kWarps;
using hopper::PermGatherSet;

constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kStatsPerKey = 3;  // min, max, valid rows

__global__ void stats_init_kernel(int64_t* stats, int nk) {
  const int i = threadIdx.x;
  if (i < nk) {
    stats[i] = INT64_MAX;
    stats[nk + i] = INT64_MIN;
    stats[2 * nk + i] = 0;
  }
  if (i == 0) stats[kStatsPerKey * nk] = 0;
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

// stats = [min_k..., max_k..., valid_rows_k..., active_rows] over all rows
// (active or not: inactive rows are sorted too).
__global__ void __launch_bounds__(kThreads)
stats_kernel(hopper::WideKeySet ks, const bool* __restrict__ active, int64_t n,
             int64_t* __restrict__ stats) {
  __shared__ int64_t part[kWarps][kStatsPerKey * hopper::kMaxWideKeys + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nk = ks.n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int k = 0; k <= nk; ++k) {
    int64_t lo = INT64_MAX, hi = INT64_MIN, cnt = 0;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
         i += stride) {
      if (k == nk) {
        cnt += active[i] ? 1 : 0;
      } else {
        int64_t v;
        if (hopper::load_key(ks.col[k], i, &v)) {
          lo = min64(lo, v);
          hi = max64(hi, v);
          ++cnt;
        }
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    cnt = warp_sum(cnt);
    if (lane == 0) {
      if (k == nk) {
        part[warp][kStatsPerKey * nk] = cnt;
      } else {
        part[warp][k] = lo;
        part[warp][nk + k] = hi;
        part[warp][2 * nk + k] = cnt;
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

// keys_out[i] = the composite of row perm[i] (perm null: row i).
__global__ void __launch_bounds__(kThreads)
compose_kernel(hopper::WideKeySet ks, const bool* __restrict__ active, Composite c,
               const int32_t* __restrict__ perm, int64_t n, uint64_t* __restrict__ keys_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = perm != nullptr ? perm[i] : i;
    uint64_t v = 0;
    for (int f = 0; f < c.n_fields; ++f) {
      const hopper::Field& fd = c.field[f];
      uint64_t x;
      if (fd.kind == hopper::kValueField) {
        int64_t k;
        const bool ok = hopper::load_key(ks.col[fd.key], r, &k);
        x = ok ? static_cast<uint64_t>(k) - static_cast<uint64_t>(fd.offset) : 0;
      } else if (fd.kind == hopper::kValidField) {
        x = ks.col[fd.key].valid[r] ? 1 : 0;
      } else {
        x = active[r] ? 0 : 1;
      }
      v |= x << fd.pos;
    }
    keys_out[i] = v;
  }
}

// Normalized key k of row r as the reference compares it: order_key, and
// INT64_MAX where NULL; *valid gets the validity.
__device__ __forceinline__ int64_t norm_key(const hopper::KeyCol& c, int64_t r, bool* valid) {
  int64_t v;
  *valid = hopper::load_key(c, r, &v);
  return *valid ? v : INT64_MAX;
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(hopper::WideKeySet ks, const bool* __restrict__ active,
              const int32_t* __restrict__ perm, int64_t n, bool* __restrict__ active_out, bool* __restrict__ new_group,
              int64_t* __restrict__ num_groups) {
  const int lane = threadIdx.x & 31;
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
    const unsigned ballot = __ballot_sync(0xffffffffu, ng);
    if (lane == 0 && ballot != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(num_groups),
                static_cast<unsigned long long>(__popc(ballot)));
    }
  }
}

}  // namespace

extern "C" int wide_key_limit() { return hopper::kMaxWideKeys; }
extern "C" int radix_tile_rows() { return hopper::radix::kTileRows; }
extern "C" int radix_perm_cols() { return hopper::kMaxPermCols; }

// Each key's value range and valid-row count, and the active-row count,
// into ``stats`` (int64 [3 * nk + 1]) on ``stream``.
extern "C" int group_sort_stats(const hopper::WideKeySet* keys, const void* active, int64_t n,
                                void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* st = static_cast<int64_t*>(stats);
  stats_init_kernel<<<1, 32, 0, s>>>(st, keys->n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  stats_kernel<<<grid_for(n), kThreads, 0, s>>>(*keys, static_cast<const bool*>(active), n, st);
  return static_cast<int>(cudaGetLastError());
}

// The sort by ``n_comps`` composites (least significant first), then
// active_out, new_group, num_groups (int64, zeroed here) and the gathers.
// keys_a/keys_b (uint64 [n]), idx_a/idx_b (int32 [n]), hist (int32 [256 *
// tiles]) and totals (int32 [256]) are scratch the caller allocates.
extern "C" int group_sort(const hopper::WideKeySet* keys, const void* active, int64_t n,
                          const Composite* comps, int n_comps, void* keys_a, void* keys_b,
                          void* idx_a, void* idx_b, void* hist, void* totals,
                          const PermGatherSet* gather, int n_gather, void* active_out,
                          void* new_group, void* num_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(num_groups, 0, sizeof(int64_t), s);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const bool* act = static_cast<const bool*>(active);
  uint64_t* kb[2] = {static_cast<uint64_t*>(keys_a), static_cast<uint64_t*>(keys_b)};
  int32_t* ib[2] = {static_cast<int32_t*>(idx_a), static_cast<int32_t*>(idx_b)};
  int32_t* perm = nullptr;
  for (int c = 0; c < n_comps; ++c) {
    compose_kernel<<<grid_for(n), kThreads, 0, s>>>(*keys, act, comps[c], perm, n, kb[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int cur = 0;
    for (int shift = 0; shift < comps[c].bits; shift += kDigitBits) {
      int32_t* out = perm == ib[0] ? ib[1] : ib[0];
      err = hopper::radix::radix_pass<kBins, uint64_t, true>(
          kb[cur], perm, kb[1 - cur], out, n, shift, kBins - 1, kBins,
          static_cast<int32_t*>(hist), static_cast<int32_t*>(totals), nullptr, nullptr, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      cur = 1 - cur;
      perm = out;
    }
  }
  finish_kernel<<<grid_for(n), kThreads, 0, s>>>(*keys, act, perm, n,
                                                static_cast<bool*>(active_out),
                                                static_cast<bool*>(new_group),
                                                static_cast<int64_t*>(num_groups));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hopper::radix::perm_gather(gather, n_gather, perm, n, s));
}
