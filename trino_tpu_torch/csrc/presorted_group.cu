// The presorted grouping: group boundaries of a page already ordered on its
// first group key, found in place, with the check that the order holds.
//
// Replaces: the presorted stage of trino_tpu/ops/megakernels.py
// _expand_phase_body (its _presorted_group_impl call inside the one Pallas
// launch of expand_phase): new_group, num_groups and the sortedness
// violation over the joined page, rows kept in place.
//
// Bit-identical to hopper_kernels.presorted_group_plain
// (executor._presorted_group_impl), on n rows and K keys (any count):
//   key_k(i)      = kernels.order_key of key k's value at row i (floats
//                   unfolded), INT64_MAX where NULL
//   prev(i)       = the last active row before i (kernels.last_active_prev:
//                   runs of inactive rows are bridged), none for the first
//   new_group[i]  = active[i] and (no prev or key_0(i) != key_0(prev))
//   num_groups    = the count of new_group
//   violation     = some active row with a prev whose key_0 decreases, or
//                   which is not a group's first row and whose later key
//                   differs from prev's
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Activity and new_group one byte
// a row each, every key's data and validity read once (a row's prev is
// almost always the row before it, in the same cache line).
//
// Design: one memset of the state, one launch. A block takes a tile of
// kTileRows rows, its id from an atomic counter (so it waits only on tiles
// that running blocks hold), 8 consecutive rows a thread. The thread's last
// active row is block-scanned with max; the tile publishes its last active
// row (its aggregate), then a one-warp decoupled look-back finds the last
// active row before the tile: the nearest earlier tile that has an active
// row, or has published its inclusive prefix, ends the walk (a max needs no
// further tile), so a run of empty tiles is crossed 32 tiles a step. The
// tile then publishes its prefix. Each row compares its keys with its prev
// row's; the block's counts of new_group and of violations go to the state
// with one atomic each, and the last block to finish writes the violation
// as a bool. The key set is read from device memory (copied there on the
// stream), so any number of keys takes the same one launch.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"

namespace hopper {

// One group key: its storage (KeyType) and validity.
struct PresortKey {
  const void* data;
  const bool* valid;
  int64_t type;
};

}  // namespace hopper

namespace {

using hopper::kThreads;
using hopper::kWarps;
using hopper::PresortKey;

constexpr int kItems = 8;                    // consecutive rows a thread
constexpr int kTileRows = kThreads * kItems;
// state words ahead of the tile status words: tile counter, num_groups,
// violations, finished tiles
constexpr int kStateHead = 4;

constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1ull << kFlagShift;
constexpr unsigned long long kPrefix = 2ull << kFlagShift;
constexpr unsigned long long kValueMask = (1ull << kFlagShift) - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long word) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word) : "memory");
}

// kernels.order_key of key c at row i, INT64_MAX where NULL.
__device__ __forceinline__ int64_t key_at(const PresortKey& c, int64_t i) {
  if (!c.valid[i]) return INT64_MAX;
  switch (c.type) {
    case hopper::kF64: return hopper::float_order_key(static_cast<const double*>(c.data)[i]);
    case hopper::kF32:
      return hopper::float_order_key(static_cast<double>(static_cast<const float*>(c.data)[i]));
    case hopper::kI64: return static_cast<const int64_t*>(c.data)[i];
    case hopper::kI32: return static_cast<const int32_t*>(c.data)[i];
    case hopper::kI16: return static_cast<const int16_t*>(c.data)[i];
    case hopper::kI8: return static_cast<const int8_t*>(c.data)[i];
    default: return static_cast<const uint8_t*>(c.data)[i] ? 1 : 0;
  }
}

// Exclusive block scan of x under max (identity -1).
__device__ int64_t block_exclusive_max(int64_t x, int64_t* total) {
  __shared__ int64_t warp_m[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o && t > inc) inc = t;
  }
  int64_t excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) warp_m[warp] = inc;
  __syncthreads();
  int64_t before = -1, all = -1;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp && warp_m[w] > before) before = warp_m[w];
    if (warp_m[w] > all) all = warp_m[w];
  }
  __syncthreads();  // warp_m is read before any later write
  *total = all;
  return excl > before ? excl : before;
}

// The last active row before ``tile`` (-1: none), walked back by warp 0
// and returned to every thread.
__device__ int64_t look_back(const unsigned long long* status, int64_t tile) {
  __shared__ int64_t s_last;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int64_t last = -1;
    for (int64_t pred = tile - 1;; pred -= 32) {
      const int64_t j = pred - lane;
      unsigned long long w = kPrefix;  // before tile 0: a prefix of no row
      if (j >= 0) {
        do {
          w = load_status(status + j);
        } while ((w >> kFlagShift) == 0);
      }
      const bool stop = (w >> kFlagShift) == 2 || (w & kValueMask) != 0;
      const unsigned found = __ballot_sync(0xffffffffu, stop);
      if (found != 0) {
        const unsigned long long v = __shfl_sync(0xffffffffu, w & kValueMask, __ffs(found) - 1);
        last = static_cast<int64_t>(v) - 1;
        break;
      }
    }
    if (lane == 0) s_last = last;
  }
  __syncthreads();
  const int64_t last = s_last;
  __syncthreads();
  return last;
}

__global__ void __launch_bounds__(kThreads)
presorted_kernel(const PresortKey* __restrict__ keys, int n_keys, const bool* __restrict__ active,
                 int64_t n, int64_t n_tiles, long long* __restrict__ state,
                 bool* __restrict__ new_group, bool* __restrict__ violation) {
  __shared__ unsigned int s_tile;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(state + kStateHead);
  if (threadIdx.x == 0) s_tile = static_cast<unsigned>(atomicAdd(
      reinterpret_cast<unsigned long long*>(state), 1ull));
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t r0 = tile * kTileRows + static_cast<int64_t>(threadIdx.x) * kItems;
  bool act[kItems];
  int64_t mine = -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    act[j] = r0 + j < n && active[r0 + j];
    if (act[j]) mine = r0 + j;
  }
  int64_t tile_last;
  const int64_t before_me = block_exclusive_max(mine, &tile_last);
  if (threadIdx.x == 0) {
    publish(status + tile, (tile == 0 ? kPrefix : kAggregate)
                               | static_cast<unsigned long long>(tile_last + 1));
  }
  const int64_t before_tile = tile == 0 ? -1 : look_back(status, tile);
  if (threadIdx.x == 0 && tile > 0) {
    const int64_t p = tile_last > before_tile ? tile_last : before_tile;
    publish(status + tile, kPrefix | static_cast<unsigned long long>(p + 1));
  }
  int64_t prev = before_me > before_tile ? before_me : before_tile;
  int groups = 0;
  bool bad = false;
  const PresortKey k0 = keys[0];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = r0 + j;
    bool ng = false;
    if (act[j]) {
      const int64_t k = key_at(k0, i);
      if (prev < 0) {
        ng = true;
      } else {
        const int64_t pk = key_at(k0, prev);
        ng = k != pk;
        bad = bad || k < pk;
        for (int c = 1; c < n_keys && !ng && !bad; ++c) {
          const PresortKey kc = keys[c];
          bad = key_at(kc, i) != key_at(kc, prev);
        }
      }
      prev = i;
    }
    if (i < n) new_group[i] = ng;
    groups += ng;
  }
  // block sums of the group starts and the violations
  __shared__ int s_groups;
  if (threadIdx.x == 0) s_groups = 0;
  __syncthreads();
  if (groups) atomicAdd(&s_groups, groups);
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    if (s_groups) atomicAdd(reinterpret_cast<unsigned long long*>(state + 1),
                            static_cast<unsigned long long>(s_groups));
    if (any_bad) atomicAdd(reinterpret_cast<unsigned long long*>(state + 2), 1ull);
    __threadfence();
    const unsigned long long done =
        atomicAdd(reinterpret_cast<unsigned long long*>(state + 3), 1ull);
    if (done == static_cast<unsigned long long>(n_tiles - 1)) {
      __threadfence();
      *violation = atomicAdd(reinterpret_cast<unsigned long long*>(state + 2), 0ull) != 0;
    }
  }
}

}  // namespace

extern "C" int presorted_group_tile_rows() { return kTileRows; }

extern "C" int presorted_group_state_head() { return kStateHead; }

static std::atomic<int64_t> g_presorted_stream_ops{0};

extern "C" int64_t presorted_group_stream_ops() { return g_presorted_stream_ops.load(); }

// ``keys`` (host, n_keys entries) is copied into ``key_buf`` (device, 24
// bytes a key) on ``stream``; ``state`` (int64 [kStateHead + n_tiles]) is
// zeroed there, and after the launch holds num_groups in word 1. Writes
// new_group (bool [n]) and violation (bool [1]). Returns the first CUDA
// error, 0 on success.
extern "C" int presorted_group(const hopper::PresortKey* keys, int n_keys, void* key_buf,
                               const void* active, int64_t n, void* state, void* new_group,
                               void* violation, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_keys <= 0) return 0;
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  cudaError_t err = cudaMemcpyAsync(key_buf, keys, sizeof(hopper::PresortKey) * n_keys,
                                    cudaMemcpyHostToDevice, s);
  ++g_presorted_stream_ops;
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(state, 0, sizeof(int64_t) * (kStateHead + n_tiles), s);
  ++g_presorted_stream_ops;
  if (err != cudaSuccess) return static_cast<int>(err);
  presorted_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const PresortKey*>(key_buf), n_keys, static_cast<const bool*>(active), n,
      n_tiles, static_cast<long long*>(state), static_cast<bool*>(new_group),
      static_cast<bool*>(violation));
  ++g_presorted_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
