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
// a row each, every key's data and validity read once.
//
// Design: one launch a call, with the key set passed by value (a
// PresortArgs parameter of up to kMaxPresortKeys keys) and no memset. A
// block takes a tile of kTileRows rows, its id from an atomic counter (so
// it waits only on tiles that running blocks hold), 8 consecutive rows a
// thread. The thread reads every column before anything waits: its 8
// activity bytes as one 64-bit load, each key's 8 values with 16-byte
// loads and their validities as one word (the kernel is specialised on
// the first key's type, so the pass over it makes no choice a row), and
// keeps of each key only a summary of its active rows: the first and the
// last key, and bit masks of the rows whose key differs from, or is below,
// the previous active row's in the thread. Those give new_group and the
// violations of every row but the thread's first active one. The thread's
// last keys are staged in shared memory; the tile's last active row is
// block-scanned with max and published (its aggregate), then a one-warp
// decoupled look-back finds the last active row before the tile: the
// nearest earlier tile that has an active row, or has published its
// inclusive prefix, ends the walk (a max needs no further tile), so a run
// of empty tiles is crossed 32 tiles a step. The tile then publishes its
// prefix, and each thread's first active row is compared with the last
// active row before it: in the staged keys of the thread that holds it,
// or, where it lies in an earlier tile (at most the tile's first rows),
// read from device memory. new_group is written as one 64-bit store a
// thread. The block's counts of new_group and of violations go to the
// state with one atomic each; the last block to finish writes num_groups
// and the violation, and sets the counters back to zero.
//
// State: a buffer the wrapper keeps for each device and stream (zeroed
// once, when it is made): kStateHead counters, then one status word a
// tile. A status word carries its launch's epoch (a tag the wrapper
// advances every launch), so a word left by an earlier launch reads as
// not yet published and nothing clears the words between launches; the
// counters come back to zero at the end of every launch. Two streams
// never share a buffer. A key set longer than kMaxPresortKeys takes one
// more launch for each kMaxPresortKeys - 1 later keys: the same pass over
// the first key and those keys, which writes neither new_group nor
// num_groups and ORs its violation into the first launch's.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"

namespace hopper {

constexpr int kMaxPresortKeys = 8;

// One group key: its storage (KeyType) and validity.
struct PresortKey {
  const void* data;
  const bool* valid;
  int64_t type;
};

// One launch's whole input, passed by value.
struct PresortArgs {
  PresortKey key[kMaxPresortKeys];
  const bool* active;
  long long* state;        // kStateHead counters, then a status word a tile
  bool* new_group;         // null: a later-key launch (violation only)
  long long* num_groups;   // 0-d int64
  bool* violation;         // 0-d bool
  int64_t n;
  uint64_t epoch;          // 1 .. kEpochMask
  int n_keys;
};

}  // namespace hopper

namespace {

using hopper::kThreads;
using hopper::kWarps;
using hopper::PresortArgs;
using hopper::PresortKey;

constexpr int kItems = 8;                    // consecutive rows a thread
constexpr int kTileRows = kThreads * kItems;
constexpr int kMinBlocks = 4;                // resident blocks an SM (64 registers)
// counters ahead of the tile status words: tile ids taken, num_groups,
// tiles with a violation, finished tiles
constexpr int kStateHead = 4;

// A status word: flag (2 bits: aggregate, prefix), epoch, value (the last
// active row + 1).
constexpr int kFlagShift = 62;
constexpr int kValueBits = 40;
constexpr unsigned long long kAggregate = 1ull << kFlagShift;
constexpr unsigned long long kPrefix = 2ull << kFlagShift;
constexpr unsigned long long kValueMask = (1ull << kValueBits) - 1;
constexpr unsigned long long kEpochMask = (1ull << (kFlagShift - kValueBits)) - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long word) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word) : "memory");
}

// kernels.order_key of element i of a column of KeyType T.
template <int T>
__device__ __forceinline__ int64_t order_key_of(const void* data, int64_t i) {
  if constexpr (T == hopper::kF64) {
    return hopper::float_order_key(static_cast<const double*>(data)[i]);
  } else if constexpr (T == hopper::kF32) {
    return hopper::float_order_key(static_cast<double>(static_cast<const float*>(data)[i]));
  } else if constexpr (T == hopper::kI64) {
    return static_cast<const int64_t*>(data)[i];
  } else if constexpr (T == hopper::kI32) {
    return static_cast<const int32_t*>(data)[i];
  } else if constexpr (T == hopper::kI16) {
    return static_cast<const int16_t*>(data)[i];
  } else if constexpr (T == hopper::kI8) {
    return static_cast<const int8_t*>(data)[i];
  } else {
    return static_cast<const uint8_t*>(data)[i] ? 1 : 0;
  }
}

template <int T>
struct Bytes {
  static constexpr int value = T == hopper::kI64 || T == hopper::kF64 ? 8
                               : T == hopper::kI32 || T == hopper::kF32 ? 4
                               : T == hopper::kI16 ? 2 : 1;
};

// The 8 bytes at rows r0 .. r0 + 7 as one word (byte j: row r0 + j; rows
// past n read as 0): one 64-bit load where they are whole and aligned.
__device__ __forceinline__ uint64_t load_bytes8(const bool* p, int64_t r0, int64_t n) {
  const bool* a = p + r0;
  if (r0 + kItems <= n && (reinterpret_cast<uintptr_t>(a) & 7) == 0) {
    return *reinterpret_cast<const uint64_t*>(a);
  }
  uint64_t w = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (r0 + j < n && a[j]) w |= 1ull << (8 * j);
  }
  return w;
}

// The order key of element j of 8 elements of KeyType T held as words u
// (element j at byte j * Bytes<T>).
template <int T>
__device__ __forceinline__ int64_t element_key(const uint64_t (&u)[Bytes<T>::value], int j) {
  constexpr int B = Bytes<T>::value;
  const uint64_t w = u[(j * B) / 8];
  const int sh = ((j * B) % 8) * 8;
  if constexpr (T == hopper::kF64) {
    return hopper::float_order_key(__longlong_as_double(static_cast<long long>(w)));
  } else if constexpr (T == hopper::kF32) {
    const float f = __int_as_float(static_cast<int>(static_cast<uint32_t>(w >> sh)));
    return hopper::float_order_key(static_cast<double>(f));
  } else if constexpr (T == hopper::kI64) {
    return static_cast<int64_t>(w);
  } else if constexpr (T == hopper::kI32) {
    return static_cast<int32_t>(static_cast<uint32_t>(w >> sh));
  } else if constexpr (T == hopper::kI16) {
    return static_cast<int16_t>(static_cast<uint16_t>(w >> sh));
  } else if constexpr (T == hopper::kI8) {
    return static_cast<int8_t>(static_cast<uint8_t>(w >> sh));
  } else {
    return (w >> sh) & 0xff ? 1 : 0;
  }
}

// Key c over the thread's active rows (bit j of act: row r0 + j), as order
// keys, INT64_MAX where NULL: the first and the last row's key, and for
// each active row after the thread's first, bit j of diff where its key
// differs from the previous active row's and of down where it is smaller.
struct KeyRun {
  int64_t first;
  int64_t last;
  uint32_t diff;
  uint32_t down;
};

// key_run of a column of KeyType T: its 8 values read with 16-byte loads
// (one 8-byte load for one-byte elements) where they are whole and
// aligned, the validities as one word.
template <int T>
__device__ __forceinline__ KeyRun key_run(const PresortKey& c, int64_t r0, int64_t n,
                                          uint32_t act) {
  constexpr int B = Bytes<T>::value;
  const uint64_t v = load_bytes8(c.valid, r0, n);
  const unsigned char* a = static_cast<const unsigned char*>(c.data) + r0 * B;
  uint64_t u[B];
  if (r0 + kItems <= n && (reinterpret_cast<uintptr_t>(a) & (B == 1 ? 7 : 15)) == 0) {
    if constexpr (B == 1) {
      u[0] = *reinterpret_cast<const uint64_t*>(a);
    } else {
#pragma unroll
      for (int q = 0; q < B / 2; ++q) {
        const ulonglong2 x = reinterpret_cast<const ulonglong2*>(a)[q];
        u[2 * q] = x.x;
        u[2 * q + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < B; ++q) u[q] = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (r0 + j >= n) break;
      uint64_t e = 0;
      if constexpr (B == 8) {
        e = reinterpret_cast<const uint64_t*>(a)[j];
      } else if constexpr (B == 4) {
        e = reinterpret_cast<const uint32_t*>(a)[j];
      } else if constexpr (B == 2) {
        e = reinterpret_cast<const uint16_t*>(a)[j];
      } else {
        e = a[j];
      }
      u[(j * B) / 8] |= e << (((j * B) % 8) * 8);
    }
  }
  KeyRun r{0, 0, 0u, 0u};
  bool has = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!(act >> j & 1u)) continue;
    const int64_t k = (v >> (8 * j)) & 0xff ? element_key<T>(u, j) : INT64_MAX;
    if (has) {
      r.diff |= static_cast<uint32_t>(k != r.last) << j;
      r.down |= static_cast<uint32_t>(k < r.last) << j;
    } else {
      r.first = k;
    }
    r.last = k;
    has = true;
  }
  return r;
}

// key_run of a key whose type is read at run time (once a thread).
__device__ __forceinline__ KeyRun key_run_any(const PresortKey& c, int64_t r0, int64_t n,
                                              uint32_t act) {
  switch (c.type) {
    case hopper::kF64: return key_run<hopper::kF64>(c, r0, n, act);
    case hopper::kF32: return key_run<hopper::kF32>(c, r0, n, act);
    case hopper::kI64: return key_run<hopper::kI64>(c, r0, n, act);
    case hopper::kI32: return key_run<hopper::kI32>(c, r0, n, act);
    case hopper::kI16: return key_run<hopper::kI16>(c, r0, n, act);
    case hopper::kI8: return key_run<hopper::kI8>(c, r0, n, act);
    default: return key_run<hopper::kBool>(c, r0, n, act);
  }
}

// Key c at row i as an order key, INT64_MAX where NULL.
__device__ __forceinline__ int64_t key_at(const PresortKey& c, int64_t i) {
  if (!c.valid[i]) return INT64_MAX;
  switch (c.type) {
    case hopper::kF64: return order_key_of<hopper::kF64>(c.data, i);
    case hopper::kF32: return order_key_of<hopper::kF32>(c.data, i);
    case hopper::kI64: return order_key_of<hopper::kI64>(c.data, i);
    case hopper::kI32: return order_key_of<hopper::kI32>(c.data, i);
    case hopper::kI16: return order_key_of<hopper::kI16>(c.data, i);
    case hopper::kI8: return order_key_of<hopper::kI8>(c.data, i);
    default: return order_key_of<hopper::kBool>(c.data, i);
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
// over the status words of this launch's epoch and returned to every
// thread.
__device__ int64_t look_back(const unsigned long long* status, int64_t tile,
                             unsigned long long epoch) {
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
        } while ((w >> kFlagShift) == 0 || ((w >> kValueBits) & kEpochMask) != epoch);
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

template <int T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) presorted_kernel(const PresortArgs a) {
  __shared__ unsigned int s_tile;
  // each thread's last active row's keys (read by the threads after it) and
  // its first active row's later keys (read by itself after the scan)
  __shared__ int64_t s_last[hopper::kMaxPresortKeys][kThreads];
  __shared__ int64_t s_first[hopper::kMaxPresortKeys][kThreads];
  __shared__ int s_groups;
  unsigned long long* state = reinterpret_cast<unsigned long long*>(a.state);
  unsigned long long* status = state + kStateHead;
  const int64_t n = a.n;
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    s_tile = static_cast<unsigned>(atomicAdd(state, 1ull));
    s_groups = 0;
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t t0 = tile * kTileRows;
  const int64_t r0 = t0 + static_cast<int64_t>(threadIdx.x) * kItems;
  // every column is read before the scan: the thread's active rows, each
  // key's runs over them, its first and last keys staged
  const uint64_t act_bytes = load_bytes8(a.active, r0, n);
  uint32_t act = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) act |= static_cast<uint32_t>((act_bytes >> (8 * j)) & 0xff ? 1 : 0) << j;
  const int64_t mine = act ? r0 + (31 - __clz(act)) : -1;  // the thread's last active row
  const KeyRun k0 = key_run<T>(a.key[0], r0, n, act);
  bool bad = k0.down != 0;
  s_last[0][threadIdx.x] = k0.last;
  for (int c = 1; c < a.n_keys; ++c) {
    const KeyRun kc = key_run_any(a.key[c], r0, n, act);
    // a later key that changes on a row continuing its first key's run
    bad = bad || (kc.diff & ~k0.diff) != 0;
    s_last[c][threadIdx.x] = kc.last;
    s_first[c][threadIdx.x] = kc.first;
  }
  int64_t tile_last;
  const int64_t before_me = block_exclusive_max(mine, &tile_last);  // barriers: staged
  const unsigned long long tag = a.epoch << kValueBits;
  if (threadIdx.x == 0) {
    publish(status + tile, (tile == 0 ? kPrefix : kAggregate) | tag
                               | static_cast<unsigned long long>(tile_last + 1));
  }
  const int64_t before_tile = tile == 0 ? -1 : look_back(status, tile, a.epoch);
  if (threadIdx.x == 0 && tile > 0) {
    const int64_t p = tile_last > before_tile ? tile_last : before_tile;
    publish(status + tile, kPrefix | tag | static_cast<unsigned long long>(p + 1));
  }
  // the thread's first active row against the last active row before it:
  // from the thread that staged it, or (in an earlier tile: once a tile)
  // from device memory
  const int64_t prev = before_me >= 0 ? before_me : before_tile;
  auto prev_key = [&](int c) -> int64_t {
    if (prev >= t0) return s_last[c][(prev - t0) / kItems];
    return key_at(a.key[c], prev);
  };
  uint32_t ng = k0.diff;  // bit j: row r0 + j starts a group
  if (act) {
    bool starts = prev < 0;
    if (!starts) {
      const int64_t pk = prev_key(0);
      starts = k0.first != pk;
      bad = bad || k0.first < pk;
      for (int c = 1; c < a.n_keys && !starts; ++c) {
        bad = bad || s_first[c][threadIdx.x] != prev_key(c);
      }
    }
    ng |= static_cast<uint32_t>(starts) << (__ffs(act) - 1);
  }
  const bool first = a.new_group != nullptr;
  if (first && r0 < n) {
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) word |= static_cast<uint64_t>(ng >> j & 1u) << (8 * j);
    bool* out = a.new_group + r0;
    if (r0 + kItems <= n && (reinterpret_cast<uintptr_t>(out) & 7) == 0) {
      *reinterpret_cast<uint64_t*>(out) = word;
    } else {
      for (int j = 0; j < kItems && r0 + j < n; ++j) out[j] = ng >> j & 1u;
    }
  }
  // block sums of the group starts and the violations
  const int groups = __popc(ng);
  if (groups) atomicAdd(&s_groups, groups);
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    if (s_groups) atomicAdd(state + 1, static_cast<unsigned long long>(s_groups));
    if (any_bad) atomicAdd(state + 2, 1ull);
    __threadfence();
    const unsigned long long done = atomicAdd(state + 3, 1ull);
    if (done == static_cast<unsigned long long>(n_tiles - 1)) {
      // the last block: every other has added its counts and taken its id
      __threadfence();
      const unsigned long long groups_all = atomicAdd(state + 1, 0ull);
      const bool violated = atomicAdd(state + 2, 0ull) != 0;
      if (first) {
        *a.num_groups = static_cast<long long>(groups_all);
        *a.violation = violated;
      } else if (violated) {
        *a.violation = true;
      }
      state[0] = 0;
      state[1] = 0;
      state[2] = 0;
      state[3] = 0;
    }
  }
}

// presorted_kernel for the first key's type.
void launch(const PresortArgs& a, unsigned grid, cudaStream_t s) {
  switch (a.key[0].type) {
    case hopper::kF64: presorted_kernel<hopper::kF64><<<grid, kThreads, 0, s>>>(a); break;
    case hopper::kF32: presorted_kernel<hopper::kF32><<<grid, kThreads, 0, s>>>(a); break;
    case hopper::kI64: presorted_kernel<hopper::kI64><<<grid, kThreads, 0, s>>>(a); break;
    case hopper::kI32: presorted_kernel<hopper::kI32><<<grid, kThreads, 0, s>>>(a); break;
    case hopper::kI16: presorted_kernel<hopper::kI16><<<grid, kThreads, 0, s>>>(a); break;
    case hopper::kI8: presorted_kernel<hopper::kI8><<<grid, kThreads, 0, s>>>(a); break;
    default: presorted_kernel<hopper::kBool><<<grid, kThreads, 0, s>>>(a); break;
  }
}

}  // namespace

extern "C" int presorted_group_tile_rows() { return kTileRows; }

extern "C" int presorted_group_state_head() { return kStateHead; }

extern "C" int presorted_group_max_keys() { return hopper::kMaxPresortKeys; }

extern "C" int64_t presorted_group_max_epoch() { return static_cast<int64_t>(kEpochMask); }

extern "C" int64_t presorted_group_max_rows() { return static_cast<int64_t>(kValueMask); }

// Stream operations (launches) issued by presorted_group since the library
// was loaded.
static std::atomic<int64_t> g_presorted_stream_ops{0};

extern "C" int64_t presorted_group_stream_ops() { return g_presorted_stream_ops.load(); }

// The grouping of ``n`` rows by ``n_keys`` keys (host array) on ``stream``:
// launch l takes epoch ``epoch + l`` (the wrapper keeps every epoch of a
// state buffer within 1 .. kEpochMask and distinct from the last one's).
// ``state`` (int64 [kStateHead + tiles], the stream's own buffer: its
// counters zero, its status words of other epochs). Writes new_group (bool
// [n]), num_groups (int64 [1]) and violation (bool [1]). Returns the first
// CUDA error, 0 on success.
extern "C" int presorted_group(const hopper::PresortKey* keys, int n_keys, const void* active,
                               int64_t n, void* state, int64_t epoch, void* new_group,
                               void* num_groups, void* violation, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_keys <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kTileRows - 1) / kTileRows);
  PresortArgs a{};
  a.active = static_cast<const bool*>(active);
  a.state = static_cast<long long*>(state);
  a.num_groups = static_cast<long long*>(num_groups);
  a.violation = static_cast<bool*>(violation);
  a.n = n;
  a.key[0] = keys[0];
  // the first launch: the first kMaxPresortKeys keys; each later one the
  // first key and the next kMaxPresortKeys - 1
  int at = 1;
  for (int l = 0; at < n_keys || l == 0; ++l) {
    a.n_keys = 1;
    while (at < n_keys && a.n_keys < hopper::kMaxPresortKeys) a.key[a.n_keys++] = keys[at++];
    a.new_group = l == 0 ? static_cast<bool*>(new_group) : nullptr;
    a.epoch = static_cast<uint64_t>(epoch + l);
    launch(a, grid, s);
    ++g_presorted_stream_ops;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
