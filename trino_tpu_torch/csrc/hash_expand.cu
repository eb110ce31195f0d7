// Hash-join expansion: every output slot's probe row and matching build
// row, then the gather of both sides' columns into the joined page.
//
// Replaces: the join stage of trino_tpu/ops/megakernels.py
// _expand_phase_body + expand_phase (the Pallas body that runs
// kernels.expand_probe_slots, finds each slot's (d+1)-th equal-key slot of
// its bucket by a cumsum over the [N_out, C] match block, and gathers the
// probe and build columns), and the exchange destination stage at the end
// of that body (epi_spec's _partition_dest, megakernels.py:448-453) when
// the joined page is the phase's output. The body's later stages run after
// this kernel: the fused projection in expr_program.cu, the presorted
// grouping in presorted_group.cu, the direct aggregation in
// segment_agg_direct.cu and the sort stage in group_sort.cu.
//
// For each output slot p < out_cap, bit-identical to the plain version
// (hopper_kernels.hash_expand_plain):
//   start      = exclusive scan of emit (int64, so no count overflows)
//   probe_idx  = the last i with start[i] <= p (zero-emit ties resolve to
//                the larger i), clipped to [0, N-1]
//   d          = p - start[probe_idx];  matched = d < count[probe_idx]
//   bpos       = the (d+1)-th slot of the probe row's bucket whose build row
//                has the probe row's keys (slot 0 where there is none),
//                as a build row index clipped to [0, M-1]
//   out_active = p < total emitted rows
// then each probe column gathered at probe_idx and each build column at
// bpos, with build validity & matched. The slots p >= total all belong to
// row N-1 (start[N-1] <= total), with d = p - start[N-1] >= emit[N-1].
// Given destination keys (columns of either side), dest[p] is the
// partition of the slot's gathered keys (partition_hash.cuh), n_parts
// where out_active is false: partition_dest_plain over the joined page.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The scan reads emit once (4
// bytes a probe row); each output slot reads its probe row's count, bucket,
// keys and activity, the occupied slots of one bucket and the build keys
// they hold, and gathers and writes every column. On TPC-H Q3 the probe
// side is 230 times the output, so the read of emit is most of the bytes.
//
// Design against that bound: one memset, then two launches.
// - The scan pass reads emit once, in one pass. A block takes a tile of
//   24,576 probe rows, its id from an atomic counter (so a block only ever
//   waits on tiles that running blocks hold), copies it into 96 KB of
//   shared memory with 24 16-byte cp.async copies a thread, and rewrites it
//   in place as the tile's exclusive scan in int32 (one round-major scan,
//   three barriers). It publishes its aggregate, then runs a block-wide
//   decoupled look-back over the 256 tiles before it for its offset, then
//   publishes its inclusive prefix: each as one 64-bit status word, flag in
//   the top two bits, read and written relaxed at device scope; the memset
//   zeroes the words on the stream before each launch. A tile waits until
//   every tile back to the nearest published prefix has its aggregate, and
//   its SM reads nothing for it meanwhile: the large tiles keep two of them,
//   192 KB, in flight on each SM (chip_smoke.py prints this pass's time).
//   The tile then owns the output slots [off, off + tile sum): its threads
//   take the slots (not the rows, so one row that emits thousands of slots
//   is spread over the block) and find each slot's row by a binary search
//   over the scan in shared memory, writing the row and d (12 bytes a slot,
//   slots at or past out_cap dropped). No per-row start is written and
//   nothing searches HBM. The last tile writes the total and start[N-1].
// - The slot pass runs one thread per output slot over the whole grid:
//   the slots past the total take row N-1; a matched slot (d < count: an
//   active probe row with valid keys) walks its bucket's occupied slots in
//   ascending build order (hash_probe.cu sorted them) to the (d+1)-th equal
//   key, any other slot takes slot 0 without reading keys; then it copies
//   whole elements (1, 2, 4, 8 or 16 bytes) of the first kMaxGatherCols
//   columns straight into the joined page. Its reads are random 32-byte
//   sectors of the probe and build columns, so it runs near the sector
//   rate, not the byte bound. The walk's dependent reads stay out of the
//   scan tiles, which would otherwise hold their SM longer. With more
//   columns (no TPC-H join has them) the slot pass also saves each slot's
//   probe row, build row and matched flag, and one gather pass per further
//   kMaxGatherCols columns reads them back.
// - The destination is one more store a slot in the slot pass (the first
//   gather set's): each key is read through the rows the slot already
//   resolved (build keys with matched, as gathered) and hashed in
//   registers, so the joined page is not read again by a launch of its own.

#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"
#include "partition_hash.cuh"

namespace hopper {

constexpr int kMaxGatherCols = 16;  // columns per gather set

struct GatherCol {
  const void* src;
  const bool* src_valid;
  void* dst;
  bool* dst_valid;
  int elem_bytes;  // 1, 2, 4, 8 or 16
  int build_side;  // 1: gather at bpos and AND validity with matched
};

// Passed by value as a kernel parameter; exported through hash_expand_slots(),
// so it lives outside the anonymous namespace.
struct GatherSet {
  GatherCol col[kMaxGatherCols];
  int n;
};

// The exchange destination's keys: source columns of either side (a build
// key's validity is ANDed with matched, as it is gathered), LUTs as value
// keys. n = 0: no destination.
struct DestKeys {
  KeyCol col[kMaxWideKeys];
  int build_side[kMaxWideKeys];
  int n;
  int n_parts;
};

}  // namespace hopper

namespace {

using hopper::GatherSet;
using hopper::grid_for;
using hopper::kMaxGatherCols;
using hopper::KeySet;
using hopper::kMaxKeys;
using hopper::kThreads;
using hopper::kWarps;

constexpr int kVec = 4;                               // emit values per 16-byte copy
constexpr int kRounds = 24;                           // copies per thread per tile
constexpr int kRoundRows = kThreads * kVec;           // rows of one round
constexpr int kTileRows = kRoundRows * kRounds;       // probe rows per scan tile
constexpr int kTileBytes = kTileRows * 4;             // the tile in shared memory
// scan blocks an SM should hold: about 192 KB of tiles in flight
constexpr int kMinBlocks = 196608 / kTileBytes;
constexpr int kLaneEntries = kRounds * kWarps / 32;   // (round, warp) totals per lane
static_assert(kRounds * kWarps == 32 * kLaneEntries, "whole lanes in the tile scan");
// the scan state ahead of the status words: tile counter, total, start[N-1]
constexpr int kStateHead = 3;

// Tile status word: flag in the top two bits, a sum of emit below (at most
// N * 2^31 < 2^62 for N < 2^31 probe rows).
constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1ull << kFlagShift;  // the tile's own sum
constexpr unsigned long long kPrefix = 2ull << kFlagShift;     // inclusive prefix
constexpr unsigned long long kValueMask = (1ull << kFlagShift) - 1;

// 16-byte asynchronous copy from global to shared memory (cp.async.cg,
// cached in L2 only), and the wait for every copy this thread issued.
__device__ __forceinline__ void copy_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Status words are read and written as single 64-bit relaxed operations at
// device scope: flag and value travel together, so no fence is needed, and
// unlike volatile accesses the loads of one window are in flight together.
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void publish(unsigned long long* status, int64_t tile,
                                        unsigned long long word) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(status + tile), "l"(word) : "memory");
}

// Tile-local exclusive scan of the rows' emit in round-major order (round
// r's vector of thread t holds rows r * kRoundRows + 4t .. + 3): s[r], the
// sum of this thread's round-r vector, becomes its exclusive prefix in
// place; returns the tile's total. One warp-level scan per round, then warp 0
// scans the (round, warp) totals, kLaneEntries a lane: three barriers in
// all, counting the one before warp_sums is reused.
__device__ __forceinline__ int64_t tile_exclusive_scan(int64_t (&s)[kRounds]) {
  __shared__ int64_t warp_sums[kRounds * kWarps];  // round-major
  __shared__ int64_t tile_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < kRounds; ++r) {
    int64_t inc = s[r];
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    s[r] = inc - s[r];
    if (lane == 31) warp_sums[r * kWarps + warp] = inc;
  }
  __syncthreads();
  if (warp == 0) {
    int64_t e[kLaneEntries];
    int64_t sum = 0;
    for (int j = 0; j < kLaneEntries; ++j) {
      e[j] = warp_sums[lane * kLaneEntries + j];
      sum += e[j];
    }
    int64_t inc = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    int64_t run = inc - sum;  // exclusive prefix of each (round, warp)
    for (int j = 0; j < kLaneEntries; ++j) {
      warp_sums[lane * kLaneEntries + j] = run;
      run += e[j];
    }
    if (lane == 31) tile_total = inc;
  }
  __syncthreads();
  for (int r = 0; r < kRounds; ++r) s[r] += warp_sums[r * kWarps + warp];
  const int64_t total = tile_total;
  __syncthreads();  // warp_sums and tile_total are read before any later write
  return total;
}

// Block-wide decoupled look-back: the sum of emit over every tile before
// ``tile``, returned to every thread. Thread k reads the status of tile
// pred - k, waiting while it is unpublished; the window ends at the nearest
// tile that has published its inclusive prefix (tiles before 0 count as a
// prefix of 0), and slides kThreads tiles further back while every tile in
// it has only its aggregate. One L2 round trip and two barriers per window.
__device__ int64_t look_back(const unsigned long long* status, int64_t tile) {
  __shared__ int64_t warp_part[kWarps];
  __shared__ int warp_done[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t excl = 0;
  for (int64_t pred = tile - 1;; pred -= kThreads) {
    const int64_t j = pred - threadIdx.x;
    unsigned long long w = kPrefix;
    if (j >= 0) {
      do {
        w = load_status(status + j);
      } while ((w >> kFlagShift) == 0);
    }
    const unsigned done = __ballot_sync(0xffffffffu, (w >> kFlagShift) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    int64_t v = lane <= stop ? static_cast<int64_t>(w & kValueMask) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) {
      warp_part[warp] = v;
      warp_done[warp] = done != 0;
    }
    __syncthreads();
    bool any = false;
    for (int i = 0; i < kWarps && !any; ++i) {
      excl += warp_part[i];
      any = warp_done[i];
    }
    __syncthreads();  // warp_part is read before the next window writes it
    if (any) return excl;
  }
}

// Local starts are kept as int32, clipped at INT32_MAX: the slot search only
// asks about q < out_cap < 2^31, for which a clipped start compares as the
// true one, and a row it selects has start <= q, so it was not clipped.
__device__ __forceinline__ int32_t clip32(int64_t v) {
  return v < INT32_MAX ? static_cast<int32_t>(v) : INT32_MAX;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const int32_t* __restrict__ emit, int64_t n, int64_t n_tiles, int64_t out_cap,
            int64_t* __restrict__ state, int64_t* __restrict__ slot_row,
            int32_t* __restrict__ slot_d) {
  // the tile's emit, then in place its exclusive scan (each thread rewrites
  // only the vectors it copied in)
  extern __shared__ __align__(16) int32_t lstart[];
  __shared__ int64_t s_last;  // start of row N-1 within the last tile
  __shared__ unsigned int s_tile;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(state + kStateHead);
  if (threadIdx.x == 0) s_tile = atomicAdd(reinterpret_cast<unsigned int*>(state), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTileRows;
  const int rows = static_cast<int>(n - base < kTileRows ? n - base : kTileRows);
  if (rows == kTileRows && (reinterpret_cast<uintptr_t>(emit) & 15) == 0) {
    for (int r = 0; r < kRounds; ++r) {
      const int li = r * kRoundRows + threadIdx.x * kVec;
      copy_async_16(lstart + li, emit + base + li);
    }
    wait_copies();
  } else {
    for (int r = 0; r < kRounds; ++r) {
      const int li = r * kRoundRows + threadIdx.x * kVec;
      for (int k = 0; k < kVec; ++k) lstart[li + k] = li + k < rows ? emit[base + li + k] : 0;
    }
  }
  int64_t ex[kRounds];
  for (int r = 0; r < kRounds; ++r) {
    const int4 v = *reinterpret_cast<const int4*>(lstart + r * kRoundRows + threadIdx.x * kVec);
    ex[r] = static_cast<int64_t>(v.x) + v.y + v.z + v.w;
  }
  const int64_t agg = tile_exclusive_scan(ex);
  for (int r = 0; r < kRounds; ++r) {
    const int li = r * kRoundRows + threadIdx.x * kVec;
    int4* at = reinterpret_cast<int4*>(lstart + li);
    const int4 v = *at;
    const int64_t st[kVec] = {ex[r], ex[r] + v.x, ex[r] + v.x + v.y, ex[r] + v.x + v.y + v.z};
    *at = make_int4(clip32(st[0]), clip32(st[1]), clip32(st[2]), clip32(st[3]));
    const int last = rows - 1 - li;  // row N-1 of the last tile, if this thread holds it
    if (tile == n_tiles - 1 && last >= 0 && last < kVec) {
      s_last = last == 0 ? st[0] : last == 1 ? st[1] : last == 2 ? st[2] : st[3];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long flag = tile == 0 ? kPrefix : kAggregate;
    publish(status, tile, flag | static_cast<unsigned long long>(agg));
  }
  const int64_t off = tile == 0 ? 0 : look_back(status, tile);
  if (threadIdx.x == 0) {
    if (tile > 0) publish(status, tile, kPrefix | static_cast<unsigned long long>(off + agg));
    if (tile == n_tiles - 1) {
      state[1] = off + agg;     // total emitted rows
      state[2] = off + s_last;  // start[N-1]
    }
  }
  const int64_t lim = agg < out_cap - off ? agg : out_cap - off;
  for (int64_t q = threadIdx.x; q < lim; q += kThreads) {
    // the first row whose start passes q; lstart[0] = 0 <= q, so lo >= 1
    int lo = 0, hi = rows;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lstart[mid] <= q) lo = mid + 1; else hi = mid;
    }
    slot_row[off + q] = base + lo - 1;
    slot_d[off + q] = static_cast<int32_t>(q - lstart[lo - 1]);
  }
}

template <typename T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst, int64_t from, int64_t to) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

__device__ __forceinline__ void gather_row(const GatherSet& cols, int64_t p, int64_t pi,
                                           int64_t bi, bool mt) {
  for (int k = 0; k < cols.n; ++k) {
    const hopper::GatherCol& c = cols.col[k];
    const int64_t from = c.build_side ? bi : pi;
    switch (c.elem_bytes) {
      case 1: copy_elem<uint8_t>(c.src, c.dst, from, p); break;
      case 2: copy_elem<uint16_t>(c.src, c.dst, from, p); break;
      case 4: copy_elem<uint32_t>(c.src, c.dst, from, p); break;
      case 8: copy_elem<uint64_t>(c.src, c.dst, from, p); break;
      default: copy_elem<ulonglong2>(c.src, c.dst, from, p); break;
    }
    c.dst_valid[p] = c.src_valid[from] && (!c.build_side || mt);
  }
}

__global__ void __launch_bounds__(kThreads)
slots_kernel(KeySet pkeys, KeySet bkeys, const int32_t* __restrict__ count,
             const int32_t* __restrict__ bucket_p, const int32_t* __restrict__ table,
             const int32_t* __restrict__ counts,
             int64_t n, int64_t m, int C, int64_t out_cap, const int64_t* __restrict__ state,
             const int64_t* __restrict__ slot_row, const int32_t* __restrict__ slot_d,
             GatherSet cols, hopper::DestKeys dk, int64_t* __restrict__ probe_idx,
             int64_t* __restrict__ bpos, bool* __restrict__ matched,
             bool* __restrict__ out_active, int32_t* __restrict__ dest) {
  const int64_t total = state[1];
  const int64_t last_start = state[2];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < out_cap;
       p += stride) {
    const bool act = p < total;
    const int64_t pi = act ? slot_row[p] : n - 1;
    const int64_t d = act ? static_cast<int64_t>(slot_d[p]) : p - last_start;
    // count > 0 only on an active probe row with valid keys, and the walk
    // finds at most count equal keys: so only a matched slot walks, and any
    // other takes slot 0, as in the plain version
    const bool mt = d < count[pi];
    const int b = bucket_p[pi];
    const int32_t* row = table + static_cast<int64_t>(b) * C;
    int slot = 0;
    if (mt) {
      int64_t keys[kMaxKeys];
      int unused;
      hopper::load_keys(pkeys, pi, keys, 1, &unused);
      const int cnt = counts[b];
      const int occ = cnt < C ? cnt : C;
      int64_t hits = 0;
      for (int c = 0; c < occ; ++c) {
        int64_t r = row[c];
        r = r < 0 ? 0 : (r >= m ? m - 1 : r);
        if (hopper::keys_equal(bkeys, r, keys) && ++hits == d + 1) {
          slot = c;
          break;
        }
      }
    }
    int64_t r = row[slot];
    r = r < 0 ? 0 : (r >= m ? m - 1 : r);
    out_active[p] = act;
    gather_row(cols, p, pi, r, mt);
    if (dk.n > 0) {
      uint64_t acc = hopper::partition::kHashSeed;
      for (int k = 0; k < dk.n; ++k) {
        const hopper::KeyCol& c = dk.col[k];
        const bool build = dk.build_side[k] != 0;
        const int64_t row = build ? r : pi;
        acc = hopper::partition::fold_key(
            acc, hopper::partition::key_bits(c, row, c.valid[row] && (!build || mt)));
      }
      dest[p] = hopper::partition::dest_of(acc, act, dk.n_parts);
    }
    if (probe_idx != nullptr) {
      probe_idx[p] = pi;
      bpos[p] = r;
      matched[p] = mt;
    }
  }
}

// The columns past the first gather set, from the slot pass's saved rows.
__global__ void __launch_bounds__(kThreads)
gather_kernel(GatherSet cols, const int64_t* __restrict__ probe_idx,
              const int64_t* __restrict__ bpos, const bool* __restrict__ matched,
              int64_t out_cap) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < out_cap;
       p += stride) {
    gather_row(cols, p, probe_idx[p], bpos[p], matched[p]);
  }
}

}  // namespace

extern "C" int hash_expand_gather_cols() { return kMaxGatherCols; }

extern "C" int hash_expand_tile_rows() { return kTileRows; }

extern "C" int hash_expand_state_head() { return kStateHead; }

extern "C" int hash_expand_look_back() { return kThreads; }

// The scan pass on ``stream``: zeroes ``state`` (int64 [3 + ceil(N /
// hash_expand_tile_rows())]: the tile counter, the total, start[N-1], then
// one status word per tile), then fills ``slot_row`` (int64 [out_cap]) and
// ``slot_d`` (int32 [out_cap]) for every slot below min(total, out_cap) and
// state[1] and state[2]. Returns the first CUDA error, 0 on success.
extern "C" int hash_expand_scan(const void* emit, int64_t n, int64_t out_cap, void* state,
                                void* slot_row, void* slot_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || out_cap <= 0) return 0;
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  // the kernel may take the tile's dynamic shared memory (set once,
  // thread-safe)
  static const cudaError_t sized = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
  if (sized != cudaSuccess) return static_cast<int>(sized);
  cudaError_t err = cudaMemsetAsync(state, 0, sizeof(int64_t) * (kStateHead + n_tiles), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<static_cast<unsigned>(n_tiles), kThreads, kTileBytes, s>>>(
      static_cast<const int32_t*>(emit), n, n_tiles, out_cap, static_cast<int64_t*>(state),
      static_cast<int64_t*>(slot_row), static_cast<int32_t*>(slot_d));
  return static_cast<int>(cudaGetLastError());
}

// The slot pass on ``stream``, after hash_expand_scan on the same state and
// slots: resolves every slot and gathers ``gather[0]`` into the joined page
// and writes ``out_active``, and with ``dest_keys->n`` > 0 each slot's
// destination into ``dest`` (int32 [out_cap]; may be null otherwise). With ``n_gather`` > 1, ``probe_idx``, ``bpos``
// (int64 [out_cap]) and ``matched`` (bool [out_cap]) are scratch the slot
// pass fills and one gather pass per further set reads; otherwise they may be
// null. Returns the first CUDA error, 0 on success.
extern "C" int hash_expand_slots(const hopper::KeySet* pkeys, const hopper::KeySet* bkeys,
                                 const void* count, const void* bucket_p, const void* table,
                                 const void* counts,
                                 int64_t n, int64_t m, int C, int64_t out_cap,
                                 const void* state, const void* slot_row, const void* slot_d,
                                 void* probe_idx, void* bpos, void* matched, void* out_active,
                                 const hopper::GatherSet* gather, int n_gather,
                                 const hopper::DestKeys* dest_keys, void* dest, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || out_cap <= 0) return 0;
  int64_t* pidx = n_gather > 1 ? static_cast<int64_t*>(probe_idx) : nullptr;
  int64_t* bp = static_cast<int64_t*>(bpos);
  bool* mt = static_cast<bool*>(matched);
  slots_kernel<<<grid_for(out_cap), kThreads, 0, s>>>(
      *pkeys, *bkeys, static_cast<const int32_t*>(count), static_cast<const int32_t*>(bucket_p),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(counts), n, m, C,
      out_cap, static_cast<const int64_t*>(state), static_cast<const int64_t*>(slot_row),
      static_cast<const int32_t*>(slot_d), gather[0], *dest_keys, pidx, bp, mt,
      static_cast<bool*>(out_active), static_cast<int32_t*>(dest));
  cudaError_t err = cudaGetLastError();
  for (int g = 1; g < n_gather && err == cudaSuccess; ++g) {
    gather_kernel<<<grid_for(out_cap), kThreads, 0, s>>>(gather[g], pidx, bp, mt, out_cap);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
