// Repartition epilogue: each row's destination partition, the rows sorted
// stably by destination, and each partition's offset and count.
//
// Replaces: trino_tpu/ops/megakernels.py fused_epilogue (the Pallas launch
// of ops/repartition._repartition_epilogue). That body hashes each row's
// partition keys (partition_ids: a 64-bit finalizer per key over
// kernels.order_key, INT64_MAX where NULL, dictionary codes mapped to
// their content-stable value keys, folded with an FNV-style multiply;
// unsigned modulo n_parts), sends inactive rows to n_parts, takes a
// bincount and its exclusive scan, and co-sorts every column stably by
// destination.
//
// Bit-identical to the plain version (hopper_kernels.
// partition_epilogue_plain, over ops/repartition.py).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The page is read once and
// written once in partition order; offsets and counts are 16 bytes a
// partition.
//
// Design, where the n_parts + 1 destinations fit one eight-bit digit (up
// to 255 partitions; the engine's default is 8), three launches over tiles
// of radix_pass.cuh's kTileRows (2,048) rows, none waiting on another
// block:
//   1. count: one block a tile hashes its rows (kHashRows a thread; the
//      kernel is specialized on the key count, so every key column's loads
//      are issued before any is used), writes each row's destination as
//      one byte and the tile's count of each destination;
//   2. radix_scan (radix_pass.cuh): one block a destination turns its
//      tile counts into the rows of that destination in earlier tiles, and
//      its total;
//   3. sweep: one block a tile starts cp.async copies of the tile's slices
//      of the columns (as many as fit kStageBytes of shared memory; they
//      hold no register while in flight), reads its rows' destinations and
//      ranks them per destination as the group sort's one-sweep pass does
//      (the ranking code is shared); then each staged column leaves in
//      destination order, consecutive rows of a destination to consecutive
//      positions, with no permutation in HBM. Tile 0 writes offsets and
//      counts. Columns past the first gather set (no caller has them) are
//      written by perm_gather from a permutation the sweep then also writes.
// Tried on a Q10-shaped page at 8 partitions on an H100, device us by
// kernel (tools/kernel_device_times.py, tools/probe_epilogue_variants.py):
// hashing again in the sweep instead of reading a destination byte, sweep
// 134.7 against the count's 38.4; a decoupled look-back in the sweep, as
// the group sort's pass has, at 4,096-row tiles 112.4 and at 2,048 78.2,
// and 66 without it (the tiles of a wave walk back over hundreds of tiles
// for a prefix none has published yet); each column staged through
// registers one after another 75, and with the cp.async copies 53 (20 KB
// staged at once; 60 at 68 KB).
//
// Past 255 partitions (to kMaxParts) the destinations take the
// three-launch counting pass of radix_pass.cuh over n_parts + 1 bins:
// dest_kernel writes an int32 destination a row, the pass orders the row
// indices by it (block 0 of its scatter writes offsets and counts) and
// perm_gather writes every column in that order.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "join_keys.cuh"
#include "launch.cuh"
#include "radix_pass.cuh"

namespace hopper {

constexpr int kMaxParts = 1024;

}  // namespace hopper

namespace {

using hopper::kThreads;
using hopper::kWarps;
using hopper::PermGatherSet;
using hopper::radix::kDigits;
using hopper::radix::kNoDigit;

using hopper::radix::kItems;
using hopper::radix::kTileRows;
using hopper::radix::kWarpRows;

constexpr int kMaxBins = hopper::kMaxParts + 1;
constexpr int kHashRows = 8;  // rows a thread hashes at once
static_assert(kTileRows == kThreads * kHashRows, "the count hashes a tile in one step");
// the sweep's shared memory: the tile's slices of as many columns as fit
// kStageBytes (each slice and its validity at a 16-byte boundary), then
// each staged row's destination and its row in the tile
constexpr int kStageBytes = 20 * 1024;
constexpr int kSweepSmem = kStageBytes + kTileRows * (1 + 2);

// Kernel launches and memsets issued by partition_epilogue since the
// library was loaded (chip_smoke.py reads the difference over one call).
int64_t g_stream_ops = 0;

__device__ __forceinline__ uint64_t fmix64(uint64_t x) {
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDull;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ull;
  return x ^ (x >> 33);
}

// The destinations of rows i[] (kNoDigit where i >= n) under NK keys: the
// partition of each row's keys' hash, n_parts where inactive. Every key
// column's loads, and the activity's, are issued before any is used.
template <int NK>
__device__ __forceinline__ void dest_rows(const hopper::WideKeySet& ks,
                                          const bool* __restrict__ active,
                                          const int64_t (&i)[kHashRows], int64_t n, int n_parts,
                                          uint32_t (&dest)[kHashRows]) {
  constexpr int kCols = NK > 0 ? NK : 1;
  bool in[kHashRows], act[kHashRows];
  int64_t v[kCols][kHashRows];
  bool ok[kCols][kHashRows];
#pragma unroll
  for (int r = 0; r < kHashRows; ++r) {
    in[r] = i[r] < n;
    act[r] = in[r] && active[i[r]];
  }
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const hopper::KeyCol& c = ks.col[k];
#pragma unroll
    for (int r = 0; r < kHashRows; ++r) ok[k][r] = in[r] && c.valid[i[r]];
    hopper::load_values(c, i, in, v[k]);
  }
  // a key's lut, where set, maps its dictionary codes to value keys (any
  // int64: no absent marker, unlike a join's LUT)
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const hopper::KeyCol& c = ks.col[k];
    if (c.lut != nullptr) {
#pragma unroll
      for (int r = 0; r < kHashRows; ++r) {
        const int64_t x = v[k][r];
        if (in[r]) v[k][r] = c.lut[x < 0 ? 0 : (x >= c.lut_len ? c.lut_len - 1 : x)];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kHashRows; ++r) {
    uint64_t acc = 0x9E3779B97F4A7C15ull;
    if (NK == 0) acc = (acc ^ fmix64(0)) * 0x100000001B3ull;  // no keys: one zero key
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const uint64_t key =
          ok[k][r] ? static_cast<uint64_t>(v[k][r]) : static_cast<uint64_t>(INT64_MAX);
      acc = (acc ^ fmix64(key)) * 0x100000001B3ull;
    }
    dest[r] = !in[r]   ? kNoDigit
              : act[r] ? static_cast<uint32_t>(acc % static_cast<uint64_t>(n_parts))
                       : static_cast<uint32_t>(n_parts);
  }
}

template <int NK>
__global__ void __launch_bounds__(kThreads)
dest_kernel(hopper::WideKeySet ks, const bool* __restrict__ active, int64_t n, int n_parts,
            uint32_t* __restrict__ dest) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kHashRows;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kHashRows; base < n;
       base += step) {
    int64_t i[kHashRows];
    uint32_t d[kHashRows];
#pragma unroll
    for (int r = 0; r < kHashRows; ++r) i[r] = base + r * kThreads + threadIdx.x;
    dest_rows<NK>(ks, active, i, n, n_parts, d);
#pragma unroll
    for (int r = 0; r < kHashRows; ++r) {
      if (i[r] < n) dest[i[r]] = d[r];
    }
  }
}

// One block a tile of kTileRows rows: each row's destination as one byte,
// and hist[d * tiles + tile] = the tile's rows of destination d (each warp
// adding one shared atomic per distinct destination and step).
template <int NK>
__global__ void __launch_bounds__(kThreads)
count_kernel(hopper::WideKeySet ks, const bool* __restrict__ active, int64_t n, int n_parts,
             uint8_t* __restrict__ dest, int32_t* __restrict__ hist, int64_t tiles) {
  __shared__ int32_t h[kDigits];
  const int nb = n_parts + 1;
  for (int b = threadIdx.x; b < nb; b += kThreads) h[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int64_t i[kHashRows];
  uint32_t d[kHashRows];
#pragma unroll
  for (int r = 0; r < kHashRows; ++r) {
    i[r] = static_cast<int64_t>(blockIdx.x) * kTileRows + r * kThreads + threadIdx.x;
  }
  dest_rows<NK>(ks, active, i, n, n_parts, d);
#pragma unroll
  for (int r = 0; r < kHashRows; ++r) {
    if (i[r] < n) dest[i[r]] = static_cast<uint8_t>(d[r]);
    const unsigned peers = __match_any_sync(0xffffffffu, d[r]);
    if (d[r] != kNoDigit && lane == __ffs(peers) - 1) atomicAdd(&h[d[r]], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    hist[static_cast<int64_t>(b) * tiles + blockIdx.x] = h[b];
  }
}

__device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

// Starts the copy of bytes [0, len) of src into shared memory at s (16-byte
// aligned): 16-byte cp.async copies, which hold no register while in
// flight, where src is 16-byte aligned too; byte by byte otherwise and for
// the tail.
__device__ __forceinline__ void copy_slice(unsigned char* s, const unsigned char* src, int len) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = len & ~15;
    for (int c = 16 * threadIdx.x; c < done; c += 16 * kThreads) {
      const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(s + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(at), "l"(src + c)
                   : "memory");
    }
  }
  for (int b = done + threadIdx.x; b < len; b += kThreads) s[b] = src[b];
}

// Starts copying the tile's slices (rows rows from ``first``) of columns
// k, k+1, ... while they fit kStageBytes; returns the column after them.
__device__ __forceinline__ int stage_columns(const PermGatherSet& cols, int k, int64_t first,
                                             int rows, unsigned char* stage) {
  int off = 0;
  int g = k;
  for (; g < cols.n; ++g) {
    const hopper::PermCol& c = cols.col[g];
    const int bytes = round16(rows * c.elem_bytes);
    const int vbytes = c.src_valid != nullptr ? round16(rows) : 0;
    if (g > k && off + bytes + vbytes > kStageBytes) break;
    copy_slice(stage + off, static_cast<const unsigned char*>(c.src) + first * c.elem_bytes,
               rows * c.elem_bytes);
    if (c.src_valid != nullptr) {
      copy_slice(stage + off + bytes, reinterpret_cast<const unsigned char*>(c.src_valid) + first,
                 rows);
    }
    off += bytes + vbytes;
  }
  return g;
}

// Writes one staged column out in destination order: staged row j (the
// tile's row s_row[j]) to s_base[its destination] + j, so consecutive
// staged rows of a destination leave as consecutive positions.
template <typename T>
__device__ __forceinline__ void write_column(const hopper::PermCol& c, const unsigned char* vals,
                                             const bool* valid, int rows, const uint8_t* s_dig,
                                             const uint16_t* s_row, const int32_t* s_base) {
  for (int j = threadIdx.x; j < rows; j += kThreads) {
    const int32_t out = s_base[s_dig[j]] + j;
    static_cast<T*>(c.dst)[out] = reinterpret_cast<const T*>(vals)[s_row[j]];
    if (valid != nullptr) c.dst_valid[out] = valid[s_row[j]];
  }
}

// One block a tile of kTileRows rows: every column of ``cols`` (the
// activity among them) written in the order of the rows' destinations
// ``dest``; perm (or null) gets each output position's row. hist[d * tiles
// + tile] holds destination d's rows in earlier tiles and totals[d] its
// rows in all (radix_scan's output). The copies of the tile's column slices
// are started first, so they are in flight while the tile is ranked.
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const uint8_t* __restrict__ dest, int64_t n, int n_parts,
             const int32_t* __restrict__ hist, const int32_t* __restrict__ totals, int64_t tiles,
             PermGatherSet cols, int32_t* __restrict__ perm, int64_t* __restrict__ offsets,
             int64_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char ep_smem[];
  unsigned char* stage = ep_smem;
  uint8_t* s_dig = reinterpret_cast<uint8_t*>(ep_smem + kStageBytes);
  uint16_t* s_row = reinterpret_cast<uint16_t*>(ep_smem + kStageBytes + kTileRows);
  __shared__ int32_t warp_cnt[kWarps][kDigits];
  __shared__ int32_t s_start[kDigits];  // each destination's first staged row
  __shared__ int32_t s_base[kDigits];   // output position of staged row 0, per destination
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = n_parts + 1;
  const int64_t tile = blockIdx.x;
  const int64_t left = n - tile * kTileRows;
  const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;
  int k = 0;
  int g = stage_columns(cols, k, tile * kTileRows, rows, stage);
  for (int b = threadIdx.x; b < kWarps * kDigits; b += kThreads) (&warp_cnt[0][0])[b] = 0;
  __syncthreads();
  const int64_t row0 = tile * kTileRows + warp * kWarpRows;
  uint32_t dig[kItems];
  int32_t pos[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = row0 + it * 32 + lane;
    dig[it] = i < n ? dest[i] : kNoDigit;
  }
  hopper::radix::warp_rank<kItems>([&](int it) { return dig[it]; }, warp_cnt[warp], pos);
  __syncthreads();
  const int d = threadIdx.x;
  const int32_t count = hopper::radix::warp_offsets(warp_cnt, d);
  int32_t unused;
  const int32_t local = hopper::radix::block_scan_excl(count, &unused);
  const int32_t total = d < nb ? totals[d] : 0;
  const int32_t first = hopper::radix::block_scan_excl(total, &unused);
  if (tile == 0 && d < nb) {
    offsets[d] = first;
    counts[d] = total;
  }
  const int32_t before_tile = d < nb ? hist[static_cast<int64_t>(d) * tiles + tile] : 0;
  s_start[d] = local;
  s_base[d] = first + before_tile - local;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (dig[it] != kNoDigit) {
      const int32_t p = pos[it] + s_start[dig[it]] + warp_cnt[warp][dig[it]];
      s_dig[p] = static_cast<uint8_t>(dig[it]);
      s_row[p] = static_cast<uint16_t>(warp * kWarpRows + it * 32 + lane);
    }
  }
  __syncthreads();
  if (perm != nullptr) {
    for (int j = threadIdx.x; j < rows; j += kThreads) {
      perm[s_base[s_dig[j]] + j] = static_cast<int32_t>(tile * kTileRows + s_row[j]);
    }
  }
  while (k < cols.n) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    int off = 0;
    for (int c = k; c < g; ++c) {
      const hopper::PermCol& col = cols.col[c];
      const int bytes = round16(rows * col.elem_bytes);
      const bool* valid =
          col.src_valid != nullptr ? reinterpret_cast<const bool*>(stage + off + bytes) : nullptr;
      switch (col.elem_bytes) {
        case 1: write_column<uint8_t>(col, stage + off, valid, rows, s_dig, s_row, s_base); break;
        case 2: write_column<uint16_t>(col, stage + off, valid, rows, s_dig, s_row, s_base); break;
        case 4: write_column<uint32_t>(col, stage + off, valid, rows, s_dig, s_row, s_base); break;
        default: write_column<uint64_t>(col, stage + off, valid, rows, s_dig, s_row, s_base); break;
      }
      off += bytes + (valid != nullptr ? round16(rows) : 0);
    }
    __syncthreads();
    k = g;
    if (k < cols.n) g = stage_columns(cols, k, tile * kTileRows, rows, stage);
  }
}

// f(std::integral_constant<int, nk>) for a runtime key count nk in [0, 8].
template <typename F>
void with_key_count(int nk, F f) {
  switch (nk) {
    case 0: f(std::integral_constant<int, 0>()); break;
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 5: f(std::integral_constant<int, 5>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 7: f(std::integral_constant<int, 7>()); break;
    default: f(std::integral_constant<int, hopper::kMaxWideKeys>()); break;
  }
}

void mark(void* const* events, int k, cudaStream_t s) {
  if (events != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(events[k]), s);
}

}  // namespace

extern "C" int partition_epilogue_max_parts() { return hopper::kMaxParts; }
extern "C" int partition_epilogue_sweep_bins() { return kDigits; }
extern "C" int64_t partition_epilogue_stream_ops() { return g_stream_ops; }

// Destinations, the stable order and the columns in it, on ``stream``.
// offsets and counts (int64 [n_parts + 1]) get each destination's start and
// row count (the last entry: inactive rows); ``gather`` holds ``n_gather``
// sets of columns, the activity among them. hist (int32 [(n_parts + 1) *
// tiles of kTileRows]) and totals (int32 [n_parts + 1]) are scratch, and so
// are dest (uint8 [n] with n_parts + 1 <= 256, int32 [n] past it) and idx
// (int32 [n]; with n_parts + 1 <= 256 only for more than one gather set).
// ``events``, null or three (one-sweep: start, after the count and scan,
// end) or four (start, after the destinations, after the pass, end) CUDA
// events, are recorded at the phases' bounds.
extern "C" int partition_epilogue(const hopper::WideKeySet* keys, const void* active,
                                  int64_t n, int n_parts, void* dest, void* idx, void* hist,
                                  void* totals, void* offsets, void* counts,
                                  const PermGatherSet* gather, int n_gather,
                                  void* const* events, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const bool* act = static_cast<const bool*>(active);
  const int nb = n_parts + 1;
  int32_t* perm = static_cast<int32_t*>(idx);
  int32_t* hst = static_cast<int32_t*>(hist);
  int32_t* tot = static_cast<int32_t*>(totals);
  const int64_t tiles = hopper::radix::tiles_for(n);
  cudaError_t err = cudaSuccess;
  mark(events, 0, s);
  if (nb <= kDigits) {
    static bool sized = false;  // the sweep's dynamic shared memory
    if (!sized) {
      err = cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSweepSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      sized = true;
    }
    uint8_t* d8 = static_cast<uint8_t*>(dest);
    with_key_count(keys->n, [&](auto nk) {
      count_kernel<decltype(nk)::value><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          *keys, act, n, n_parts, d8, hst, tiles);
    });
    ++g_stream_ops;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hopper::radix::radix_scan<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(hst, tiles, tot);
    ++g_stream_ops;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mark(events, 1, s);
    sweep_kernel<<<static_cast<unsigned>(tiles), kThreads, kSweepSmem, s>>>(
        d8, n, n_parts, hst, tot, tiles, gather[0], n_gather > 1 ? perm : nullptr,
        static_cast<int64_t*>(offsets), static_cast<int64_t*>(counts));
    ++g_stream_ops;
    err = cudaGetLastError();
    if (err == cudaSuccess && n_gather > 1) {
      err = hopper::radix::perm_gather(gather + 1, n_gather - 1, perm, n, s);
      g_stream_ops += n_gather - 1;
    }
    mark(events, 2, s);
    return static_cast<int>(err);
  }
  uint32_t* d = static_cast<uint32_t*>(dest);
  with_key_count(keys->n, [&](auto nk) {
    constexpr int kNK = decltype(nk)::value;
    static const int per_sm = hopper::blocks_per_sm(
        reinterpret_cast<const void*>(dest_kernel<kNK>));
    dest_kernel<kNK><<<hopper::resident_grid((n + kHashRows - 1) / kHashRows, per_sm), kThreads,
                       0, s>>>(*keys, act, n, n_parts, d);
  });
  ++g_stream_ops;
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mark(events, 1, s);
  err = hopper::radix::radix_pass<kMaxBins, uint32_t, false>(
      d, nullptr, nullptr, perm, n, 0, 0xffffffffu, nb, hst, tot,
      static_cast<int64_t*>(offsets), static_cast<int64_t*>(counts), s);
  g_stream_ops += 3;
  if (err != cudaSuccess) return static_cast<int>(err);
  mark(events, 2, s);
  err = hopper::radix::perm_gather(gather, n_gather, perm, n, s);
  g_stream_ops += n_gather;
  mark(events, 3, s);
  return static_cast<int>(err);
}
