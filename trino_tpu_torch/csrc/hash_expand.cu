// Hash-join expansion: every output slot's probe row and matching build
// row, then the gather of both sides' columns into the joined page.
//
// Replaces: the join stage of trino_tpu/ops/megakernels.py
// _expand_phase_body + expand_phase (the Pallas body that runs
// kernels.expand_probe_slots, finds each slot's (d+1)-th equal-key slot of
// its bucket by a cumsum over the [N_out, C] match block, and gathers the
// probe and build columns). The fused project and group stages of that body
// run after this kernel as the port's torch operators.
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
// bpos, with build validity & matched.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The scan reads emit once (4
// bytes a probe row); each output slot reads its probe row's count, bucket,
// keys and activity, the occupied slots of one bucket and the build keys
// they hold, and gathers and writes every column. On TPC-H Q3 the probe
// side is 40 times the output, so the scan of emit is most of the bytes.
//
// Design: a three-pass device-wide scan (per-tile sums; one block scans the
// tile sums; each tile rescans with its offset), then one thread per output
// slot binary-searches the scan (the reference's scatter-max plus cummax
// computes the same index) and walks its bucket's slots in ascending build
// order (hash_probe.cu sorted them), and one gather pass copies whole
// elements (1, 2, 4, 8 or 16 bytes) column by column.

#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"

namespace hopper {

constexpr int kMaxGatherCols = 16;  // columns per gather launch

struct GatherCol {
  const void* src;
  const bool* src_valid;
  void* dst;
  bool* dst_valid;
  int elem_bytes;  // 1, 2, 4, 8 or 16
  int build_side;  // 1: gather at bpos and AND validity with matched
};

// Passed by value as a kernel parameter; exported through hash_expand(),
// so it lives outside the anonymous namespace.
struct GatherSet {
  GatherCol col[kMaxGatherCols];
  int n;
};

}  // namespace hopper

namespace {

using hopper::GatherSet;
using hopper::grid_for;
using hopper::kMaxGatherCols;
using hopper::KeySet;
using hopper::kMaxKeys;
using hopper::kThreads;

constexpr int kItems = 8;                    // emit values per thread per tile
constexpr int kTile = kThreads * kItems;     // emit values per scan tile
constexpr int kScanThreads = 1024;           // the one block that scans tile sums

// Block-wide exclusive scan of one int64 per thread; returns this thread's
// exclusive prefix and writes the block total to *total.
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t v, int64_t* total) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int64_t inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive warp prefixes
  }
  __syncthreads();
  const int64_t warp_prefix = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return warp_prefix + inc - v;
}

__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const int32_t* __restrict__ emit, int64_t n, int64_t* __restrict__ tile_sums) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t s = 0;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads + threadIdx.x;
    if (i < n) s += emit[i];
  }
  int64_t total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: tile_sums becomes its exclusive scan, in place.
__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums_kernel(int64_t* __restrict__ tile_sums, int64_t n_tiles) {
  int64_t carry = 0;
  for (int64_t base = 0; base < n_tiles; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int64_t v = i < n_tiles ? tile_sums[i] : 0;
    int64_t total;
    const int64_t ex = block_exclusive_scan(v, &total);
    if (i < n_tiles) tile_sums[i] = carry + ex;
    carry += total;
  }
}

// Each thread owns kItems consecutive values of the tile.
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const int32_t* __restrict__ emit, int64_t n,
                 const int64_t* __restrict__ tile_offsets, int64_t* __restrict__ start) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int32_t v[kItems];
  int64_t s = 0;
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? emit[base + k] : 0;
    s += v[k];
  }
  int64_t total;
  int64_t run = tile_offsets[blockIdx.x] + block_exclusive_scan(s, &total);
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) start[base + k] = run;
    run += v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
slots_kernel(KeySet pkeys, KeySet bkeys, const bool* __restrict__ probe_active,
             const int64_t* __restrict__ start, const int32_t* __restrict__ emit,
             const int32_t* __restrict__ count, const int32_t* __restrict__ bucket_p,
             const int32_t* __restrict__ table, const int32_t* __restrict__ counts,
             int64_t n, int64_t m, int C, int64_t out_cap, int64_t* __restrict__ probe_idx,
             int64_t* __restrict__ bpos, bool* __restrict__ matched,
             bool* __restrict__ out_active) {
  const int64_t total = start[n - 1] + emit[n - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < out_cap;
       p += stride) {
    // upper bound: the first i with start[i] > p
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (start[mid] <= p) lo = mid + 1; else hi = mid;
    }
    const int64_t pi = lo > 0 ? lo - 1 : 0;
    const int64_t d = p - start[pi];
    int64_t keys[kMaxKeys];
    int unused;
    const bool ok = hopper::load_keys(pkeys, pi, keys, 1, &unused) && probe_active[pi];
    const int b = bucket_p[pi];
    const int32_t* row = table + static_cast<int64_t>(b) * C;
    int slot = 0;
    if (ok) {
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
    probe_idx[p] = pi;
    bpos[p] = r;
    matched[p] = d < count[pi];
    out_active[p] = p < total;
  }
}

template <typename T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst, int64_t from, int64_t to) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(GatherSet cols, const int64_t* __restrict__ probe_idx,
              const int64_t* __restrict__ bpos, const bool* __restrict__ matched,
              int64_t out_cap) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < out_cap;
       p += stride) {
    const int64_t pi = probe_idx[p];
    const int64_t bi = bpos[p];
    const bool mt = matched[p];
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
}

}  // namespace

extern "C" int hash_expand_gather_cols() { return kMaxGatherCols; }

// Scan, slot resolution and the gather of every column, on ``stream``.
// ``start`` (int64 [N]), ``tile_sums`` (int64 [ceil(N / 2048)]),
// ``probe_idx`` and ``bpos`` (int64 [out_cap]) and ``matched`` (bool
// [out_cap]) are scratch the caller allocates; ``gather`` holds ``n_gather``
// host GatherSets of up to hash_expand_gather_cols() columns each. Returns
// the first CUDA error, 0 on success.
extern "C" int hash_expand(const hopper::KeySet* pkeys, const hopper::KeySet* bkeys,
                           const void* probe_active, const void* emit, const void* count,
                           const void* bucket_p, const void* table, const void* counts,
                           int64_t n, int64_t m, int C, int64_t out_cap, void* start,
                           void* tile_sums, void* probe_idx, void* bpos, void* matched,
                           void* out_active, const hopper::GatherSet* gather, int n_gather,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || out_cap <= 0) return 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  int64_t* sums = static_cast<int64_t*>(tile_sums);
  int64_t* st = static_cast<int64_t*>(start);
  const int32_t* em = static_cast<const int32_t*>(emit);
  tile_sums_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(em, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tile_sums_kernel<<<1, kScanThreads, 0, s>>>(sums, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scan_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(em, n, sums, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t* pidx = static_cast<int64_t*>(probe_idx);
  int64_t* bp = static_cast<int64_t*>(bpos);
  bool* mt = static_cast<bool*>(matched);
  slots_kernel<<<grid_for(out_cap), kThreads, 0, s>>>(
      *pkeys, *bkeys, static_cast<const bool*>(probe_active), st, em,
      static_cast<const int32_t*>(count), static_cast<const int32_t*>(bucket_p),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(counts), n, m, C,
      out_cap, pidx, bp, mt, static_cast<bool*>(out_active));
  err = cudaGetLastError();
  for (int g = 0; g < n_gather && err == cudaSuccess; ++g) {
    gather_kernel<<<grid_for(out_cap), kThreads, 0, s>>>(gather[g], pidx, bp, mt, out_cap);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
