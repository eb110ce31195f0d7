// approx_distinct's HyperLogLog path on a group-sorted page: hll.
//
// Replaces: trino_tpu/runtime/executor.py _aggregate_impl's hll_fn (taken
// where out_cap * 2^11 <= 2^23), that is trino_tpu/ops/kernels.py
// hll_registers and hll_estimate, inside trino_tpu/ops/megakernels.py
// aggregate_phase's Pallas launch.
//
// Bit-identical to the plain version (hopper_kernels.hll_plain):
//   registers[g][b] = the max over the weighted rows of group g =
//       max(cumsum(new_group) - 1, 0) whose hash h = splitmix64(order
//       key) has top 11 bits b, of rho = the leading zeros of h << 11, plus
//       one (54 where h << 11 is 0); 0 where no row falls
//   estimate[g] = round(small ? linear : e) as int64, in float32: z = the
//       sum of 2^-r over the group's 2048 registers, taken as the count of
//       each register value r times 2^-r (exact), added from r = 54 down
//       to 0, each add rounded on its own; e = float32(alpha m^2) / z;
//       v = the registers at 0; small = e <= 2.5 m and v > 0; linear =
//       m * log(m / max(v, 1)); rounding half to even (torch.round).
// A max does not depend on the order of the rows, so the registers, and
// the estimates, are the same in every run however the atomics interleave.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, as chip_smoke.py's
// resort_bound counts them: new_group, the values and the weight columns
// read once, the estimates and their validity written once (the registers
// are the kernel's own state, not the function's), beside about a dozen
// operations a row for the hash.
//
// Design, six stream operations. The tile head counts and their scan
// (segment_rows.cuh, two passes of many blocks). A prepare pass, one block a slot, classes each group
// from the tile bases (a binary search for the tiles of its first and last
// rows): a group cut by the edge of a block's range of tiles, or lying
// strictly inside one tile between its first and last groups, is global,
// and only its registers are zeroed; a slot past the last group gets its
// estimate 0 here. The register pass is a resident grid: each block owns
// a contiguous range of whole 2,048-row tiles (hopper_kernels.hll_plan)
// and keeps its current group's 2,048 registers in shared memory, each
// weighted row a shared atomicMax: a tile's rows are read coalesced,
// hashed into a code a row in shared memory, and read back 8 consecutive
// rows a thread beside their groups (tile_groups' block scan).
// When the group changes or the range ends the block finishes it: a group
// whose every row lies in the range is the block's alone, and its estimate
// is computed in the block from shared memory (its registers never reach
// device memory); a cut group's non-zero registers are merged into its
// global registers by atomicMax. A global group strictly inside a tile
// (a tile of many short groups) takes one global atomicMax a weighted row,
// as before. The estimate pass, one block a slot, finishes the global
// groups only: it counts each register value in shared memory (integer
// atomics, exact) and one thread sums the 55 terms in the plain version's
// order, each float32 operation rounded on its own (__fdiv_rn, __fmul_rn,
// logf and rintf, as torch's kernels compute them); the block finish uses
// the same code.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "agg_common.cuh"
#include "launch.cuh"
#include "segment_rows.cuh"

namespace {

using hopper::kThreads;
using hopper::WeightSet;
using hopper::rows::kItems;
using hopper::rows::kTileRows;

constexpr int kHllBits = 11;
constexpr int kRegisters = 1 << kHllBits;
constexpr int kRhoMax = 64 - kHllBits + 1;
constexpr int kRegsPerThread = kRegisters / kThreads;

// A slot's class (the prepare pass's flags).
constexpr uint8_t kWhole = 0;   // finished in the block that holds all its rows
constexpr uint8_t kGlobal = 1;  // global registers: cut by a range, or inside one tile
constexpr uint8_t kEmpty = 2;   // past the last group: estimate 0

std::atomic<int64_t> g_stream_ops{0};

// The group of a tile's first row and of its last (the page's groups
// max(cumsum(new_group) - 1, 0)), from the tile's base, whether its first
// row is a head, and the next tile's base.
__device__ __forceinline__ int64_t first_group(int64_t base_t, bool head0) {
  const int64_t g = base_t - 1 + (head0 ? 1 : 0);
  return g < 0 ? 0 : g;
}

__device__ __forceinline__ int64_t last_group(int64_t base_next) {
  return base_next > 0 ? base_next - 1 : 0;
}

// The tile of head k (0 <= k < base[n_tiles]): the last t with base[t] <= k.
__device__ int64_t tile_of_head(const int64_t* base, int64_t n_tiles, int64_t k) {
  int64_t lo = 0, hi = n_tiles - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (base[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Thread 0 of a block: the estimate from the counts of each register value.
__device__ __forceinline__ int64_t estimate_of(const int* counts, float alpha_mm) {
  float z = 0.0f;
  for (int r = kRhoMax; r >= 0; --r) {
    // counts[r] * 2^-r is exact: at most 12 significant bits
    z = __fadd_rn(z, __fmul_rn(static_cast<float>(counts[r]), ldexpf(1.0f, -r)));
  }
  const float m = static_cast<float>(kRegisters);
  const float e = __fdiv_rn(alpha_mm, z);
  const int v = counts[0];
  const bool small = e <= 2.5f * m && v > 0;
  const float linear = __fmul_rn(m, logf(__fdiv_rn(m, static_cast<float>(v > 1 ? v : 1))));
  return static_cast<int64_t>(rintf(small ? linear : e));
}

// One block a slot: its class; a global group's registers zeroed, an
// empty slot's estimate written.
__global__ void __launch_bounds__(kThreads)
hll_prepare_kernel(const bool* __restrict__ new_group, int64_t n_tiles,
                   const int64_t* __restrict__ base, int64_t tiles_per_range,
                   uint8_t* __restrict__ flags, int32_t* __restrict__ regs,
                   int64_t* __restrict__ out, bool* __restrict__ valid) {
  __shared__ uint8_t cls;
  const int64_t g = blockIdx.x;
  if (threadIdx.x == 0) {
    const int64_t heads = base[n_tiles];
    if (g >= (heads > 0 ? heads : 1)) {
      cls = kEmpty;
    } else {
      // the tiles of the group's first row (row 0 for group 0) and last
      const int64_t f = g == 0 ? 0 : tile_of_head(base, n_tiles, g);
      int64_t l = n_tiles - 1;
      if (g + 1 < heads) {
        const int64_t t = tile_of_head(base, n_tiles, g + 1);
        l = base[t] == g + 1 && new_group[t * kTileRows] ? t - 1 : t;
      }
      const bool cut = f / tiles_per_range != l / tiles_per_range;
      const bool inside = f == l && first_group(base[f], new_group[f * kTileRows]) < g &&
                          g < last_group(base[f + 1]);
      cls = cut || inside ? kGlobal : kWhole;
    }
    flags[g] = cls;
    if (cls == kEmpty) {
      out[g] = 0;
      valid[g] = true;
    }
  }
  __syncthreads();
  if (cls != kGlobal) return;
  int4* row = reinterpret_cast<int4*>(regs + g * kRegisters);
  for (int q = threadIdx.x; q < kRegisters / 4; q += kThreads) row[q] = make_int4(0, 0, 0, 0);
}

// The block's current group's registers (shared), the counts of its
// register values at a finish, and each row's code of the tile at hand.
struct HllShared {
  int regs[kRegisters];
  int counts[kRhoMax + 1];
  alignas(16) int code[kTileRows];
};

// Finishes group g held in shared memory (every thread of the block calls
// it): a whole group's estimate, or a global one's non-zero registers
// merged; the shared registers are left zero.
__device__ __forceinline__ void finish_group(HllShared& sh, int64_t g, int64_t out_cap,
                                             const uint8_t* __restrict__ flags,
                                             int32_t* __restrict__ regs, float alpha_mm,
                                             int64_t* __restrict__ out, bool* __restrict__ valid) {
  __syncthreads();  // every shared atomic of the group has landed
  const bool live = g >= 0 && g < out_cap;
  const bool whole = live && flags[g] == kWhole;
#pragma unroll
  for (int q = 0; q < kRegsPerThread; ++q) {
    const int b = threadIdx.x + q * kThreads;
    const int r = sh.regs[b];
    sh.regs[b] = 0;
    if (whole) {
      atomicAdd(&sh.counts[r], 1);
    } else if (live && r != 0) {
      atomicMax(regs + g * kRegisters + b, r);
    }
  }
  __syncthreads();
  if (whole && threadIdx.x == 0) {
    out[g] = estimate_of(sh.counts, alpha_mm);
    valid[g] = true;
    for (int r = 0; r <= kRhoMax; ++r) sh.counts[r] = 0;
  }
  // the next use of the counts follows another finish's first barrier
}

// One tile's rows as a thread reads them: its 8 strided rows' keys and
// weights (row j * kThreads + thread of the tile, coalesced), its 8
// consecutive rows' head bits (tile_groups' layout), and the tile's base,
// the next tile's and whether its first row is a head.
struct TileRows {
  int64_t key[kItems];
  unsigned w, heads;
  int64_t base0, base1;
  bool head0;
};

__device__ __forceinline__ void load_tile(const bool* __restrict__ new_group,
                                          const void* __restrict__ values, int type,
                                          const WeightSet& ws, int64_t n,
                                          const int64_t* __restrict__ base, int64_t tile,
                                          TileRows& t) {
  const int64_t first = tile * kTileRows;
  t.base0 = base[tile];
  t.base1 = base[tile + 1];
  t.head0 = new_group[first];
  t.heads = hopper::rows::flag_bits(new_group, n, first + threadIdx.x * kItems);
  t.w = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j * kThreads + threadIdx.x;
    t.key[j] = 0;
    if (i < n) {
      t.w |= (hopper::rows::weighted(ws, i) ? 1u : 0u) << j;
      t.key[j] = hopper::agg::order_key(type, values, i);
    }
  }
}

// The register pass: block b takes tiles [b * tiles_per_range, ...) of
// its range, one at a time: each tile's rows (and its bases) are read
// together, hashed into codes in shared memory, and each thread takes 8
// consecutive rows' codes beside their groups. Group indices fit 32 bits
// (pages have fewer than 2^31 rows), which keeps the registers to five
// blocks an SM.
__global__ void __launch_bounds__(kThreads)
hll_registers_kernel(const bool* __restrict__ new_group, const void* __restrict__ values,
                     int type, WeightSet ws, int64_t n, int64_t out_cap,
                     const int64_t* __restrict__ base, int64_t tiles_per_range,
                     const uint8_t* __restrict__ flags, int32_t* __restrict__ regs,
                     float alpha_mm, int64_t* __restrict__ out, bool* __restrict__ valid) {
  __shared__ HllShared sh;
  for (int b = threadIdx.x; b < kRegisters; b += kThreads) sh.regs[b] = 0;
  for (int r = threadIdx.x; r <= kRhoMax; r += kThreads) sh.counts[r] = 0;
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tiles_per_range;
  const int64_t t1 = t0 + tiles_per_range < n_tiles ? t0 + tiles_per_range : n_tiles;
  const int cap = static_cast<int>(out_cap < INT32_MAX ? out_cap : INT32_MAX);
  int cur = -1;  // the group in shared memory (block-uniform)
  for (int64_t tile = t0; tile < t1; ++tile) {
    TileRows rows;
    load_tile(new_group, values, type, ws, n, base, tile, rows);
    __syncthreads();  // the previous tile's codes are read
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint64_t h = hopper::agg::splitmix64(static_cast<uint64_t>(rows.key[j]));
      const uint64_t rest = h << kHllBits;
      const int rho = rest == 0 ? kRhoMax : __clzll(static_cast<long long>(rest)) + 1;
      sh.code[j * kThreads + threadIdx.x] =
          (rows.w >> j) & 1u ? static_cast<int>(h >> (64 - kHllBits)) << 8 | rho : -1;
    }
    int g[kItems];
    hopper::rows::tile_groups(rows.heads, rows.base0, g);  // barriers inside
    int code[kItems];
    const int4 c0 = reinterpret_cast<const int4*>(sh.code)[2 * threadIdx.x];
    const int4 c1 = reinterpret_cast<const int4*>(sh.code)[2 * threadIdx.x + 1];
    code[0] = c0.x; code[1] = c0.y; code[2] = c0.z; code[3] = c0.w;
    code[4] = c1.x; code[5] = c1.y; code[6] = c1.z; code[7] = c1.w;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (g[j] >= cap) code[j] = -1;  // groups from out_cap on do not count
    }
    const int lo = static_cast<int>(first_group(rows.base0, rows.head0));
    const int hi = static_cast<int>(last_group(rows.base1));
    if (lo != cur) {
      if (cur >= 0) finish_group(sh, cur, out_cap, flags, regs, alpha_mm, out, valid);
      cur = lo;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (code[j] < 0) continue;
      if (g[j] == lo) {
        atomicMax(&sh.regs[code[j] >> 8], code[j] & 0xff);
      } else if (g[j] < hi) {  // inside the tile: a global group
        atomicMax(regs + static_cast<int64_t>(g[j]) * kRegisters + (code[j] >> 8),
                  code[j] & 0xff);
      }
    }
    if (hi != lo) {
      finish_group(sh, lo, out_cap, flags, regs, alpha_mm, out, valid);
      cur = hi;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (code[j] >= 0 && g[j] == hi) atomicMax(&sh.regs[code[j] >> 8], code[j] & 0xff);
      }
    }
  }
  if (cur >= 0) finish_group(sh, cur, out_cap, flags, regs, alpha_mm, out, valid);
}

// One block a slot: a global group's estimate from its registers.
__global__ void __launch_bounds__(kThreads)
hll_estimate_kernel(const uint8_t* __restrict__ flags, const int32_t* __restrict__ regs,
                    float alpha_mm, int64_t* __restrict__ out, bool* __restrict__ valid) {
  if (flags[blockIdx.x] != kGlobal) return;
  __shared__ int counts[kRhoMax + 1];
  for (int r = threadIdx.x; r <= kRhoMax; r += kThreads) counts[r] = 0;
  __syncthreads();
  const int32_t* row = regs + static_cast<int64_t>(blockIdx.x) * kRegisters;
  for (int b = threadIdx.x; b < kRegisters; b += kThreads) atomicAdd(&counts[row[b]], 1);
  __syncthreads();
  if (threadIdx.x != 0) return;
  out[blockIdx.x] = estimate_of(counts, alpha_mm);
  valid[blockIdx.x] = true;
}

}  // namespace

extern "C" int hll_bits() { return kHllBits; }
extern "C" int hll_max_weights() { return hopper::kMaxWeights; }
extern "C" int64_t hll_stream_ops() { return g_stream_ops.load(); }

// Words of the int64 scratch segment_rows.cuh's tile bases take over n
// rows (hll's and segment_sort's).
extern "C" int64_t tile_scratch_words(int64_t n) {
  return hopper::rows::bases_scratch_words((n + kTileRows - 1) / kTileRows);
}

// Blocks of the register pass one SM holds at once.
extern "C" int hll_blocks_per_sm() {
  return hopper::blocks_per_sm(reinterpret_cast<const void*>(&hll_registers_kernel));
}

// Each group's estimate into out (int64 [out_cap]), and valid (bool
// [out_cap]) set everywhere, as the reference's column is, on ``stream``:
// block b of the register pass takes tiles [b * tiles_per_range, (b + 1)
// * tiles_per_range) (hopper_kernels.hll_plan); regs (int32 [out_cap *
// 2048]; only the global groups' are used), scratch (int64
// [tile_scratch_words(n)]) and flags (uint8 [out_cap]) are the
// kernel's; alpha_mm is float32(alpha * m * m). Returns the first CUDA
// error, 0 on success.
extern "C" int hll(const void* new_group, const void* values, int type, const WeightSet* ws,
                   int64_t n, int64_t out_cap, float alpha_mm, int64_t tiles_per_range,
                   void* regs, void* scratch, void* flags, void* out, void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_cap <= 0 || n <= 0 || tiles_per_range <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* r = static_cast<int32_t*>(regs);
  uint8_t* f = static_cast<uint8_t*>(flags);
  int64_t* o = static_cast<int64_t*>(out);
  bool* v = static_cast<bool*>(valid);
  const bool* ng = static_cast<const bool*>(new_group);
  cudaError_t err;
  const int64_t* base = hopper::rows::tile_bases(ng, n, static_cast<int64_t*>(scratch), s, &err);
  g_stream_ops += 3;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  hll_prepare_kernel<<<static_cast<unsigned>(out_cap), kThreads, 0, s>>>(
      ng, n_tiles, base, tiles_per_range, f, r, o, v);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (n_tiles + tiles_per_range - 1) / tiles_per_range;
  hll_registers_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      ng, values, type, *ws, n, out_cap, base, tiles_per_range, f, r, alpha_mm, o, v);
  ++g_stream_ops;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  hll_estimate_kernel<<<static_cast<unsigned>(out_cap), kThreads, 0, s>>>(f, r, alpha_mm, o, v);
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
