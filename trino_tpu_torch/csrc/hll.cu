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
// A max does not depend on the order of the rows, so the registers are the
// same in every run however the atomics interleave.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. new_group, the values and the
// weight columns read once, the registers (out_cap * 2048 int32) written
// and read once, the estimates written once.
//
// Design, five stream operations: a memset of the registers; the tile head
// counts and their scan (segment_rows.cuh); one block a tile (8 consecutive
// rows a thread) block-scans its heads into each row's group, hashes each
// weighted row's order key and takes an atomicMax into its register; one
// block a group counts its registers' values in shared memory (integer
// atomics, exact), and one thread sums the 55 terms in the plain version's
// order and finishes the estimate with each float32 operation rounded on its
// own (__fdiv_rn, __fmul_rn, logf and rintf, as torch's kernels compute
// them).

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

std::atomic<int64_t> g_stream_ops{0};

__global__ void __launch_bounds__(kThreads)
hll_registers_kernel(const bool* __restrict__ new_group, const void* __restrict__ values,
                     int type, WeightSet ws, int64_t n, int64_t out_cap,
                     const int64_t* __restrict__ base, int32_t* __restrict__ regs) {
  const int64_t tile = blockIdx.x;
  const int64_t r0 = tile * kTileRows + static_cast<int64_t>(threadIdx.x) * kItems;
  int64_t gid[kItems];
  hopper::rows::tile_groups(new_group, n, r0, base, tile, gid);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = r0 + j;
    if (i >= n || gid[j] >= out_cap || !hopper::rows::weighted(ws, i)) continue;
    const uint64_t h = hopper::agg::splitmix64(
        static_cast<uint64_t>(hopper::agg::order_key(type, values, i)));
    const uint64_t bucket = h >> (64 - kHllBits);
    const uint64_t rest = h << kHllBits;
    const int rho = rest == 0 ? kRhoMax : __clzll(static_cast<long long>(rest)) + 1;
    atomicMax(regs + gid[j] * kRegisters + static_cast<int64_t>(bucket), rho);
  }
}

// One block a group: its estimate from its registers.
__global__ void __launch_bounds__(kThreads)
hll_estimate_kernel(const int32_t* __restrict__ regs, float alpha_mm,
                    int64_t* __restrict__ out, bool* __restrict__ valid) {
  __shared__ int counts[kRhoMax + 1];
  for (int r = threadIdx.x; r <= kRhoMax; r += kThreads) counts[r] = 0;
  __syncthreads();
  const int32_t* row = regs + static_cast<int64_t>(blockIdx.x) * kRegisters;
  for (int b = threadIdx.x; b < kRegisters; b += kThreads) atomicAdd(&counts[row[b]], 1);
  __syncthreads();
  if (threadIdx.x != 0) return;
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
  out[blockIdx.x] = static_cast<int64_t>(rintf(small ? linear : e));
  valid[blockIdx.x] = true;
}

}  // namespace

extern "C" int hll_bits() { return kHllBits; }
extern "C" int hll_max_weights() { return hopper::kMaxWeights; }
extern "C" int64_t hll_stream_ops() { return g_stream_ops.load(); }

// Each group's estimate into out (int64 [out_cap]), and valid (bool
// [out_cap]) set everywhere, as the reference's column is, on ``stream``: regs
// (int32 [out_cap * 2048]) and scratch (int64 [2 * n_tiles + 1], n_tiles =
// ceil(n / 2048)) are the kernel's; alpha_mm is float32(alpha * m * m).
// Returns the first CUDA error, 0 on success.
extern "C" int hll(const void* new_group, const void* values, int type, const WeightSet* ws,
                   int64_t n, int64_t out_cap, float alpha_mm, void* regs, void* scratch,
                   void* out, void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_cap <= 0) return 0;
  int32_t* r = static_cast<int32_t*>(regs);
  cudaError_t err = cudaMemsetAsync(r, 0, sizeof(int32_t) * out_cap * kRegisters, s);
  ++g_stream_ops;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const bool* ng = static_cast<const bool*>(new_group);
    const int64_t* base = hopper::rows::tile_bases(ng, n, static_cast<int64_t*>(scratch), s, &err);
    g_stream_ops += 2;
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
    hll_registers_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
        ng, values, type, *ws, n, out_cap, base, r);
    ++g_stream_ops;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  hll_estimate_kernel<<<static_cast<unsigned>(out_cap), kThreads, 0, s>>>(
      r, alpha_mm, static_cast<int64_t*>(out), static_cast<bool*>(valid));
  ++g_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
