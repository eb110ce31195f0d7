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
// Design: dest_kernel hashes each row into an int32 destination; one
// stable counting pass of radix_pass.cuh over n_parts + 1 bins orders the
// row indices by destination (block 0 of its scatter writes offsets and
// counts from the digit totals it scans); perm_gather writes every column
// and the activity in that order. The hash, the histogram and the scatter
// are the reference's bincount and stable sort, without a library sort.

#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"
#include "radix_pass.cuh"

namespace hopper {

constexpr int kMaxParts = 1024;

}  // namespace hopper

namespace {

using hopper::grid_for;
using hopper::kThreads;

constexpr int kMaxBins = hopper::kMaxParts + 1;

__device__ __forceinline__ uint64_t fmix64(uint64_t x) {
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDull;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ull;
  return x ^ (x >> 33);
}

__global__ void __launch_bounds__(kThreads)
dest_kernel(hopper::WideKeySet ks, const bool* __restrict__ active, int64_t n, int n_parts,
            uint32_t* __restrict__ dest) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    uint64_t acc = 0x9E3779B97F4A7C15ull;
    if (ks.n == 0) {
      acc = (acc ^ fmix64(0)) * 0x100000001B3ull;  // no keys: one zero key
    }
    for (int k = 0; k < ks.n; ++k) {
      // a key's lut, where set, maps its dictionary codes to value keys
      // (any int64: no absent marker, unlike a join's LUT)
      hopper::KeyCol c = ks.col[k];
      const int64_t* lut = c.lut;
      c.lut = nullptr;
      int64_t v;
      const bool ok = hopper::load_key(c, i, &v);
      if (lut != nullptr) v = lut[v < 0 ? 0 : (v >= c.lut_len ? c.lut_len - 1 : v)];
      const uint64_t key = ok ? static_cast<uint64_t>(v) : static_cast<uint64_t>(INT64_MAX);
      acc = (acc ^ fmix64(key)) * 0x100000001B3ull;
    }
    dest[i] = active[i] ? static_cast<uint32_t>(acc % static_cast<uint64_t>(n_parts))
                        : static_cast<uint32_t>(n_parts);
  }
}

}  // namespace

extern "C" int partition_epilogue_max_parts() { return hopper::kMaxParts; }

// Destinations, the stable pass and the gathers, on ``stream``. dest and
// idx (int32 [n]), hist (int32 [(n_parts + 1) * tiles]) and totals (int32
// [n_parts + 1]) are scratch; offsets and counts (int64 [n_parts + 1]) get
// each destination's start and row count (the last entry: inactive rows);
// ``gather`` holds ``n_gather`` sets of columns, the activity among them.
extern "C" int partition_epilogue(const hopper::WideKeySet* keys, const void* active,
                                  int64_t n, int n_parts, void* dest, void* idx, void* hist,
                                  void* totals, void* offsets, void* counts,
                                  const hopper::PermGatherSet* gather, int n_gather,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  uint32_t* d = static_cast<uint32_t*>(dest);
  dest_kernel<<<grid_for(n), kThreads, 0, s>>>(*keys, static_cast<const bool*>(active), n,
                                               n_parts, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_t* perm = static_cast<int32_t*>(idx);
  err = hopper::radix::radix_pass<kMaxBins, uint32_t, false>(
      d, nullptr, nullptr, perm, n, 0, 0xffffffffu, n_parts + 1, static_cast<int32_t*>(hist),
      static_cast<int32_t*>(totals), static_cast<int64_t*>(offsets),
      static_cast<int64_t*>(counts), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hopper::radix::perm_gather(gather, n_gather, perm, n, s));
}
