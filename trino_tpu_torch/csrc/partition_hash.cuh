// The exchange partition hash, shared by partition_dest.cu (the exchange
// destination stage where no kernel holds the keys), the destination
// folded into hash_expand.cu's slot pass and segment_agg.cu's finish pass,
// and partition_epilogue.cu (the repartition epilogue), so all give the
// same bits. Partition hashes are part of the exchange-frame contract: these are
// trino_tpu/ops/repartition.py partition_ids and _partition_dest, bit for
// bit. Each key is read as kernels.order_key bits (floats unfolded), a
// dictionary key mapped through its value-key LUT, INT64_MAX where NULL;
// per key the 64-bit finalizer fmix64 is folded into an FNV-style
// accumulator seeded with the golden ratio; the partition is the
// accumulator modulo n_parts as an unsigned 64-bit integer, n_parts for an
// inactive row. No key hashes one zero key.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "join_keys.cuh"
#include "launch.cuh"
#include "radix_pass.cuh"

namespace hopper {
namespace partition {

constexpr int kHashRows = 8;  // rows a thread hashes at once
constexpr uint64_t kHashSeed = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ uint64_t fmix64(uint64_t x) {
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDull;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ull;
  return x ^ (x >> 33);
}

// One key folded into the accumulator (seeded with kHashSeed).
__device__ __forceinline__ uint64_t fold_key(uint64_t acc, uint64_t key) {
  return (acc ^ fmix64(key)) * 0x100000001B3ull;
}

// The hashed bits of column c's key at row i: its normalized value through
// the value-key LUT where set, INT64_MAX where ``ok`` is false (NULL).
__device__ __forceinline__ uint64_t key_bits(const KeyCol& c, int64_t i, bool ok) {
  if (!ok) return static_cast<uint64_t>(INT64_MAX);
  const int64_t idx[1] = {i};
  const bool take[1] = {true};
  int64_t v[1];
  load_values(c, idx, take, v);
  if (c.lut != nullptr) v[0] = c.lut[v[0] < 0 ? 0 : (v[0] >= c.lut_len ? c.lut_len - 1 : v[0])];
  return static_cast<uint64_t>(v[0]);
}

// The destination of an accumulator: its partition, n_parts where inactive.
__device__ __forceinline__ int32_t dest_of(uint64_t acc, bool active, int n_parts) {
  return active ? static_cast<int32_t>(acc % static_cast<uint64_t>(n_parts)) : n_parts;
}

// The destinations of rows i[] (radix::kNoDigit where i >= n) under NK
// keys: the partition of each row's keys' hash, n_parts where inactive.
// Every key column's loads, and the activity's, are issued before any is
// used.
template <int NK>
__device__ __forceinline__ void dest_rows(const WideKeySet& ks, const bool* __restrict__ active,
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
    const KeyCol& c = ks.col[k];
#pragma unroll
    for (int r = 0; r < kHashRows; ++r) ok[k][r] = in[r] && c.valid[i[r]];
    load_values(c, i, in, v[k]);
  }
  // a key's lut, where set, maps its dictionary codes to value keys (any
  // int64: no absent marker, unlike a join's LUT)
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const KeyCol& c = ks.col[k];
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
    uint64_t acc = kHashSeed;
    if (NK == 0) acc = fold_key(acc, 0);  // no keys: one zero key
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      acc = fold_key(acc, ok[k][r] ? static_cast<uint64_t>(v[k][r])
                                   : static_cast<uint64_t>(INT64_MAX));
    }
    dest[r] = !in[r]   ? radix::kNoDigit
              : act[r] ? static_cast<uint32_t>(acc % static_cast<uint64_t>(n_parts))
                       : static_cast<uint32_t>(n_parts);
  }
}

// dest[i] = row i's destination, for every row, in a grid-stride loop of
// kHashRows rows a thread.
template <int NK>
__global__ void __launch_bounds__(kThreads)
dest_kernel(WideKeySet ks, const bool* __restrict__ active, int64_t n, int n_parts,
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
    default: f(std::integral_constant<int, kMaxWideKeys>()); break;
  }
}

// Launches dest_kernel over n rows on s: as many blocks as the card holds
// at once (read once per key count, thread-safe).
inline cudaError_t launch_dest(const WideKeySet& ks, const bool* active, int64_t n, int n_parts,
                               uint32_t* dest, cudaStream_t s) {
  with_key_count(ks.n, [&](auto nk) {
    constexpr int kNK = decltype(nk)::value;
    static const int per_sm = blocks_per_sm(reinterpret_cast<const void*>(dest_kernel<kNK>));
    dest_kernel<kNK><<<resident_grid((n + kHashRows - 1) / kHashRows, per_sm), kThreads, 0, s>>>(
        ks, active, n, n_parts, dest);
  });
  return cudaGetLastError();
}

}  // namespace partition
}  // namespace hopper
