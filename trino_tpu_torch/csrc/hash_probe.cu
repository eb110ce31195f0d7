// Hash-join build and probe count: the bucket table of the build side and
// each probe row's number of equal-key build rows.
//
// Replaces: trino_tpu/ops/megakernels.py _probe_phase_body + probe_phase
// (one Pallas launch whose body inserts build rows into a [B+1, C] slot
// table in a sequential fori_loop, then compares each probe row against its
// bucket's C slots as one [N, C] block).
//
// Outputs, bit-identical to the plain version (hopper_kernels.
// hash_probe_plain) wherever they reach a result:
//   table    int32 [B+1, C]  build row indices, ascending within each bucket
//   counts   int32 [B+1]     rows per bucket; bucket B is the trash bucket of
//                            inactive and NULL-key build rows
//   bucket_p int32 [N]       each probe row's bucket
//   count    int32 [N]       equal-key build rows of each active probe row
//   emit     int32 [N]       output rows of each probe row (LEFT: max(count, 1)
//                            on active rows)
//   max_count int32          max(counts[:B]); > C means a bucket overflowed
// The trash bucket's row of the table, and the rows of overflowed buckets
// (the caller retries at a larger C or declines), are never read and are
// left unspecified.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each probe row reads its keys,
// validity and activity (10 bytes for one int64 key) and writes 12 bytes;
// the table (16 MiB per million buckets at C = 32) is written once. The
// probe's reads of the table and of the build keys it compares are random
// but few: a bucket holds 0.35 rows on average on TPC-H Q3.
//
// Design: the sequential build loop of the TPU kernel becomes a parallel
// claim, one atomicAdd on the bucket's count per build row (warp-aggregated
// for the trash bucket, which takes every inactive row). Claims land in
// scheduling order, so a second pass sorts each bucket's <= C claimed row
// indices ascending (one thread per bucket, insertion sort): that restores
// the sequential loop's order, which is what makes the fused join's d-th
// match the serial join's (megakernels.py:35-42). The probe pass is one
// thread per probe row walking its bucket's occupied slots.

#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"

namespace {

using hopper::grid_for;
using hopper::KeySet;
using hopper::kMaxKeys;
using hopper::kThreads;

__global__ void __launch_bounds__(kThreads)
build_claim_kernel(KeySet bkeys, const bool* __restrict__ build_active, int64_t m,
                   int n_buckets, int C, int32_t* __restrict__ table,
                   int32_t* __restrict__ counts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < m;
       j += stride) {
    int64_t keys[kMaxKeys];
    int b;
    const bool ok = hopper::load_keys(bkeys, j, keys, n_buckets, &b);
    const bool trash = !(ok && build_active[j]);
    const unsigned mask = __ballot_sync(__activemask(), trash);
    if (trash) {
      if (lane == __ffs(mask) - 1) atomicAdd(&counts[n_buckets], __popc(mask));
    } else {
      const int c = atomicAdd(&counts[b], 1);
      if (c < C) table[static_cast<int64_t>(b) * C + c] = static_cast<int32_t>(j);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sort_buckets_kernel(int32_t* __restrict__ table, const int32_t* __restrict__ counts,
                    int n_buckets, int C, int32_t* __restrict__ max_count) {
  int local_max = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; b < n_buckets;
       b += stride) {
    const int cnt = counts[b];
    local_max = cnt > local_max ? cnt : local_max;
    const int n = cnt < C ? cnt : C;
    int32_t* row = table + b * C;
    for (int i = 1; i < n; ++i) {
      const int32_t v = row[i];
      int k = i - 1;
      while (k >= 0 && row[k] > v) {
        row[k + 1] = row[k];
        --k;
      }
      row[k + 1] = v;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int other = __shfl_down_sync(0xffffffffu, local_max, o);
    local_max = other > local_max ? other : local_max;
  }
  if ((threadIdx.x & 31) == 0 && local_max > 0) atomicMax(max_count, local_max);
}

__global__ void __launch_bounds__(kThreads)
probe_count_kernel(KeySet pkeys, KeySet bkeys, const bool* __restrict__ probe_active,
                   int64_t n, int64_t m, int n_buckets, int C,
                   const int32_t* __restrict__ table, const int32_t* __restrict__ counts,
                   int left_outer, int32_t* __restrict__ bucket_p,
                   int32_t* __restrict__ count, int32_t* __restrict__ emit) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    int64_t keys[kMaxKeys];
    int b;
    const bool ok = hopper::load_keys(pkeys, i, keys, n_buckets, &b);
    const bool active = probe_active[i];
    int hits = 0;
    if (ok && active) {
      const int cnt = counts[b];
      const int occ = cnt < C ? cnt : C;
      const int32_t* row = table + static_cast<int64_t>(b) * C;
      for (int c = 0; c < occ; ++c) {
        int64_t r = row[c];
        r = r < 0 ? 0 : (r >= m ? m - 1 : r);
        hits += hopper::keys_equal(bkeys, r, keys) ? 1 : 0;
      }
    }
    bucket_p[i] = b;
    count[i] = hits;
    emit[i] = left_outer ? (active ? (hits > 1 ? hits : 1) : 0) : hits;
  }
}

}  // namespace

// One attempt at (n_buckets, C): zeroes the table, counts and max_count,
// then launches the three passes on ``stream``. The key sets are host
// structs, copied into each launch's parameters. Returns the first CUDA
// error, 0 on success.
extern "C" int hash_probe(const hopper::KeySet* pkeys, const hopper::KeySet* bkeys,
                          const void* probe_active,
                          const void* build_active, int64_t n, int64_t m, int n_buckets,
                          int C, int left_outer, void* table, void* counts, void* bucket_p,
                          void* count, void* emit, void* max_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t slots = (static_cast<size_t>(n_buckets) + 1) * static_cast<size_t>(C);
  cudaError_t err = cudaMemsetAsync(table, 0, slots * sizeof(int32_t), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counts, 0, (static_cast<size_t>(n_buckets) + 1) * sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(max_count, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_t* tbl = static_cast<int32_t*>(table);
  int32_t* cnts = static_cast<int32_t*>(counts);
  if (m > 0) {
    build_claim_kernel<<<grid_for(m), kThreads, 0, s>>>(
        *bkeys, static_cast<const bool*>(build_active), m, n_buckets, C, tbl, cnts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sort_buckets_kernel<<<grid_for(n_buckets), kThreads, 0, s>>>(
      tbl, cnts, n_buckets, C, static_cast<int32_t*>(max_count));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    probe_count_kernel<<<grid_for(n), kThreads, 0, s>>>(
        *pkeys, *bkeys, static_cast<const bool*>(probe_active), n, m, n_buckets, C, tbl, cnts,
        left_outer, static_cast<int32_t*>(bucket_p), static_cast<int32_t*>(count),
        static_cast<int32_t*>(emit));
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
