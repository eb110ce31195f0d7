// Hash-join build and probe count: the bucket table of the build side and
// each probe row's number of equal-key build rows.
//
// Replaces: trino_tpu/ops/megakernels.py _probe_phase_body + probe_phase
// (one Pallas launch whose body inserts build rows into a [B+1, C] slot
// table in a sequential fori_loop, then compares each probe row against its
// bucket's C slots as one [N, C] block).
//
// Outputs, bit-identical to the plain version (hopper_kernels.
// hash_probe_plain) on everything hash_expand reads:
//   table    int32 [B+1, C]  build row indices, ascending within each bucket
//   counts   int32 [B+1]     rows per bucket; bucket B is the trash bucket of
//                            inactive and NULL-key build rows
//   bucket_p int32 [N]       each probe row's bucket
//   count    int32 [N]       equal-key build rows of each active probe row
//   emit     int32 [N]       output rows of each probe row (LEFT: max(count, 1)
//                            on active rows); on inner joins the same buffer
//                            as count
//   max_count int32          max(counts[:B]); > C means a bucket overflowed
// Unspecified, since no later phase reads them: the table's slots at or
// past min(counts[b], C), except slot 0 of an empty bucket that an
// unmatched output slot of hash_expand reads (the bucket of a LEFT join's
// active probe row, or of the last probe row, whose bucket the slots past
// the total read), which is 0 as in the plain version; and bucket_p and
// count on inactive probe rows other than the last. Where a bucket
// overflowed (the caller retries at a larger C or declines), count and
// emit too.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each probe row reads its
// activity, and an active one its keys and validity (9 bytes for one int64
// key); emit is written for every row and bucket_p for the active ones
// (and count on LEFT joins). The build side is read once; each active
// build row writes one slot and one count.
//
// Design, four stream operations a call:
//   1. one memset zeroes counts and max_count (one buffer). The table is
//      not zeroed: at C = 32 it is 128 bytes a bucket (537 MB on TPC-H Q3),
//      and only occupied slots are read.
//   2. claim: one atomicAdd on the bucket's count per build row gives the
//      row its slot. Inactive and NULL-key rows are counted per block in
//      shared memory and added to the trash bucket's count once a block:
//      that one counter, taken a warp at a time, serialized the first
//      design's claim. The claim writes nothing else: a 4-byte write at
//      random to a line not in L2 costs a read of its sector, and a head
//      written here made the claim 80 us slower on Q3's second join.
//   3. buckets: claims land in scheduling order, so one thread per bucket
//      sorts its <= C claimed row indices ascending (insertion sort), which
//      restores the sequential loop's order and so makes the fused join's
//      d-th match the serial join's (megakernels.py:35-42); it reduces
//      max_count and writes every bucket's head: its one row, -1 if empty,
//      -1 - min(count, C) if it holds several (16.8 MB on Q3, in L2).
//   4. probe (specialized on the key count, its grid as many blocks as stay
//      resident): each thread holds kRows probe rows at once, their loads
//      issued together; it reads their activity first (a step ahead) and
//      the keys of active rows only, then each bucket's head: an empty
//      bucket costs nothing more, a bucket of one row one build-key read
//      and no table read; only larger buckets read their table row. Its
//      outputs are stored evict-first. The pass is bound by the rows it
//      holds in flight, not by bytes (tools/probe_epilogue_variants.py on
//      Q3's second join on an H100): 2 rows a thread at 32 registers, so 8
//      blocks an SM, took 954 us where 4 rows at 64 registers took 1068;
//      reading every row's keys with its activity (one round fewer, twice
//      the bytes) took longer.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"

namespace {

using hopper::grid_for;
using hopper::KeyCol;
using hopper::KeySet;
using hopper::kMaxKeys;
using hopper::kThreads;

constexpr int kRows = 2;  // probe rows a thread holds at once

// Kernel launches and memsets issued by hash_probe since the library was
// loaded (chip_smoke.py reads the difference over one call).
std::atomic<int64_t> g_stream_ops{0};

__global__ void __launch_bounds__(kThreads)
claim_kernel(KeySet bkeys, const bool* __restrict__ build_active, int64_t m, int n_buckets,
             int C, int32_t* __restrict__ table, int32_t* __restrict__ counts) {
  __shared__ int trash;
  if (threadIdx.x == 0) trash = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < m;
       j += stride) {
    int64_t keys[kMaxKeys];
    int b;
    const bool ok = hopper::load_keys(bkeys, j, keys, n_buckets, &b);
    const bool out = !(ok && build_active[j]);
    const unsigned mask = __ballot_sync(__activemask(), out);
    if (out) {
      if (lane == __ffs(mask) - 1) atomicAdd(&trash, __popc(mask));
    } else {
      const int c = atomicAdd(&counts[b], 1);
      if (c < C) table[static_cast<int64_t>(b) * C + c] = static_cast<int32_t>(j);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && trash > 0) atomicAdd(&counts[n_buckets], trash);
}

__global__ void __launch_bounds__(kThreads)
buckets_kernel(int32_t* __restrict__ table, const int32_t* __restrict__ counts, int n_buckets,
               int C, int32_t* __restrict__ heads, int32_t* __restrict__ max_count) {
  int local_max = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; b < n_buckets;
       b += stride) {
    const int cnt = counts[b];
    local_max = cnt > local_max ? cnt : local_max;
    const int n = cnt < C ? cnt : C;
    int32_t* row = table + b * C;
    heads[b] = n == 1 ? row[0] : -1 - n;
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

// hopper::load_key of column c at the rows i[] where take[] (0 and false
// elsewhere), their loads issued together.
__device__ __forceinline__ void load_key_rows(const KeyCol& c, const int64_t (&i)[kRows],
                                              const bool (&take)[kRows], int64_t (&key)[kRows],
                                              bool (&ok)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) ok[k] = take[k] && c.valid[i[k]];
  if (hopper::load_values(c, i, take, key) || c.lut == nullptr) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (take[k]) {
      const int64_t d = key[k];
      key[k] = c.lut[d < 0 ? 0 : (d >= c.lut_len ? c.lut_len - 1 : d)];
      ok[k] = ok[k] && key[k] >= 0;
    }
  }
}

// NK key columns a side.
template <int NK>
__global__ void __launch_bounds__(kThreads)
probe_kernel(KeySet pkeys, KeySet bkeys, const bool* __restrict__ probe_active, int64_t n,
             int64_t m, int n_buckets, int C, int32_t* __restrict__ table,
             const int32_t* __restrict__ heads, int left_outer, int32_t* __restrict__ bucket_p,
             int32_t* __restrict__ count, int32_t* __restrict__ emit) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kRows;
  // the activity is read one step ahead, so its load overlaps a step's work
  bool next[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads * kRows + k * kThreads +
                      threadIdx.x;
    next[k] = i < n && probe_active[i];
  }
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kRows; base < n;
       base += step) {
    int64_t i[kRows];
    bool act[kRows], take[kRows], ok[kRows], warp_takes[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      i[k] = base + k * kThreads + threadIdx.x;
      act[k] = next[k];
      next[k] = i[k] + step < n && probe_active[i[k] + step];
      // the last row's bucket and count are read by hash_expand's slots
      // past the total, whatever its activity
      take[k] = act[k] || i[k] == n - 1;
      ok[k] = take[k];
      // a warp with a row to write writes bucket_p (and count) on all its
      // rows, whole sectors; a warp of inactive rows writes only emit
      warp_takes[k] = __any_sync(0xffffffffu, take[k]);
    }
    int64_t keys[NK][kRows];
    uint64_t h[kRows];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      bool vj[kRows];
      load_key_rows(pkeys.col[j], i, take, keys[j], vj);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        ok[k] = ok[k] && vj[k];
        h[k] = hopper::splitmix64(j == 0 ? static_cast<uint64_t>(keys[0][k])
                                         : h[k] + static_cast<uint64_t>(keys[j][k]));
      }
    }
    // each bucket's head; a bucket of one row compares its one row, key by
    // key for every such probe row at once
    int b[kRows];
    int32_t head[kRows];
    bool one[kRows];
    int64_t r0[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      b[k] = static_cast<int>(h[k] & static_cast<uint64_t>(n_buckets - 1));
      ok[k] = ok[k] && act[k];
      head[k] = take[k] ? heads[b[k]] : -1;
      one[k] = ok[k] && head[k] >= 0;
      r0[k] = head[k] < 0 ? 0 : (head[k] >= m ? m - 1 : head[k]);
    }
    bool eq[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) eq[k] = one[k];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      int64_t bk[kRows];
      bool unused[kRows];
      load_key_rows(bkeys.col[j], r0, one, bk, unused);
#pragma unroll
      for (int k = 0; k < kRows; ++k) eq[k] = eq[k] && bk[k] == keys[j][k];
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (i[k] >= n) continue;
      int hits = eq[k] ? 1 : 0;
      const int occ = -1 - head[k];
      if (ok[k] && occ > 1) {
        int64_t pk[kMaxKeys];
#pragma unroll
        for (int j = 0; j < NK; ++j) pk[j] = keys[j][k];
        const int32_t* row = table + static_cast<int64_t>(b[k]) * C;
        for (int c = 0; c < occ; ++c) {
          int64_t r = row[c];
          r = r < 0 ? 0 : (r >= m ? m - 1 : r);
          hits += hopper::keys_equal(bkeys, r, pk) ? 1 : 0;
        }
      }
      if (warp_takes[k]) {
        __stcs(bucket_p + i[k], take[k] ? b[k] : 0);
        if (count != emit) __stcs(count + i[k], hits);
      }
      // hash_expand's unmatched slots read slot 0 of the row's bucket
      if (take[k] && head[k] == -1 && (left_outer || i[k] == n - 1)) {
        table[static_cast<int64_t>(b[k]) * C] = 0;
      }
      __stcs(emit + i[k], left_outer ? (act[k] ? (hits > 1 ? hits : 1) : 0) : hits);
    }
  }
}

template <int NK>
void launch_probe(const KeySet& pkeys, const KeySet& bkeys, const bool* probe_active,
                  int64_t n, int64_t m, int n_buckets, int C, int32_t* table,
                  const int32_t* heads, int left_outer, int32_t* bucket_p, int32_t* count,
                  int32_t* emit, cudaStream_t s) {
  static const int per_sm = hopper::blocks_per_sm(reinterpret_cast<const void*>(
      probe_kernel<NK>));
  probe_kernel<NK><<<hopper::resident_grid((n + kRows - 1) / kRows, per_sm), kThreads, 0, s>>>(
      pkeys, bkeys, probe_active, n, m, n_buckets, C, table, heads, left_outer, bucket_p, count,
      emit);
}

void mark(void* const* events, int k, cudaStream_t s) {
  if (events != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(events[k]), s);
}

}  // namespace

extern "C" int64_t hash_probe_stream_ops() { return g_stream_ops.load(); }

// One attempt at (n_buckets, C) on ``stream``: meta (int32 [B+2]) holds
// counts and then max_count, and is zeroed; heads (int32 [B]) is scratch;
// count is emit on inner joins. The key sets are
// host structs, copied into each launch's parameters. ``events``, null or
// five CUDA events, are recorded before the memset, after it, after the
// claim, after the bucket pass and after the probe. Returns the first CUDA
// error, 0 on success.
extern "C" int hash_probe(const KeySet* pkeys, const KeySet* bkeys, const void* probe_active,
                          const void* build_active, int64_t n, int64_t m, int n_buckets, int C,
                          int left_outer, void* table, void* meta, void* heads,
                          void* bucket_p, void* count, void* emit, void* const* events,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* tbl = static_cast<int32_t*>(table);
  int32_t* cnts = static_cast<int32_t*>(meta);
  int32_t* hd = static_cast<int32_t*>(heads);
  mark(events, 0, s);
  cudaError_t err =
      cudaMemsetAsync(meta, 0, (static_cast<size_t>(n_buckets) + 2) * sizeof(int32_t), s);
  ++g_stream_ops;
  if (err != cudaSuccess) return static_cast<int>(err);
  mark(events, 1, s);
  if (m > 0) {
    claim_kernel<<<grid_for(m), kThreads, 0, s>>>(
        *bkeys, static_cast<const bool*>(build_active), m, n_buckets, C, tbl, cnts);
    ++g_stream_ops;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mark(events, 2, s);
  buckets_kernel<<<grid_for(n_buckets), kThreads, 0, s>>>(tbl, cnts, n_buckets, C, hd,
                                                          cnts + n_buckets + 1);
  ++g_stream_ops;
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mark(events, 3, s);
  if (n > 0) {
    const bool* pa = static_cast<const bool*>(probe_active);
    int32_t* bp = static_cast<int32_t*>(bucket_p);
    int32_t* ct = static_cast<int32_t*>(count);
    int32_t* em = static_cast<int32_t*>(emit);
    switch (pkeys->n) {
      case 1:
        launch_probe<1>(*pkeys, *bkeys, pa, n, m, n_buckets, C, tbl, hd, left_outer, bp, ct, em,
                        s);
        break;
      case 2:
        launch_probe<2>(*pkeys, *bkeys, pa, n, m, n_buckets, C, tbl, hd, left_outer, bp, ct, em,
                        s);
        break;
      case 3:
        launch_probe<3>(*pkeys, *bkeys, pa, n, m, n_buckets, C, tbl, hd, left_outer, bp, ct, em,
                        s);
        break;
      default:
        launch_probe<kMaxKeys>(*pkeys, *bkeys, pa, n, m, n_buckets, C, tbl, hd, left_outer, bp,
                               ct, em, s);
        break;
    }
    ++g_stream_ops;
    err = cudaGetLastError();
  }
  mark(events, 4, s);
  return static_cast<int>(err);
}
