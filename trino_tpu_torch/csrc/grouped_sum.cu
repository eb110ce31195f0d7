// Grouped exact int64 sums over a dense group id, for the direct-indexed
// aggregation (Q1's sums and counts).
//
// Replaces: trino_tpu/ops/pallas_kernels.py _gsum_kernel / _grouped_limb_sums,
// reached through grouped_sum_i64 and grouped_sum_i32. The TPU kernel splits
// every value into 16-bit limbs held in int32 lanes because the TPU's VPU has
// no int64; Hopper has native 64-bit integer adds, so the limb split is not
// carried over.
//
// out[g] = sum(values[i] for gid[i] == g and weight[i]) mod 2^64, for
// 1 <= num_groups <= 64. Rows whose gid lies outside [0, num_groups) are
// skipped, as the wrapper's plain version (hopper_kernels.grouped_sum_plain)
// skips them, so both devices keep one contract.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each row is read once: 8 (int64
// value) or 4 (int32 value) + 1 (weight) + 4 (gid) bytes, so 13 or 9 bytes a
// row; the adds are a few integer operations per row.
//
// Design against that bound: one grid-stride pass in which every thread
// loads four rows at a time as 16-byte gids and values and 4 bytes of
// weights, two such groups of loads in flight before their adds. A view
// whose pointers are not 16-byte aligned keeps that path from the first row
// at which all three are aligned together; the rows before it and after the
// last whole group of four, or every row where no such row exists, are read
// one at a time. Each thread adds into its own column of shared
// accumulators, acc[g][thread], with a plain load and store: no two threads
// touch one address, so the per-row atomic of a per-warp copy, which
// serializes when a warp's lanes share a few groups (Q1 has 4 live groups
// of 12), is gone, and consecutive threads' 64-bit entries fall on distinct
// bank pairs whatever g is. The layout is picked by G so that a block's
// accumulators stay within 32 KB: 256 threads up to 16 groups, 128 up to 32
// and 64 up to 64. After the pass each warp folds the columns of some
// groups with shuffles and issues one global atomicAdd per group. Sums are
// unsigned 64-bit adds, associative and commutative mod 2^64, so the result
// is bit-identical whatever the order.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kMaxGroups = 64;
constexpr int kRowsPerLoad = 4;  // rows of one 16-byte gid load
constexpr int kUnroll = 2;       // groups of four rows loaded before their adds
// accumulators a block holds at most (G * threads): 32 KB
constexpr int kAccEntries = 4096;

template <typename T>
struct Four {
  T v[kRowsPerLoad];
};

template <typename T>
__device__ __forceinline__ Four<T> load_four(const T* p);

template <>
__device__ __forceinline__ Four<int32_t> load_four<int32_t>(const int32_t* p) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}

template <>
__device__ __forceinline__ Four<int64_t> load_four<int64_t>(const int64_t* p) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
  return {{static_cast<int64_t>(a.x), static_cast<int64_t>(a.y), static_cast<int64_t>(b.x),
           static_cast<int64_t>(b.y)}};
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
grouped_sum_kernel(const T* __restrict__ values, const bool* __restrict__ weight,
                   const int32_t* __restrict__ gid, int64_t n, int num_groups, int64_t head,
                   int64_t n_four, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];  // acc[g * THREADS + thread]
  for (int i = threadIdx.x; i < num_groups * THREADS; i += THREADS) acc[i] = 0ull;
  __syncthreads();
  unsigned long long* mine = acc + threadIdx.x;
  const unsigned G = static_cast<unsigned>(num_groups);
  auto add = [&](int32_t g, bool w, T v) {
    // sign-extend to 64 bits, then add as unsigned (wraps mod 2^64)
    if (w && static_cast<unsigned>(g) < G) {
      mine[static_cast<unsigned>(g) * THREADS] +=
          static_cast<unsigned long long>(static_cast<long long>(v));
    }
  };
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  // rows head + 4k .. head + 4k + 3, k < n_four, every load aligned
  for (int64_t k = first; k < n_four; k += kUnroll * stride) {
    int4 g4[kUnroll];
    uint32_t w4[kUnroll];
    Four<T> v4[kUnroll];
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = head + (k + u * stride) * kRowsPerLoad;
      if (k + u * stride < n_four) {
        g4[u] = __ldcs(reinterpret_cast<const int4*>(gid + r));
        w4[u] = __ldcs(reinterpret_cast<const unsigned int*>(weight + r));
        v4[u] = load_four<T>(values + r);
      } else {
        w4[u] = 0u;
        g4[u] = make_int4(0, 0, 0, 0);
        v4[u] = Four<T>{};
      }
    }
    for (int u = 0; u < kUnroll; ++u) {
      add(g4[u].x, w4[u] & 0xffu, v4[u].v[0]);
      add(g4[u].y, (w4[u] >> 8) & 0xffu, v4[u].v[1]);
      add(g4[u].z, (w4[u] >> 16) & 0xffu, v4[u].v[2]);
      add(g4[u].w, w4[u] >> 24, v4[u].v[3]);
    }
  }
  // the rows one at a time: [0, head) and [head + 4 * n_four, n)
  const int64_t tail = head + n_four * kRowsPerLoad;
  for (int64_t i = first; i < head + (n - tail); i += stride) {
    const int64_t r = i < head ? i : tail + (i - head);
    add(gid[r], weight[r], values[r]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < num_groups; g += THREADS / 32) {
    unsigned long long s = 0ull;
    for (int t = lane; t < THREADS; t += 32) s += acc[g * THREADS + t];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && s != 0ull) atomicAdd(&out[g], s);
  }
}

template <typename T, int THREADS>
int launch_with(const T* values, const bool* weight, const int32_t* gid, int64_t n,
                int num_groups, unsigned long long* out, cudaStream_t s) {
  // the first row at which gid, weight and values are all aligned for the
  // four-row loads; none (every row one at a time) if it does not exist
  const uintptr_t ga = reinterpret_cast<uintptr_t>(gid);
  int64_t head = static_cast<int64_t>(((16 - (ga & 15)) & 15) / sizeof(int32_t));
  const bool together = ga % sizeof(int32_t) == 0
      && (reinterpret_cast<uintptr_t>(weight + head) & 3) == 0
      && (reinterpret_cast<uintptr_t>(values + head) & 15) == 0;
  if (!together || head > n) head = n;
  const int64_t n_four = (n - head) / kRowsPerLoad;
  // blocks an SM holds with the layout's largest accumulators (read once,
  // thread-safe: worker threads launch concurrently); a negative value is
  // the query's CUDA error
  static const int resident = [] {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, grouped_sum_kernel<T, THREADS>, THREADS,
        sizeof(unsigned long long) * kAccEntries);
    return err != cudaSuccess ? -static_cast<int>(err) : blocks;
  }();
  if (resident < 0) return -resident;
  const int64_t want = ((n + kRowsPerLoad - 1) / kRowsPerLoad + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(hopper::sm_count()) * (resident > 0 ? resident : 1);
  const unsigned grid = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  grouped_sum_kernel<T, THREADS>
      <<<grid, THREADS, sizeof(unsigned long long) * num_groups * THREADS, s>>>(
          values, weight, gid, n, num_groups, head, n_four, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* values, const void* weight, const void* gid, int64_t n,
           int num_groups, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(unsigned long long) * num_groups, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_groups < 1 || num_groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const T* v = static_cast<const T*>(values);
  const bool* w = static_cast<const bool*>(weight);
  const int32_t* g = static_cast<const int32_t*>(gid);
  // G * threads <= kAccEntries
  if (num_groups <= 16) return launch_with<T, 256>(v, w, g, n, num_groups, o, s);
  if (num_groups <= 32) return launch_with<T, 128>(v, w, g, n, num_groups, o, s);
  return launch_with<T, 64>(v, w, g, n, num_groups, o, s);
}

}  // namespace

extern "C" int grouped_sum_i64(const void* values, const void* weight, const void* gid,
                               int64_t n, int num_groups, void* out, void* stream) {
  return launch<int64_t>(values, weight, gid, n, num_groups, out, stream);
}

extern "C" int grouped_sum_i32(const void* values, const void* weight, const void* gid,
                               int64_t n, int num_groups, void* out, void* stream) {
  return launch<int32_t>(values, weight, gid, n, num_groups, out, stream);
}
