// Exchange destination: each row's destination partition, where the page
// a fused phase returns feeds a hash exchange and no kernel of that phase
// holds the keys.
//
// Replaces: the epi_spec stage of trino_tpu/ops/megakernels.py
// expand_phase (the _partition_dest call ending _expand_phase_body) and of
// aggregate_phase (the same call ending _agg_phase_body). When a
// fragment's output feeds a hash exchange, the reference computes each
// row's destination inside the kernel that produced the page and attaches
// it to the page; the exchange then consumes it (ops/repartition.py
// _take_fused_dest) instead of hashing again. The port computes it in the
// kernel that produced the page where that kernel holds the keys:
// hash_expand.cu's slot pass (a join whose output is the phase's page) and
// segment_agg.cu's finish pass (keys that are all group keys). This launch
// runs where none does: after a direct aggregation or a projection of the
// joined page, and where an exchange key is an aggregate's output.
//
// Bit-identical to the plain version (ops/repartition.py _partition_dest):
// the hash is partition_hash.cuh's, the one partition_epilogue.cu uses.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each key column and its
// validity, and the activity, are read once; one int32 a row is written.
//
// Design: one grid-stride launch (dest_kernel, kHashRows = 8 rows a
// thread, specialized on the key count so every key column's loads are
// issued before any is used), as many blocks as the card holds at once.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "partition_hash.cuh"

namespace {

// Kernel launches issued by partition_dest since the library was loaded.
std::atomic<int64_t> g_stream_ops{0};

}  // namespace

extern "C" int64_t partition_dest_stream_ops() { return g_stream_ops.load(); }

// dest (int32 [n]) = each row's destination under ``keys`` (0 to 8 key
// columns, LUTs as value-key maps), n_parts where ``active`` is false, on
// ``stream``.
extern "C" int partition_dest(const hopper::WideKeySet* keys, const void* active, int64_t n,
                              int n_parts, void* dest, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = hopper::partition::launch_dest(
      *keys, static_cast<const bool*>(active), n, n_parts, static_cast<uint32_t*>(dest),
      static_cast<cudaStream_t>(stream));
  ++g_stream_ops;
  return static_cast<int>(err);
}
