// Key loading shared by the kernels that read key columns, and the bucket
// hashing of hash_probe.cu and hash_expand.cu: the device form of
// megakernels._normalized_keys and megakernels._bucket_of in
// trino_tpu_torch/ops/megakernels.py.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hopper {

// Key columns one join carries at most (the wrapper raises past it).
constexpr int kMaxKeys = 4;

// Storage type of a key column, as the wrapper encodes torch dtypes.
enum KeyType : int { kI64 = 0, kI32 = 1, kI16 = 2, kI8 = 3, kBool = 4, kF64 = 5, kF32 = 6 };

struct KeyCol {
  const void* data;
  const bool* valid;
  // probe-side dictionary translation into the build dictionary's codes
  // (-1 = value absent from the build side), or null
  const int64_t* lut;
  int64_t lut_len;
  int type;
};

// Passed by value as a kernel parameter.
struct KeySet {
  KeyCol col[kMaxKeys];
  int n;
};

// The keys of a group sort (group_sort.cu) or a partition hash
// (partition_epilogue.cu): up to kMaxWideKeys columns, LUTs as each kernel
// reads them. Passed by value as a kernel parameter.
constexpr int kMaxWideKeys = 8;

struct WideKeySet {
  KeyCol col[kMaxWideKeys];
  int n;
};

// kernels.float_order_key: IEEE bits, negatives unfolded to ~bits with the
// sign bit set, so that integer order is float order.
__device__ __forceinline__ int64_t float_order_key(double v) {
  const long long bits = __double_as_longlong(v);
  return bits < 0 ? static_cast<int64_t>(~bits ^ (1ll << 63)) : static_cast<int64_t>(bits);
}

// Normalized key of column c at row i (kernels.order_key after the LUT);
// returns false where the key is NULL or its value is absent from the
// build dictionary.
__device__ __forceinline__ bool load_key(const KeyCol& c, int64_t i, int64_t* key) {
  bool ok = c.valid[i];
  int64_t d;
  switch (c.type) {
    case kF64: *key = float_order_key(static_cast<const double*>(c.data)[i]); return ok;
    case kF32:
      *key = float_order_key(static_cast<double>(static_cast<const float*>(c.data)[i]));
      return ok;
    case kI64: d = static_cast<const int64_t*>(c.data)[i]; break;
    case kI32: d = static_cast<const int32_t*>(c.data)[i]; break;
    case kI16: d = static_cast<const int16_t*>(c.data)[i]; break;
    case kI8: d = static_cast<const int8_t*>(c.data)[i]; break;
    default: d = static_cast<const uint8_t*>(c.data)[i] ? 1 : 0; break;
  }
  if (c.lut != nullptr) {
    const int64_t j = d < 0 ? 0 : (d >= c.lut_len ? c.lut_len - 1 : d);
    d = c.lut[j];
    ok = ok && d >= 0;
  }
  *key = d;
  return ok;
}

// load_key's value of column c, before its LUT, at the rows i[] where
// take[] (0 elsewhere), for R rows at once: the switch on the column's type
// is uniform, so the rows' loads are issued together. Returns whether the
// column is a float (whose value no LUT translates).
template <int R>
__device__ __forceinline__ bool load_values(const KeyCol& c, const int64_t (&i)[R],
                                            const bool (&take)[R], int64_t (&key)[R]) {
  switch (c.type) {
    case kF64:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = take[r] ? float_order_key(static_cast<const double*>(c.data)[i[r]]) : 0;
      }
      return true;
    case kF32:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = take[r] ? float_order_key(static_cast<double>(
                               static_cast<const float*>(c.data)[i[r]]))
                         : 0;
      }
      return true;
    case kI64:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = take[r] ? static_cast<const int64_t*>(c.data)[i[r]] : 0;
      }
      return false;
    case kI32:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = take[r] ? static_cast<const int32_t*>(c.data)[i[r]] : 0;
      }
      return false;
    case kI16:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = take[r] ? static_cast<const int16_t*>(c.data)[i[r]] : 0;
      }
      return false;
    case kI8:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = take[r] ? static_cast<const int8_t*>(c.data)[i[r]] : 0;
      }
      return false;
    default:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        key[r] = take[r] && static_cast<const uint8_t*>(c.data)[i[r]] ? 1 : 0;
      }
      return false;
  }
}

// kernels.splitmix64 on unsigned bits (wrapping adds and multiplies,
// logical shifts): the same bits as the torch version.
__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// All keys of row i: returns whether every key is valid, fills keys[] and
// the bucket (chained SplitMix64 over the key tuple, masked to B - 1; B is a
// power of two).
__device__ __forceinline__ bool load_keys(const KeySet& ks, int64_t i, int64_t* keys,
                                          int n_buckets, int* bucket) {
  bool ok = true;
  uint64_t h = 0;
  for (int k = 0; k < ks.n; ++k) {
    ok = load_key(ks.col[k], i, &keys[k]) && ok;
    h = splitmix64(k == 0 ? static_cast<uint64_t>(keys[0]) : h + static_cast<uint64_t>(keys[k]));
  }
  *bucket = static_cast<int>(h & static_cast<uint64_t>(n_buckets - 1));
  return ok;
}

// Whether build row r's keys equal keys[] (build keys carry no LUT; rows in
// a real bucket are active and non-NULL by construction).
__device__ __forceinline__ bool keys_equal(const KeySet& bs, int64_t r, const int64_t* keys) {
  for (int k = 0; k < bs.n; ++k) {
    int64_t b;
    load_key(bs.col[k], r, &b);
    if (b != keys[k]) return false;
  }
  return true;
}

}  // namespace hopper
