// The request and output plans of the port's aggregation kernels, and the
// device code they share: segment_agg.cu (the sort path over a group-sorted
// page) and segment_agg_direct.cu (the direct-indexed path over small key
// domains) read one AggRequestSet and finish one AggOutputSet with the same
// contribution, combination and finishing code, so the two paths give one
// aggregate the same bits wherever they reduce the same rows in one order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"

namespace hopper {

constexpr int kMaxAggRequests = 32;
constexpr int kMaxAggOutputs = 24;

// Reduction kinds (hopper_kernels._AGG_KINDS).
enum AggKind : int {
  kSumInt = 0, kSumFloat = 1, kMinInt = 2, kMaxInt = 3, kMinFloat = 4, kMaxFloat = 5,
  kLastRow = 6, kCount = 7,
};
// Predicates on the value that narrow a request's weight.
enum AggPred : int { kPredNone = 0, kPredNonZero = 1, kPredZero = 2 };

struct AggRequest {
  const void* values;        // null for a count without a predicate
  const bool* valid;         // null: every value valid
  const bool* filter;        // null: no filter
  const bool* filter_valid;
  double divisor;            // kSumFloat: each value times its reciprocal (1: not)
  int64_t identity;          // bits of the empty reduction
  int type;                  // KeyType of values
  int kind;
  int pred;
  int square;                // kSumFloat: each value squared after the division
};

struct AggRequestSet {
  AggRequest req[kMaxAggRequests];
  int n;
};

// What the finish pass reads of the requests (a smaller kernel parameter).
struct AggCombine {
  int64_t identity[kMaxAggRequests];
  int kind[kMaxAggRequests];
  int n;
};

// Finishing ops (hopper_kernels._AGG_OPS).
enum AggOp : int { kValue = 0, kAvgDecimal = 1, kAvgDouble = 2, kBoolAnd = 3, kBoolOr = 4,
                   kFirst = 5 };

struct AggOutput {
  const void* first_values;  // kFirst: the column gathered at the request's row
  void* data;
  bool* valid;
  double divisor;            // kAvgDouble: times its reciprocal after the count (1: not)
  int op;
  int a;                     // the request it finishes
  int b;                     // the count whose > 0 is the validity (-1: always valid)
  int out_type;              // KeyType of data
  int elem_bytes;            // kFirst
  int a_float;               // request a holds a double
};

struct AggOutputSet {
  AggOutput out[kMaxAggOutputs];
  int n;
};

// The group keys, gathered at the starts; col[k].lut is the value-key LUT
// of a key the destination hashes.
struct GroupKeySet {
  KeyCol col[kMaxWideKeys];
  void* dst[kMaxWideKeys];
  bool* dst_valid[kMaxWideKeys];
  int elem_bytes[kMaxWideKeys];
  int n;
  int dest_key[kMaxWideKeys];  // the keys the destination hashes, in order
  int n_dest;                  // 0: no destination
  int n_parts;
};

}  // namespace hopper

namespace hopper {
namespace agg {

__device__ __forceinline__ int64_t load_int(int type, const void* p, int64_t i) {
  switch (type) {
    case hopper::kI64: return static_cast<const int64_t*>(p)[i];
    case hopper::kI32: return static_cast<const int32_t*>(p)[i];
    case hopper::kI16: return static_cast<const int16_t*>(p)[i];
    case hopper::kI8: return static_cast<const int8_t*>(p)[i];
    case hopper::kBool: return static_cast<const uint8_t*>(p)[i] ? 1 : 0;
    case hopper::kF64: return static_cast<int64_t>(static_cast<const double*>(p)[i]);
    default: return static_cast<int64_t>(static_cast<const float*>(p)[i]);
  }
}

__device__ __forceinline__ double load_double(int type, const void* p, int64_t i) {
  switch (type) {
    case hopper::kF64: return static_cast<const double*>(p)[i];
    case hopper::kF32: return static_cast<double>(static_cast<const float*>(p)[i]);
    default: return static_cast<double>(load_int(type, p, i));
  }
}

__device__ __forceinline__ bool nonzero(int type, const void* p, int64_t i) {
  switch (type) {
    case hopper::kF64: return static_cast<const double*>(p)[i] != 0.0;
    case hopper::kF32: return static_cast<const float*>(p)[i] != 0.0f;
    default: return load_int(type, p, i) != 0;
  }
}

__device__ __forceinline__ double as_double(uint64_t b) {
  return __longlong_as_double(static_cast<long long>(b));
}

__device__ __forceinline__ uint64_t bits_of(double d) {
  return static_cast<uint64_t>(__double_as_longlong(d));
}

// NaN-propagating min and max (torch's amin/amax).
__device__ __forceinline__ double fmin_nan(double x, double y) {
  return x != x ? x : (y != y ? y : (y < x ? y : x));
}

__device__ __forceinline__ double fmax_nan(double x, double y) {
  return x != x ? x : (y != y ? y : (y > x ? y : x));
}

__device__ __forceinline__ uint64_t combine(int kind, uint64_t a, uint64_t b) {
  switch (kind) {
    case hopper::kSumInt:
    case hopper::kCount: return a + b;
    case hopper::kSumFloat: return bits_of(as_double(a) + as_double(b));
    case hopper::kMinInt: {
      const int64_t x = static_cast<int64_t>(a), y = static_cast<int64_t>(b);
      return static_cast<uint64_t>(y < x ? y : x);
    }
    case hopper::kMinFloat: return bits_of(fmin_nan(as_double(a), as_double(b)));
    case hopper::kMaxFloat: return bits_of(fmax_nan(as_double(a), as_double(b)));
    default: {  // kMaxInt, kLastRow
      const int64_t x = static_cast<int64_t>(a), y = static_cast<int64_t>(b);
      return static_cast<uint64_t>(y > x ? y : x);
    }
  }
}

// Row i's contribution to request q: its value (or 1, or its index) where
// the row is weighted, the identity elsewhere.
__device__ __forceinline__ uint64_t contribution(const AggRequest& q, const bool* active,
                                                 int64_t i) {
  bool w = active[i];
  if (q.filter != nullptr) w = w && q.filter[i] && q.filter_valid[i];
  if (q.valid != nullptr) w = w && q.valid[i];
  if (w && q.pred != hopper::kPredNone) {
    w = nonzero(q.type, q.values, i) == (q.pred == hopper::kPredNonZero);
  }
  if (!w) return static_cast<uint64_t>(q.identity);
  switch (q.kind) {
    case hopper::kCount: return 1ull;
    case hopper::kSumFloat: {
      double x = load_double(q.type, q.values, i);
      // torch divides by a scalar on the card as a product with the
      // scalar's reciprocal; so does this, for the same bits
      if (q.divisor != 1.0) x = x * (1.0 / q.divisor);
      if (q.square) x = x * x;
      return bits_of(x);
    }
    case hopper::kMinFloat:
    case hopper::kMaxFloat: return bits_of(load_double(q.type, q.values, i));
    case hopper::kLastRow: return static_cast<uint64_t>(i);
    default: return static_cast<uint64_t>(load_int(q.type, q.values, i));
  }
}

__device__ __forceinline__ void copy_bytes(const void* src, int64_t from, void* dst, int64_t to,
                                           int bytes) {
  switch (bytes) {
    case 1: static_cast<uint8_t*>(dst)[to] = static_cast<const uint8_t*>(src)[from]; break;
    case 2: static_cast<uint16_t*>(dst)[to] = static_cast<const uint16_t*>(src)[from]; break;
    case 4: static_cast<uint32_t*>(dst)[to] = static_cast<const uint32_t*>(src)[from]; break;
    default: static_cast<uint64_t*>(dst)[to] = static_cast<const uint64_t*>(src)[from]; break;
  }
}

// A finished value into an output column of KeyType ``type``.
__device__ __forceinline__ void store_value(void* data, int type, int64_t g, uint64_t v,
                                            bool is_float) {
  const double d = is_float ? as_double(v) : static_cast<double>(static_cast<int64_t>(v));
  const int64_t x = static_cast<int64_t>(v);
  switch (type) {
    case hopper::kI64: static_cast<int64_t*>(data)[g] = x; break;
    case hopper::kI32: static_cast<int32_t*>(data)[g] = static_cast<int32_t>(x); break;
    case hopper::kI16: static_cast<int16_t*>(data)[g] = static_cast<int16_t>(x); break;
    case hopper::kI8: static_cast<int8_t*>(data)[g] = static_cast<int8_t>(x); break;
    case hopper::kBool: static_cast<bool*>(data)[g] = is_float ? d != 0.0 : x != 0; break;
    case hopper::kF64: static_cast<double*>(data)[g] = d; break;
    default: static_cast<float*>(data)[g] = static_cast<float>(d); break;
  }
}

// Python's floor division of int64s (b > 0), wrapping as torch does.
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}

// Output ``out`` of slot g from the requests' values v[] (n rows): the
// finishing of executor._eval_aggregate.
__device__ __forceinline__ void finish_output(const AggOutput& out, const uint64_t* v,
                                              int64_t g, int64_t n) {
  const bool ok = out.b < 0 || static_cast<int64_t>(v[out.b]) > 0;
  const uint64_t a = v[out.a];
  switch (out.op) {
    case hopper::kAvgDecimal: {
      const int64_t sum = static_cast<int64_t>(a), cnt = static_cast<int64_t>(v[out.b]);
      const int64_t half = floor_div(cnt, 2);
      const int64_t den = cnt > 1 ? cnt : 1;
      const uint64_t us = static_cast<uint64_t>(sum), uh = static_cast<uint64_t>(half);
      const int64_t q = sum >= 0 ? floor_div(static_cast<int64_t>(us + uh), den)
                                 : static_cast<int64_t>(0ull - static_cast<uint64_t>(
                                       floor_div(static_cast<int64_t>(uh - us), den)));
      store_value(out.data, out.out_type, g, static_cast<uint64_t>(q), false);
      break;
    }
    case hopper::kAvgDouble: {
      const int64_t cnt = static_cast<int64_t>(v[out.b]);
      double d = out.a_float ? as_double(a) : static_cast<double>(static_cast<int64_t>(a));
      d = d / static_cast<double>(cnt > 1 ? cnt : 1);
      if (out.divisor != 1.0) d = d * (1.0 / out.divisor);
      store_value(out.data, out.out_type, g, bits_of(d), true);
      break;
    }
    case hopper::kBoolAnd: static_cast<bool*>(out.data)[g] = a == 0; break;
    case hopper::kBoolOr: static_cast<bool*>(out.data)[g] = static_cast<int64_t>(a) > 0; break;
    case hopper::kFirst: {
      const int64_t row = static_cast<int64_t>(a);
      copy_bytes(out.first_values, row < 0 ? 0 : (row > n - 1 ? n - 1 : row), out.data, g,
                 out.elem_bytes);
      break;
    }
    default: store_value(out.data, out.out_type, g, a, out.a_float); break;
  }
  out.valid[g] = ok;
}

}  // namespace agg
}  // namespace hopper
