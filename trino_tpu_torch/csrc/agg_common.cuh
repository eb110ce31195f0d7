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
constexpr int kMaxAggReads = 6;

// Reduction kinds (hopper_kernels._AGG_KINDS): wrapping int64 sums,
// float64 sums, integer and float min and max, the last weighted row, a
// count, bitwise AND, OR and XOR, a checksum, min_by/max_by's row
// (kMatchLast: the last weighted row whose order key is its ref's extreme)
// and a long decimal's tied lo limb (kTied: the min, or the max, as its
// ref is a min or a max, of its values among the weighted rows whose
// values2 is its ref's extreme). kMatchLast and kTied read their ref's
// result, so they are served in a second round.
enum AggKind : int {
  kSumInt = 0, kSumFloat = 1, kMinInt = 2, kMaxInt = 3, kMinFloat = 4, kMaxFloat = 5,
  kLastRow = 6, kCount = 7, kBitAnd = 8, kBitOr = 9, kBitXor = 10, kChecksum = 11,
  kMatchLast = 12, kTied = 13,
};

// Whether a request of this kind reads its ref's result (a second round).
__host__ __device__ __forceinline__ bool second_round(int kind) {
  return kind == kMatchLast || kind == kTied;
}

// The reduction of a request's contributions: its kind, but a kTied
// request's is its ref's min or max, which its identity tells (INT64_MAX:
// a min).
__host__ __device__ __forceinline__ int combine_kind(int kind, int64_t identity) {
  if (kind != kTied) return kind;
  return identity == INT64_MAX ? kMinInt : kMaxInt;
}
// Predicates on the value that narrow a request's weight.
enum AggPred : int { kPredNone = 0, kPredNonZero = 1, kPredZero = 2 };
// Per-row transforms (hopper_kernels._AGG_TRANSFORMS).
enum AggTransform : int {
  kNoTransform = 0, kLog = 1, kClampZero = 2, kXLog2X = 3, kOrderKey = 4,
};

// What a NULL row adds to a checksum (hopper_kernels.CHECKSUM_NULL).
constexpr uint64_t kChecksumNull = 0x9E3779B9ull;

struct AggRequest {
  const void* values;        // null for a count without a predicate
  const bool* valid;         // null: every value valid (kChecksum: not in the weight)
  const bool* filter;        // null: no filter
  const bool* filter_valid;
  const void* values2;       // kSumFloat: a second factor (null: none); kTied: the
                             // ref's values, compared with the ref's extreme
  const bool* valid2;        // null: no second validity in the weight
  const int64_t* lut;        // kChecksum: dictionary code -> value key (null: none)
  double inv_divisor;        // kSumFloat: each value times the reciprocal of its
                             // divisor, made on the host (1: no divisor)
  double inv_divisor2;       // the same for values2
  int64_t identity;          // bits of the empty reduction
  int32_t lut_len;
  int32_t ref;               // kMatchLast, kTied: the request whose extreme it reads
  int8_t type;               // KeyType of values
  int8_t type2;              // KeyType of values2
  int8_t kind;
  int8_t pred;
  int8_t power;              // kSumFloat: 1 to 4
  int8_t transform;
  int8_t resorted;           // reads segment_sort's columns: the page's activity is not
                             // part of the weight (the sorted weight carries it)
};

struct AggRequestSet {
  AggRequest req[kMaxAggRequests];
  int n;
};

// What the finish pass reads of the requests (a smaller kernel parameter).
struct AggCombine {
  int64_t identity[kMaxAggRequests];
  int kind[kMaxAggRequests];  // combine_kind of each request
  int ref[kMaxAggRequests];   // kMatchLast, kTied: the request whose extreme it reads
  int n;
};

// Finishing ops (hopper_kernels._AGG_OPS).
enum AggOp : int {
  kValue = 0, kAvgDecimal = 1, kAvgDouble = 2, kBoolAnd = 3, kBoolOr = 4, kFirst = 5,
  kVarPop = 6, kVarSamp = 7, kStddevPop = 8, kStddevSamp = 9, kCovarPop = 10,
  kCovarSamp = 11, kCorr = 12, kRegrSlope = 13, kRegrIntercept = 14, kRegrAvgx = 15,
  kRegrAvgy = 16, kRegrSxx = 17, kRegrSyy = 18, kRegrSxy = 19, kRegrR2 = 20,
  kSkewness = 21, kKurtosis = 22, kGeometricMean = 23, kEntropy = 24, kPercentile = 25,
  kDigest = 26, kInt128 = 27,
};

// The centroids of a digest output (spi/types.py TDIGEST_CENTROIDS): each
// slot holds their 64 means, then their 64 weights.
constexpr int kDigestCentroids = 64;

struct AggOutput {
  const void* first_values;  // kFirst: the column gathered at the request's row
  const bool* first_valid;   // kFirst: its validity there joins the output's (null: not)
  void* data;
  bool* valid;
  double divisor;            // kAvgDouble: times its reciprocal after the count (1: not)
  int op;
  int reads[kMaxAggReads];   // the requests the op reads (hopper_kernels.AggOutput)
  int n_reads;
  int out_type;              // KeyType of data
  int elem_bytes;            // kFirst, kPercentile
  int a_float;               // request reads[0] holds a double
  int values_type;           // kDigest: KeyType of first_values
  int quantiles_type;        // kPercentile: KeyType of quantiles
  const void* quantiles;     // kPercentile: the quantile column, read at the request's row
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

// The finishings round every operation as torch's one-operation kernels
// do: never contracted into a fused multiply-add, which nvcc would do by
// default for a product feeding a sum.
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double ddiv(double a, double b) { return __ddiv_rn(a, b); }

// torch's clamp(min=lo) on the card: NaN stays, else ::max (fmax).
__device__ __forceinline__ double clamp_min(double v, double lo) {
  return v != v ? v : fmax(v, lo);
}

// A request kind as a type: the kernels' loops are specialised on it (a
// kTied request's on its combine_kind).
template <int K>
struct KindTag {
  static constexpr int kind = K;
};

// fn(KindTag<kind>{}): one specialisation of fn per request kind, chosen once
// where a loop over rows would otherwise switch on the kind at every row.
template <typename Fn>
__device__ __forceinline__ void with_kind(int kind, Fn&& fn) {
  switch (kind) {
    case hopper::kSumInt: fn(KindTag<hopper::kSumInt>{}); break;
    case hopper::kSumFloat: fn(KindTag<hopper::kSumFloat>{}); break;
    case hopper::kMinInt: fn(KindTag<hopper::kMinInt>{}); break;
    case hopper::kMaxInt: fn(KindTag<hopper::kMaxInt>{}); break;
    case hopper::kMinFloat: fn(KindTag<hopper::kMinFloat>{}); break;
    case hopper::kMaxFloat: fn(KindTag<hopper::kMaxFloat>{}); break;
    case hopper::kLastRow: fn(KindTag<hopper::kLastRow>{}); break;
    case hopper::kCount: fn(KindTag<hopper::kCount>{}); break;
    case hopper::kBitAnd: fn(KindTag<hopper::kBitAnd>{}); break;
    case hopper::kBitOr: fn(KindTag<hopper::kBitOr>{}); break;
    case hopper::kBitXor: fn(KindTag<hopper::kBitXor>{}); break;
    case hopper::kChecksum: fn(KindTag<hopper::kChecksum>{}); break;
    default: fn(KindTag<hopper::kMatchLast>{}); break;
  }
}

// The reduction of request kind KIND: wrapping int64 sums (counts and
// checksums too), float64 sums, bitwise, and min and max (the last row and
// min_by's row are the largest row index).
template <int KIND>
__device__ __forceinline__ uint64_t combine_of(uint64_t a, uint64_t b) {
  if constexpr (KIND == hopper::kSumInt || KIND == hopper::kCount || KIND == hopper::kChecksum) {
    return a + b;
  } else if constexpr (KIND == hopper::kSumFloat) {
    return bits_of(dadd(as_double(a), as_double(b)));
  } else if constexpr (KIND == hopper::kBitAnd) {
    return a & b;
  } else if constexpr (KIND == hopper::kBitOr) {
    return a | b;
  } else if constexpr (KIND == hopper::kBitXor) {
    return a ^ b;
  } else if constexpr (KIND == hopper::kMinInt) {
    const int64_t x = static_cast<int64_t>(a), y = static_cast<int64_t>(b);
    return static_cast<uint64_t>(y < x ? y : x);
  } else if constexpr (KIND == hopper::kMinFloat) {
    return bits_of(fmin_nan(as_double(a), as_double(b)));
  } else if constexpr (KIND == hopper::kMaxFloat) {
    return bits_of(fmax_nan(as_double(a), as_double(b)));
  } else {  // kMaxInt, kLastRow, kMatchLast
    const int64_t x = static_cast<int64_t>(a), y = static_cast<int64_t>(b);
    return static_cast<uint64_t>(y > x ? y : x);
  }
}

__device__ __forceinline__ uint64_t combine(int kind, uint64_t a, uint64_t b) {
  uint64_t out = 0;
  with_kind(kind, [&](auto tag) { out = combine_of<decltype(tag)::kind>(a, b); });
  return out;
}

// kernels.order_key of a value: a double's order-preserving bits, else the
// value as int64.
__device__ __forceinline__ int64_t order_key(int type, const void* p, int64_t i) {
  if (type == hopper::kF64 || type == hopper::kF32) {
    return hopper::float_order_key(load_double(type, p, i));
  }
  return load_int(type, p, i);
}

// kernels.splitmix64 (wrapping products, logical shifts).
__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// A kSumFloat request's double from its value x (and second factor x2),
// as contribs computes it.
__device__ __forceinline__ double float_of(const AggRequest& q, double x, double x2) {
  if (q.inv_divisor != 1.0) x = dmul(x, q.inv_divisor);
  switch (q.transform) {
    case hopper::kLog: x = log(x); break;
    case hopper::kClampZero: x = clamp_min(x, 0.0); break;
    case hopper::kXLog2X: {
      const double c = clamp_min(x, 0.0);
      x = c > 0.0 ? dmul(c, log2(c)) : 0.0;
      break;
    }
    default: break;
  }
  double y = x;
  for (int p = 1; p < q.power; ++p) y = dmul(y, x);
  if (q.values2 != nullptr) {
    if (q.inv_divisor2 != 1.0) x2 = dmul(x2, q.inv_divisor2);
    y = dmul(y, x2);
  }
  return y;
}

// float_of at row i.
__device__ __forceinline__ double float_row(const AggRequest& q, int64_t i) {
  return float_of(q, load_double(q.type, q.values, i),
                  q.values2 != nullptr ? load_double(q.type2, q.values2, i) : 0.0);
}

// Whether row i passes request q's weight columns: the page's activity
// (not for a resorted count), its filter and validities (a checksum's
// validity picks its NULL constant instead). Every column is read whatever
// the others hold, so the loads go out together.
__device__ __forceinline__ bool weight_columns(const AggRequest& q, const bool* active,
                                               int64_t i) {
  bool w = q.resorted ? true : active[i];
  if (q.filter != nullptr) w = w & q.filter[i] & q.filter_valid[i];
  if (q.valid != nullptr && q.kind != hopper::kChecksum) w = w & q.valid[i];
  if (q.valid2 != nullptr) w = w & q.valid2[i];
  return w;
}

// Whether row i is weighted for request q: its weight columns and its
// predicate on the value.
__device__ __forceinline__ bool weighted(const AggRequest& q, const bool* active, int64_t i) {
  bool w = weight_columns(q, active, i);
  if (q.pred != hopper::kPredNone) {
    w = w & (nonzero(q.type, q.values, i) == (q.pred == hopper::kPredNonZero));
  }
  return w;
}

// A checksum's term of a weighted row: splitmix64 of the value's order key
// (or of its dictionary code's value key), a constant where it is NULL.
__device__ __forceinline__ uint64_t checksum_term(const AggRequest& q, int64_t code_or_key,
                                                  bool is_null) {
  if (is_null) return kChecksumNull;
  int64_t v = code_or_key;
  if (q.lut != nullptr) v = q.lut[v < 0 ? 0 : (v >= q.lut_len ? q.lut_len - 1 : v)];
  return splitmix64(static_cast<uint64_t>(v));
}

// Row i's contribution to request q of kind KIND (not kMatchLast or kTied): its
// value (or 1, or its index) where the row is weighted, the identity
// elsewhere. The value is read beside the weight, not after it.
template <int KIND>
__device__ __forceinline__ uint64_t contribution_of(const AggRequest& q, const bool* active,
                                                    int64_t i) {
  const bool w = weighted(q, active, i);
  const uint64_t ident = static_cast<uint64_t>(q.identity);
  if constexpr (KIND == hopper::kCount) {
    return w ? 1ull : ident;
  } else if constexpr (KIND == hopper::kSumFloat) {
    const double y = float_row(q, i);
    return w ? bits_of(y) : ident;
  } else if constexpr (KIND == hopper::kMinFloat || KIND == hopper::kMaxFloat) {
    const double x = load_double(q.type, q.values, i);
    return w ? bits_of(x) : ident;
  } else if constexpr (KIND == hopper::kLastRow || KIND == hopper::kMatchLast) {
    return w ? static_cast<uint64_t>(i) : ident;
  } else if constexpr (KIND == hopper::kChecksum) {
    const bool is_null = q.valid != nullptr && !q.valid[i];
    const int64_t k = q.lut != nullptr ? load_int(q.type, q.values, i)
                                       : order_key(q.type, q.values, i);
    return w ? checksum_term(q, k, is_null) : ident;
  } else {
    const int64_t x = q.transform == hopper::kOrderKey ? order_key(q.type, q.values, i)
                                                       : load_int(q.type, q.values, i);
    return w ? static_cast<uint64_t>(x) : ident;
  }
}

// A raw value: int64 for an integer or bool column, a double's bits for a
// float one (a float32 widened), as load_int and load_double read it.
__device__ __forceinline__ bool is_float_type(int type) {
  return type == hopper::kF64 || type == hopper::kF32;
}

__device__ __forceinline__ uint64_t load_raw_row(int type, const void* p, int64_t i) {
  return is_float_type(type) ? bits_of(load_double(type, p, i))
                             : static_cast<uint64_t>(load_int(type, p, i));
}

// A raw value as load_double, load_int and order_key read it.
__device__ __forceinline__ double raw_double(uint64_t raw, bool f) {
  return f ? as_double(raw) : static_cast<double>(static_cast<int64_t>(raw));
}

__device__ __forceinline__ uint64_t raw_int(uint64_t raw, bool f) {
  return f ? static_cast<uint64_t>(static_cast<int64_t>(as_double(raw))) : raw;
}

__device__ __forceinline__ uint64_t raw_order_key(uint64_t raw, bool f) {
  return f ? static_cast<uint64_t>(hopper::float_order_key(as_double(raw))) : raw;
}

// The contributions c of request q (not kMatchLast or kTied) over R rows, row(j)
// the index of row j, whose raw values x the caller read (load_raw_row's
// form; 0 for a count without values): w the rows' weight bits before the
// predicate, not_null a checksum's bits where its value is not NULL, and
// load2(x2) reads the second factor's raw values of the R rows. Each
// choice the request makes (its kind, transform, power, divisors) is made
// once for the R rows. A float sum's double: the value times its divisor's
// reciprocal (torch divides by a scalar on the card as a product with the
// scalar's reciprocal; the host makes it, correctly rounded as the card's
// division is), transformed, raised to its power left to right and times
// the second factor (over its own divisor), each product rounded on its
// own.
template <int R, typename Row, typename Load2>
__device__ __forceinline__ void contribs(const AggRequest& q, uint32_t w, uint32_t not_null,
                                         uint64_t (&x)[R], Row row, Load2 load2,
                                         uint64_t (&c)[R]) {
  const uint64_t ident = static_cast<uint64_t>(q.identity);
  const bool f = is_float_type(q.type);
  if (q.pred != hopper::kPredNone) {
    const bool want = q.pred == hopper::kPredNonZero;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool nz = f ? as_double(x[j]) != 0.0 : x[j] != 0;
      if (nz != want) w &= ~(1u << j);
    }
  }
  switch (q.kind) {
    case hopper::kCount:
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = w >> j & 1u;
      return;
    case hopper::kLastRow:
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = w >> j & 1u ? static_cast<uint64_t>(row(j)) : ident;
      return;
    case hopper::kSumFloat: {
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = bits_of(raw_double(x[j], f));
      if (q.inv_divisor != 1.0) {
#pragma unroll
        for (int j = 0; j < R; ++j) x[j] = bits_of(dmul(as_double(x[j]), q.inv_divisor));
      }
      switch (q.transform) {
        case hopper::kLog:
#pragma unroll
          for (int j = 0; j < R; ++j) x[j] = bits_of(log(as_double(x[j])));
          break;
        case hopper::kClampZero:
#pragma unroll
          for (int j = 0; j < R; ++j) x[j] = bits_of(clamp_min(as_double(x[j]), 0.0));
          break;
        case hopper::kXLog2X:
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const double v = clamp_min(as_double(x[j]), 0.0);
            x[j] = bits_of(v > 0.0 ? dmul(v, log2(v)) : 0.0);
          }
          break;
        default: break;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = x[j];
      for (int p = 1; p < q.power; ++p) {
#pragma unroll
        for (int j = 0; j < R; ++j) c[j] = bits_of(dmul(as_double(c[j]), as_double(x[j])));
      }
      if (q.values2 != nullptr) {
        const bool f2 = is_float_type(q.type2);
        load2(x);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          double v = raw_double(x[j], f2);
          if (q.inv_divisor2 != 1.0) v = dmul(v, q.inv_divisor2);
          c[j] = bits_of(dmul(as_double(c[j]), v));
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = w >> j & 1u ? c[j] : 0ull;
      return;
    }
    case hopper::kMinFloat:
    case hopper::kMaxFloat:
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = w >> j & 1u ? bits_of(raw_double(x[j], f)) : ident;
      return;
    case hopper::kChecksum:
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint64_t k = q.lut != nullptr ? raw_int(x[j], f) : raw_order_key(x[j], f);
        c[j] = w >> j & 1u ? checksum_term(q, static_cast<int64_t>(k), !(not_null >> j & 1u))
                           : ident;
      }
      return;
    default: {  // the integer sums, min, max and bitwise kinds
      const bool okey = q.transform == hopper::kOrderKey;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint64_t v = okey ? raw_order_key(x[j], f) : raw_int(x[j], f);
        c[j] = w >> j & 1u ? v : ident;
      }
      return;
    }
  }
}

__device__ __forceinline__ void copy_bytes(const void* src, int64_t from, void* dst, int64_t to,
                                           int bytes) {
  switch (bytes) {
    case 1: static_cast<uint8_t*>(dst)[to] = static_cast<const uint8_t*>(src)[from]; break;
    case 2: static_cast<uint16_t*>(dst)[to] = static_cast<const uint16_t*>(src)[from]; break;
    case 4: static_cast<uint32_t*>(dst)[to] = static_cast<const uint32_t*>(src)[from]; break;
    case 16:  // a long decimal's two limbs
      static_cast<uint64_t*>(dst)[2 * to] = static_cast<const uint64_t*>(src)[2 * from];
      static_cast<uint64_t*>(dst)[2 * to + 1] = static_cast<const uint64_t*>(src)[2 * from + 1];
      break;
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

// The moments' finishing (hopper_kernels._moments, executor._eval_aggregate's
// formulas) from the count ``cnt`` and the sums ``s`` (the op's reads after
// the count, as doubles); sets *ok to the validity.
__device__ __forceinline__ double moment(int op, int64_t cnt, const double* s, bool* ok) {
  const double n = static_cast<double>(cnt > 1 ? cnt : 1);
  switch (op) {
    case hopper::kVarPop:
    case hopper::kVarSamp:
    case hopper::kStddevPop:
    case hopper::kStddevSamp: {
      const double mean = ddiv(s[0], n);
      const double var_pop = clamp_min(dsub(ddiv(s[1], n), dmul(mean, mean)), 0.0);
      const bool pop = op == hopper::kVarPop || op == hopper::kStddevPop;
      *ok = pop ? cnt > 0 : cnt > 1;
      const double var = pop ? var_pop : ddiv(dmul(var_pop, n), clamp_min(dsub(n, 1.0), 1.0));
      return op == hopper::kStddevPop || op == hopper::kStddevSamp ? sqrt(var) : var;
    }
    case hopper::kSkewness:
    case hopper::kKurtosis: {
      // central moments from the raw power sums
      const double s1 = s[0], s2 = s[1], s3 = s[2];
      const double m = ddiv(s1, n);
      const double m2 = dsub(s2, dmul(s1, m));
      const double m3 = dadd(dsub(s3, dmul(dmul(3.0, s2), m)), dmul(dmul(dmul(2.0, s1), m), m));
      if (op == hopper::kSkewness) {
        *ok = cnt > 2 && m2 > 0.0;
        return ddiv(dmul(sqrt(n), m3), pow(clamp_min(m2, 1e-300), 1.5));
      }
      const double s4 = s[3];
      const double m4 = dsub(dadd(dsub(s4, dmul(dmul(4.0, s3), m)),
                                  dmul(dmul(dmul(6.0, s2), m), m)),
                             dmul(dmul(dmul(dmul(3.0, s1), m), m), m));
      const double n1 = dsub(n, 1.0), n2 = dsub(n, 2.0), n3 = dsub(n, 3.0);
      const double a = ddiv(dmul(n, dadd(n, 1.0)), clamp_min(dmul(dmul(n1, n2), n3), 1.0));
      const double b = ddiv(dmul(n, m4), clamp_min(dmul(m2, m2), 1e-300));
      const double c = ddiv(dmul(dmul(3.0, n1), n1), clamp_min(dmul(n2, n3), 1.0));
      *ok = cnt > 3 && m2 > 0.0;
      return dsub(dmul(a, b), c);
    }
    case hopper::kGeometricMean:
      *ok = cnt > 0;
      return exp(ddiv(s[0], n));
    case hopper::kEntropy: {
      // log2 entropy of the per-row counts: log2(S) - sum(c log2 c) / S
      const bool pos = s[0] > 0.0;
      const double safe = pos ? s[0] : 1.0;
      *ok = cnt > 0;
      return clamp_min(pos ? dsub(log2(safe), ddiv(s[1], safe)) : 0.0, 0.0);
    }
    default: {
      // the two-column moments; s: sum x, sum y, sum xy, sum x^2, sum y^2
      // (those the op does not read are not used)
      const double sx = s[0], sy = s[1];
      const double mx = ddiv(sx, n), my = ddiv(sy, n);
      switch (op) {
        case hopper::kRegrAvgx: *ok = cnt > 0; return mx;
        case hopper::kRegrAvgy: *ok = cnt > 0; return my;
        case hopper::kRegrSxx:
          *ok = cnt > 0;
          return dmul(clamp_min(dsub(ddiv(s[3], n), dmul(mx, mx)), 0.0), n);
        case hopper::kRegrSyy:
          *ok = cnt > 0;
          return dmul(clamp_min(dsub(ddiv(s[4], n), dmul(my, my)), 0.0), n);
        default: break;
      }
      const double cov = dsub(ddiv(s[2], n), dmul(mx, my));
      switch (op) {
        case hopper::kCovarPop: *ok = cnt > 0; return cov;
        case hopper::kCovarSamp:
          *ok = cnt > 1;
          return ddiv(dmul(cov, n), clamp_min(dsub(n, 1.0), 1.0));
        case hopper::kRegrSxy: *ok = cnt > 0; return dmul(cov, n);
        default: break;
      }
      const double varx = clamp_min(dsub(ddiv(s[3], n), dmul(mx, mx)), 0.0);
      if (op == hopper::kRegrSlope || op == hopper::kRegrIntercept) {
        const double slope = ddiv(cov, varx > 0.0 ? varx : 1.0);
        *ok = cnt > 1 && varx > 0.0;
        return op == hopper::kRegrSlope ? slope : dsub(my, dmul(slope, mx));
      }
      const double vary = clamp_min(dsub(ddiv(s[4], n), dmul(my, my)), 0.0);
      if (op == hopper::kCorr) {
        const double denom = sqrt(dmul(varx, vary));
        *ok = cnt > 1 && denom > 0.0;
        return ddiv(cov, denom > 0.0 ? denom : 1.0);
      }
      // regr_r2: 1.0 where y is constant, NULL where x is
      const double vv = dmul(varx, vary);
      const double r2 = ddiv(dmul(cov, cov), vv > 0.0 ? vv : 1.0);
      *ok = cnt > 0 && varx > 0.0;
      return vary > 0.0 ? r2 : 1.0;
    }
  }
}

// kPercentile: the sorted values (first_values, segment_sort's) at the
// group's start plus the rank of quantile q among its cnt participants,
// floor(q * max(cnt - 1, 0)) clamped to [0, max(cnt - 1, 0)]; q is the
// quantile column at row ``row`` (times its divisor's reciprocal, as torch
// divides by a scalar on the card). A float-to-int conversion saturates and
// takes NaN to 0, as torch's cast on the card does.
__device__ __forceinline__ void finish_percentile(const AggOutput& out, int64_t row,
                                                  int64_t cnt, int64_t g, int64_t n,
                                                  int64_t start) {
  const int64_t at = row < 0 ? 0 : (row > n - 1 ? n - 1 : row);
  const int64_t top = cnt > 1 ? cnt - 1 : 0;
  double q = load_double(out.quantiles_type, out.quantiles, at);
  if (out.divisor != 1.0) q = dmul(q, 1.0 / out.divisor);
  int64_t idx = static_cast<int64_t>(floor(dmul(q, static_cast<double>(top))));
  idx = idx < 0 ? 0 : (idx > top ? top : idx);
  int64_t pos = start + idx;
  pos = pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
  copy_bytes(out.first_values, pos, out.data, g, out.elem_bytes);
  out.valid[g] = cnt > 0;
}

// Output ``out`` of slot g from the requests' values v[] (n rows, the
// group starting at row ``start``): the finishing of
// executor._eval_aggregate. A digest is written by its own pass
// (segment_agg.cu's agg_digest_kernel).
__device__ __forceinline__ void finish_output(const AggOutput& out, const uint64_t* v,
                                              int64_t g, int64_t n, int64_t start) {
  const uint64_t a = v[out.reads[0]];
  if (out.op == hopper::kDigest) return;
  if (out.op == hopper::kInt128) {
    // the hi extreme, then the tied lo back from its unsigned order
    int64_t* d = static_cast<int64_t*>(out.data);
    d[2 * g] = static_cast<int64_t>(a);
    d[2 * g + 1] = static_cast<int64_t>(v[out.reads[1]] ^ 0x8000000000000000ull);
    out.valid[g] = static_cast<int64_t>(v[out.reads[2]]) > 0;
    return;
  }
  if (out.op == hopper::kPercentile) {
    finish_percentile(out, static_cast<int64_t>(a), static_cast<int64_t>(v[out.reads[1]]), g,
                      n, start);
    return;
  }
  if (out.op >= hopper::kVarPop && out.op <= hopper::kEntropy) {
    double s[kMaxAggReads - 1];
    for (int k = 1; k < out.n_reads; ++k) {
      s[k - 1] = out.reads[k] < 0 ? 0.0 : as_double(v[out.reads[k]]);
    }
    bool ok;
    const double d = moment(out.op, static_cast<int64_t>(a), s, &ok);
    static_cast<double*>(out.data)[g] = d;
    out.valid[g] = ok;
    return;
  }
  const int b = out.n_reads > 1 ? out.reads[1] : -1;
  bool ok = b < 0 || static_cast<int64_t>(v[b]) > 0;
  switch (out.op) {
    case hopper::kAvgDecimal: {
      const int64_t sum = static_cast<int64_t>(a), cnt = static_cast<int64_t>(v[b]);
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
      const int64_t cnt = static_cast<int64_t>(v[b]);
      double d = out.a_float ? as_double(a) : static_cast<double>(static_cast<int64_t>(a));
      d = ddiv(d, static_cast<double>(cnt > 1 ? cnt : 1));
      if (out.divisor != 1.0) d = dmul(d, 1.0 / out.divisor);
      store_value(out.data, out.out_type, g, bits_of(d), true);
      break;
    }
    case hopper::kBoolAnd: static_cast<bool*>(out.data)[g] = a == 0; break;
    case hopper::kBoolOr: static_cast<bool*>(out.data)[g] = static_cast<int64_t>(a) > 0; break;
    case hopper::kFirst: {
      const int64_t row = static_cast<int64_t>(a);
      const int64_t at = row < 0 ? 0 : (row > n - 1 ? n - 1 : row);
      copy_bytes(out.first_values, at, out.data, g, out.elem_bytes);
      if (out.first_valid != nullptr) ok = ok && out.first_valid[at];
      break;
    }
    default: store_value(out.data, out.out_type, g, a, out.a_float); break;
  }
  out.valid[g] = ok;
}

}  // namespace agg
}  // namespace hopper
