// The fused projection as one expression-program launch: every lowered
// assignment of a projection evaluated for every row of the joined page.
//
// Replaces: the projection stage of trino_tpu/ops/megakernels.py
// _expand_phase_body (_project_impl's compiled closures traced into the one
// Pallas launch of expand_phase; trino_tpu/runtime/executor.py
// _project_impl). Trino generates JVM bytecode for an expression and the
// reference traces its closures into the kernel; here ops/expr_program.py
// lowers each assignment to a short straight-line program over a register
// file of 64-bit values with a validity bit each, and this kernel
// interprets it. It is built once with the other kernels: a query never
// waits on a compiler, and since every thread runs the same instruction
// stream, the interpreter's switch does not diverge.
//
// Semantics are the port's closures' (hopper_kernels.expr_program_plain
// runs the same program as torch operations over whole columns; this
// kernel is bit-identical to it):
//   an integer register holds its value sign-extended from the width of
//   its torch dtype; adds, subtractions and products are done in unsigned
//   64-bit arithmetic and wrapped to that width, as torch wraps; integer
//   division truncates over |b| clamped to 1 (a zero divisor gives 0) and
//   integer % takes the dividend's sign, both computed as the closures'
//   abs, floor division and sign products at the operands' width; a double
//   % is torch.remainder (fmod, then the divisor added where the signs
//   differ); double arithmetic uses the round-to-nearest intrinsics, so no
//   product and sum contract into a fused multiply-add; an integer becomes
//   a double by round to nearest; a division by a Python scalar (a
//   decimal's scale) is a product with its reciprocal, as torch computes it
//   on the card; a decimal rescale rounds half up; AND and OR are Kleene's;
//   CASE takes the first WHEN whose condition is valid and true; year,
//   month and day are Hinnant's civil_from_days with floor division.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each input column (data and
// validity) is read once and each output written once; the program's
// operations are a few tens of integer or double operations a row.
//
// Design: one launch, a grid-stride loop of one row a thread. The program
// (instructions, constants, input and output columns, LUT pointers) is one
// kernel parameter, so each instruction is a uniform read from the
// constant bank; the register file is a per-thread array (local memory,
// cached in L1). Rows are independent: no shared memory, no atomic.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "join_keys.cuh"
#include "launch.cuh"

namespace hopper {

constexpr int kMaxExprInstrs = 128;
constexpr int kMaxExprRegs = 32;
constexpr int kMaxExprConsts = 32;
constexpr int kMaxExprInputs = 16;
constexpr int kMaxExprOutputs = 16;
constexpr int kMaxExprLuts = 8;

// Opcodes (expr_program.OPS).
enum ExprOp : int {
  kLoad = 0, kConst = 1, kAdd = 2, kSub = 3, kMul = 4, kNeg = 5, kIDiv = 6, kIMod = 7,
  kFAdd = 8, kFSub = 9, kFMul = 10, kFDiv = 11, kFMod = 12, kFNeg = 13, kDivS = 14, kI2F = 15,
  kWrap = 16, kToBool = 17, kFToBool = 18, kCmp = 19, kFCmp = 20, kAnd = 21, kOr = 22,
  kNot = 23, kIsNull = 24, kNotNull = 25, kSelect = 26, kCoalesce = 27, kLut = 28,
  kDatePart = 29, kDivRound = 30, kStore = 31,
};

struct ExprInstr {
  uint8_t op, dst, a, b, c, t;  // t: the result's KeyType (its width)
  uint16_t aux;                 // input, constant, output, LUT index; comparison; date
                                // part; operand widths
};

struct ExprCol {
  const void* data;
  const bool* valid;
  int type;  // KeyType
};

struct ExprOut {
  void* data;
  bool* valid;
  int type;
};

struct ExprLut {
  const bool* lut;
  int64_t len;
};

// Passed by value as the kernel's parameter.
struct ExprProgram {
  ExprInstr code[kMaxExprInstrs];
  int64_t consts[kMaxExprConsts];
  ExprCol in[kMaxExprInputs];
  ExprOut out[kMaxExprOutputs];
  ExprLut lut[kMaxExprLuts];
  int n_code;
};

}  // namespace hopper

namespace {

using hopper::ExprInstr;
using hopper::ExprProgram;
using hopper::kThreads;

__device__ __forceinline__ int64_t wrap(int64_t x, int t) {
  switch (t) {
    case hopper::kI32: return static_cast<int32_t>(x);
    case hopper::kI16: return static_cast<int16_t>(x);
    case hopper::kI8: return static_cast<int8_t>(x);
    case hopper::kBool: return x != 0;
    default: return x;
  }
}

__device__ __forceinline__ int64_t add_w(int64_t x, int64_t y) {
  return static_cast<int64_t>(static_cast<uint64_t>(x) + static_cast<uint64_t>(y));
}

__device__ __forceinline__ int64_t sub_w(int64_t x, int64_t y) {
  return static_cast<int64_t>(static_cast<uint64_t>(x) - static_cast<uint64_t>(y));
}

__device__ __forceinline__ int64_t mul_w(int64_t x, int64_t y) {
  return static_cast<int64_t>(static_cast<uint64_t>(x) * static_cast<uint64_t>(y));
}

__device__ __forceinline__ int64_t sign_of(int64_t x) { return (x > 0) - (x < 0); }

// Python's floor division (b > 0).
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}

__device__ __forceinline__ double as_double(int64_t b) { return __longlong_as_double(b); }

__device__ __forceinline__ int64_t bits_of(double d) { return __double_as_longlong(d); }

__device__ __forceinline__ bool compare(int kind, bool lt, bool eq) {
  switch (kind) {
    case 0: return eq;
    case 1: return !eq;
    case 2: return lt;
    case 3: return lt || eq;
    case 4: return !lt && !eq;
    default: return !lt;
  }
}

__device__ __forceinline__ bool fcompare(int kind, double x, double y) {
  switch (kind) {
    case 0: return x == y;
    case 1: return x != y;
    case 2: return x < y;
    case 3: return x <= y;
    case 4: return x > y;
    default: return x >= y;
  }
}

// kernels' _civil_from_days: (year, month, day) of days since the epoch.
__device__ __forceinline__ int64_t date_part(int64_t days, int part) {
  const int64_t z = days + 719468;
  const int64_t era = floor_div(z, 146097);
  const int64_t doe = z - era * 146097;
  const int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const int64_t mp = (5 * doy + 2) / 153;
  const int64_t d = doy - (153 * mp + 2) / 5 + 1;
  const int64_t m = mp + (mp < 10 ? 3 : -9);
  if (part == 2) return d;
  if (part == 1) return m;
  return yoe + era * 400 + (m <= 2 ? 1 : 0);
}

__device__ __forceinline__ int64_t load(const hopper::ExprCol& c, int64_t i) {
  switch (c.type) {
    case hopper::kI64: return static_cast<const int64_t*>(c.data)[i];
    case hopper::kI32: return static_cast<const int32_t*>(c.data)[i];
    case hopper::kI16: return static_cast<const int16_t*>(c.data)[i];
    case hopper::kI8: return static_cast<const int8_t*>(c.data)[i];
    case hopper::kBool: return static_cast<const uint8_t*>(c.data)[i] ? 1 : 0;
    default: return static_cast<const int64_t*>(c.data)[i];  // kF64: its bits
  }
}

__device__ __forceinline__ void store(const hopper::ExprOut& c, int64_t i, int64_t x, bool ok) {
  switch (c.type) {
    case hopper::kI32: static_cast<int32_t*>(c.data)[i] = static_cast<int32_t>(x); break;
    case hopper::kI16: static_cast<int16_t*>(c.data)[i] = static_cast<int16_t>(x); break;
    case hopper::kI8: static_cast<int8_t*>(c.data)[i] = static_cast<int8_t>(x); break;
    case hopper::kBool: static_cast<bool*>(c.data)[i] = x != 0; break;
    default: static_cast<int64_t*>(c.data)[i] = x; break;  // kI64, kF64 bits
  }
  c.valid[i] = ok;
}

__global__ void __launch_bounds__(kThreads)
expr_program_kernel(ExprProgram p, int64_t n) {
  int64_t r[hopper::kMaxExprRegs];
  bool v[hopper::kMaxExprRegs];
  for (int k = 0; k < hopper::kMaxExprRegs; ++k) {
    r[k] = 0;
    v[k] = false;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    for (int pc = 0; pc < p.n_code; ++pc) {
      const ExprInstr ins = p.code[pc];
      const int t = ins.t;
      const int64_t x = r[ins.a], y = r[ins.b], z = r[ins.c];
      const bool va = v[ins.a], vb = v[ins.b], vc = v[ins.c];
      int64_t o = 0;
      bool ov = va && vb;  // the binary operations' validity
      switch (ins.op) {
        case hopper::kLoad: {
          const hopper::ExprCol& c = p.in[ins.aux];
          o = load(c, i);
          ov = c.valid[i];
          break;
        }
        case hopper::kConst: o = p.consts[ins.aux]; ov = ins.a != 0; break;
        case hopper::kAdd: o = wrap(add_w(x, y), t); break;
        case hopper::kSub: o = wrap(sub_w(x, y), t); break;
        case hopper::kMul: o = wrap(mul_w(x, y), t); break;
        case hopper::kNeg: o = wrap(sub_w(0, x), t); ov = va; break;
        case hopper::kIDiv:
        case hopper::kIMod: {
          // abs and the clamp at each operand's own width (aux: 8 * ta + tb),
          // the floor division and the sign product at the result's
          const int64_t aa = wrap(x < 0 ? sub_w(0, x) : x, ins.aux >> 3);
          int64_t bb = wrap(y < 0 ? sub_w(0, y) : y, ins.aux & 7);
          if (bb < 1) bb = 1;
          if (ins.op == hopper::kIDiv) {
            o = wrap(mul_w(floor_div(aa, bb), sign_of(x) * sign_of(y)), t);
          } else {
            int64_t m = aa % bb;
            if (m < 0) m += bb;
            o = wrap(mul_w(m, sign_of(x)), t);
          }
          break;
        }
        case hopper::kFAdd: o = bits_of(__dadd_rn(as_double(x), as_double(y))); break;
        case hopper::kFSub: o = bits_of(__dsub_rn(as_double(x), as_double(y))); break;
        case hopper::kFMul: o = bits_of(__dmul_rn(as_double(x), as_double(y))); break;
        case hopper::kFDiv: o = bits_of(__ddiv_rn(as_double(x), as_double(y))); break;
        case hopper::kFMod: {
          const double b = as_double(y);
          double m = fmod(as_double(x), b);
          if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m = __dadd_rn(m, b);
          o = bits_of(m);
          break;
        }
        case hopper::kFNeg: o = bits_of(-as_double(x)); ov = va; break;
        case hopper::kDivS:
          o = bits_of(__dmul_rn(as_double(x), as_double(p.consts[ins.aux])));
          ov = va;
          break;
        case hopper::kI2F: o = bits_of(__ll2double_rn(x)); ov = va; break;
        case hopper::kWrap: o = wrap(x, t); ov = va; break;
        case hopper::kToBool: o = x != 0; ov = va; break;
        case hopper::kFToBool: o = as_double(x) != 0.0; ov = va; break;
        case hopper::kCmp: o = compare(ins.aux, x < y, x == y); break;
        case hopper::kFCmp: o = fcompare(ins.aux, as_double(x), as_double(y)); break;
        case hopper::kAnd: {
          const bool ad = x != 0, bd = y != 0;
          const bool yes = va && ad && vb && bd;
          o = yes;
          ov = yes || (va && !ad) || (vb && !bd);
          break;
        }
        case hopper::kOr: {
          const bool ad = x != 0, bd = y != 0;
          const bool yes = (va && ad) || (vb && bd);
          o = yes;
          ov = yes || (va && !ad && vb && !bd);
          break;
        }
        case hopper::kNot: o = x == 0; ov = va; break;
        case hopper::kIsNull: o = !va; ov = true; break;
        case hopper::kNotNull: o = va; ov = true; break;
        case hopper::kSelect: {  // a: the condition, b: its result, c: the later WHENs
          const bool fire = va && x != 0;
          o = fire ? y : z;
          ov = fire ? vb : vc;
          break;
        }
        case hopper::kCoalesce: o = va ? x : y; ov = va || vb; break;
        case hopper::kLut: {
          const hopper::ExprLut& l = p.lut[ins.aux];
          const int64_t k = x < 0 ? 0 : (x >= l.len ? l.len - 1 : x);
          o = l.lut[k] ? 1 : 0;
          ov = va;
          break;
        }
        case hopper::kDatePart: o = date_part(x, ins.aux); ov = va; break;
        case hopper::kDivRound: {
          const int64_t d = p.consts[ins.aux];
          const int64_t half = d / 2;
          o = x >= 0 ? floor_div(add_w(x, half), d)
                     : sub_w(0, floor_div(add_w(sub_w(0, x), half), d));
          ov = va;
          break;
        }
        default:  // kStore
          store(p.out[ins.aux], i, x, va);
          continue;
      }
      r[ins.dst] = o;
      v[ins.dst] = ov;
    }
  }
}

}  // namespace

extern "C" int expr_program_max_instrs() { return hopper::kMaxExprInstrs; }
extern "C" int expr_program_max_regs() { return hopper::kMaxExprRegs; }
extern "C" int expr_program_max_consts() { return hopper::kMaxExprConsts; }
extern "C" int expr_program_max_inputs() { return hopper::kMaxExprInputs; }
extern "C" int expr_program_max_outputs() { return hopper::kMaxExprOutputs; }
extern "C" int expr_program_max_luts() { return hopper::kMaxExprLuts; }

static std::atomic<int64_t> g_expr_stream_ops{0};

extern "C" int64_t expr_program_stream_ops() { return g_expr_stream_ops.load(); }

// One launch over n rows on ``stream``. Returns the first CUDA error, 0 on
// success.
extern "C" int expr_program(const hopper::ExprProgram* program, int64_t n, void* stream) {
  if (n <= 0) return 0;
  expr_program_kernel<<<hopper::grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *program, n);
  ++g_expr_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
