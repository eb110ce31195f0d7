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
// Design: one launch over tiles of kThreads * K rows, K (1, 2 or 4) a
// template argument; each thread takes K rows of a tile, strided by the
// block's width, so every column load and store is coalesced, and one
// decode and dispatch of an instruction serve K independent rows. The
// program (instructions, constants, input and output columns, LUT
// pointers) is one kernel parameter, so each instruction is a uniform
// read from the constant bank. A row's register values live in dynamic
// shared memory as [max(n_regs, 1)][kThreads * K] 64-bit words, a warp's
// rows of one register consecutive (conflict-free 64-bit accesses), and
// each operation reads only its own operands; a row's validity bits are
// one 32-bit mask in a true register (bit k: register k is valid).
// A thread touches only its own rows' words: no barrier, no atomic. The
// wrapper chooses K and the grid from n_regs and the card's occupancy
// (hopper_kernels.expr_program_plan).

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
  int n_regs;  // registers the code uses (the shared file's rows)
};

}  // namespace hopper

namespace {

using hopper::ExprInstr;
using hopper::ExprProgram;
using hopper::kThreads;

// wrap(x, t) as a shift chosen once an instruction: the left shift that
// drops the bits above t's width (-1 for a bool: x != 0), by KeyType.
__constant__ signed char kWrapShift[8] = {0, 32, 48, 56, -1, 0, 0, 0};

__device__ __forceinline__ int wrap_shift(int t) { return kWrapShift[t & 7]; }

__device__ __forceinline__ int64_t wrap_by(int64_t x, int sh) {
  return sh < 0 ? (x != 0) : static_cast<int64_t>(static_cast<uint64_t>(x) << sh) >> sh;
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

// Column i0 + j * kThreads of each row j (0 past n) and its validity.
template <typename T, int K>
__device__ __forceinline__ void load_rows(const hopper::ExprCol& c, int64_t i0, int64_t n,
                                          int64_t (&o)[K], bool (&ov)[K]) {
  const T* d = static_cast<const T*>(c.data);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * kThreads;
    const bool in = i < n;
    o[j] = in ? static_cast<int64_t>(d[i]) : 0;
    ov[j] = in && c.valid[i];
  }
}

template <typename T, int K>
__device__ __forceinline__ void store_rows(const hopper::ExprOut& c, int64_t i0, int64_t n,
                                           const int64_t (&x)[K], const bool (&ok)[K]) {
  T* d = static_cast<T*>(c.data);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * kThreads;
    if (i < n) {
      d[i] = static_cast<T>(x[j]);
      c.valid[i] = ok[j];
    }
  }
}

template <int K>
__device__ __forceinline__ void load_column(const hopper::ExprCol& c, int64_t i0, int64_t n,
                                            int64_t (&o)[K], bool (&ov)[K]) {
  switch (c.type) {
    case hopper::kI32: load_rows<int32_t>(c, i0, n, o, ov); break;
    case hopper::kI16: load_rows<int16_t>(c, i0, n, o, ov); break;
    case hopper::kI8: load_rows<int8_t>(c, i0, n, o, ov); break;
    case hopper::kBool:
      load_rows<uint8_t>(c, i0, n, o, ov);
#pragma unroll
      for (int j = 0; j < K; ++j) o[j] = o[j] != 0;
      break;
    default: load_rows<int64_t>(c, i0, n, o, ov); break;  // kI64, kF64: its bits
  }
}

template <int K>
__device__ __forceinline__ void store_column(const hopper::ExprOut& c, int64_t i0, int64_t n,
                                             int64_t (&x)[K], const bool (&ok)[K]) {
  switch (c.type) {
    case hopper::kI32: store_rows<int32_t>(c, i0, n, x, ok); break;
    case hopper::kI16: store_rows<int16_t>(c, i0, n, x, ok); break;
    case hopper::kI8: store_rows<int8_t>(c, i0, n, x, ok); break;
    case hopper::kBool:
#pragma unroll
      for (int j = 0; j < K; ++j) x[j] = x[j] != 0;
      store_rows<bool>(c, i0, n, x, ok);
      break;
    default: store_rows<int64_t>(c, i0, n, x, ok); break;  // kI64, kF64 bits
  }
}

// Shared bytes of the register file of kernel<K> for n_regs registers.
inline size_t file_bytes(int n_regs, int k) {
  return sizeof(int64_t) * static_cast<size_t>(n_regs > 1 ? n_regs : 1) * kThreads * k;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
expr_program_kernel(ExprProgram p, int64_t n) {
  extern __shared__ int64_t file[];  // [max(n_regs, 1)][kRows]
  constexpr int kRows = kThreads * K;
  const int64_t n_tiles = (n + kRows - 1) / kRows;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t i0 = tile * kRows + threadIdx.x;
    uint32_t vm[K];  // bit r: register r of the row is valid
#pragma unroll
    for (int j = 0; j < K; ++j) vm[j] = 0;
    for (int pc = 0; pc < p.n_code; ++pc) {
      const ExprInstr ins = p.code[pc];
      const int sh = wrap_shift(ins.t);
      // each case reads only the operands it uses: row j's values of
      // registers a, b and c, and their validity bits in the row's mask
      const int64_t* ra = file + ins.a * kRows + threadIdx.x;
      const int64_t* rb = file + ins.b * kRows + threadIdx.x;
      const int64_t* rc = file + ins.c * kRows + threadIdx.x;
      const uint32_t ma = 1u << ins.a, mb = 1u << ins.b, mc = 1u << ins.c, mab = ma | mb;
      int64_t o[K];
      bool ov[K];
#define EACH_ROW _Pragma("unroll") for (int j = 0; j < K; ++j)
#define X ra[j * kThreads]
#define Y rb[j * kThreads]
#define Z rc[j * kThreads]
#define VA ((vm[j] & ma) != 0)
#define VB ((vm[j] & mb) != 0)
#define VC ((vm[j] & mc) != 0)
#define VAB ((vm[j] & mab) == mab)  // the binary operations' validity
      switch (ins.op) {
        case hopper::kLoad: load_column(p.in[ins.aux], i0, n, o, ov); break;
        case hopper::kConst: {
          const int64_t c = p.consts[ins.aux];
          EACH_ROW { o[j] = c; ov[j] = ins.a != 0; }
          break;
        }
        case hopper::kAdd: EACH_ROW { o[j] = wrap_by(add_w(X, Y), sh); ov[j] = VAB; } break;
        case hopper::kSub: EACH_ROW { o[j] = wrap_by(sub_w(X, Y), sh); ov[j] = VAB; } break;
        case hopper::kMul: EACH_ROW { o[j] = wrap_by(mul_w(X, Y), sh); ov[j] = VAB; } break;
        case hopper::kNeg: EACH_ROW { o[j] = wrap_by(sub_w(0, X), sh); ov[j] = VA; } break;
        case hopper::kIDiv:
        case hopper::kIMod: {
          // abs and the clamp at each operand's own width (aux: 8 * ta + tb),
          // the floor division and the sign product at the result's
          const int sa = wrap_shift(ins.aux >> 3), sb = wrap_shift(ins.aux & 7);
          EACH_ROW {
            const int64_t x = X, y = Y;
            const int64_t aa = wrap_by(x < 0 ? sub_w(0, x) : x, sa);
            int64_t bb = wrap_by(y < 0 ? sub_w(0, y) : y, sb);
            if (bb < 1) bb = 1;
            if (ins.op == hopper::kIDiv) {
              o[j] = wrap_by(mul_w(floor_div(aa, bb), sign_of(x) * sign_of(y)), sh);
            } else {
              int64_t m = aa % bb;
              if (m < 0) m += bb;
              o[j] = wrap_by(mul_w(m, sign_of(x)), sh);
            }
            ov[j] = VAB;
          }
          break;
        }
        case hopper::kFAdd:
          EACH_ROW { o[j] = bits_of(__dadd_rn(as_double(X), as_double(Y))); ov[j] = VAB; }
          break;
        case hopper::kFSub:
          EACH_ROW { o[j] = bits_of(__dsub_rn(as_double(X), as_double(Y))); ov[j] = VAB; }
          break;
        case hopper::kFMul:
          EACH_ROW { o[j] = bits_of(__dmul_rn(as_double(X), as_double(Y))); ov[j] = VAB; }
          break;
        case hopper::kFDiv:
          EACH_ROW { o[j] = bits_of(__ddiv_rn(as_double(X), as_double(Y))); ov[j] = VAB; }
          break;
        case hopper::kFMod:
          EACH_ROW {
            const double b = as_double(Y);
            double m = fmod(as_double(X), b);
            if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m = __dadd_rn(m, b);
            o[j] = bits_of(m);
            ov[j] = VAB;
          }
          break;
        case hopper::kFNeg: EACH_ROW { o[j] = bits_of(-as_double(X)); ov[j] = VA; } break;
        case hopper::kDivS: {
          const double r = as_double(p.consts[ins.aux]);
          EACH_ROW { o[j] = bits_of(__dmul_rn(as_double(X), r)); ov[j] = VA; }
          break;
        }
        case hopper::kI2F: EACH_ROW { o[j] = bits_of(__ll2double_rn(X)); ov[j] = VA; } break;
        case hopper::kWrap: EACH_ROW { o[j] = wrap_by(X, sh); ov[j] = VA; } break;
        case hopper::kToBool: EACH_ROW { o[j] = X != 0; ov[j] = VA; } break;
        case hopper::kFToBool: EACH_ROW { o[j] = as_double(X) != 0.0; ov[j] = VA; } break;
        case hopper::kCmp:
          EACH_ROW {
            const int64_t x = X, y = Y;
            o[j] = compare(ins.aux, x < y, x == y);
            ov[j] = VAB;
          }
          break;
        case hopper::kFCmp:
          EACH_ROW { o[j] = fcompare(ins.aux, as_double(X), as_double(Y)); ov[j] = VAB; }
          break;
        case hopper::kAnd:
          EACH_ROW {
            const bool va = VA, vb = VB, ad = X != 0, bd = Y != 0;
            const bool yes = va && ad && vb && bd;
            o[j] = yes;
            ov[j] = yes || (va && !ad) || (vb && !bd);
          }
          break;
        case hopper::kOr:
          EACH_ROW {
            const bool va = VA, vb = VB, ad = X != 0, bd = Y != 0;
            const bool yes = (va && ad) || (vb && bd);
            o[j] = yes;
            ov[j] = yes || (va && !ad && vb && !bd);
          }
          break;
        case hopper::kNot: EACH_ROW { o[j] = X == 0; ov[j] = VA; } break;
        case hopper::kIsNull: EACH_ROW { o[j] = !VA; ov[j] = true; } break;
        case hopper::kNotNull: EACH_ROW { o[j] = VA; ov[j] = true; } break;
        case hopper::kSelect:  // a: the condition, b: its result, c: the later WHENs
          EACH_ROW {
            const bool fire = VA && X != 0;
            o[j] = fire ? Y : Z;
            ov[j] = fire ? VB : VC;
          }
          break;
        case hopper::kCoalesce:
          EACH_ROW {
            const bool va = VA;
            o[j] = va ? X : Y;
            ov[j] = va || VB;
          }
          break;
        case hopper::kLut: {
          const hopper::ExprLut& l = p.lut[ins.aux];
          EACH_ROW {
            const int64_t x = X;
            const int64_t k = x < 0 ? 0 : (x >= l.len ? l.len - 1 : x);
            o[j] = l.lut[k] ? 1 : 0;
            ov[j] = VA;
          }
          break;
        }
        case hopper::kDatePart: EACH_ROW { o[j] = date_part(X, ins.aux); ov[j] = VA; } break;
        case hopper::kDivRound: {
          const int64_t d = p.consts[ins.aux];
          const int64_t half = d / 2;
          EACH_ROW {
            const int64_t x = X;
            o[j] = x >= 0 ? floor_div(add_w(x, half), d)
                          : sub_w(0, floor_div(add_w(sub_w(0, x), half), d));
            ov[j] = VA;
          }
          break;
        }
        default:  // kStore
          EACH_ROW { o[j] = X; ov[j] = VA; }
          store_column(p.out[ins.aux], i0, n, o, ov);
          continue;
      }
#undef VAB
#undef VC
#undef VB
#undef VA
#undef Z
#undef Y
#undef X
#undef EACH_ROW
      int64_t* rd = file + ins.dst * kRows + threadIdx.x;
      const uint32_t clear = ~(1u << ins.dst);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        rd[j * kThreads] = o[j];
        vm[j] = (vm[j] & clear) | (static_cast<uint32_t>(ov[j]) << ins.dst);
      }
    }
  }
}

template <int K>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&expr_program_kernel<K>);
}

const void* kernel_for(int k) {
  return k == 4 ? kernel_of<4>() : (k == 2 ? kernel_of<2>() : kernel_of<1>());
}

// Dynamic shared bytes a block of this device may take.
int optin_bytes() {
  static const int bytes = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  }();
  return bytes;
}

cudaError_t allow(const void* kernel, int k) {
  const size_t most = file_bytes(hopper::kMaxExprRegs, k);
  const int bytes = most < static_cast<size_t>(optin_bytes()) ? static_cast<int>(most)
                                                               : optin_bytes();
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Lets kernel<k> take the largest file that fits a block (32 registers,
// up to the device's opt-in limit), once a process (thread-safe statics).
cudaError_t allow_file(int k) {
  static const cudaError_t err[3] = {allow(kernel_of<1>(), 1), allow(kernel_of<2>(), 2),
                                     allow(kernel_of<4>(), 4)};
  return err[k == 4 ? 2 : (k == 2 ? 1 : 0)];
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

// Blocks of kernel<k> one SM holds at once with n_regs registers in its
// file (0 where the file does not fit, or k is not 1, 2 or 4).
extern "C" int expr_program_blocks_per_sm(int k, int n_regs) {
  if ((k != 1 && k != 2 && k != 4) || n_regs < 0 || n_regs > hopper::kMaxExprRegs ||
      file_bytes(n_regs, k) > static_cast<size_t>(optin_bytes()) || allow_file(k) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_for(k), kThreads,
                                                    file_bytes(n_regs, k)) != cudaSuccess)
    return 0;
  return blocks;
}

// One launch of kernel<k> over n rows in ``grid`` blocks on ``stream``
// (the plan of hopper_kernels.expr_program_plan). Returns the first CUDA
// error, 0 on success.
extern "C" int expr_program(const hopper::ExprProgram* program, int64_t n, int k, int grid,
                            void* stream) {
  if (n <= 0) return 0;
  const int n_regs = program->n_regs;
  if ((k != 1 && k != 2 && k != 4) || n_regs < 0 || n_regs > hopper::kMaxExprRegs || grid < 1 ||
      file_bytes(n_regs, k) > static_cast<size_t>(optin_bytes()))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_file(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = file_bytes(n_regs, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 4) {
    expr_program_kernel<4><<<grid, kThreads, bytes, s>>>(*program, n);
  } else if (k == 2) {
    expr_program_kernel<2><<<grid, kThreads, bytes, s>>>(*program, n);
  } else {
    expr_program_kernel<1><<<grid, kThreads, bytes, s>>>(*program, n);
  }
  ++g_expr_stream_ops;
  return static_cast<int>(cudaGetLastError());
}
