// The chain program's interpreter, shared by C1 (chain.cu) and G1 (gang.cu)
// so that the two kernels run one set of opcode semantics.
//
// A program (ops/chain.py lowers every chain to one) is a postfix list of
// instructions over a stack of per-row values.  `run_tile` runs it over one
// tile of R x kBlock rows: a thread owns R rows of the tile (neighbouring
// threads on neighbouring rows, so every column load is coalesced).  The
// operand stack is a set of tile vectors in shared memory — slot k of row j
// at stk[k * T + j] — and each instruction is a loop of the thread over its
// R rows.  Every thread runs the same opcode, so there is no divergence; no
// per-thread stack spills to local memory; the mask and the group id stay
// in registers.  A thread touches only its own rows' stack slots, so the
// interpreter needs no barrier.  STORE hands each row's value to the
// caller's Store: C1 writes it to an output column in device memory, G1 to a
// tile slot in shared memory.  The block width B is a template parameter:
// C1 and G1 run kBlock (256) threads, F1 1024 (finalize.cu).
//
// Semantics follow PyTorch's ops, which the plain interpreter in
// ops/chain.py runs one per opcode: integer add, subtract, multiply and
// negate wrap (computed in uint64); integer % and // floor, with a zero
// divisor giving 0 and INT64_MIN // -1 wrapping; floats use CUDA's double
// functions without fast math (rint for round: half to even).
#pragma once

#include <math.h>

#include "common.cuh"

namespace px_chain {

constexpr int kBlock = 256;
constexpr int kMaxCols = 32;
constexpr int kMaxLuts = 32;
constexpr int kMaxOuts = 16;
constexpr int kMaxScalars = 16;

enum Kind : int { kBool = 0, kI32 = 1, kI64 = 2, kF64 = 3 };

// Opcodes; the order is ops/chain.py's OPS.
enum Op : int {
  LOAD_COL, LOAD_CONST, LOAD_SCALAR, LOAD_ROW, DUP, STORE, MASK_AND, GID_COMBINE,
  LUT, LUT_DOMAIN, PAIR, SEARCH, WINDOW, CAST_I2F, CAST_F2I, CAST_I64, NOT, AND, OR,
  ADD_I, SUB_I, MUL_I, ADD_F, SUB_F, MUL_F, DIV_F, MOD_I, MOD_F, FDIV_I, FDIV_F, POW_F,
  ABS_I, ABS_F, NEG_I, NEG_F, LOG, LOG2, LOG10, EXP, SQRT, CEIL, FLOOR, RINT, BIN_I,
  EQ_I, NE_I, LT_I, LE_I, GT_I, GE_I, EQ_F, NE_F, LT_F, LE_F, GT_F, GE_F, SELECT,
  APPROX_EQ, kNumOps
};

}  // namespace px_chain

// One program's launch parameters: the program (code and consts on the
// device, uploaded once per chain shape) and one feed's pointers and
// scalars.  The layout is mirrored by ctypes in ops/chain.py: 8-byte fields
// first, then the 4-byte ones.
struct ChainParams {
  const int* code;  // ncode instructions of 3 int32: op, a, b
  const long long* consts;
  const void* col[px_chain::kMaxCols];
  const void* lut[px_chain::kMaxLuts];
  long long lut_len[px_chain::kMaxLuts];
  void* out[px_chain::kMaxOuts];
  long long scalar[px_chain::kMaxScalars];
  unsigned char* mask_out;  // n bools, or null
  int* gid_out;             // n int32, or null
  long long n;
  int ncode;
  int depth;
  int col_kind[px_chain::kMaxCols];
  int lut_kind[px_chain::kMaxLuts];
  int out_kind[px_chain::kMaxOuts];
};

namespace px_chain {

typedef unsigned long long u64;

__device__ __forceinline__ double as_f(long long v) { return __longlong_as_double(v); }
__device__ __forceinline__ long long of_f(double v) { return __double_as_longlong(v); }

__device__ __forceinline__ long long load_kind(const void* ptr, int kind, long long i) {
  switch (kind) {
    case kBool: return static_cast<const unsigned char*>(ptr)[i] != 0;
    case kI32: return static_cast<const int*>(ptr)[i];
    default: return static_cast<const long long*>(ptr)[i];  // int64, or f64 bits
  }
}

__device__ __forceinline__ void store_kind(void* ptr, int kind, long long i, long long v) {
  switch (kind) {
    case kBool: static_cast<unsigned char*>(ptr)[i] = v != 0; break;
    case kI32: static_cast<int*>(ptr)[i] = static_cast<int>(v); break;
    default: static_cast<long long*>(ptr)[i] = v; break;
  }
}

// A value as store_kind would write and load_kind read it back: bools 0/1,
// int32 truncated and sign-extended, 8-byte kinds unchanged.
__device__ __forceinline__ long long as_kind(int kind, long long v) {
  switch (kind) {
    case kBool: return v != 0;
    case kI32: return static_cast<int>(v);
    default: return v;
  }
}

// Python's (and PyTorch's) floor modulo; the caller has ruled out b == 0.
__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  if (b == -1) return 0;  // also INT64_MIN % -1, which C++ leaves undefined
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  if (b == -1) return static_cast<long long>(0ULL - static_cast<u64>(a));  // wraps
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// PyTorch's remainder of two doubles (BinaryRemainderKernel: fmod, then
// the divisor's sign).
__device__ __forceinline__ double floor_mod_f(double a, double b) {
  double m = fmod(a, b);
  if ((m != 0) && ((b < 0) != (m < 0))) m += b;
  return m;
}

// c10's div_floor_floating, as PyTorch's floor_divide runs it.
__device__ __forceinline__ double floor_div_f(double a, double b) {
  if (b == 0) return a / b;
  const double m = fmod(a, b);
  double div = (a - m) / b;
  if ((m != 0) && ((b < 0) != (m < 0))) div -= 1.0;
  double fl;
  if (div != 0) {
    fl = floor(div);
    if (div - fl > 0.5) fl += 1.0;
  } else {
    fl = copysign(0.0, a / b);
  }
  return fl;
}

// Per-row loops over the thread's R rows of the tile.  S(k) is stack slot
// sp - k (S(1) the top) of row r; PUSH the slot above the top.
#define PX_ROWS _Pragma("unroll") for (int r = 0; r < R; ++r)
#define PX_S(k) stk[static_cast<size_t>(sp - (k)) * T + r * B + threadIdx.x]
#define PX_PUSH stk[static_cast<size_t>(sp) * T + r * B + threadIdx.x]
#define PX_BIN_INT(expr)                                        \
  PX_ROWS {                                                     \
    const long long x = PX_S(2), y = PX_S(1);                   \
    PX_S(2) = (expr);                                           \
  }                                                             \
  sp -= 1;                                                      \
  break;
#define PX_BIN_FLT(expr)                                        \
  PX_ROWS {                                                     \
    const double x = as_f(PX_S(2)), y = as_f(PX_S(1));          \
    PX_S(2) = (expr);                                           \
  }                                                             \
  sp -= 1;                                                      \
  break;
#define PX_UN_FLT(expr)                                         \
  PX_ROWS {                                                     \
    const double x = as_f(PX_S(1));                             \
    PX_S(1) = of_f(expr);                                       \
  }                                                             \
  break;

// Runs program p over the tile of rows [base, base + R * B) of a block of B
// threads: mask and gid start all-true and 0 and come back as the program
// left them; stk is the tile's stack (p.depth * R * B values); each STORE
// calls store(slot, r, row, value) for the thread's rows r.  p may live in
// the launch's parameter space (C1, G1, F1) or anywhere else.
template <int R, int B, class Store>
__device__ __forceinline__ void run_tile(const ChainParams& p, long long base, long long* stk,
                                         bool (&mask)[R], int (&gid)[R], Store& store) {
  constexpr int T = R * B;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mask[r] = true;
    gid[r] = 0;
  }
  int sp = 0;
  // the loop's own fields in registers: where p lives in shared memory (G1,
  // F1) the compiler must otherwise assume each stack store may change them
  // and reload them on every instruction
  const int* const code = p.code;
  const long long* const consts = p.consts;
  const int ncode = p.ncode;
  const long long n = p.n;
  for (int pc = 0; pc < ncode; ++pc) {
    const int op = __ldg(code + 3 * pc);
    const int a = __ldg(code + 3 * pc + 1);
    const int b = __ldg(code + 3 * pc + 2);
    switch (op) {
      case LOAD_COL: {
        const void* col = p.col[a];
        const int kind = p.col_kind[a];
        PX_ROWS {
          const long long i = base + r * B + threadIdx.x;
          PX_PUSH = i < n ? load_kind(col, kind, i) : 0;
        }
        sp += 1;
        break;
      }
      case LOAD_CONST: {
        const long long v = __ldg(consts + a);
        PX_ROWS { PX_PUSH = v; }
        sp += 1;
        break;
      }
      case LOAD_SCALAR: {
        const long long v = p.scalar[a];
        PX_ROWS { PX_PUSH = v; }
        sp += 1;
        break;
      }
      case LOAD_ROW:
        PX_ROWS { PX_PUSH = base + r * B + threadIdx.x; }
        sp += 1;
        break;
      case DUP:
        PX_ROWS { PX_PUSH = PX_S(1); }
        sp += 1;
        break;
      case STORE:
        PX_ROWS { store(a, r, base + r * B + threadIdx.x, PX_S(1)); }
        sp -= 1;
        break;
      case MASK_AND:
        PX_ROWS { mask[r] = mask[r] && PX_S(1) != 0; }
        sp -= 1;
        break;
      case GID_COMBINE:
        // combine_codes: gid * card + clamp(int32(code), 0, card - 1), in int32
        PX_ROWS {
          int c = static_cast<int>(PX_S(1));
          c = c < 0 ? 0 : (c > a - 1 ? a - 1 : c);
          gid[r] = static_cast<int>(static_cast<unsigned>(gid[r]) * static_cast<unsigned>(a) +
                                    static_cast<unsigned>(c));
        }
        sp -= 1;
        break;
      case LUT: {
        // apply_lut: a code < 0 (or an empty LUT) gives the fill; a code
        // past the end reads the last entry, as the clamped gather does
        const void* lut = p.lut[a];
        const long long len = p.lut_len[a];
        const int kind = p.lut_kind[a];
        const long long fill = __ldg(consts + b);
        PX_ROWS {
          const long long c = PX_S(1);
          PX_S(1) = (c < 0 || len == 0) ? fill : load_kind(lut, kind, c < len ? c : len - 1);
        }
        break;
      }
      case LUT_DOMAIN: {
        // a bounded integer domain [lo, hi] into a LUT; outside it, oob
        const void* lut = p.lut[a];
        const int kind = p.lut_kind[a];
        const long long lo = __ldg(consts + b), hi = __ldg(consts + b + 1);
        const long long oob = __ldg(consts + b + 2);
        PX_ROWS {
          const long long x = PX_S(1);
          PX_S(1) = (x >= lo && x <= hi) ? load_kind(lut, kind, x - lo) : oob;
        }
        break;
      }
      case PAIR:
        // two dictionary codes into one code of their cross product (int32)
        PX_ROWS {
          const long long ca = PX_S(2), cb = PX_S(1);
          PX_S(2) = (ca >= 0 && cb >= 0)
                        ? static_cast<int>(static_cast<unsigned>(ca) * static_cast<unsigned>(a) +
                                           static_cast<unsigned>(cb))
                        : -1;
        }
        sp -= 1;
        break;
      case SEARCH: {
        // encode_against: lower bound of the value in a sorted int64 LUT
        const long long* lut = static_cast<const long long*>(p.lut[a]);
        const long long len = p.lut_len[a];
        PX_ROWS {
          const long long v = PX_S(1);
          long long lo = 0, hi = len;
          while (lo < hi) {
            const long long mid = (lo + hi) >> 1;
            if (__ldg(lut + mid) < v) lo = mid + 1; else hi = mid;
          }
          PX_S(1) = static_cast<int>(lo);
        }
        break;
      }
      case WINDOW: {
        // window key: int32(floor(t / width) - origin)
        const long long w = __ldg(consts + a);
        const long long origin = p.scalar[b];
        PX_ROWS {
          const long long q = floor_div(PX_S(1), w);
          PX_S(1) = static_cast<int>(static_cast<long long>(static_cast<u64>(q) -
                                                            static_cast<u64>(origin)));
        }
        break;
      }
      case CAST_I2F:
        PX_ROWS { PX_S(1) = of_f(static_cast<double>(PX_S(1))); }
        break;
      case CAST_F2I:
        PX_ROWS { PX_S(1) = static_cast<long long>(as_f(PX_S(1))); }
        break;
      case CAST_I64:
        break;  // bools and int32 codes already sit in int64 slots
      case NOT:
        PX_ROWS { PX_S(1) = PX_S(1) == 0; }
        break;
      case AND: PX_BIN_INT((x != 0) && (y != 0))
      case OR: PX_BIN_INT((x != 0) || (y != 0))
      case ADD_I: PX_BIN_INT(static_cast<long long>(static_cast<u64>(x) + static_cast<u64>(y)))
      case SUB_I: PX_BIN_INT(static_cast<long long>(static_cast<u64>(x) - static_cast<u64>(y)))
      case MUL_I: PX_BIN_INT(static_cast<long long>(static_cast<u64>(x) * static_cast<u64>(y)))
      case ADD_F: PX_BIN_FLT(of_f(x + y))
      case SUB_F: PX_BIN_FLT(of_f(x - y))
      case MUL_F: PX_BIN_FLT(of_f(x * y))
      case DIV_F: PX_BIN_FLT(of_f(x / y))
      case MOD_I: PX_BIN_INT(y == 0 ? 0 : floor_mod(x, y))
      case MOD_F: PX_BIN_FLT(of_f(y == 0 ? 0.0 : floor_mod_f(x, y)))
      case FDIV_I: PX_BIN_INT(y == 0 ? 0 : floor_div(x, y))
      case FDIV_F: PX_BIN_FLT(of_f(y == 0 ? 0.0 : floor_div_f(x, y)))
      case POW_F: PX_BIN_FLT(of_f(pow(x, y)))
      case ABS_I:
        PX_ROWS {
          const long long x = PX_S(1);
          PX_S(1) = x < 0 ? static_cast<long long>(0ULL - static_cast<u64>(x)) : x;
        }
        break;
      case ABS_F: PX_UN_FLT(fabs(x))
      case NEG_I:
        PX_ROWS { PX_S(1) = static_cast<long long>(0ULL - static_cast<u64>(PX_S(1))); }
        break;
      case NEG_F: PX_UN_FLT(-x)
      case LOG: PX_UN_FLT(log(x))
      case LOG2: PX_UN_FLT(log2(x))
      case LOG10: PX_UN_FLT(log10(x))
      case EXP: PX_UN_FLT(exp(x))
      case SQRT: PX_UN_FLT(sqrt(x))
      case CEIL: PX_UN_FLT(ceil(x))
      case FLOOR: PX_UN_FLT(floor(x))
      case RINT: PX_UN_FLT(rint(x))
      case BIN_I:
        // bin(t, s) = t - t % (s == 0 ? 1 : s)
        PX_BIN_INT(static_cast<long long>(static_cast<u64>(x) -
                                          static_cast<u64>(floor_mod(x, y == 0 ? 1 : y))))
      case EQ_I: PX_BIN_INT(x == y)
      case NE_I: PX_BIN_INT(x != y)
      case LT_I: PX_BIN_INT(x < y)
      case LE_I: PX_BIN_INT(x <= y)
      case GT_I: PX_BIN_INT(x > y)
      case GE_I: PX_BIN_INT(x >= y)
      case EQ_F: PX_BIN_FLT(x == y)
      case NE_F: PX_BIN_FLT(x != y)
      case LT_F: PX_BIN_FLT(x < y)
      case LE_F: PX_BIN_FLT(x <= y)
      case GT_F: PX_BIN_FLT(x > y)
      case GE_F: PX_BIN_FLT(x >= y)
      case SELECT:
        PX_ROWS { PX_S(3) = PX_S(3) != 0 ? PX_S(2) : PX_S(1); }
        sp -= 2;
        break;
      case APPROX_EQ: PX_BIN_FLT(fabs(x - y) < 1e-9)
      default:
        break;  // ops/chain.py checks every opcode before the launch
    }
  }
}

#undef PX_ROWS
#undef PX_S
#undef PX_PUSH
#undef PX_BIN_INT
#undef PX_BIN_FLT
#undef PX_UN_FLT

}  // namespace px_chain
