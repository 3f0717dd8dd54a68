// The chain program's interpreter, shared by C1 (chain.cu) and G1 (gang.cu)
// so that the two kernels run one set of opcode semantics.
//
// A program (ops/chain.py lowers every chain to one and shortens it) is a
// postfix list of instructions over a stack of per-row values.  `run_tile`
// runs it over one tile of R x B rows.  A thread owns R rows of the tile in
// runs of V = min(R, 4) neighbouring rows (`Rows`), so a column of any
// kind loads with one wide access a run (4 bools in a word, 4 int32 in an
// int4, 4 int64 in two 16-byte loads) and the warp's accesses stay
// contiguous.  Each instruction is a loop of the thread over its R rows,
// and every thread runs the same opcode, so there is no divergence.
//
// Registers, not shared memory, carry the values between instructions: the
// top of each row's stack (t), the mask, the group id, and the first
// LOCALS columns, which CACHE loads once a tile (the lowering puts the
// columns read more than once first).  Only the entries under the top live
// in shared memory, slot k of the thread's row r at stk[k * T + r * B +
// threadIdx.x]; shortened programs rarely reach them (config #1's and #2's
// chains are one deep).  A thread touches only its own rows' slots, so
// the interpreter needs no barrier.  The fused
// instructions (MASK_CMP, DICT_KEY, a binary op with an immediate operand)
// read their column or literal and fold the result into the mask or the
// group id without a push; an integer division by a constant is a
// multiply-high (Div).  STORE hands the thread's R values to the caller's
// Store: C1 writes an output column in device memory, G1 a tile slot in
// shared memory.  The block width B is a template parameter: C1 and G1 run
// kBlock (256) threads, F1 1024 (finalize.cu).
//
// Semantics follow PyTorch's ops, which the plain interpreter in
// ops/chain.py runs one per opcode: integer add, subtract, multiply and
// negate wrap (computed in uint64); integer % and // floor, with a zero
// divisor giving 0 and INT64_MIN // -1 wrapping; floats use CUDA's double
// functions without fast math (rint for round: half to even).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace px_chain {

constexpr int kBlock = 256;
constexpr int kMaxCols = 32;
constexpr int kMaxLuts = 32;
constexpr int kMaxOuts = 16;
constexpr int kMaxScalars = 16;
// stack entries held in registers (the top); the deeper ones live in
// shared memory
constexpr int kRegSlots = 1;
// columns a program may hold in registers for a tile (CACHE)
constexpr int kLocals = 2;
// SEARCH over a LUT at most this long is a branch-free count of the
// entries below the value, from registers
constexpr int kSmallLut = 8;

enum Kind : int { kBool = 0, kI32 = 1, kI64 = 2, kF64 = 3 };

// Opcodes; the order is ops/chain.py's OPS.
enum Op : int {
  LOAD_COL, LOAD_CONST, LOAD_SCALAR, LOAD_ROW, DUP, STORE, MASK_AND, GID_COMBINE,
  LUT, LUT_DOMAIN, PAIR, SEARCH, WINDOW, CAST_I2F, CAST_F2I, CAST_I64, NOT, AND, OR,
  ADD_I, SUB_I, MUL_I, ADD_F, SUB_F, MUL_F, DIV_F, MOD_I, MOD_F, FDIV_I, FDIV_F, POW_F,
  ABS_I, ABS_F, NEG_I, NEG_F, LOG, LOG2, LOG10, EXP, SQRT, CEIL, FLOOR, RINT, BIN_I,
  EQ_I, NE_I, LT_I, LE_I, GT_I, GE_I, EQ_F, NE_F, LT_F, LE_F, GT_F, GE_F, SELECT,
  APPROX_EQ, MASK_CMP, DICT_KEY, CACHE, kNumOps
};

// Shared-memory stack slots (each R x B values of 8 B) a program of the
// given depth needs beyond the registers (ops/chain.py stack_slots).
__host__ __device__ constexpr int shared_slots(int depth) {
  return depth > kRegSlots ? depth - kRegSlots : 0;
}

}  // namespace px_chain

// One program's launch parameters: the program (code and consts on the
// device, uploaded once per chain shape) and one feed's pointers and
// scalars.  The layout is mirrored by ctypes in ops/chain.py: 8-byte fields
// first, then the 4-byte ones.
struct ChainParams {
  const int* code;  // ncode instructions of 4 int32: op, a, b, c (16-byte aligned)
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

// The functions that expand to long code (libdevice's log, exp, pow, the
// fmod loop of float % and //, the 64-bit integer division), called rather
// than inlined: inlined R times into the interpreter's loop they would set
// its register budget for every opcode, though no scan of the benchmarks
// runs them.
__device__ __noinline__ double px_log(double x) { return log(x); }
__device__ __noinline__ double px_log2(double x) { return log2(x); }
__device__ __noinline__ double px_log10(double x) { return log10(x); }
__device__ __noinline__ double px_exp(double x) { return exp(x); }
__device__ __noinline__ double px_pow(double x, double y) { return pow(x, y); }
// int64 floor division and modulo by a divisor known only per row (or a
// constant below 1): the 64-bit division is a long sequence too
__device__ __noinline__ long long px_fdiv_i(long long x, long long y) {
  return y == 0 ? 0 : floor_div(x, y);
}
__device__ __noinline__ long long px_mod_i(long long x, long long y) {
  return y == 0 ? 0 : floor_mod(x, y);
}
__device__ __noinline__ double px_mod_f(double x, double y) {
  return y == 0 ? 0.0 : floor_mod_f(x, y);
}
__device__ __noinline__ double px_fdiv_f(double x, double y) {
  return y == 0 ? 0.0 : floor_div_f(x, y);
}

// Floor division and modulo by a constant d, as the lowering encoded it:
// the divisor, then div_magic's multiplier and mode (ops/chain.py).  mode
// >= 0: the quotient of a >= 0 is the high word of a * m shifted right by
// mode, exact for every dividend below 2^63 (Granlund and Montgomery), and
// of a < 0 the complement of ~a's (~a = -a - 1 >= 0, and floor(a / d) =
// ~floor(~a / d)); mode -2: d is 1; mode -1: d < 1, the division above
// (d = 0 gives 0, as MOD_I and FDIV_I define it).  mode is one value a
// launch, so its branches never diverge.
struct Div {
  long long d;
  u64 m;
  int mode;
  __device__ __forceinline__ explicit Div(const long long* c)
      : d(__ldg(c)), m(static_cast<u64>(__ldg(c + 1))), mode(static_cast<int>(__ldg(c + 2))) {}
  __device__ __forceinline__ long long fdiv(long long a) const {
    if (mode == -2) return a;
    if (mode < 0) return px_fdiv_i(a, d);
    const u64 na = a < 0 ? ~static_cast<u64>(a) : static_cast<u64>(a);
    const u64 q = __umul64hi(na, m) >> mode;
    return static_cast<long long>(a < 0 ? ~q : q);
  }
  __device__ __forceinline__ long long fmod(long long a) const {
    if (mode == -1) return px_mod_i(a, d);
    return static_cast<long long>(static_cast<u64>(a) -
                                  static_cast<u64>(mode == -2 ? 1 : d) *
                                      static_cast<u64>(fdiv(a)));
  }
};

// The rows of a tile of R x B rows that a thread owns: runs of V = min(R,
// 4) neighbouring rows, run k of thread x at k * B * V + x * V.
template <int R, int B>
struct Rows {
  static_assert(R == 1 || R == 2 || R % 4 == 0, "R rows: 1, 2 or a multiple of 4");
  static constexpr int V = R < 4 ? R : 4;
  static constexpr int T = R * B;
  // row r's offset in the tile
  __device__ static __forceinline__ int at(int r) {
    return (r / V) * (B * V) + static_cast<int>(threadIdx.x) * V + r % V;
  }
  // the whole tile at `base` holds rows of the feed, and ptr allows 16-byte
  // accesses: the wide path (one value a launch, tile by tile)
  __device__ static __forceinline__ bool wide(const void* ptr, long long base, long long n) {
    return base + T <= n && (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  }
};

#define PX_ROWS _Pragma("unroll") for (int r = 0; r < R; ++r)

// v[r] = the thread's row r of a column of `kind` in the tile at base (0
// past n), each run of V rows with one wide load where the tile allows.
template <int R, int B>
__device__ __forceinline__ void load_rows(const void* col, int kind, long long base, long long n,
                                          long long (&v)[R]) {
  using L = Rows<R, B>;
  constexpr int V = L::V;
  if (!L::wide(col, base, n)) {
    PX_ROWS {
      const long long i = base + L::at(r);
      v[r] = i < n ? load_kind(col, kind, i) : 0;
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < R / V; ++g) {
    const long long i = base + L::at(g * V);
    long long* w = v + g * V;
    if (kind == kBool) {
      const unsigned char* c = static_cast<const unsigned char*>(col) + i;
      if constexpr (V == 4) {
        const unsigned x = __ldg(reinterpret_cast<const unsigned*>(c));
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = ((x >> (8 * k)) & 0xffu) != 0;
      } else if constexpr (V == 2) {
        const unsigned short x = __ldg(reinterpret_cast<const unsigned short*>(c));
        w[0] = (x & 0xffu) != 0;
        w[1] = (x >> 8) != 0;
      } else {
        w[0] = __ldg(c) != 0;
      }
    } else if (kind == kI32) {
      const int* c = static_cast<const int*>(col) + i;
      if constexpr (V == 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(c));
        w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
      } else if constexpr (V == 2) {
        const int2 x = __ldg(reinterpret_cast<const int2*>(c));
        w[0] = x.x, w[1] = x.y;
      } else {
        w[0] = __ldg(c);
      }
    } else {
      const long long* c = static_cast<const long long*>(col) + i;
      if constexpr (V >= 2) {
#pragma unroll
        for (int k = 0; k < V; k += 2) {
          const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(c + k));
          w[k] = x.x, w[k + 1] = x.y;
        }
      } else {
        w[0] = __ldg(c);
      }
    }
  }
}

// The thread's rows of the tile at base into a column of `kind` (rows past
// n untouched), each run of V rows with one wide store where the tile
// allows; values as store_kind writes them.
template <int R, int B>
__device__ __forceinline__ void store_rows(void* col, int kind, long long base, long long n,
                                           const long long (&v)[R]) {
  using L = Rows<R, B>;
  constexpr int V = L::V;
  if (!L::wide(col, base, n)) {
    PX_ROWS {
      const long long i = base + L::at(r);
      if (i < n) store_kind(col, kind, i, v[r]);
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < R / V; ++g) {
    const long long i = base + L::at(g * V);
    const long long* w = v + g * V;
    if (kind == kBool) {
      unsigned char* c = static_cast<unsigned char*>(col) + i;
      if constexpr (V == 4) {
        *reinterpret_cast<unsigned*>(c) = (w[0] != 0) | (w[1] != 0) << 8 | (w[2] != 0) << 16 |
                                          static_cast<unsigned>(w[3] != 0) << 24;
      } else if constexpr (V == 2) {
        *reinterpret_cast<unsigned short*>(c) =
            static_cast<unsigned short>((w[0] != 0) | (w[1] != 0) << 8);
      } else {
        c[0] = w[0] != 0;
      }
    } else if (kind == kI32) {
      int* c = static_cast<int*>(col) + i;
      if constexpr (V == 4) {
        *reinterpret_cast<int4*>(c) = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                                                static_cast<int>(w[2]), static_cast<int>(w[3]));
      } else if constexpr (V == 2) {
        *reinterpret_cast<int2*>(c) = make_int2(static_cast<int>(w[0]), static_cast<int>(w[1]));
      } else {
        c[0] = static_cast<int>(w[0]);
      }
    } else {
      long long* c = static_cast<long long*>(col) + i;
      if constexpr (V >= 2) {
#pragma unroll
        for (int k = 0; k < V; k += 2) {
          *reinterpret_cast<longlong2*>(c + k) = make_longlong2(w[k], w[k + 1]);
        }
      } else {
        c[0] = w[0];
      }
    }
  }
}

// The stack: t[r] is the top (S1) of row r; shared slot k holds the entry
// k from the bottom (k < sp - 1).
#define PX_SLOT(k) stk[static_cast<size_t>(k) * T + r * B + threadIdx.x]
// push EXPR (which may read t[r]) onto every row's stack
#define PX_PUSH(expr)                                   \
  {                                                     \
    if (sp >= 1) {                                      \
      PX_ROWS { PX_SLOT(sp - 1) = t[r]; }               \
    }                                                   \
    PX_ROWS { t[r] = (expr); }                          \
    sp += 1;                                            \
  }
// pop the top: the entry under it comes back from shared memory
#define PX_POP                                          \
  {                                                     \
    if (sp >= 2) {                                      \
      PX_ROWS { t[r] = PX_SLOT(sp - 2); }               \
    }                                                   \
    sp -= 1;                                            \
  }
// t = expr(x, y) over x = S2, y = S1, or x = S1 and y the immediate
#define PX_BIN_INT(expr)                                \
  if (c != 0) {                                         \
    const long long y = imm(c);                         \
    PX_ROWS {                                           \
      const long long x = t[r];                         \
      t[r] = (expr);                                    \
    }                                                   \
  } else {                                              \
    PX_ROWS {                                           \
      const long long x = PX_SLOT(sp - 2), y = t[r];    \
      t[r] = (expr);                                    \
    }                                                   \
    sp -= 1;                                            \
  }                                                     \
  break;
#define PX_BIN_FLT(expr)                                \
  if (c != 0) {                                         \
    const double y = as_f(imm(c));                      \
    PX_ROWS {                                           \
      const double x = as_f(t[r]);                      \
      t[r] = (expr);                                    \
    }                                                   \
  } else {                                              \
    PX_ROWS {                                           \
      const double x = as_f(PX_SLOT(sp - 2));           \
      const double y = as_f(t[r]);                      \
      t[r] = (expr);                                    \
    }                                                   \
    sp -= 1;                                            \
  }                                                     \
  break;
#define PX_UN_FLT(expr)                                 \
  PX_ROWS {                                             \
    const double x = as_f(t[r]);                        \
    t[r] = of_f(expr);                                  \
  }                                                     \
  break;
// BIN_I, FDIV_I and MOD_I by a constant: c points at the Div block
#define PX_DIV(expr_div, expr_plain)                    \
  if (c > 0) {                                          \
    const Div dv(consts + c - 1);                       \
    PX_ROWS {                                           \
      const long long x = t[r];                         \
      t[r] = (expr_div);                                \
    }                                                   \
    break;                                              \
  }                                                     \
  PX_BIN_INT(expr_plain)

// MASK_CMP's compare b (an index into EQ_I..GE_F) of x against y: as a
// set of the outcomes {less, equal, greater} that make it true, and
// whether to negate (NE: a NaN compares unequal).
__device__ __forceinline__ unsigned cmp_set(int b) {
  switch (b % 6) {
    case 0: return 2u;   // EQ
    case 1: return 10u;  // NE: not EQ
    case 2: return 1u;   // LT
    case 3: return 3u;   // LE
    case 4: return 4u;   // GT
    default: return 6u;  // GE
  }
}

// Runs program p over the tile of rows [base, base + R * B) of a block of B
// threads: mask and gid start all-true and 0 and come back as the program
// left them; stk is the tile's shared stack (shared_slots(p.depth) * R * B
// values); each STORE calls store(slot, v, base) with the thread's R
// values.  p may live in the launch's parameter space (C1, G1, F1) or
// anywhere else.  Locals (at most kLocals): the columns CACHE may hold in
// registers, fewer where the caller's register budget is tight; a column
// past them loads where the program reads it.
template <int R, int B, int Locals = kLocals, class Store>
__device__ __forceinline__ void run_tile(const ChainParams& p, long long base, long long* stk,
                                         bool (&mask)[R], int (&gid)[R], Store& store) {
  static_assert(Locals >= 0 && Locals <= kLocals, "Locals: 0 to kLocals columns");
  using L = Rows<R, B>;
  constexpr int T = L::T;
  long long t[R], c0[R], c1[R];
  PX_ROWS {
    mask[r] = true;
    gid[r] = 0;
    t[r] = c0[r] = c1[r] = 0;
  }
  int sp = 0, ncached = 0;
  // the loop's own fields in registers: where p lives in shared memory the
  // compiler must otherwise assume each stack store may change them
  const int4* const code = reinterpret_cast<const int4*>(p.code);
  const long long* const consts = p.consts;
  const int ncode = p.ncode;
  const long long n = p.n;
  // an immediate operand: constant c - 1, or scalar -c - 1
  auto imm = [&](int c) -> long long { return c > 0 ? __ldg(consts + c - 1) : p.scalar[-c - 1]; };
  // column a of the thread's rows: from the registers CACHE filled, or loaded
  auto column = [&](int a, long long (&v)[R]) {
    if (a < ncached) {
      PX_ROWS { v[r] = a == 0 ? c0[r] : c1[r]; }
    } else {
      load_rows<R, B>(p.col[a], p.col_kind[a], base, n, v);
    }
  };
  int4 ahead = ncode > 0 ? __ldg(code) : make_int4(0, 0, 0, 0);
  for (int pc = 0; pc < ncode; ++pc) {
    const int4 ins = ahead;
    if (pc + 1 < ncode) ahead = __ldg(code + pc + 1);
    const int a = ins.y, b = ins.z, c = ins.w;
    switch (ins.x) {
      case CACHE:
        // hold columns [0, a) in registers for the tile, as many as Locals
        // allows
        ncached = a < Locals ? a : Locals;
        if (ncached > 0) load_rows<R, B>(p.col[0], p.col_kind[0], base, n, c0);
        if (ncached > 1) load_rows<R, B>(p.col[1], p.col_kind[1], base, n, c1);
        break;
      case LOAD_COL: {
        long long v[R];
        column(a, v);
        PX_PUSH(v[r])
        break;
      }
      case LOAD_CONST: {
        const long long v = __ldg(consts + a);
        PX_PUSH(v)
        break;
      }
      case LOAD_SCALAR: {
        const long long v = p.scalar[a];
        PX_PUSH(v)
        break;
      }
      case LOAD_ROW:
        PX_PUSH(base + L::at(r))
        break;
      case DUP:
        PX_PUSH(t[r])
        break;
      case STORE:
        store(a, t, base);
        PX_POP
        break;
      case MASK_AND:
        PX_ROWS { mask[r] = mask[r] && t[r] != 0; }
        PX_POP
        break;
      case GID_COMBINE:
        // combine_codes: gid * card + clamp(int32(code), 0, card - 1), in int32
        PX_ROWS {
          int k = static_cast<int>(t[r]);
          k = k < 0 ? 0 : (k > a - 1 ? a - 1 : k);
          gid[r] = static_cast<int>(static_cast<unsigned>(gid[r]) * static_cast<unsigned>(a) +
                                    static_cast<unsigned>(k));
        }
        PX_POP
        break;
      case MASK_CMP: {
        // mask &= column a (the row index for a < 0) <cmp b> immediate c
        long long v[R];
        if (a < 0) {
          PX_ROWS { v[r] = base + L::at(r); }
        } else {
          column(a, v);
        }
        const long long y = imm(c);
        const unsigned set = cmp_set(b);
        const bool neg = set > 7u;
        if (b >= 6) {
          const double yf = as_f(y);
          PX_ROWS {
            const double x = as_f(v[r]);
            const unsigned o = (x < yf) | (x == yf) << 1 | (x > yf) << 2;
            mask[r] = mask[r] && (((set & o) != 0) != neg);
          }
        } else {
          PX_ROWS {
            const long long x = v[r];
            const unsigned o = (x < y) | (x == y) << 1 | (x > y) << 2;
            mask[r] = mask[r] && (((set & o) != 0) != neg);
          }
        }
        break;
      }
      case DICT_KEY: {
        // a dictionary key: mask &= code >= imm (nulls drop out), then
        // gid = gid * card + clamp(int32(code), 0, card - 1)
        long long v[R];
        column(a, v);
        const long long lo = imm(c);
        PX_ROWS {
          mask[r] = mask[r] && v[r] >= lo;
          int k = static_cast<int>(v[r]);
          k = k < 0 ? 0 : (k > b - 1 ? b - 1 : k);
          gid[r] = static_cast<int>(static_cast<unsigned>(gid[r]) * static_cast<unsigned>(b) +
                                    static_cast<unsigned>(k));
        }
        break;
      }
      case LUT: {
        // apply_lut: a code < 0 (or an empty LUT) gives the fill; a code
        // past the end reads the last entry, as the clamped gather does
        const void* lut = p.lut[a];
        const long long len = p.lut_len[a];
        const int kind = p.lut_kind[a];
        const long long fill = __ldg(consts + b);
        PX_ROWS {
          const long long k = t[r];
          t[r] = (k < 0 || len == 0) ? fill : load_kind(lut, kind, k < len ? k : len - 1);
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
          const long long x = t[r];
          t[r] = (x >= lo && x <= hi) ? load_kind(lut, kind, x - lo) : oob;
        }
        break;
      }
      case PAIR:
        // two dictionary codes into one code of their cross product (int32)
        PX_ROWS {
          const long long ca = PX_SLOT(sp - 2), cb = t[r];
          t[r] = (ca >= 0 && cb >= 0)
                     ? static_cast<int>(static_cast<unsigned>(ca) * static_cast<unsigned>(a) +
                                        static_cast<unsigned>(cb))
                     : -1;
        }
        sp -= 1;
        break;
      case SEARCH: {
        // encode_against: the lower bound of the value in a sorted int64
        // LUT, the count of its entries below the value
        const long long* lut = static_cast<const long long*>(p.lut[a]);
        const long long len = p.lut_len[a];
        if (len <= kSmallLut) {
          int below[R];
          PX_ROWS { below[r] = 0; }
          for (int k = 0; k < len; ++k) {
            const long long e = __ldg(lut + k);
            PX_ROWS { below[r] += e < t[r]; }
          }
          PX_ROWS { t[r] = below[r]; }
        } else {
          PX_ROWS {
            const long long v = t[r];
            long long lo = 0, hi = len;
            while (lo < hi) {
              const long long mid = (lo + hi) >> 1;
              if (__ldg(lut + mid) < v) lo = mid + 1; else hi = mid;
            }
            t[r] = static_cast<int>(lo);
          }
        }
        break;
      }
      case WINDOW: {
        // window key: int32(floor(t / width) - origin); consts[a] the
        // width's Div block
        const Div dv(consts + a);
        const long long origin = p.scalar[b];
        PX_ROWS {
          const long long q = dv.fdiv(t[r]);
          t[r] = static_cast<int>(static_cast<long long>(static_cast<u64>(q) -
                                                         static_cast<u64>(origin)));
        }
        break;
      }
      case CAST_I2F:
        PX_ROWS { t[r] = of_f(static_cast<double>(t[r])); }
        break;
      case CAST_F2I:
        PX_ROWS { t[r] = static_cast<long long>(as_f(t[r])); }
        break;
      case CAST_I64:
        break;  // bools and int32 codes already sit in int64 slots
      case NOT:
        PX_ROWS { t[r] = t[r] == 0; }
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
      case MOD_I: PX_DIV(dv.fmod(x), px_mod_i(x, y))
      case MOD_F: PX_BIN_FLT(of_f(px_mod_f(x, y)))
      case FDIV_I: PX_DIV(dv.fdiv(x), px_fdiv_i(x, y))
      case FDIV_F: PX_BIN_FLT(of_f(px_fdiv_f(x, y)))
      case POW_F: PX_BIN_FLT(of_f(px_pow(x, y)))
      case ABS_I:
        PX_ROWS {
          const long long x = t[r];
          t[r] = x < 0 ? static_cast<long long>(0ULL - static_cast<u64>(x)) : x;
        }
        break;
      case ABS_F: PX_UN_FLT(fabs(x))
      case NEG_I:
        PX_ROWS { t[r] = static_cast<long long>(0ULL - static_cast<u64>(t[r])); }
        break;
      case NEG_F: PX_UN_FLT(-x)
      case LOG: PX_UN_FLT(px_log(x))
      case LOG2: PX_UN_FLT(px_log2(x))
      case LOG10: PX_UN_FLT(px_log10(x))
      case EXP: PX_UN_FLT(px_exp(x))
      case SQRT: PX_UN_FLT(sqrt(x))
      case CEIL: PX_UN_FLT(ceil(x))
      case FLOOR: PX_UN_FLT(floor(x))
      case RINT: PX_UN_FLT(rint(x))
      case BIN_I:
        // bin(t, s) = t - t % (s == 0 ? 1 : s)
        PX_DIV(static_cast<long long>(static_cast<u64>(x) - static_cast<u64>(dv.fmod(x))),
               static_cast<long long>(static_cast<u64>(x) -
                                      static_cast<u64>(px_mod_i(x, y == 0 ? 1 : y))))
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
        // S3 ? S2 : S1, S3 and S2 in shared memory
        PX_ROWS { t[r] = PX_SLOT(sp - 3) != 0 ? PX_SLOT(sp - 2) : t[r]; }
        sp -= 2;
        break;
      case APPROX_EQ: PX_BIN_FLT(fabs(x - y) < 1e-9)
      default:
        break;  // ops/chain.py checks every opcode before the launch
    }
  }
}

#undef PX_ROWS
#undef PX_SLOT
#undef PX_PUSH
#undef PX_POP
#undef PX_BIN_INT
#undef PX_BIN_FLT
#undef PX_UN_FLT
#undef PX_DIV

}  // namespace px_chain
