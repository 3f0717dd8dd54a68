// C1: the chain program — one feed's row mask, group ids and computed value
// columns in one launch.
//
// Replaces: pixie_tpu/engine/executor.py ChainKernel (`_base_mask`,
// `_apply_steps`'s filters, the key and value builders of `make_agg_step`,
// `make_output_step` and `make_partial_agg_step`, :566-765),
// pixie_tpu/ops/groupby.py `combine_codes` / `encode_against` (:21, :73) and
// pixie_tpu/engine/eval.py `apply_lut` (:57).  XLA fused all of these into
// the program of the UDA updates; eager PyTorch ran them as one launch per
// elementwise op.
//
// Bound on the H100: bytes.  A chain reads each column it names once and
// writes the mask (1 B/row), the group ids (4 B/row) and each computed
// column once; plain column references pass through to the UDA kernels
// and are never copied.  Config #1's chain reads service (4 B) and status
// (8 B) and writes 5 B a row: 285 MB for a 16M-row feed, 0.085 ms at
// 3.35 TB/s.  The arithmetic is a few integer operations a row.
//
// Design: one interpreter, built once, that runs a small postfix program
// (ops/chain.py lowers every chain to one; the program is uploaded once per
// chain shape and cached).  Runtime scalars (the valid-row count, the time
// bounds, window origins) and the column, LUT and output pointers travel in
// the launch's parameter struct, by value, so a new feed or a new window
// origin uploads nothing.  Each block takes tiles of R x 256 rows; a thread
// owns R rows of the tile (neighbouring threads on neighbouring rows, so
// every column load is coalesced).  The operand stack is a set of tile
// vectors in dynamic shared memory — slot k of row j at stk[k * T + j] —
// and each instruction is a loop of the thread over its R rows.  Every
// thread runs the same opcode, so there is no divergence; no per-thread
// stack spills to local memory; the mask and the group id stay in
// registers.  The stack depth (known at lowering) picks R so that the stack
// fits 48 KB where it can.
//
// Semantics follow PyTorch's ops, which the plain interpreter in
// ops/chain.py runs one per opcode: integer add, subtract, multiply and
// negate wrap (computed in uint64); integer % and // floor, with a zero
// divisor giving 0 and INT64_MIN // -1 wrapping; floats use CUDA's double
// functions without fast math (rint for round: half to even).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxCols = 32;
constexpr int kMaxLuts = 32;
constexpr int kMaxOuts = 16;
constexpr int kMaxScalars = 16;
// 48 KB of stack without opting in to more shared memory
constexpr int kSmallSmem = 48 * 1024;

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

}  // namespace

// The launch's parameters (by value).  The layout is mirrored by ctypes in
// ops/chain.py: 8-byte fields first, then the 4-byte ones.
struct ChainParams {
  const int* code;  // ncode instructions of 3 int32: op, a, b
  const long long* consts;
  const void* col[kMaxCols];
  const void* lut[kMaxLuts];
  long long lut_len[kMaxLuts];
  void* out[kMaxOuts];
  long long scalar[kMaxScalars];
  unsigned char* mask_out;  // n bools, or null
  int* gid_out;             // n int32, or null
  long long n;
  int ncode;
  int depth;
  int col_kind[kMaxCols];
  int lut_kind[kMaxLuts];
  int out_kind[kMaxOuts];
};

namespace {

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
#define ROWS _Pragma("unroll") for (int r = 0; r < R; ++r)
#define S(k) stk[static_cast<size_t>(sp - (k)) * T + r * kBlock + threadIdx.x]
#define PUSH stk[static_cast<size_t>(sp) * T + r * kBlock + threadIdx.x]
#define BIN_INT(expr)                                           \
  ROWS {                                                        \
    const long long x = S(2), y = S(1);                         \
    S(2) = (expr);                                              \
  }                                                             \
  sp -= 1;                                                      \
  break;
#define BIN_FLT(expr)                                           \
  ROWS {                                                        \
    const double x = as_f(S(2)), y = as_f(S(1));                \
    S(2) = (expr);                                              \
  }                                                             \
  sp -= 1;                                                      \
  break;
#define UN_FLT(expr)                                            \
  ROWS {                                                        \
    const double x = as_f(S(1));                                \
    S(1) = of_f(expr);                                          \
  }                                                             \
  break;

template <int R>
__global__ void __launch_bounds__(kBlock) chain_kernel(const ChainParams p) {
  extern __shared__ long long stk[];
  constexpr int T = R * kBlock;
  const long long tiles = (p.n + T - 1) / T;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = tile * T;
    bool mask[R];
    int gid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mask[r] = true;
      gid[r] = 0;
    }
    int sp = 0;
    for (int pc = 0; pc < p.ncode; ++pc) {
      const int op = __ldg(p.code + 3 * pc);
      const int a = __ldg(p.code + 3 * pc + 1);
      const int b = __ldg(p.code + 3 * pc + 2);
      switch (op) {
        case LOAD_COL: {
          const void* col = p.col[a];
          const int kind = p.col_kind[a];
          ROWS {
            const long long i = base + r * kBlock + threadIdx.x;
            PUSH = i < p.n ? load_kind(col, kind, i) : 0;
          }
          sp += 1;
          break;
        }
        case LOAD_CONST: {
          const long long v = __ldg(p.consts + a);
          ROWS { PUSH = v; }
          sp += 1;
          break;
        }
        case LOAD_SCALAR: {
          const long long v = p.scalar[a];
          ROWS { PUSH = v; }
          sp += 1;
          break;
        }
        case LOAD_ROW:
          ROWS { PUSH = base + r * kBlock + threadIdx.x; }
          sp += 1;
          break;
        case DUP:
          ROWS { PUSH = S(1); }
          sp += 1;
          break;
        case STORE: {
          void* out = p.out[a];
          const int kind = p.out_kind[a];
          ROWS {
            const long long i = base + r * kBlock + threadIdx.x;
            if (i < p.n) store_kind(out, kind, i, S(1));
          }
          sp -= 1;
          break;
        }
        case MASK_AND:
          ROWS { mask[r] = mask[r] && S(1) != 0; }
          sp -= 1;
          break;
        case GID_COMBINE:
          // combine_codes: gid * card + clamp(int32(code), 0, card - 1), in int32
          ROWS {
            int c = static_cast<int>(S(1));
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
          const long long fill = __ldg(p.consts + b);
          ROWS {
            const long long c = S(1);
            S(1) = (c < 0 || len == 0) ? fill : load_kind(lut, kind, c < len ? c : len - 1);
          }
          break;
        }
        case LUT_DOMAIN: {
          // a bounded integer domain [lo, hi] into a LUT; outside it, oob
          const void* lut = p.lut[a];
          const int kind = p.lut_kind[a];
          const long long lo = __ldg(p.consts + b), hi = __ldg(p.consts + b + 1);
          const long long oob = __ldg(p.consts + b + 2);
          ROWS {
            const long long x = S(1);
            S(1) = (x >= lo && x <= hi) ? load_kind(lut, kind, x - lo) : oob;
          }
          break;
        }
        case PAIR:
          // two dictionary codes into one code of their cross product (int32)
          ROWS {
            const long long ca = S(2), cb = S(1);
            S(2) = (ca >= 0 && cb >= 0)
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
          ROWS {
            const long long v = S(1);
            long long lo = 0, hi = len;
            while (lo < hi) {
              const long long mid = (lo + hi) >> 1;
              if (__ldg(lut + mid) < v) lo = mid + 1; else hi = mid;
            }
            S(1) = static_cast<int>(lo);
          }
          break;
        }
        case WINDOW: {
          // window key: int32(floor(t / width) - origin)
          const long long w = __ldg(p.consts + a);
          const long long origin = p.scalar[b];
          ROWS {
            const long long q = floor_div(S(1), w);
            S(1) = static_cast<int>(static_cast<long long>(static_cast<u64>(q) -
                                                           static_cast<u64>(origin)));
          }
          break;
        }
        case CAST_I2F:
          ROWS { S(1) = of_f(static_cast<double>(S(1))); }
          break;
        case CAST_F2I:
          ROWS { S(1) = static_cast<long long>(as_f(S(1))); }
          break;
        case CAST_I64:
          break;  // bools and int32 codes already sit in int64 slots
        case NOT:
          ROWS { S(1) = S(1) == 0; }
          break;
        case AND: BIN_INT((x != 0) && (y != 0))
        case OR: BIN_INT((x != 0) || (y != 0))
        case ADD_I: BIN_INT(static_cast<long long>(static_cast<u64>(x) + static_cast<u64>(y)))
        case SUB_I: BIN_INT(static_cast<long long>(static_cast<u64>(x) - static_cast<u64>(y)))
        case MUL_I: BIN_INT(static_cast<long long>(static_cast<u64>(x) * static_cast<u64>(y)))
        case ADD_F: BIN_FLT(of_f(x + y))
        case SUB_F: BIN_FLT(of_f(x - y))
        case MUL_F: BIN_FLT(of_f(x * y))
        case DIV_F: BIN_FLT(of_f(x / y))
        case MOD_I: BIN_INT(y == 0 ? 0 : floor_mod(x, y))
        case MOD_F: BIN_FLT(of_f(y == 0 ? 0.0 : floor_mod_f(x, y)))
        case FDIV_I: BIN_INT(y == 0 ? 0 : floor_div(x, y))
        case FDIV_F: BIN_FLT(of_f(y == 0 ? 0.0 : floor_div_f(x, y)))
        case POW_F: BIN_FLT(of_f(pow(x, y)))
        case ABS_I:
          ROWS {
            const long long x = S(1);
            S(1) = x < 0 ? static_cast<long long>(0ULL - static_cast<u64>(x)) : x;
          }
          break;
        case ABS_F: UN_FLT(fabs(x))
        case NEG_I:
          ROWS { S(1) = static_cast<long long>(0ULL - static_cast<u64>(S(1))); }
          break;
        case NEG_F: UN_FLT(-x)
        case LOG: UN_FLT(log(x))
        case LOG2: UN_FLT(log2(x))
        case LOG10: UN_FLT(log10(x))
        case EXP: UN_FLT(exp(x))
        case SQRT: UN_FLT(sqrt(x))
        case CEIL: UN_FLT(ceil(x))
        case FLOOR: UN_FLT(floor(x))
        case RINT: UN_FLT(rint(x))
        case BIN_I:
          // bin(t, s) = t - t % (s == 0 ? 1 : s)
          BIN_INT(static_cast<long long>(static_cast<u64>(x) -
                                         static_cast<u64>(floor_mod(x, y == 0 ? 1 : y))))
        case EQ_I: BIN_INT(x == y)
        case NE_I: BIN_INT(x != y)
        case LT_I: BIN_INT(x < y)
        case LE_I: BIN_INT(x <= y)
        case GT_I: BIN_INT(x > y)
        case GE_I: BIN_INT(x >= y)
        case EQ_F: BIN_FLT(x == y)
        case NE_F: BIN_FLT(x != y)
        case LT_F: BIN_FLT(x < y)
        case LE_F: BIN_FLT(x <= y)
        case GT_F: BIN_FLT(x > y)
        case GE_F: BIN_FLT(x >= y)
        case SELECT:
          ROWS { S(3) = S(3) != 0 ? S(2) : S(1); }
          sp -= 2;
          break;
        case APPROX_EQ: BIN_FLT(fabs(x - y) < 1e-9)
        default:
          break;  // ops/chain.py checks every opcode before the launch
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = base + r * kBlock + threadIdx.x;
      if (i < p.n) {
        if (p.mask_out != nullptr) p.mask_out[i] = mask[r];
        if (p.gid_out != nullptr) p.gid_out[i] = gid[r];
      }
    }
  }
}

#undef ROWS
#undef S
#undef PUSH
#undef BIN_INT
#undef BIN_FLT
#undef UN_FLT

template <int R>
int launch(const ChainParams& p, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(p.depth < 1 ? 1 : p.depth) * R * kBlock * 8;
  if (smem > static_cast<size_t>(kSmallSmem)) {
    if (smem > static_cast<size_t>(px_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        chain_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = px_grid(chain_kernel<R>, (p.n + R - 1) / R, kBlock, smem);
  chain_kernel<R><<<static_cast<unsigned>(grid), kBlock, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// -------------------------------------------------------------- C interface
// p: the program (code and consts on the device, uploaded once per chain
// shape) and this feed's pointers and scalars; see ChainParams.  Returns a
// cudaError_t (0 = launched).

// sizeof(ChainParams), which the wrapper holds against its ctypes mirror
extern "C" int px_chain_params_size() { return static_cast<int>(sizeof(ChainParams)); }

extern "C" int px_chain_run(const ChainParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->n <= 0) return 0;
  // rows a thread owns: as many as keep the stack within 48 KB a block
  const int depth = p->depth < 1 ? 1 : p->depth;
  if (depth * 4 * kBlock * 8 <= kSmallSmem) return launch<4>(*p, s);
  if (depth * 2 * kBlock * 8 <= kSmallSmem) return launch<2>(*p, s);
  return launch<1>(*p, s);
}
