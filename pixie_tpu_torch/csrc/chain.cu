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
// origin uploads nothing.  Each block takes tiles of R x 256 rows with a
// grid stride and runs the program over each tile (the interpreter,
// `px_chain::run_tile`, lives in chain.cuh and is shared with G1, gang.cu);
// STORE writes an output column.  The operand stack lives in dynamic shared
// memory; the stack depth (known at lowering) picks R so that the stack
// fits 48 KB where it can.

#include "chain.cuh"

namespace {

using namespace px_chain;

// 48 KB of stack without opting in to more shared memory
constexpr int kSmallSmem = 48 * 1024;

// STORE: the row's value into output column `a`, in its kind.
struct GlobalStore {
  const ChainParams& p;
  __device__ __forceinline__ void operator()(int a, int /*r*/, long long i, long long v) const {
    if (i < p.n) store_kind(p.out[a], p.out_kind[a], i, v);
  }
};

template <int R>
__global__ void __launch_bounds__(kBlock) chain_kernel(const __grid_constant__ ChainParams p) {
  extern __shared__ long long stk[];
  constexpr int T = R * kBlock;
  const long long tiles = (p.n + T - 1) / T;
  GlobalStore store{p};
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = tile * T;
    bool mask[R];
    int gid[R];
    run_tile<R, kBlock>(p, base, stk, mask, gid, store);
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
