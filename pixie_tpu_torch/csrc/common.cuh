// Helpers shared by the port's kernels.  Each kernel source is compiled on its
// own into one shared library with a plain C interface (see ops/_build.py), so
// the definitions below exist once per library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PX_MAX_DEVICES 64

extern "C" const char* px_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Streaming multiprocessors of the current device (cached per device).
static int px_sm_count() {
  static int cache[PX_MAX_DEVICES] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < PX_MAX_DEVICES && cache[dev] > 0) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 1;
  if (dev < PX_MAX_DEVICES) cache[dev] = n;
  return n;
}

// Largest dynamic shared memory one block may opt in to (227 KB on Hopper).
static int px_smem_optin() {
  static int cache[PX_MAX_DEVICES] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < PX_MAX_DEVICES && cache[dev] > 0) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (n <= 0) n = 48 * 1024;
  if (dev < PX_MAX_DEVICES) cache[dev] = n;
  return n;
}

// Grid for a grid-stride kernel: enough blocks to cover n rows once, capped
// at what the card keeps resident at this block size and shared memory.
template <typename Kernel>
static long long px_grid(Kernel kernel, long long n, int block, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  if (per_sm < 1) per_sm = 1;
  long long want = (n + block - 1) / block;
  long long cap = static_cast<long long>(per_sm) * px_sm_count();
  long long grid = want < cap ? want : cap;
  return grid < 1 ? 1 : grid;
}

// Asynchronous copies from device memory into shared memory (cp.async):
// 16 bytes (both addresses 16-byte aligned, L2 only) or 4, then a group
// committed and waited for until at most N groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes `device` the calling thread's current device for one launch and
// restores the caller's device on return.  A wrapper that passes its
// tensors' device index here needs no device context of its own on the host
// hot path: when `device` is already current, this is one cudaGetDevice.
struct PxDeviceScope {
  int prev = -1;
  explicit PxDeviceScope(int device) {
    int cur = 0;
    cudaGetDevice(&cur);
    if (cur != device && cudaSetDevice(device) == cudaSuccess) prev = cur;
  }
  ~PxDeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  PxDeviceScope(const PxDeviceScope&) = delete;
  PxDeviceScope& operator=(const PxDeviceScope&) = delete;
};
