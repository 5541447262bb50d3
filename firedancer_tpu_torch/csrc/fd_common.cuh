// Shared plumbing for the port's kernels: each csrc/<name>.cu is built into
// its own shared library with a plain C interface (utils/kbuild.py) and
// includes this header once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FD_EXPORT extern "C" __attribute__((visibility("default")))

FD_EXPORT const char* fd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Select the caller's device in this library's runtime (the library links
// its own static cudart; the stream handle comes from PyTorch).  The
// current device is per host thread: cudaGetDevice reads it, and
// cudaSetDevice runs only when it differs, so a launch never goes to
// another device than the one named and the common call skips the switch.
static inline int fd_set_device(int device) {
  int cur = -1;
  cudaError_t rc = cudaGetDevice(&cur);
  if (rc != cudaSuccess) return (int)rc;
  return cur == device ? 0 : (int)cudaSetDevice(device);
}

// Bits [lo, lo + width) of the little-endian integer held in n 64-bit
// words (width <= 64).  Called with constant arguments after unrolling.
__device__ __forceinline__ uint64_t fd_bits(const uint64_t* w, int n, int lo,
                                            int width) {
  int k = lo >> 6, sh = lo & 63;
  uint64_t v = w[k] >> sh;
  if (sh && sh + width > 64 && k + 1 < n) v |= w[k + 1] << (64 - sh);
  return width == 64 ? v : (v & ((1ull << width) - 1));
}

// 32 byte rows of lane `lane` from a (32, B) row-major byte array, read in
// place (neighbouring lanes sit at neighbouring addresses), as 4
// little-endian words.
__device__ __forceinline__ void fd_load32(const uint8_t* __restrict__ rows,
                                          int64_t stride, int64_t lane,
                                          uint64_t w[4]) {
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint64_t v = 0;
#pragma unroll
    for (int b = 0; b < 8; b++)
      v |= (uint64_t)__ldg(rows + (int64_t)(8 * k + b) * stride + lane) << (8 * b);
    w[k] = v;
  }
}
