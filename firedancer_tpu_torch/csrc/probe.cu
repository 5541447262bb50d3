// The two toolchain probes: counterparts of the Pallas probes in
// firedancer_tpu/scripts/probe_pallas.py, which checked that a kernel
// compiles and runs on the backend at all.
//
//   probe_add  replaces probe_pallas.py:18 add_kernel (pallas_call :25):
//              elementwise int32 add, (8, 128) in the probe.
//   probe_conv replaces probe_pallas.py:34 conv_kernel (pallas_call :52):
//              the unreduced 20 x 20 limb convolution of two (20, B) int32
//              limb rows, out[k] = sum_{i + j = k} a[i] * b[j], (39, B),
//              wrapping mod 2^32 as int32 arithmetic does.
//
// Bound: both are tiny (a few KB); at the probe shapes launch latency is
// the whole time.  Beyond that both are bytes-bound: add moves 12 bytes per
// add, and conv's 400 multiply-adds per lane against 316 bytes stay under
// the card's ~5 integer instructions per byte of memory traffic.  Design:
// one element (add) or one lane (conv) per thread, the lane's 40 limbs in
// registers, loads coalesced along the trailing axis.
#include "fd_common.cuh"

#define PROBE_NLIMB 20

__global__ void probe_add_kernel(const int32_t* __restrict__ x,
                                 const int32_t* __restrict__ y,
                                 int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)((uint32_t)x[i] + (uint32_t)y[i]);
}

__global__ void probe_conv_kernel(const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ b,
                                  int32_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t av[PROBE_NLIMB], bv[PROBE_NLIMB];
#pragma unroll
  for (int i = 0; i < PROBE_NLIMB; i++) {
    av[i] = (uint32_t)a[(int64_t)i * B + lane];
    bv[i] = (uint32_t)b[(int64_t)i * B + lane];
  }
#pragma unroll
  for (int k = 0; k < 2 * PROBE_NLIMB - 1; k++) {
    uint32_t t = 0;
#pragma unroll
    for (int i = 0; i < PROBE_NLIMB; i++)
      if (k - i >= 0 && k - i < PROBE_NLIMB) t += av[i] * bv[k - i];
    out[(int64_t)k * B + lane] = (int32_t)t;
  }
}

FD_EXPORT int fd_probe_add(const void* x, const void* y, void* out, int64_t n,
                           int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (n == 0) return 0;
  probe_add_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

FD_EXPORT int fd_probe_conv(const void* a, const void* b, void* out, int64_t B,
                            int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  probe_conv_kernel<<<(unsigned)((B + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, B);
  return (int)cudaGetLastError();
}
