// K2 fe_mul_chain: k chained field multiplies per lane, (x, y) -> (x*y, x).
//
// Replaces: the Pallas microbenchmark make_pallas13 (scripts/perf_fe.py:114,
// body _pallas_mul_body :81), a radix-2^13 chained fe_mul.  It runs the same
// __device__ fe_mul as the verify kernel (csrc/fe_field.cuh), so it checks
// the field arithmetic on the card exactly and in isolation.
//
// Bound: integer multiplies.  Each fe_mul is 100 32x32->64 products (one
// IMAD.WIDE each) plus a carry chain, against 80 bytes read and written per
// lane for the whole chain.  Design: one lane per thread, the chain in
// registers, limbs (10, B) row-major so the 10 loads and stores per lane
// coalesce across the warp.
#include "fe_field.cuh"

__global__ void __launch_bounds__(128)
fe_mul_chain_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                    int32_t* __restrict__ xo, int32_t* __restrict__ yo,
                    int64_t B, int k) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe a, b;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    a.v[i] = x[(int64_t)i * B + lane];
    b.v[i] = y[(int64_t)i * B + lane];
  }
  for (int it = 0; it < k; it++) {
    fe t = fe_mul(a, b);
    b = a;
    a = t;
  }
#pragma unroll
  for (int i = 0; i < 10; i++) {
    xo[(int64_t)i * B + lane] = a.v[i];
    yo[(int64_t)i * B + lane] = b.v[i];
  }
}

FD_EXPORT int fd_fe_mul_chain(const void* x, const void* y, void* xo, void* yo,
                              int B, int k, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  fe_mul_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (int32_t*)xo, (int32_t*)yo, B, k);
  return (int)cudaGetLastError();
}
