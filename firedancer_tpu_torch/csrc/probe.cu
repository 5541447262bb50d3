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
// Bound: both are tiny (a few KB); at the probe shapes the launch is the
// whole time.  Beyond that both are bytes-bound: add moves 12 bytes per
// add, and conv's 400 multiply-adds per lane against 316 bytes stay under
// the card's ~5 integer instructions per byte of memory traffic.
//
// probe_add: one element a thread.  probe_conv has two forms, picked by
// the batch.  While one lane a thread would leave an SM without a block
// (B <= 128 x SMs; the probe's B = 512 filled 4 SMs), a block of
// PROBE_GROUPS warps takes PROBE_LANES lanes, and warp w computes the
// output rows [probe_row_group(w), probe_row_group(w + 1)) for them, one
// lane a thread: it loads the limbs those rows read (a row's 32 lanes one
// coalesced 128-byte load; the block's warps read the rows they share
// from L1), sums each row's products in 32 bits and stores its rows
// coalesced.  Row k has min(k + 1, 39 - k) products (400 in all); the
// groups' counts are 105, 105, 99 and 91, so no thread runs more than 105
// IMADs, where one thread ran all 400.  Past that batch every SM has
// blocks of whole lanes, and one lane a thread (128-thread blocks, all 39
// rows) loads each limb once: the split's warps make 132 row loads for
// 32 lanes where one lane a thread makes 40, which cost ~0.5 us at 65,536
// lanes read from HBM (chip_smoke.py [probe_conv-ab]).
#include "fd_common.cuh"

#define PROBE_NLIMB 20

__global__ void probe_add_kernel(const int32_t* __restrict__ x,
                                 const int32_t* __restrict__ y,
                                 int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)((uint32_t)x[i] + (uint32_t)y[i]);
}

#define PROBE_LANES 32
#define PROBE_GROUPS 4
// Warp w's output rows, [probe_row_group(w), probe_row_group(w + 1)):
// contiguous, balanced by product count
__host__ __device__ constexpr int probe_row_group(int w) {
  constexpr int edge[PROBE_GROUPS + 1] = {0, 14, 20, 26, 39};
  return edge[w];
}

// Output rows [R0, R1) of one lane: the limbs they read into registers,
// then each row's products in 32 bits.
template <int R0, int R1>
__device__ __forceinline__ void probe_conv_rows(const int32_t* __restrict__ a,
                                                const int32_t* __restrict__ b,
                                                int32_t* __restrict__ out, int64_t B,
                                                int64_t lane) {
  constexpr int LO = R0 - (PROBE_NLIMB - 1) > 0 ? R0 - (PROBE_NLIMB - 1) : 0;
  constexpr int HI = R1 - 1 < PROBE_NLIMB - 1 ? R1 - 1 : PROBE_NLIMB - 1;
  uint32_t av[PROBE_NLIMB], bv[PROBE_NLIMB];
#pragma unroll
  for (int i = LO; i <= HI; i++) {
    av[i] = (uint32_t)a[(int64_t)i * B + lane];
    bv[i] = (uint32_t)b[(int64_t)i * B + lane];
  }
#pragma unroll
  for (int k = R0; k < R1; k++) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < PROBE_NLIMB; i++)
      if (k - i >= 0 && k - i < PROBE_NLIMB) acc += av[i] * bv[k - i];
    out[(int64_t)k * B + lane] = (int32_t)acc;
  }
}

__global__ void __launch_bounds__(PROBE_LANES * PROBE_GROUPS)
probe_conv_split_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                        int32_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * PROBE_LANES + threadIdx.x % PROBE_LANES;
  if (lane >= B) return;
  switch (threadIdx.x / PROBE_LANES) {  // warp-uniform: each warp its rows, unrolled
    case 0: probe_conv_rows<probe_row_group(0), probe_row_group(1)>(a, b, out, B, lane); break;
    case 1: probe_conv_rows<probe_row_group(1), probe_row_group(2)>(a, b, out, B, lane); break;
    case 2: probe_conv_rows<probe_row_group(2), probe_row_group(3)>(a, b, out, B, lane); break;
    default: probe_conv_rows<probe_row_group(3), probe_row_group(4)>(a, b, out, B, lane); break;
  }
}

#define PROBE_LANE_THREADS 128

__global__ void probe_conv_lane_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ b,
                                       int32_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  probe_conv_rows<0, 2 * PROBE_NLIMB - 1>(a, b, out, B, lane);
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
  int sms = 0;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc) return rc;
  auto pa = (const int32_t*)a;
  auto pb = (const int32_t*)b;
  auto po = (int32_t*)out;
  if (B <= (int64_t)PROBE_LANE_THREADS * sms)
    probe_conv_split_kernel<<<(unsigned)((B + PROBE_LANES - 1) / PROBE_LANES),
                              PROBE_LANES * PROBE_GROUPS, 0, (cudaStream_t)stream>>>(pa, pb, po, B);
  else
    probe_conv_lane_kernel<<<(unsigned)((B + PROBE_LANE_THREADS - 1) / PROBE_LANE_THREADS),
                             PROBE_LANE_THREADS, 0, (cudaStream_t)stream>>>(pa, pb, po, B);
  return (int)cudaGetLastError();
}
