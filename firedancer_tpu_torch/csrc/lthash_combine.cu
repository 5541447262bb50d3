// K13 lthash_combine: the signed lattice sum of N account hashes,
// out[j] = sum_i signs[i] * values[i][j] mod 2^16 over (N, 1024) u16 rows.
//
// Replaces: firedancer_tpu/ops/lthash.py:43 combine_device (XLA: widen to
// int32, multiply by the row's sign, sum over rows, mask 0xFFFF), the
// accounts-delta reduction of every slot's bank hash
// (flamenco/runtime.py:1102, inside SlotExecution.seal).
//
// Bound: bytes, N x (2,048 + 1) read once plus 4 KB written; at a slot's
// few thousand rows that is ~1-2 us on 3.35 TB/s, below a launch's own
// latency, so the launch dominates there.  Design: each thread owns two
// adjacent lanes and reads them as one 32-bit word, so a warp's loads
// cover 128 contiguous bytes of a row; a 2-D grid (2 x chunks of rows)
// spreads a large N over the SMs; each thread accumulates sign x value in
// uint32, which wraps exactly (only the low 16 bits are kept), then adds
// its two lanes into a zeroed (1024,) uint32 buffer with atomicAdd.
// Integer atomics commute, so the result does not depend on block order.
// signs == nullptr means every row counts +1.
#include "fd_common.cuh"

#define LT_WORDS 512  // 1,024 u16 lanes as 512 u32 words per row
#define LT_THREADS 256

__global__ void __launch_bounds__(LT_THREADS)
lthash_combine_kernel(const uint32_t* __restrict__ values,
                      const int8_t* __restrict__ signs, int64_t n,
                      int64_t rows_per_chunk, uint32_t* __restrict__ out) {
  const int w = blockIdx.x * LT_THREADS + threadIdx.x;  // word of the row
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = min(n, r0 + rows_per_chunk);
  uint32_t lo = 0, hi = 0;
  int64_t r = r0;
  // four rows in flight per thread: independent loads overlap
  for (; r + 4 <= r1; r += 4) {
    uint32_t v[4], s[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      v[k] = __ldg(values + (r + k) * LT_WORDS + w);
      s[k] = signs ? (uint32_t)(int32_t)__ldg(signs + r + k) : 1u;
    }
#pragma unroll
    for (int k = 0; k < 4; k++) {
      lo += s[k] * (v[k] & 0xFFFFu);
      hi += s[k] * (v[k] >> 16);
    }
  }
  for (; r < r1; r++) {
    uint32_t v = __ldg(values + r * LT_WORDS + w);
    uint32_t s = signs ? (uint32_t)(int32_t)__ldg(signs + r) : 1u;
    lo += s * (v & 0xFFFFu);
    hi += s * (v >> 16);
  }
  if (r1 > r0) {
    atomicAdd(out + 2 * w, lo);
    atomicAdd(out + 2 * w + 1, hi);
  }
}

// values: (n, 1024) u16 rows, contiguous; signs: (n,) int8 in {-1, 0, 1} or
// nullptr; out: (1024,) uint32, zeroed by the caller.
FD_EXPORT int fd_lthash_combine(const void* values, const void* signs, int64_t n,
                                int64_t chunks, void* out, int device,
                                void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (n <= 0) return 0;
  if (chunks < 1) chunks = 1;
  const int64_t rows = (n + chunks - 1) / chunks;
  chunks = (n + rows - 1) / rows;
  dim3 grid(LT_WORDS / LT_THREADS, (unsigned)chunks);
  lthash_combine_kernel<<<grid, LT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)values, (const int8_t*)signs, n, rows, (uint32_t*)out);
  return (int)cudaGetLastError();
}
