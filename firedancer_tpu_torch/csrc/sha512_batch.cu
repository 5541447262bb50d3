// K3 sha512_batch: batched SHA-512 of variable-length messages, one lane
// per thread.
//
// Replaces: firedancer_tpu/ops/sha512.py:179 sha512_msg (with sha512_pad
// :149 and _compress_block :95), launched alone.  It runs the same
// __device__ sha512_lane as the verify kernel (csrc/verify.cu), so a wrong
// verify mask on the card is traced to the hash or to the curve in one run.
//
// Bound: integer operations.  Each 128-byte block costs ~4,100 32-bit
// integer instructions (80 rounds of 64-bit adds, rotates and 3-input
// logic) against 128 bytes read, far above the card's ops:byte balance.
// Design: native uint64 words (the TPU emulated 2x32-bit halves), one
// thread per message so the 80-round chain stays in registers, and each
// lane stops at its own final block.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so byte i
// of neighbouring lanes sits at neighbouring addresses and loads coalesce;
// len (B,) int32; out (64, B) uint8.  A length outside [0, max_len] gives an
// all-zero digest (the plain version does the same).
#include "sha512.cuh"

struct RowSrc {
  const uint8_t* __restrict__ msg;
  int64_t stride;
  int64_t lane;
  __device__ __forceinline__ uint8_t operator()(uint32_t pos) const {
    return __ldg(msg + (int64_t)pos * stride + lane);
  }
};

__global__ void __launch_bounds__(128)
sha512_batch_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len,
                    uint8_t* __restrict__ out, int64_t B, int max_len) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int32_t n = len[lane];
  uint64_t st[8];
  if (n < 0 || n > max_len) {
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = 0;
  } else {
    RowSrc src{msg, B, lane};
    sha512_lane(src, (uint32_t)n, st);
  }
#pragma unroll
  for (int i = 0; i < 64; i++)
    out[(int64_t)i * B + lane] = (uint8_t)(st[i >> 3] >> (56 - 8 * (i & 7)));
}

FD_EXPORT int fd_sha512_batch(const void* msg, const void* len, void* out,
                              int64_t B, int max_len, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  sha512_batch_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B, max_len);
  return (int)cudaGetLastError();
}
