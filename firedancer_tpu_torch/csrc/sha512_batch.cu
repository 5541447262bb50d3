// K3 sha512_batch: batched SHA-512 of variable-length messages, 32
// messages a two-warp block.
//
// Replaces: firedancer_tpu/ops/sha512.py:179 sha512_msg (with sha512_pad
// :149 and _compress_block :95), launched alone.
//
// Bound: the dependent chain.  A message's blocks are strictly serial, and
// a block is 80 dependent rounds of 64-bit adds, rotates and 3-input logic
// (~3,536 32-bit instructions, chip_smoke.py SHA512_OPS_PER_BLOCK), so at
// the batches the callers give (a few thousand lanes) the kernel's time is
// the longest lane's block count times what one warp issues a SHA block.
//
// Design.  One message a thread through sha512_lane issued 128 guarded
// single-byte loads a SHA block in series with the 80 rounds (0.185 ms at B
// = 4,096 x 1,296 on an H100, ~37x its bound).  K3 computes K10's hash
// (csrc/verify_split.cu) without the R || A prefix, so it runs the same
// warp pair (sha512.cuh sha512_message_warp and sha512_round_warp) on the
// row source Sha512Rows: warp 1 loads the block's row segments (uint4 on
// the wide path, the next SHA block's during this one's schedule) through
// the byte tile, pads, schedules and hands W + K over in chunks of 16
// rounds; warp 0 runs the rounds and stores the digest as 64 byte rows.
// The wide path needs B a multiple of 16 and the rows 16-byte aligned;
// otherwise each thread loads its own lane's byte of each row.  The lanes
// of a ragged tail read the batch's last lane, take part in every barrier
// and store nothing.  SASS (cuobjdump, nvcc 12.8, sm_90a): the round
// warp's 16-round loop 504 instructions and its block loop 551, so 2,567 a
// SHA block; the message warp's schedule loop 412 and block loop 1,216
// (K10's 414 and 1,321, which pick a row's source), 2,452 a SHA block;
// the narrow path's byte loop 81 a row octet.  The parent's one loop was
// 5,475 a SHA block (128 LDG, 258 ISETP, 130 SEL).  ptxas: 126 registers,
// no spills, 45,184 bytes of shared memory, so 4 blocks an SM; B = 4,096
// is 128 blocks, one an SM, each running to its longest of 32 messages.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so byte i
// of neighbouring lanes sits at neighbouring addresses; len (B,) int32; out
// (64, B) uint8.  A length outside [0, max_len] gives an all-zero digest
// (the plain version does the same): the warps hash such a lane as an empty
// message, and the store writes zeros.
#include "sha512.cuh"

__global__ void __launch_bounds__(SHA512_THREADS)
sha512_batch_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len_in,
                    uint8_t* __restrict__ out, int64_t B, int max_len, bool wide) {
  __shared__ __align__(16) ulonglong2 wk_s[2][SHA512_CHUNKS * 8][SHA512_LANES];
  __shared__ __align__(16) uint32_t tile_s[8][SHA512_TILE_STRIDE];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * SHA512_LANES;
  const bool in_batch = base + l < B;
  const int64_t lane = in_batch ? base + l : B - 1;
  const int32_t n = __ldg(len_in + lane);
  const bool in_range = n >= 0 && n <= max_len;
  const uint32_t len = in_range ? (uint32_t)n : 0u;
  const uint32_t nb = (len + 17 + 127) / 128;
  const uint32_t nb_max = __reduce_max_sync(0xffffffffu, nb);
  if (warp == 1) {
    sha512_message_warp(Sha512Rows{msg}, B, base, lane, l, len,
                        __reduce_max_sync(0xffffffffu, len), nb, nb_max, wide, tile_s, wk_s);
    return;
  }
  uint64_t st[8];
  sha512_round_warp(nb, nb_max, l, st, wk_s);
  if (in_batch) {
#pragma unroll
    for (int i = 0; i < 64; i++)
      out[(int64_t)i * B + lane] =
          in_range ? (uint8_t)(st[i >> 3] >> (56 - 8 * (i & 7))) : (uint8_t)0;
  }
}

FD_EXPORT int fd_sha512_batch(const void* msg, const void* len, void* out,
                              int64_t B, int max_len, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const bool wide = B % 16 == 0 && (uintptr_t)msg % 16 == 0;
  const int64_t blocks = (B + SHA512_LANES - 1) / SHA512_LANES;
  sha512_batch_kernel<<<(unsigned)blocks, SHA512_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B, max_len, wide);
  return (int)cudaGetLastError();
}
