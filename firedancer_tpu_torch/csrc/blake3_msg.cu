// K16 blake3_msg: single-chunk BLAKE3 (messages of at most 1,024 bytes, 32
// bytes out), one message per thread.
//
// Replaces: firedancer_tpu/ops/blake3.py:150 blake3_msg.
//
// Bound: the dependent chain.  A lane's blocks are strictly serial (block
// k + 1 starts from block k's chaining value), and a compression is 7
// rounds of 8 quarter-round mixes, each a chain of 12 dependent 32-bit
// instructions (chip_smoke.py BLAKE3_OPS_PER_COMPRESSION).  At the batches
// the callers give, the kernel is latency-bound: about the longest lane's
// block count times one compression's latency.
//
// Design: the TPU version runs every block for every lane and masks the
// chaining value past each lane's final block (the `past` mask).  Here each
// thread runs only its own blocks: block 0 carries CHUNK_START, the final
// block (max(len - 1, 0) / 64) carries CHUNK_END | ROOT and its own length
// (an empty message hashes one zero-length block), and the digest is that
// block's output.  The 16-word state and the message block live in
// registers; the message permutation is a renaming after unrolling.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so a warp's
// loads of a row coalesce; len (B,) int32, each in [0, max_len] with
// max_len <= 1,024 (the wrapper checks); out (32, B) uint8, words
// little-endian.
#include "fd_common.cuh"

#define B3_CHUNK_START 1u
#define B3_CHUNK_END 2u
#define B3_ROOT 8u

__device__ __forceinline__ uint32_t b3_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define B3_G(a, b, c, d, mx, my)          \
  do {                                    \
    s[a] = s[a] + s[b] + (mx);            \
    s[d] = b3_rotr(s[d] ^ s[a], 16);      \
    s[c] = s[c] + s[d];                   \
    s[b] = b3_rotr(s[b] ^ s[c], 12);      \
    s[a] = s[a] + s[b] + (my);            \
    s[d] = b3_rotr(s[d] ^ s[a], 8);       \
    s[c] = s[c] + s[d];                   \
    s[b] = b3_rotr(s[b] ^ s[c], 7);       \
  } while (0)

// cv <- the first 8 output words of one compression (counter 0).
__device__ __forceinline__ void b3_compress(uint32_t cv[8], const uint32_t block[16],
                                            uint32_t block_len, uint32_t flags) {
  constexpr uint32_t IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                              0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  constexpr int PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};
  uint32_t s[16], m[16];
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = cv[i];
#pragma unroll
  for (int i = 0; i < 4; i++) s[8 + i] = IV[i];
  s[12] = 0u;
  s[13] = 0u;
  s[14] = block_len;
  s[15] = flags;
#pragma unroll
  for (int i = 0; i < 16; i++) m[i] = block[i];
#pragma unroll
  for (int r = 0; r < 7; r++) {
    B3_G(0, 4, 8, 12, m[0], m[1]);
    B3_G(1, 5, 9, 13, m[2], m[3]);
    B3_G(2, 6, 10, 14, m[4], m[5]);
    B3_G(3, 7, 11, 15, m[6], m[7]);
    B3_G(0, 5, 10, 15, m[8], m[9]);
    B3_G(1, 6, 11, 12, m[10], m[11]);
    B3_G(2, 7, 8, 13, m[12], m[13]);
    B3_G(3, 4, 9, 14, m[14], m[15]);
    if (r < 6) {
      uint32_t t[16];
#pragma unroll
      for (int i = 0; i < 16; i++) t[i] = m[PERM[i]];
#pragma unroll
      for (int i = 0; i < 16; i++) m[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) cv[i] = s[i] ^ s[i + 8];
}

__global__ void __launch_bounds__(32)
blake3_msg_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len,
                  uint8_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint32_t n = (uint32_t)len[lane];
  const uint32_t final_block = n ? (n - 1) / 64 : 0;
  uint32_t cv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  for (uint32_t bi = 0; bi <= final_block; bi++) {
    const uint32_t base = bi * 64;
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++) {
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; b++) {
        const uint32_t pos = base + 4 * t + b;
        const uint32_t byte = pos < n ? (uint32_t)__ldg(msg + (int64_t)pos * B + lane) : 0u;
        x |= byte << (8 * b);
      }
      w[t] = x;
    }
    const bool last = bi == final_block;
    const uint32_t flags = (bi == 0 ? B3_CHUNK_START : 0u) | (last ? B3_CHUNK_END | B3_ROOT : 0u);
    b3_compress(cv, w, last ? n - base : 64u, flags);
  }
#pragma unroll
  for (int i = 0; i < 32; i++)
    out[(int64_t)i * B + lane] = (uint8_t)(cv[i >> 2] >> (8 * (i & 3)));
}

FD_EXPORT int fd_blake3_msg(const void* msg, const void* len, void* out, int64_t B,
                            int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  blake3_msg_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
