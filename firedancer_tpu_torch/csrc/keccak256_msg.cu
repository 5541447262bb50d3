// K17 keccak256_msg: batched Keccak-256 of variable-length messages (the
// legacy 0x01 padding of sol_keccak256 and secp256k1_recover, not SHA-3's
// 0x06), one message per thread.
//
// Replaces: firedancer_tpu/ops/keccak256.py:148 keccak256_msg (permutation
// _keccak_f :116).
//
// Bound: the dependent chain.  A lane's blocks are strictly serial, and
// keccak-f[1600] is 24 dependent rounds of ~130 64-bit operations
// (chip_smoke.py KECCAK_OPS_PER_PERMUTATION counts each as two 32-bit
// ones).  At the batches the callers give, the kernel is latency-bound:
// about the longest lane's block count times one permutation's latency.
//
// Design: the TPU has no 64-bit integers, so the JAX op keeps the state as
// (lo, hi) uint32 planes; Hopper has native 64-bit XOR, AND and shifts, so
// the 25 lanes live in 50 registers as uint64.  The TPU version pads every
// lane into a buffer and runs all blocks for every lane; here each thread
// pads in registers (0x01 after its message, 0x80 XORed into byte 135 of its
// final block len / 136; the two meet in one byte when len % 136 == 135) and
// stops after its own final block.  The rounds' lane indices are constants
// after unrolling; the round loop itself is not unrolled, to keep the code
// small.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so a warp's
// loads of a row coalesce; len (B,) int32, each in [0, max_len] (the wrapper
// checks); out (32, B) uint8, the first 4 lanes little-endian.
#include "fd_common.cuh"

#define KECCAK_RATE 136

__device__ __constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t keccak_rotl(uint64_t v, int n) {
  return n ? (v << n) | (v >> (64 - n)) : v;
}

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
  // rotation offsets, lane index x + 5 y (the JAX package's _ROT)
  constexpr int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                           25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint64_t d = c[(x + 4) % 5] ^ keccak_rotl(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
    }
#pragma unroll
    for (int x = 0; x < 5; x++)
#pragma unroll
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = keccak_rotl(a[x + 5 * y], ROT[x + 5 * y]);
#pragma unroll
    for (int i = 0; i < 25; i++)
      a[i] = b[i] ^ (~b[(i + 1) % 5 + 5 * (i / 5)] & b[(i + 2) % 5 + 5 * (i / 5)]);
    a[0] ^= KECCAK_RC[r];
  }
}

__global__ void __launch_bounds__(32)
keccak256_msg_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len,
                     uint8_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint32_t n = (uint32_t)len[lane];
  const uint32_t final_block = n / KECCAK_RATE;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0;
  for (uint32_t bi = 0; bi <= final_block; bi++) {
    const uint32_t base = bi * KECCAK_RATE;
#pragma unroll
    for (int i = 0; i < KECCAK_RATE / 8; i++) {
      uint64_t x = 0;
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const uint32_t pos = base + 8 * i + k;
        const uint64_t byte = pos < n ? (uint64_t)__ldg(msg + (int64_t)pos * B + lane)
                                      : (pos == n ? 0x01ull : 0ull);
        x |= byte << (8 * k);
      }
      a[i] ^= x;
    }
    if (bi == final_block) a[KECCAK_RATE / 8 - 1] ^= 0x80ull << 56;
    keccak_f(a);
  }
#pragma unroll
  for (int i = 0; i < 32; i++)
    out[(int64_t)i * B + lane] = (uint8_t)(a[i >> 3] >> (8 * (i & 7)));
}

FD_EXPORT int fd_keccak256_msg(const void* msg, const void* len, void* out, int64_t B,
                               int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  keccak256_msg_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
