// K18 chacha20_keystream: B independent 64-byte ChaCha20 blocks (RFC 7539),
// one block per thread.
//
// Replaces: firedancer_tpu/ops/chacha20.py:65 chacha20_keystream.
//
// Bound: operations at large B, the dependent chain at small B.  A block is
// 10 double rounds of 8 quarter rounds, 12 32-bit instructions each, plus 16
// final adds (chip_smoke.py CHACHA20_OPS_PER_BLOCK), against 112 bytes moved
// (key, index, nonce in; 64 bytes out): far above the card's ops:byte
// balance.  A thread's rounds are a serial chain, so until every SM holds
// enough warps to hide the chain, the latency of one block sets the time.
//
// Design: the 16-word state lives in registers; the TPU version's (16, B)
// state planes become one thread's registers.  A null nonce pointer means
// the zero nonce (the RNG's form).  Blocks of 32 threads spread the warps
// over every SM.
//
// Layout (the JAX package's): key (32, B) uint8 row-major, idx (B,) int32
// (the u32 bit pattern), nonce (12, B) uint8 or null; out (64, B) uint8,
// words little-endian.
#include "fd_common.cuh"

__device__ __forceinline__ uint32_t cc_rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

#define CC_QR(a, b, c, d)                 \
  do {                                    \
    s[a] += s[b]; s[d] = cc_rotl(s[d] ^ s[a], 16); \
    s[c] += s[d]; s[b] = cc_rotl(s[b] ^ s[c], 12); \
    s[a] += s[b]; s[d] = cc_rotl(s[d] ^ s[a], 8);  \
    s[c] += s[d]; s[b] = cc_rotl(s[b] ^ s[c], 7);  \
  } while (0)

// the little-endian word of bytes 4 i .. 4 i + 3 of one lane's rows
__device__ __forceinline__ uint32_t cc_word(const uint8_t* __restrict__ rows, int64_t B,
                                            int64_t lane, int i) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; k++)
    v |= (uint32_t)__ldg(rows + (int64_t)(4 * i + k) * B + lane) << (8 * k);
  return v;
}

__global__ void __launch_bounds__(32)
chacha20_keystream_kernel(const uint8_t* __restrict__ key, const int32_t* __restrict__ idx,
                          const uint8_t* __restrict__ nonce, uint8_t* __restrict__ out,
                          int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t init[16], s[16];
  init[0] = 0x61707865u;  // "expand 32-byte k"
  init[1] = 0x3320646Eu;
  init[2] = 0x79622D32u;
  init[3] = 0x6B206574u;
#pragma unroll
  for (int i = 0; i < 8; i++) init[4 + i] = cc_word(key, B, lane, i);
  init[12] = (uint32_t)idx[lane];
#pragma unroll
  for (int i = 0; i < 3; i++) init[13 + i] = nonce ? cc_word(nonce, B, lane, i) : 0u;
#pragma unroll
  for (int i = 0; i < 16; i++) s[i] = init[i];
#pragma unroll 1
  for (int r = 0; r < 10; r++) {
    CC_QR(0, 4, 8, 12);
    CC_QR(1, 5, 9, 13);
    CC_QR(2, 6, 10, 14);
    CC_QR(3, 7, 11, 15);
    CC_QR(0, 5, 10, 15);
    CC_QR(1, 6, 11, 12);
    CC_QR(2, 7, 8, 13);
    CC_QR(3, 4, 9, 14);
  }
#pragma unroll
  for (int i = 0; i < 16; i++) {
    const uint32_t v = s[i] + init[i];
#pragma unroll
    for (int k = 0; k < 4; k++) out[(int64_t)(4 * i + k) * B + lane] = (uint8_t)(v >> (8 * k));
  }
}

FD_EXPORT int fd_chacha20_keystream(const void* key, const void* idx, const void* nonce,
                                    void* out, int64_t B, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  chacha20_keystream_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)key, (const int32_t*)idx, (const uint8_t*)nonce, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
