// K4 sha256_iter32: n-fold iterated SHA-256 of B independent 32-byte
// states (the PoH hash chain, fd_poh_append), one chain per thread.
//
// Replaces: firedancer_tpu/ops/sha256.py:171 sha256_iter32 (with
// _iter32_block :158 and _compress_block :55), the PoH lane of the serving
// step (parallel/serve.py:176) and of runtime/poh.py:106 verify_segments_tpu.
//
// Bound: the dependent chain.  A chain's hashes are strictly serial (hash
// k + 1 reads hash k), so one chain can never be split across threads; a
// compression is 64 dependent rounds of ~5 instructions on the critical
// path each.  At B = 4,096 chains there are 128 warps, under one per SM,
// so the kernel is latency-bound: time ~ n x (one compression's latency),
// flat in B up to several warps per SM.  Throughput grows only with more
// chains, or with more independent work per thread (interleaving 2-4
// chains per thread for ILP), which is later work.  The operations bound
// counts ~1,320 32-bit instructions per compression (48 schedule steps x
// 10: two 3-term sigma = 2 SHF + 1 SHR + 1 LOP3 each, 2 IADD3; 64 rounds x
// 13: Sigma1/Sigma0 = 3 SHF + 1 LOP3 each, ch and maj 1 LOP3 each, 3 IADD3
// for t1, e and a; 8 final adds) before constant folding.
//
// Design: the state lives in 8 registers; each iteration compresses
// state || the constant pad block (words 8-15 = 0x80000000, 0 x 6, 256), so
// the first 16 schedule words need no loads and the compiler folds the
// pad's terms; K lives in __constant__; blocks of 32 threads spread the
// warps over every SM.
//
// Layout (the JAX package's): in/out (32, B) uint8 row-major, byte i of
// chain j at i * B + j, so neighbouring threads read neighbouring bytes.
// n is a runtime argument; n = 0 copies the input.
#include "fd_common.cuh"

__device__ __constant__ uint32_t SHA256_K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// s <- sha256(s) for a 32-byte message s (8 big-endian words).
__device__ __forceinline__ void sha256_iter32_once(uint32_t s[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = s[i];
  w[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; i++) w[i] = 0u;
  w[15] = 256u;
  uint32_t a = 0x6A09E667u, b = 0xBB67AE85u, c = 0x3C6EF372u, d = 0xA54FF53Au;
  uint32_t e = 0x510E527Fu, f = 0x9B05688Cu, g = 0x1F83D9ABu, h = 0x5BE0CD19u;
#pragma unroll
  for (int t = 0; t < 64; t++) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + SHA256_K[t] + wt;
    const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  s[0] = 0x6A09E667u + a; s[1] = 0xBB67AE85u + b;
  s[2] = 0x3C6EF372u + c; s[3] = 0xA54FF53Au + d;
  s[4] = 0x510E527Fu + e; s[5] = 0x9B05688Cu + f;
  s[6] = 0x1F83D9ABu + g; s[7] = 0x5BE0CD19u + h;
}

__global__ void __launch_bounds__(32)
sha256_iter32_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int64_t B, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; k++)
      v = (v << 8) | (uint32_t)__ldg(in + (int64_t)(4 * i + k) * B + lane);
    s[i] = v;
  }
  for (int64_t it = 0; it < n; it++) sha256_iter32_once(s);
#pragma unroll
  for (int i = 0; i < 32; i++)
    out[(int64_t)i * B + lane] = (uint8_t)(s[i >> 2] >> (24 - 8 * (i & 3)));
}

FD_EXPORT int fd_sha256_iter32(const void* in, void* out, int64_t B, int64_t n,
                               int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  sha256_iter32_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, B, n);
  return (int)cudaGetLastError();
}
