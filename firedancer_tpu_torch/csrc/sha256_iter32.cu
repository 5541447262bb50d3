// K4 sha256_iter32: n-fold iterated SHA-256 of B independent 32-byte
// states (the PoH hash chain, fd_poh_append), each chain on a pair of warps.
//
// Replaces: firedancer_tpu/ops/sha256.py:171 sha256_iter32 (with
// _iter32_block :158 and _compress_block :55), the PoH lane of the serving
// step (parallel/serve.py:176) and of runtime/poh.py:106 verify_segments_tpu.
//
// Bound: the chain.  Hash k + 1 reads hash k, so a chain never splits
// across hashes, and its time is n x (the time of one compression on the
// warp that carries it), whatever B is.  One chain a thread put the whole
// compression on that warp: ~1,320 32-bit instructions by hand (48
// schedule steps x 10, 64 rounds x 13, 8 final adds), issued by one
// scheduler whose 16 INT32 lanes take a warp instruction every two
// clocks, so the time was flat in B.  More chains a warp or a thread only
// add to that warp's stream.
//
// Design: 32 chains a block of two warps, which land on two schedulers.
//   - warp 0, the round warp, runs the 64 rounds of every hash.  Words 0-7
//     of the message are the previous digest, already in its registers;
//     words 8-15 are the constant pad (0x80000000, six zeros, 256) and fold
//     into the round constants; W16..W63, each with its K added, come from
//     shared memory as four LDS.128 a chunk of 16.  The IV's rounds and the
//     final add fold at compile time (the round constants are literals).
//     It publishes each digest to shared memory and arrives on BAR_DIGEST.
//   - warp 1, the schedule warp, waits on BAR_DIGEST, expands W16..W63
//     from the digest and the pad (sigma0 and sigma1 of the pad words and
//     the constant W[t-16] and W[t-7] terms fold), and writes W + K in
//     three chunks of 16 words, arriving on BAR_CHUNK + c after each.  So
//     it expands hash k + 1's first chunk while the round warp runs hash
//     k + 1's rounds 0-15, which need no schedule word.
//   - the round warp waits on BAR_CHUNK + c before rounds 16c + 16.
// Named barriers (bar.arrive by the producer, bar.sync by the consumer, 64
// threads each) carry the shared-memory writes across; every buffer is
// written again only after its reader has arrived on the barrier that
// follows its last read, so one copy of each suffices.  Lanes past B read
// the batch's last chain, take part in every barrier and store nothing.
//
// SASS (nvcc 12.8, sm_90a; cuobjdump, counted by python -m
// firedancer_tpu_torch.utils.sass), instructions a hash in each loop:
//   - one chain a thread: 1,345 (SHF 636, LOP3 344, IADD3 226, IMAD 103,
//     VIADD 25); of the 672 rotates and shifts the two Sigmas and the 48
//     schedule steps take, the IV and the pad words folded 36; longest
//     chain of dependent instructions 267;
//   - here, the round warp: 981 (SHF 378, LOP3 254, IADD3 195, IMAD 108,
//     VIADD 23, LDS 12, BAR 4, STS 2): round 0's Sigmas on the IV fold
//     (384 - 6 SHF); longest dependent chain 194;
//   - the schedule warp: 499 (SHF 258 of 288, LOP3 86, VIADD 49, IADD3
//     44, IMAD 39, STS 12).
// The round warp's stream is ~15 instructions a round, six of them the
// Sigmas' rotates, most on the INT32 pipe, and an H100 issues it at
// 1.98 clocks an instruction (chip_smoke.py phase 8), about that pipe's 2:
// the round warp's issue, not the schedule, is now what a hash costs.
// Two adds a round forced onto IMAD (the FMA pipe), or one rotate of each
// Sigma as IMAD.HI + IMAD, ran slower on an H100 (the IMAD's latency lies
// on the round's chain), so ptxas's own pipe choice stays.
//
// Layout (the JAX package's): in/out (32, B) uint8 row-major, byte i of
// chain j at i * B + j, so neighbouring threads read neighbouring bytes.
// n is a runtime argument; n = 0 copies the input.
#include "sha256.cuh"

#define ITER_CHAINS 32                 // chains a block: lane j of each warp
#define ITER_THREADS (2 * ITER_CHAINS)
#define BAR_DIGEST 1                   // round warp -> schedule warp
#define BAR_CHUNK 2                    // 2, 3, 4: W16..31, W32..47, W48..63

// The round constants as literals, so every constant term folds.
#define K4_K {                                                                        \
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,    \
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,    \
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,    \
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,    \
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,    \
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,    \
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,    \
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,    \
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,    \
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,    \
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u}
#define K4_IV {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, \
               0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u}
// words 8-15 of a 32-byte message's only block
#define K4_PAD {0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 256u}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(ITER_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(ITER_THREADS) : "memory");
}

__device__ __forceinline__ uint32_t pick_word(const uint4& q, int i) {
  return i == 0 ? q.x : (i == 1 ? q.y : (i == 2 ? q.z : q.w));
}

// The round warp: s <- sha256(s), n times; the digest goes to dig_s before
// each hash and W + K comes from wk_s.
__device__ __forceinline__ void iter32_rounds(uint32_t s[8], int64_t n, int j,
                                              uint4 (*dig_s)[ITER_CHAINS],
                                              const uint4 (*wk_s)[ITER_CHAINS]) {
  const uint32_t K[64] = K4_K;
  const uint32_t IV[8] = K4_IV;
  const uint32_t PAD[8] = K4_PAD;
#pragma unroll 1
  for (int64_t it = 0; it < n; it++) {
    dig_s[0][j] = make_uint4(s[0], s[1], s[2], s[3]);
    dig_s[1][j] = make_uint4(s[4], s[5], s[6], s[7]);
    bar_arrive(BAR_DIGEST);
    uint32_t a = IV[0], b = IV[1], c = IV[2], d = IV[3];
    uint32_t e = IV[4], f = IV[5], g = IV[6], h = IV[7];
    uint4 q[4];
#pragma unroll
    for (int t = 0; t < 64; t++) {
      uint32_t wk;
      if (t < 8) {
        wk = s[t] + K[t];
      } else if (t < 16) {
        wk = PAD[t - 8] + K[t];
      } else {
        if ((t & 15) == 0) {
          bar_sync(BAR_CHUNK + (t >> 4) - 1);
#pragma unroll
          for (int i = 0; i < 4; i++) q[i] = wk_s[((t - 16) >> 2) + i][j];
        }
        wk = pick_word(q[(t >> 2) & 3], t & 3);
      }
      // h + W + K and d + h + W + K do not wait for e, so the next e is
      // one three-input add after Sigma1 and ch (three dependent steps a
      // round, where e = d + t1 took four), at one add more a round
      const uint32_t hw = h + wk, dhw = d + hw;
      const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = hw + S1 + ch;
      const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      h = g;
      g = f;
      f = e;
      e = dhw + S1 + ch;
      d = c;
      c = b;
      b = a;
      a = t1 + S0 + maj;
    }
    s[0] = IV[0] + a; s[1] = IV[1] + b; s[2] = IV[2] + c; s[3] = IV[3] + d;
    s[4] = IV[4] + e; s[5] = IV[5] + f; s[6] = IV[6] + g; s[7] = IV[7] + h;
  }
}

// The schedule warp: n times, W16..W63 + K from the published digest.
__device__ __forceinline__ void iter32_schedule(int64_t n, int j,
                                                const uint4 (*dig_s)[ITER_CHAINS],
                                                uint4 (*wk_s)[ITER_CHAINS]) {
  const uint32_t K[64] = K4_K;
  const uint32_t PAD[8] = K4_PAD;
#pragma unroll 1
  for (int64_t it = 0; it < n; it++) {
    bar_sync(BAR_DIGEST);
    const uint4 d0 = dig_s[0][j], d1 = dig_s[1][j];
    uint32_t w[16] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int i = 0; i < 8; i++) w[8 + i] = PAD[i];
#pragma unroll
    for (int ch = 0; ch < 3; ch++) {
#pragma unroll
      for (int qi = 0; qi < 4; qi++) {
        uint32_t o[4];
#pragma unroll
        for (int r = 0; r < 4; r++) {
          const int t = 16 + 16 * ch + 4 * qi + r;
          const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
          const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
          const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
          const uint32_t wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
          w[t & 15] = wt;
          o[r] = wt + K[t];
        }
        wk_s[4 * ch + qi][j] = make_uint4(o[0], o[1], o[2], o[3]);
      }
      bar_arrive(BAR_CHUNK + ch);
    }
  }
}

__global__ void __launch_bounds__(ITER_THREADS)
sha256_iter32_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int64_t B, int64_t n) {
  __shared__ uint4 dig_s[2][ITER_CHAINS];   // digest words 4i .. 4i+3 of chain j
  __shared__ uint4 wk_s[12][ITER_CHAINS];   // W + K of words 16 + 4i .. 16 + 4i + 3
  const int j = threadIdx.x & 31;
  const int64_t chain = (int64_t)blockIdx.x * ITER_CHAINS + j;
  if (threadIdx.x < 32) {
    const int64_t lane = chain < B ? chain : B - 1;
    uint32_t s[8];
    sha256_load_words32(in, B, lane, s);
    iter32_rounds(s, n, j, dig_s, wk_s);
    if (chain < B) sha256_store_digest(out, B, chain, s);
  } else {
    iter32_schedule(n, j, dig_s, wk_s);
  }
}

FD_EXPORT int fd_sha256_iter32(const void* in, void* out, int64_t B, int64_t n,
                               int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int64_t blocks = (B + ITER_CHAINS - 1) / ITER_CHAINS;
  sha256_iter32_kernel<<<(unsigned)blocks, ITER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, B, n);
  return (int)cudaGetLastError();
}
