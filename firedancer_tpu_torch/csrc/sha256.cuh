// SHA-256's constants and the 32-byte row loads and stores, shared by K4
// (csrc/sha256_iter32.cu) and K14/K15 (csrc/sha256_msg.cu).  The plain
// PyTorch twin is ops/sha256.py (_compress).
#pragma once

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

__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// 8 big-endian words from 32 byte rows of one lane.
__device__ __forceinline__ void sha256_load_words32(const uint8_t* __restrict__ rows,
                                                    int64_t B, int64_t lane, uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; k++)
      v = (v << 8) | (uint32_t)__ldg(rows + (int64_t)(4 * i + k) * B + lane);
    w[i] = v;
  }
}

// The 8 state words as 32 big-endian byte rows of one lane.
__device__ __forceinline__ void sha256_store_digest(uint8_t* __restrict__ out, int64_t B,
                                                    int64_t lane, const uint32_t st[8]) {
#pragma unroll
  for (int i = 0; i < 32; i++)
    out[(int64_t)i * B + lane] = (uint8_t)(st[i >> 2] >> (24 - 8 * (i & 3)));
}
