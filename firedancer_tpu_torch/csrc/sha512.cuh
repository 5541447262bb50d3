// SHA-512 of one variable-length message per thread, in native uint64.
// The message bytes come from a source functor `src(pos)` (pos < len), so
// the verify kernel hashes R || A || msg straight out of its three input
// arrays with no concatenation.  A lane runs only its own blocks,
// (len + 17 + 127) / 128 of them.  The plain PyTorch twin is ops/sha512.py.
#pragma once

#include "fd_common.cuh"

__device__ __constant__ uint64_t SHA512_K[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
    0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
    0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
    0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
    0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
    0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
    0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
    0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
    0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
    0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
    0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
    0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
    0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
    0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
};

__device__ __forceinline__ uint64_t sha_rotr(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ void sha512_compress(uint64_t st[8], uint64_t w[16]) {
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    uint64_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      uint64_t s0 = sha_rotr(w15, 1) ^ sha_rotr(w15, 8) ^ (w15 >> 7);
      uint64_t s1 = sha_rotr(w2, 19) ^ sha_rotr(w2, 61) ^ (w2 >> 6);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    uint64_t S1 = sha_rotr(e, 14) ^ sha_rotr(e, 18) ^ sha_rotr(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = h + S1 + ch + SHA512_K[t] + wt;
    uint64_t S0 = sha_rotr(a, 28) ^ sha_rotr(a, 34) ^ sha_rotr(a, 39);
    uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Digest state words (big-endian words of the 64-byte digest) of the
// len-byte message src(0..len-1).
template <class Src>
__device__ __forceinline__ void sha512_lane(const Src& src, uint32_t len,
                                            uint64_t st[8]) {
  st[0] = 0x6A09E667F3BCC908ull; st[1] = 0xBB67AE8584CAA73Bull;
  st[2] = 0x3C6EF372FE94F82Bull; st[3] = 0xA54FF53A5F1D36F1ull;
  st[4] = 0x510E527FADE682D1ull; st[5] = 0x9B05688C2B3E6C1Full;
  st[6] = 0x1F83D9ABFB41BD6Bull; st[7] = 0x5BE0CD19137E2179ull;
  const uint32_t nb = (len + 17 + 127) / 128;
  for (uint32_t blk = 0; blk < nb; blk++) {
    uint64_t w[16];
    const uint32_t base = blk * 128;
#pragma unroll
    for (int t = 0; t < 16; t++) {
      uint64_t x = 0;
#pragma unroll
      for (int b = 0; b < 8; b++) {
        const uint32_t pos = base + 8 * t + b;
        uint32_t byte = pos < len ? (uint32_t)src(pos) : (pos == len ? 0x80u : 0u);
        x = (x << 8) | byte;
      }
      w[t] = x;
    }
    if (blk == nb - 1) w[15] = (uint64_t)len * 8;  // 128-bit length, high word 0
    sha512_compress(st, w);
  }
}

// The verify kernels' message source: R || A || msg read in place from
// sig (64, B), pubkey (32, B) and msg (max_len, B) byte rows, with no
// concatenation (csrc/verify.cu, csrc/verify_cached.cu).
struct VerifySrc {
  const uint8_t* __restrict__ sig;
  const uint8_t* __restrict__ pk;
  const uint8_t* __restrict__ msg;
  int64_t B;
  int64_t lane;
  __device__ __forceinline__ uint8_t operator()(uint32_t pos) const {
    if (pos < 32) return __ldg(sig + (int64_t)pos * B + lane);
    if (pos < 64) return __ldg(pk + (int64_t)(pos - 32) * B + lane);
    return __ldg(msg + (int64_t)(pos - 64) * B + lane);
  }
};
