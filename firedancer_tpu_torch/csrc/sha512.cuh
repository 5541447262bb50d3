// SHA-512 in native uint64, two ways:
//   - sha512_lane: one variable-length message a thread, its bytes from a
//     source functor `src(pos)` (pos < len), so K1 and K6 (csrc/verify.cu,
//     csrc/verify_cached.cu) hash R || A || msg straight out of their three
//     input arrays with no concatenation; a lane runs only its own blocks,
//     (len + 17 + 127) / 128 of them;
//   - the warp pair (sha512_message_warp, sha512_round_warp): 32 messages
//     a two-warp block, for K10 phase_hash (csrc/verify_split.cu) and K3
//     sha512_batch (csrc/sha512_batch.cu), each with its own row source.
// The plain PyTorch twin is ops/sha512.py.
#pragma once

#include "msg_tile.cuh"

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

__device__ __forceinline__ void sha512_init(uint64_t st[8]) {
  st[0] = 0x6A09E667F3BCC908ull; st[1] = 0xBB67AE8584CAA73Bull;
  st[2] = 0x3C6EF372FE94F82Bull; st[3] = 0xA54FF53A5F1D36F1ull;
  st[4] = 0x510E527FADE682D1ull; st[5] = 0x9B05688C2B3E6C1Full;
  st[6] = 0x1F83D9ABFB41BD6Bull; st[7] = 0x5BE0CD19137E2179ull;
}

// Digest state words (big-endian words of the 64-byte digest) of the
// len-byte message src(0..len-1).
template <class Src>
__device__ __forceinline__ void sha512_lane(const Src& src, uint32_t len,
                                            uint64_t st[8]) {
  sha512_init(st);
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

// ---- The warp pair: 32 messages a two-warp block --------------------------
//
// One message a thread on one warp issues, a SHA block, 128 single-byte
// loads (each behind the source's branch and the pad's compares), the 64
// schedule steps and the 80 rounds, the loads' latency in series (K10's
// parent: 6,589 SASS instructions a SHA block at ~6 clocks each).  Here a
// block is two warps for 32 messages:
//   - the message warp (warp 1) loads the block's row segments (32
//     contiguous bytes a row, uint4 loads, the next SHA block's during this
//     one's schedule) into a byte tile in shared memory, turns them into
//     each lane's words (PRMT), pads, expands the schedule and hands W + K
//     over in chunks of 16 rounds (named barriers, two buffers);
//   - the round warp (warp 0) runs only the rounds and the feed-forward;
//     the kernel then reduces or stores the state.
// Both warps loop over the chunks (16 rounds or schedule steps a loop
// body): unrolled over all 80, their SHA-block loops were 2,484 and 2,589
// SASS instructions (~40 KB of code each) and ran slower on an H100 at
// every shape measured, with the same instructions issued (instruction
// fetch is the suspect; not profiled).  SASS (cuobjdump, nvcc 12.8, K10's
// build): the round warp's chunk loop 504 instructions, its block loop 551
// (one chunk and the feed-forward); the message warp's chunk loop 414, its
// block loop 1,318 (the tile, the words, the pad, chunk 0 and one chunk).
// So each warp issues ~2,560 instructions a SHA block, side by side.  The
// shared memory: W + K 40,960 bytes and the tile 4,224, so 4 blocks an SM.
//
// Where the rows come from is a row source (Sha512Rows for one (max_len,
// B) buffer, Sha512RowsRAM for K10's R || A || msg), a template argument:
//   row(p, B)          row p's byte of lane 0 (the narrow path adds the lane);
//   shift(col)         the same source with every base moved by col bytes
//                      (the wide path: this thread's column);
//   group(row0, i, s)  of a shifted source, the first byte of row row0 +
//                      16 i (row0 a multiple of 128, s = 16 B: 16 rows).
// A wide row group (16 rows) never straddles two of a source's arrays.

#define SHA512_LANES 32  // messages a two-warp block
#define SHA512_THREADS (2 * SHA512_LANES)
#define SHA512_CHUNKS 5  // W + K handed over in chunks of 16 rounds
#define SHA512_TILE_STRIDE 132  // words of a lane quad's column of the byte tile (128 rows + 4)

// Named barriers (barrier 0 is __syncthreads'): the message warp arrives on
// SHA512_BAR_WK(buf, c) once chunk c of buffer buf holds W + K, and the
// round warp on SHA512_BAR_FREE(buf) once it has read the buffer.
#define SHA512_BAR_WK(buf, c) (1 + SHA512_CHUNKS * (buf) + (c))
#define SHA512_BAR_FREE(buf) (1 + 2 * SHA512_CHUNKS + (buf))

__device__ __forceinline__ void sha512_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(SHA512_THREADS) : "memory");
}

__device__ __forceinline__ void sha512_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(SHA512_THREADS) : "memory");
}

// One (max_len, B) byte buffer (K3).
struct Sha512Rows {
  const uint8_t* __restrict__ msg;
  __device__ __forceinline__ Sha512Rows shift(int64_t col) const { return {msg + col}; }
  __device__ __forceinline__ const uint8_t* row(uint32_t p, int64_t B) const {
    return msg + (int64_t)p * B;
  }
  __device__ __forceinline__ const uint8_t* group(uint32_t row0, int i, int64_t step) const {
    return msg + (int64_t)(row0 >> 4) * step + i * step;
  }
};

// R || A || msg read in place (K10): sig rows 0-31, pubkey rows 32-63, then
// msg rows.  The first SHA block's row groups are sig (i = 0, 1), pubkey
// (2, 3) and msg (4-7), a later one's all msg.
struct Sha512RowsRAM {
  const uint8_t* __restrict__ sig;
  const uint8_t* __restrict__ pk;
  const uint8_t* __restrict__ msg;
  __device__ __forceinline__ Sha512RowsRAM shift(int64_t col) const {
    return {sig + col, pk + col, msg + col};
  }
  __device__ __forceinline__ const uint8_t* row(uint32_t p, int64_t B) const {
    return p < 32 ? sig + (int64_t)p * B
                  : (p < 64 ? pk + (int64_t)(p - 32) * B : msg + (int64_t)(p - 64) * B);
  }
  __device__ __forceinline__ const uint8_t* group(uint32_t row0, int i, int64_t step) const {
    const uint8_t* first = i < 2 ? sig + i * step : (i < 4 ? pk + (i - 2) * step : msg + (i - 4) * step);
    const uint8_t* later = msg + (row0 == 0 ? 0 : (int64_t)((row0 - 64) >> 4) * step);
    return row0 == 0 ? first : later + i * step;
  }
};

// The wide path's row segments of one SHA block, rows row0 .. row0 + 127
// below len_max: v[i] = the 16 bytes of row row0 + 16 i + l / 2 at this
// thread's lanes, from cols = the source shifted to this thread's column.
template <class Src>
__device__ __forceinline__ void sha512_load_rows(const Src& cols, int64_t B, int l,
                                                 uint32_t row0, uint32_t len_max, uint4 v[8]) {
  const int64_t step = 16 * B;  // 16 rows
#pragma unroll
  for (int i = 0; i < 8; i++)
    if (row0 + 16 * i + (l >> 1) < len_max)
      v[i] = __ldg(reinterpret_cast<const uint4*>(cols.group(row0, i, step)));
}

// The message warp, thread l for lane l of the block: for each of the
// block's SHA blocks, the 128 rows' 32 bytes of the block's lanes into the
// byte tile (tile[q][r]: row r of lanes 4q .. 4q+3), then lane l's 16
// big-endian words out of it (two conflict-free LDS.128 and six PRMT a
// word), the 0x80 pad and the bit length, the 64 scheduled words, and W + K
// for the 80 rounds into wk in five chunks of 16 rounds.  Rows at or past
// the block's longest message are not read.  `wide`: the batch is a
// multiple of 16 lanes and the rows 16-byte aligned, so a full block's
// row segments load as uint4 (16 rows a warp instruction), the next SHA
// block's while this one's schedule runs; otherwise (and in a ragged last
// block) each thread loads its own lane's byte of each row.
template <class Src>
__device__ __forceinline__ void sha512_message_warp(
    const Src& src, int64_t B, int64_t base, int64_t lane, int l, uint32_t len,
    uint32_t len_max, uint32_t nb, uint32_t nb_max, bool wide,
    uint32_t (*tile)[SHA512_TILE_STRIDE], ulonglong2 (*wk)[SHA512_CHUNKS * 8][SHA512_LANES]) {
  const bool full = wide && base + SHA512_LANES <= B;
  const uint32_t sel = tile_sel(l);
  const int q = l >> 2, q0 = 4 * (l & 1);
  const Src cols = src.shift((int64_t)(l >> 1) * B + base + 16 * (l & 1));
  uint4 next[8];  // the wide path's rows of the next SHA block, loaded a block ahead
  if (full) sha512_load_rows(cols, B, l, 0, len_max, next);
#pragma unroll 1
  for (uint32_t blk = 0; blk < nb_max; blk++) {
    const int buf = blk & 1;
    const uint32_t row0 = blk * 128;
    if (full) {
#pragma unroll
      for (int i = 0; i < 8; i++) {
        const int r = 16 * i + (l >> 1);
        if (row0 + r < len_max) {
          tile[q0][r] = next[i].x;
          tile[q0 + 1][r] = next[i].y;
          tile[q0 + 2][r] = next[i].z;
          tile[q0 + 3][r] = next[i].w;
        }
      }
    } else {
      uint8_t* col_b = reinterpret_cast<uint8_t*>(&tile[q][0]) + (l & 3);
#pragma unroll 8
      for (int r = 0; r < 128; r++)
        if (row0 + r < len_max) col_b[4 * r] = __ldg(src.row(row0 + r, B) + lane);
    }
    __syncwarp();
    // bytes at or past len: 0x80 at len (in word tb), zeros after
    const int rem = (int)len - (int)row0, tb = rem >> 3, ob = rem & 7;
    const uint64_t keep = ob == 0 ? 0ull : ~0ull << (64 - 8 * ob);
    const uint64_t pad = 0x80ull << (56 - 8 * ob);
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++) {
      const uint4 hi = *reinterpret_cast<const uint4*>(&tile[q][8 * t]);
      const uint4 lo = *reinterpret_cast<const uint4*>(&tile[q][8 * t + 4]);
      const uint64_t x = ((uint64_t)tile_gather_be(hi, sel) << 32) | tile_gather_be(lo, sel);
      w[t] = t < tb ? x : (t == tb ? (x & keep) | pad : 0ull);
    }
    __syncwarp();  // the tile is read before the next block's rows land in it
    if (full && blk + 1 < nb_max) sha512_load_rows(cols, B, l, row0 + 128, len_max, next);
    if (blk + 1 == nb) w[15] = (uint64_t)len * 8;  // 128-bit length, high word 0
    if (blk >= 2) sha512_bar_sync(SHA512_BAR_FREE(buf));
#pragma unroll
    for (int i = 0; i < 8; i++)
      wk[buf][i][l] = make_ulonglong2(w[2 * i] + SHA512_K[2 * i],
                                      w[2 * i + 1] + SHA512_K[2 * i + 1]);
    sha512_bar_arrive(SHA512_BAR_WK(buf, 0));
    // chunks 1-4, one loop body (word 16 c + j replaces w[j])
#pragma unroll 1
    for (int c = 1; c < SHA512_CHUNKS; c++) {
#pragma unroll
      for (int i = 0; i < 8; i++) {
        uint64_t o2[2];
#pragma unroll
        for (int h = 0; h < 2; h++) {
          const int j = 2 * i + h;
          const uint64_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
          const uint64_t s0 = sha_rotr(w15, 1) ^ sha_rotr(w15, 8) ^ (w15 >> 7);
          const uint64_t s1 = sha_rotr(w2, 19) ^ sha_rotr(w2, 61) ^ (w2 >> 6);
          w[j] += s0 + w[(j + 9) & 15] + s1;
          o2[h] = w[j] + SHA512_K[16 * c + j];
        }
        wk[buf][8 * c + i][l] = make_ulonglong2(o2[0], o2[1]);
      }
      sha512_bar_arrive(SHA512_BAR_WK(buf, c));
    }
  }
}

// The round warp, thread l for lane l: the 80 rounds of each SHA block on
// W + K from wk (one LDS.128 for two rounds), the feed-forward while the
// lane's message lasts (a lane whose message has ended keeps its state).
__device__ __forceinline__ void sha512_round_warp(
    uint32_t nb, uint32_t nb_max, int l, uint64_t st[8],
    const ulonglong2 (*wk)[SHA512_CHUNKS * 8][SHA512_LANES]) {
  sha512_init(st);
#pragma unroll 1
  for (uint32_t blk = 0; blk < nb_max; blk++) {
    const int buf = blk & 1;
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 1
    for (int ch = 0; ch < SHA512_CHUNKS; ch++) {
      sha512_bar_sync(SHA512_BAR_WK(buf, ch));
#pragma unroll
      for (int i = 0; i < 16; i++) {
        const ulonglong2 pair = wk[buf][8 * ch + (i >> 1)][l];
        const uint64_t wkt = (i & 1) ? pair.y : pair.x;
        // h + W + K and d + h + W + K do not wait for e (K4's form)
        const uint64_t hw = h + wkt, dhw = d + hw;
        const uint64_t S1 = sha_rotr(e, 14) ^ sha_rotr(e, 18) ^ sha_rotr(e, 41);
        const uint64_t chv = (e & f) ^ (~e & g);
        const uint64_t t1 = hw + S1 + chv;
        const uint64_t S0 = sha_rotr(a, 28) ^ sha_rotr(a, 34) ^ sha_rotr(a, 39);
        const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        h = g;
        g = f;
        f = e;
        e = dhw + S1 + chv;
        d = c;
        c = b;
        b = a;
        a = t1 + S0 + maj;
      }
    }
    if (blk + 2 < nb_max) sha512_bar_arrive(SHA512_BAR_FREE(buf));
    if (blk < nb) {
      st[0] += a; st[1] += b; st[2] += c; st[3] += d;
      st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
  }
}
