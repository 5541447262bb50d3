// K14 sha256_msg: batched SHA-256 of variable-length messages, 32 messages
// a two-warp block; K15 sha256_mix32: sha256(state || mixin) of 32-byte
// rows, the PoH mixin step, on the same warp pair.
//
// Replaces: firedancer_tpu/ops/sha256.py:122 sha256_msg (with sha256_pad
// :89, _compress_block :57 and _state_to_bytes :112) and :182 sha256_mix32;
// K14 is also the hash under the merkle layers of ops/bmtree.py
// (hash_leaves_batch, _merge_layer, layers_batch, root_batch).
//
// Bound: the dependent chain.  A message's blocks are strictly serial, and
// a compression is 64 dependent rounds, so at the batches the callers give
// (a few thousand lanes, one or two warps an SM) the kernel's time is the
// longest lane's block count times what one warp issues a compression.
// The operations bound counts ~1,320 32-bit instructions per compression
// (chip_smoke.py SHA256_OPS_PER_COMPRESSION).
//
// K14's design.  One message a thread built each word from four guarded
// single-byte loads (64 a SHA block, each behind `pos < len ? ... : pos ==
// len ? 0x80 : 0`) and ran the schedule and the 64 rounds on the same
// warp, one-warp blocks: at B = 4,096, 128 warps, one an SM, the loads'
// latency in series.  Here a block is 32 messages on two warps, as K10's
// (csrc/verify_split.cu):
//   - warp 1, the message warp, loads the block's row segments (32
//     contiguous bytes a row) as uint4, 16 rows a warp instruction, the
//     next SHA block's while this one's schedule runs, into a byte tile
//     (tile[q][r]: row r of lanes 4q .. 4q+3, 68 words a quad so the
//     stores and the LDS.128 reads are conflict-free); it gathers each
//     lane's 16 big-endian words (one LDS.128 and three PRMT a word),
//     applies the pad by mask from the lane's length (0x80 at len, zeros
//     after, the 64-bit bit length in words 14-15 of the final block (len
//     + 9 + 63) / 64 - 1, which holds no message byte when len % 64 >=
//     56), expands the 48 schedule steps and hands W + K over in four
//     chunks of 16 rounds (named barriers, two buffers);
//   - warp 0, the round warp, runs only the 64 rounds (one LDS.128 for
//     four) and the feed-forward while the lane's message lasts (a lane
//     whose message has ended keeps its state), and stores the digest.
// Both warps run to the block's longest message and loop over the 16-round
// chunks (K10's unrolled loops ran slower).  Rows at or past the block's
// longest message are not read.  The wide path needs B a multiple of 16
// and the rows 16-byte aligned (ops/bmtree.py pads its lanes for it); any
// other batch or an offset view takes the narrow path: each thread loads
// its own lane's 64 bytes of the next SHA block as single bytes, a block
// ahead, and packs them with PRMT (through the tile, one byte a thread
// and no prefetch, it ran 73 us where the parent took 52 at the root
// build's 2,754 x 1,070-byte leaves on an H100).  The lanes of a ragged
// tail read the batch's last lane, take part in every barrier and store
// nothing.
//
// SASS (cuobjdump, nvcc 12.8, sm_90a; python -m
// firedancer_tpu_torch.utils.sass), the wide instantiation: the round
// warp's 16-round loop 253 instructions (SHF 96, LOP3 64, IADD3 48, IMAD
// 35, LDS 4), its block loop 289, so ~1,050 a SHA block; the message
// warp's schedule loop 195 and block loop 549 (PRMT 48, STS 24, LDS 16,
// LDG 4), ~1,130 a block.  At ~2 clocks an instruction on an H100 either
// warp takes ~2,200 clocks a SHA block.  The pad's mask sits in each
// path's word loop: in a loop of its own the block loop took 20 BSSY and
// BSYNC and the kernel 1.3x the time.  The narrow instantiation's block
// loop is 1,438 (128 LDG, 410 IMAD and 271 IADD3 of addressing).  ptxas:
// wide 74 registers and 18,560 bytes of shared memory, narrow 96 and
// 16,384; no spills.
//
// K15's design.  One state a thread loaded its 16 words as 64 single-byte
// loads, ran both compressions' schedules and rounds on one warp (32
// threads a block) and stored 32 bytes: 2,768 SASS instructions a thread.
// Here it is K14's pair of warps for 32 lanes, the rows from a row source
// (Sha256RowsMix: rows 0-31 from state, 32-63 from mixin, each 16-row
// group in one array), every length 64, so the message warp hands over
// block 1's W + K alone with no pad mask; the round warp runs block 1 on
// it, then the constant pad block from literal W + K (K15_PAD_WK), with no
// barrier and no shared memory, and on the wide path stores the digests as
// uint4 rows through the tile (mix32_store_rows) instead of 32 byte
// stores.  A block is one pair, or four once the batch gives an SM more
// than two pairs (fd_sha256_mix32).  SASS (nvcc 12.8, sm_90a; utils.sass),
// the wide one-pair instantiation: 1,776 instructions in all (SHF 580,
// LOP3 363, IADD3 273, PRMT 120, LDS 44, STS 32); the round warp's
// 16-round chunk loop 251 (four passes), block 2 unrolled on immediates,
// so ~1,900 a lane group on the round warp; the message warp's schedule
// loop 197 (three passes).  ptxas: 49 registers and 10,368 bytes of shared
// memory a pair (four pairs: 47 and 41,472), narrow 38 (44); no spills.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so byte i of
// neighbouring lanes sits at neighbouring addresses; len (B,) int32, each
// in [0, max_len] (the wrapper checks); out (32, B) uint8.  K15: state and
// mixin (32, B) uint8 -> out (32, B).
#include "msg_tile.cuh"
#include "sha256.cuh"

#define MSG_LANES 32  // K14: messages a two-warp block
#define MSG_THREADS (2 * MSG_LANES)
#define MSG_CHUNKS 4  // W + K handed over in chunks of 16 rounds

// Named barriers (barrier 0 is __syncthreads'): the message warp arrives on
// MSG_BAR_WK(buf, c) once chunk c of buffer buf holds W + K, and the round
// warp on MSG_BAR_FREE(buf) once it has read the buffer.  NT: the threads
// that meet there (a block of several warp pairs shares each barrier).
#define MSG_BAR_WK(buf, c) (1 + MSG_CHUNKS * (buf) + (c))
#define MSG_BAR_FREE(buf) (1 + 2 * MSG_CHUNKS + (buf))

template <int NT = MSG_THREADS>
__device__ __forceinline__ void msg_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(NT) : "memory");
}

template <int NT = MSG_THREADS>
__device__ __forceinline__ void msg_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(NT) : "memory");
}

// Where the message warp's rows come from, a template argument (as
// sha512.cuh's Sha512Rows): K14's one (max_len, B) buffer or K15's
// state || mixin.  A source shifted by col bytes (shift) loads
//   load_rows(B, l, row0, len_max, seg_in, v)  the wide path's row segments
//       of a SHA block (msg_tile.cuh tile_load_rows64: v[i] = row row0 +
//       16 i + l / 2, the shift being this thread's column);
//   load_bytes(B, row0, len_max, raw)  the narrow path's 64 bytes of one
//       lane (tile_load_bytes64, the shift being the lane).
// A wide row group (16 rows) never straddles two of a source's arrays.
struct Sha256Rows {
  const uint8_t* __restrict__ msg;
  __device__ __forceinline__ Sha256Rows shift(int64_t col) const { return {msg + col}; }
  __device__ __forceinline__ void load_rows(int64_t B, int l, uint32_t row0, uint32_t len_max,
                                            bool seg_in, uint4 v[4]) const {
    tile_load_rows64(msg, B, l, row0, len_max, seg_in, v);
  }
  __device__ __forceinline__ void load_bytes(int64_t B, uint32_t row0, uint32_t len_max,
                                             uint32_t raw[64]) const {
    tile_load_bytes64(msg, B, row0, len_max, raw);
  }
};

// K15's 64-byte message, state rows 0-31 then mixin rows 32-63, each (32,
// B): one SHA block (row0 = 0) whose rows all lie below len_max = 64, so
// those arguments are not read.  Row groups 0, 1 are state's, 2, 3 mixin's.
struct Sha256RowsMix {
  const uint8_t* __restrict__ state;
  const uint8_t* __restrict__ mixin;
  __device__ __forceinline__ Sha256RowsMix shift(int64_t col) const {
    return {state + col, mixin + col};
  }
  __device__ __forceinline__ void load_rows(int64_t B, int, uint32_t, uint32_t, bool seg_in,
                                            uint4 v[4]) const {
#pragma unroll
    for (int i = 0; i < 4; i++)
      if (seg_in)
        v[i] = __ldg(reinterpret_cast<const uint4*>((i < 2 ? state : mixin)
                                                    + (int64_t)(16 * (i & 1)) * B));
  }
  __device__ __forceinline__ void load_bytes(int64_t B, uint32_t, uint32_t,
                                             uint32_t raw[64]) const {
#pragma unroll
    for (int r = 0; r < 32; r++) {
      raw[r] = __ldg(state + r * B);
      raw[32 + r] = __ldg(mixin + r * B);
    }
  }
};

// The message warp, thread l for lane l of the block: for each SHA block,
// lane l's 16 words (WIDE: the block's 64 rows into the tile, then out of
// it; else the lane's own 64 bytes, loaded a block ahead, packed with
// PRMT), the pad, and W + K for the 64 rounds into wk in four chunks (word
// 16 c + j replaces w[j]).  On the wide path a half block (B an odd
// multiple of 16) loads only its first 16 lanes' segments.
template <bool WIDE, class Src, int NT = MSG_THREADS>
__device__ __forceinline__ void msg_message_warp(
    const Src& src, int64_t B, int64_t base, int64_t lane, int l,
    uint32_t len, uint32_t len_max, uint32_t nb, uint32_t nb_max,
    uint32_t (*tile)[TILE64_STRIDE], uint4 (*wk)[MSG_CHUNKS * 4][MSG_LANES]) {
  const bool seg_in = base + 16 * (l & 1) + 16 <= B;
  const uint32_t sel = tile_sel(l);
  const int q = l >> 2;
  const Src col = src.shift((int64_t)(l >> 1) * B + base + 16 * (l & 1));
  const Src own = src.shift(lane);
  uint4 next[4];     // the wide path's rows of the next SHA block, loaded a block ahead
  uint32_t raw[64];  // the narrow path's bytes of the next SHA block
  if (WIDE)
    col.load_rows(B, l, 0, len_max, seg_in, next);
  else
    own.load_bytes(B, 0, len_max, raw);
#pragma unroll 1
  for (uint32_t blk = 0; blk < nb_max; blk++) {
    const int buf = blk & 1;
    const uint32_t row0 = blk * 64;
    // bytes at or past len: 0x80 at len (in word tb), zeros after, applied
    // in each path's word loop
    const int rem = (int)len - (int)row0, tb = rem >> 2, ob = rem & 3;
    const uint32_t keep = ob == 0 ? 0u : ~0u << (32 - 8 * ob);
    const uint32_t pad = 0x80u << (24 - 8 * ob);
    uint32_t w[16];
    if (WIDE) {
      tile_store_rows64(tile, next, l, row0, len_max);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 16; t++) {
        const uint32_t x = tile_gather_be(*reinterpret_cast<const uint4*>(&tile[q][4 * t]), sel);
        w[t] = t < tb ? x : (t == tb ? (x & keep) | pad : 0u);
      }
      __syncwarp();  // the tile is read before the next block's rows land in it
      if (blk + 1 < nb_max) col.load_rows(B, l, row0 + 64, len_max, seg_in, next);
    } else {
#pragma unroll
      for (int t = 0; t < 16; t++) {  // big-endian: byte 4t in the top
        const uint32_t x = __byte_perm(__byte_perm(raw[4 * t + 3], raw[4 * t + 2], 0x0040),
                                       __byte_perm(raw[4 * t + 1], raw[4 * t], 0x0040), 0x5410);
        w[t] = t < tb ? x : (t == tb ? (x & keep) | pad : 0u);
      }
      if (blk + 1 < nb_max) own.load_bytes(B, row0 + 64, len_max, raw);
    }
    if (blk + 1 == nb) {  // the 64-bit bit length
      w[14] = len >> 29;
      w[15] = len << 3;
    }
    if (blk >= 2) msg_bar_sync<NT>(MSG_BAR_FREE(buf));
#pragma unroll
    for (int i = 0; i < 4; i++)
      wk[buf][i][l] = make_uint4(w[4 * i] + SHA256_K[4 * i], w[4 * i + 1] + SHA256_K[4 * i + 1],
                                 w[4 * i + 2] + SHA256_K[4 * i + 2],
                                 w[4 * i + 3] + SHA256_K[4 * i + 3]);
    msg_bar_arrive<NT>(MSG_BAR_WK(buf, 0));
#pragma unroll 1
    for (int c = 1; c < MSG_CHUNKS; c++) {
#pragma unroll
      for (int i = 0; i < 4; i++) {
        uint32_t o[4];
#pragma unroll
        for (int h = 0; h < 4; h++) {
          const int j = 4 * i + h;
          const uint32_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
          const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
          const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
          w[j] += s0 + w[(j + 9) & 15] + s1;
          o[h] = w[j] + SHA256_K[16 * c + j];
        }
        wk[buf][4 * c + i][l] = make_uint4(o[0], o[1], o[2], o[3]);
      }
      msg_bar_arrive<NT>(MSG_BAR_WK(buf, c));
    }
  }
}

// One round on W + K: h + W + K and d + h + W + K do not wait for e (K4's
// form).
__device__ __forceinline__ void msg_round(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                                          uint32_t& e, uint32_t& f, uint32_t& g, uint32_t& h,
                                          uint32_t wk) {
  const uint32_t hw = h + wk, dhw = d + hw;
  const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
  const uint32_t chv = (e & f) ^ (~e & g);
  const uint32_t t1 = hw + S1 + chv;
  const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  h = g;
  g = f;
  f = e;
  e = dhw + S1 + chv;
  d = c;
  c = b;
  b = a;
  a = t1 + S0 + maj;
}

// The round warp, thread l for lane l: the 64 rounds of each SHA block on
// W + K from wk, the feed-forward while the lane's message lasts.
template <int NT = MSG_THREADS>
__device__ __forceinline__ void msg_round_warp(uint32_t nb, uint32_t nb_max, int l,
                                               uint32_t st[8],
                                               const uint4 (*wk)[MSG_CHUNKS * 4][MSG_LANES]) {
  sha256_init(st);
#pragma unroll 1
  for (uint32_t blk = 0; blk < nb_max; blk++) {
    const int buf = blk & 1;
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 1
    for (int ch = 0; ch < MSG_CHUNKS; ch++) {
      msg_bar_sync<NT>(MSG_BAR_WK(buf, ch));
      uint4 quad;
#pragma unroll
      for (int i = 0; i < 16; i++) {
        if ((i & 3) == 0) quad = wk[buf][4 * ch + (i >> 2)][l];
        const uint32_t wkt = (i & 3) == 0 ? quad.x : (i & 3) == 1 ? quad.y
                           : (i & 3) == 2 ? quad.z : quad.w;
        msg_round(a, b, c, d, e, f, g, h, wkt);
      }
    }
    if (blk + 2 < nb_max) msg_bar_arrive<NT>(MSG_BAR_FREE(buf));
    if (blk < nb) {
      st[0] += a; st[1] += b; st[2] += c; st[3] += d;
      st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
  }
}

// K14: MSG_LANES messages a two-warp block: warp 1 turns the rows into W +
// K (msg_message_warp), warp 0 runs the rounds and stores the digests
// (msg_round_warp).  One instantiation a path, so that each carries only
// its own loads.
template <bool WIDE>
__global__ void __launch_bounds__(MSG_THREADS)
sha256_msg_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len_in,
                  uint8_t* __restrict__ out, int64_t B) {
  __shared__ __align__(16) uint4 wk_s[2][MSG_CHUNKS * 4][MSG_LANES];
  __shared__ __align__(16) uint32_t tile_s[8][TILE64_STRIDE];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * MSG_LANES;
  const bool in_batch = base + l < B;
  const int64_t lane = in_batch ? base + l : B - 1;
  const uint32_t len = (uint32_t)__ldg(len_in + lane);
  const uint32_t nb = (len + 9 + 63) / 64;
  const uint32_t nb_max = __reduce_max_sync(0xffffffffu, nb);
  if (warp == 1) {
    msg_message_warp<WIDE>(Sha256Rows{msg}, B, base, lane, l, len,
                           __reduce_max_sync(0xffffffffu, len), nb, nb_max, tile_s, wk_s);
    return;
  }
  uint32_t st[8];
  msg_round_warp(nb, nb_max, l, st, wk_s);
  if (in_batch) sha256_store_digest(out, B, lane, st);
}

// K15's second SHA block, the pad of a 64-byte message (0x80000000, 14
// zeros, the bit length 512): its 64 scheduled words plus K, folded.
#define K15_PAD_WK {                                                               \
    0xC28A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u, \
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u, \
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF374u, 0x649B69C1u, 0xF0FE4786u, \
    0x0FE1EDC6u, 0x240CF254u, 0x4FE9346Fu, 0x6CC984BEu, 0x61B9411Eu, 0x16F988FAu, \
    0xF2C65152u, 0xA88E5A6Du, 0xB019FC65u, 0xB9D99EC7u, 0x9A1231C3u, 0xE70EEAA0u, \
    0xFDB1232Bu, 0xC7353EB0u, 0x3069BAD5u, 0xCB976D5Fu, 0x5A0F118Fu, 0xDC1EEEFDu, \
    0x0A35B689u, 0xDE0B7A04u, 0x58F4CA9Du, 0xE15D5B16u, 0x007F3E86u, 0x37088980u, \
    0xA507EA32u, 0x6FAB9537u, 0x17406110u, 0x0D8CD6F1u, 0xCDAA3B6Du, 0xC0BBBE37u, \
    0x83613BDAu, 0xDB48A363u, 0x0B02E931u, 0x6FD15CA7u, 0x521AFACAu, 0x31338431u, \
    0x6ED41A95u, 0x6D437890u, 0xC39C91F2u, 0x9ECCABBDu, 0xB5C9A0E6u, 0x532FB63Cu, \
    0xD2C741C6u, 0x07237EA3u, 0xA4954B68u, 0x4C191D76u}

// st <- compress(st, the pad block): 64 rounds on literal W + K, no barrier
// and no shared memory (K4 folds its pad the same way).
__device__ __forceinline__ void mix32_pad_rounds(uint32_t st[8]) {
  const uint32_t WK[64] = K15_PAD_WK;
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; t++) msg_round(a, b, c, d, e, f, g, h, WK[t]);
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The round warp's digests of the block's 32 lanes as 32 byte rows through
// shared memory (the wide path, out 16-byte aligned): thread l writes its 8
// words to tile[t][l], then gathers row l (byte l % 4, big-endian, of word
// l / 4 of each lane: one LDS.128 and three PRMT a quad, as the message
// warp's gather) and stores it as two uint4, lanes base .. + 15 and base +
// 16 .. + 31, each if it lies in the batch.  tile[t] is 68 words apart, so
// the stores and the LDS.128 of 8 threads fall in distinct banks.
__device__ __forceinline__ void mix32_store_rows(uint8_t* __restrict__ out, int64_t B,
                                                 int64_t base, int l, const uint32_t st[8],
                                                 uint32_t (*tile)[TILE64_STRIDE]) {
#pragma unroll
  for (int t = 0; t < 8; t++) tile[t][l] = st[t];
  __syncwarp();
  const uint32_t sel = tile_sel(3 - (l & 3));
  const uint32_t* row = tile[l >> 2];
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; j++)
    w[j] = tile_gather_le(*reinterpret_cast<const uint4*>(row + 4 * j), sel);
  uint8_t* dst = out + (int64_t)l * B + base;
#pragma unroll
  for (int h = 0; h < 2; h++)
    if (base + 16 * h + 16 <= B)
      *reinterpret_cast<uint4*>(dst + 16 * h) =
          make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
}

// K15: sha256(state || mixin) on K14's warp pair, MSG_LANES lanes a pair.
// The message warp hands over block 1's W + K only (every lane's length is
// 64, so block 1 holds no pad byte, and with one SHA block of rows the bit
// length, in block 2, is never written); the round warp runs block 1 on it,
// then the constant pad block from literals, and stores the digests (WIDE:
// as uint4 rows through the tile; else as K14's bytes).  A block holds
// GROUPS pairs: warps 0 .. GROUPS - 1 run the rounds of lane groups 0 ..
// GROUPS - 1 and the next GROUPS warps their messages, all meeting on the
// same barriers.
template <bool WIDE, int GROUPS>
__global__ void __launch_bounds__(MSG_THREADS * GROUPS)
sha256_mix32_kernel(const uint8_t* __restrict__ state, const uint8_t* __restrict__ mixin,
                    uint8_t* __restrict__ out, int64_t B) {
  constexpr int NT = MSG_THREADS * GROUPS;
  __shared__ __align__(16) uint4 wk_s[GROUPS][1][MSG_CHUNKS * 4][MSG_LANES];
  __shared__ __align__(16) uint32_t tile_s[GROUPS][8][TILE64_STRIDE];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, g = warp % GROUPS;
  const int64_t base = ((int64_t)blockIdx.x * GROUPS + g) * MSG_LANES;
  const bool in_batch = base + l < B;
  const int64_t lane = in_batch ? base + l : B - 1;
  if (warp >= GROUPS) {
    msg_message_warp<WIDE, Sha256RowsMix, NT>(Sha256RowsMix{state, mixin}, B, base, lane, l,
                                              64u, 64u, 2u, 1u, tile_s[g], wk_s[g]);
    return;
  }
  uint32_t st[8];
  msg_round_warp<NT>(1u, 1u, l, st, wk_s[g]);
  mix32_pad_rounds(st);
  if (WIDE)  // the tile's last reader, the message warp, arrived before block 1's rounds
    mix32_store_rows(out, B, base, l, st, tile_s[g]);
  else if (in_batch)
    sha256_store_digest(out, B, lane, st);
}

FD_EXPORT int fd_sha256_msg(const void* msg, const void* len, void* out, int64_t B,
                            int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const bool wide = B % 16 == 0 && (uintptr_t)msg % 16 == 0;
  const int64_t blocks = (B + MSG_LANES - 1) / MSG_LANES;
  if (wide)
    sha256_msg_kernel<true><<<(unsigned)blocks, MSG_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  else
    sha256_msg_kernel<false><<<(unsigned)blocks, MSG_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}

// K15: B lanes; the wide path needs B a multiple of 16 and the three arrays
// 16-byte aligned.  A block is one warp pair while the batch gives each SM
// at most two pairs, else four pairs: a pair's two warps sit on neighbouring
// schedulers of an SM, so with many one-pair blocks the round warps, which
// issue about twice the message warps' instructions, crowd two of its four
// schedulers, and the kernel ran slower than one lane a thread at B = 65,536
// on an H100.  Four pairs a block put each round warp on its message warp's
// scheduler, which costs at small batches, so those keep one pair
// (chip_smoke.py --parent times both layouts: [K15-knobs], PERF.md
// section 5).
#ifndef MIX32_GROUPS  // 1 or 4 forces a layout
#define MIX32_GROUPS 0
#endif
FD_EXPORT int fd_sha256_mix32(const void* state, const void* mixin, void* out, int64_t B,
                              int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  int sms = 0;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc) return rc;
  const bool wide = B % 16 == 0 && (uintptr_t)state % 16 == 0 && (uintptr_t)mixin % 16 == 0
                    && (uintptr_t)out % 16 == 0;
  const int64_t pairs = (B + MSG_LANES - 1) / MSG_LANES;
  const int groups = MIX32_GROUPS ? MIX32_GROUPS : pairs > 2 * (int64_t)sms ? 4 : 1;
  const unsigned blocks = (unsigned)((pairs + groups - 1) / groups);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t *st = (const uint8_t*)state, *mx = (const uint8_t*)mixin;
  uint8_t* o = (uint8_t*)out;
  if (groups == 4) {
    if (wide)
      sha256_mix32_kernel<true, 4><<<blocks, 4 * MSG_THREADS, 0, s>>>(st, mx, o, B);
    else
      sha256_mix32_kernel<false, 4><<<blocks, 4 * MSG_THREADS, 0, s>>>(st, mx, o, B);
  } else {
    if (wide)
      sha256_mix32_kernel<true, 1><<<blocks, MSG_THREADS, 0, s>>>(st, mx, o, B);
    else
      sha256_mix32_kernel<false, 1><<<blocks, MSG_THREADS, 0, s>>>(st, mx, o, B);
  }
  return (int)cudaGetLastError();
}
