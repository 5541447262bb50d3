// K16 blake3_msg: single-chunk BLAKE3 (messages of at most 1,024 bytes, 32
// bytes out), one message a thread, 32 messages a one-warp block.
//
// Replaces: firedancer_tpu/ops/blake3.py:150 blake3_msg.
//
// Bound: the dependent chain.  A lane's blocks are strictly serial (block
// k + 1 starts from block k's chaining value), and a compression is 7
// rounds of 8 quarter-round mixes, each a chain of 12 dependent 32-bit
// instructions (chip_smoke.py BLAKE3_OPS_PER_COMPRESSION).  At the batches
// the callers give, the kernel's time is the longest lane's block count
// times what one warp issues a block.
//
// Design: the TPU version runs every block for every lane and masks the
// chaining value past each lane's final block (the `past` mask).  Here each
// thread compresses only its own blocks: block 0 carries CHUNK_START, the
// final block (max(len - 1, 0) / 64) carries CHUNK_END | ROOT and its own
// length (an empty message hashes one zero-length block), and the digest
// is that block's output.  The 16-word state and the message block live in
// registers; the message permutation is a renaming after unrolling.
//
// The loads.  The parent built each word from four guarded single-byte
// loads (64 a block, each behind `pos < len`), ~930 instructions a block at
// ~5 clocks each: the loads' latency in series (37.17 us at B = 16,384 x
// 1,024 on an H100).  Here, as K14's message warp (csrc/sha256_msg.cu), the
// warp's 32 messages are 32 contiguous bytes of a row: thread l loads row
// 16 i + l / 2 at lanes 16 (l % 2) .. + 15 as one uint4 (4 a block), the
// next block's during this one's compression, into a byte tile (tile[q][r]:
// row r of lanes 4q .. 4q+3, 68 words a quad, so the stores and the LDS.128
// reads are conflict-free), and reads its lane's 16 little-endian words out
// of it (one LDS.128 and three PRMT a word, K17's selector); bytes at or
// past the length are zeroed by mask in the same loop.  The wide path needs
// B a multiple of 16 and the rows 16-byte aligned; any other batch or an
// offset view takes the narrow path: each thread loads its own lane's 64
// bytes of the next block as single bytes, a block ahead, and packs them
// with PRMT.  Every thread runs the warp's longest lane's block loop (the
// tile's loads need the whole warp) and compresses only up to its own final
// block; the lanes of a ragged tail read the batch's last lane and store
// nothing.  One warp a block, so at B = 16,384 the 512 warps have a
// scheduler each; splitting a state over threads (as K17) would add
// shuffles and free no issue slot.  SASS (cuobjdump, nvcc 12.8, sm_90a):
// the wide instantiation's block loop 904 instructions (LOP3 247, SHF 226,
// IMAD 136, IADD3 116, PRMT 48, LDS 16, STS 16, LDG 4), the parent's 1,417
// (64 LDG, 128 LDC, 401 IMAD).  ptxas: wide 128 registers and 2,176 bytes
// of shared memory, narrow 161 registers; no spills.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so a warp's
// loads of a row coalesce; len (B,) int32, each in [0, max_len] with
// max_len <= 1,024 (the wrapper checks); out (32, B) uint8, words
// little-endian.
#include "msg_tile.cuh"

#define B3_CHUNK_START 1u
#define B3_CHUNK_END 2u
#define B3_ROOT 8u
#define B3_LANES 32  // messages a one-warp block

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

// K16: B3_LANES messages a one-warp block, thread l on lane base + l.  For
// each block up to the warp's longest message: the lane's 16 words (wide:
// the rows into the tile, then out of it; narrow: its own bytes, packed),
// masked past its length, the next block's rows or bytes issued, and the
// compression if the block is one of the lane's own.  One instantiation a
// path, as K14.
template <bool WIDE>
__global__ void __launch_bounds__(B3_LANES)
blake3_msg_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len,
                  uint8_t* __restrict__ out, int64_t B) {
  __shared__ __align__(16) uint32_t tile[8][TILE64_STRIDE];
  const int l = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * B3_LANES;
  const bool in_batch = base + l < B;
  const int64_t lane = in_batch ? base + l : B - 1;
  const uint32_t n = (uint32_t)__ldg(len + lane);
  const uint32_t final_block = n ? (n - 1) / 64 : 0;
  const uint32_t nb_max = __reduce_max_sync(0xffffffffu, final_block + 1);
  const uint32_t len_max = __reduce_max_sync(0xffffffffu, n);
  const bool seg_in = base + 16 * (l & 1) + 16 <= B;
  const uint32_t sel = tile_sel(l);
  const int q = l >> 2;
  const uint8_t* col = msg + (int64_t)(l >> 1) * B + base + 16 * (l & 1);
  uint4 next[4];     // the wide path's rows of the next block, loaded a block ahead
  uint32_t raw[64];  // the narrow path's bytes of the next block
  if (WIDE)
    tile_load_rows64(col, B, l, 0, len_max, seg_in, next);
  else
    tile_load_bytes64(msg + lane, B, 0, len_max, raw);
  uint32_t cv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
#pragma unroll 1
  for (uint32_t bi = 0; bi < nb_max; bi++) {
    const uint32_t row0 = bi * 64;
    // bytes at or past n are zero: word tb keeps its low ob bytes, later
    // words none; applied in each path's word loop
    const int rem = (int)n - (int)row0, tb = rem >> 2, ob = rem & 3;
    const uint32_t keep = (1u << (8 * ob)) - 1u;
    uint32_t w[16];
    if (WIDE) {
      tile_store_rows64(tile, next, l, row0, len_max);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 16; t++) {
        const uint32_t x = tile_gather_le(*reinterpret_cast<const uint4*>(&tile[q][4 * t]), sel);
        w[t] = t < tb ? x : (t == tb ? x & keep : 0u);
      }
      __syncwarp();  // the tile is read before the next block's rows land in it
      if (bi + 1 < nb_max) tile_load_rows64(col, B, l, row0 + 64, len_max, seg_in, next);
    } else {
#pragma unroll
      for (int t = 0; t < 16; t++) {  // little-endian: byte 4t lowest
        const uint32_t x = __byte_perm(__byte_perm(raw[4 * t], raw[4 * t + 1], 0x0040),
                                       __byte_perm(raw[4 * t + 2], raw[4 * t + 3], 0x0040),
                                       0x5410);
        w[t] = t < tb ? x : (t == tb ? x & keep : 0u);
      }
      if (bi + 1 < nb_max) tile_load_bytes64(msg + lane, B, row0 + 64, len_max, raw);
    }
    if (bi <= final_block) {
      const bool last = bi == final_block;
      const uint32_t flags = (bi == 0 ? B3_CHUNK_START : 0u) | (last ? B3_CHUNK_END | B3_ROOT : 0u);
      b3_compress(cv, w, last ? n - row0 : 64u, flags);
    }
  }
  if (in_batch) {
#pragma unroll
    for (int i = 0; i < 32; i++)
      out[(int64_t)i * B + lane] = (uint8_t)(cv[i >> 2] >> (8 * (i & 3)));
  }
}

FD_EXPORT int fd_blake3_msg(const void* msg, const void* len, void* out, int64_t B,
                            int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const bool wide = B % 16 == 0 && (uintptr_t)msg % 16 == 0;
  const int64_t blocks = (B + B3_LANES - 1) / B3_LANES;
  if (wide)
    blake3_msg_kernel<true><<<(unsigned)blocks, B3_LANES, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  else
    blake3_msg_kernel<false><<<(unsigned)blocks, B3_LANES, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
