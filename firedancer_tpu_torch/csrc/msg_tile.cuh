// The byte tile of the message-hash kernels: K3 and K10 (through
// sha512.cuh's warp pair), K14 (csrc/sha256_msg.cu), K16
// (csrc/blake3_msg.cu) and K17 (csrc/keccak256_msg.cu).
//
// A message batch is (max_len, B) byte rows, so one row's bytes of 16 or 32
// neighbouring lanes are contiguous.  On a kernel's wide path (B a multiple
// of 16 and the rows 16-byte aligned) a warp loads them as uint4 segments
// into a tile in shared memory, tile[q][r] = row r of lanes 4q .. 4q+3 as
// one 32-bit word (byte b for lane 4q + b), each quad's column padded by 4
// words so the stores and the LDS.128 reads fall in distinct banks; a
// thread reads four rows of its quad at once (LDS.128) and picks its lane's
// byte of each with PRMT.  On the narrow path each thread loads its own
// lane's bytes.
#pragma once

#include "fd_common.cuh"

#define TILE64_STRIDE 68  // words of a lane quad's column of a 64-row tile (64 rows + 4)

// The PRMT selector of lane l's byte of a quad's word (byte l % 4), for
// both halves of a gather.
__device__ __forceinline__ uint32_t tile_sel(int l) {
  return (uint32_t)(l & 3) | ((uint32_t)((l & 3) + 4) << 4);
}

// Bytes b of v's four words (rows 4t .. 4t+3 of one lane quad) as one
// big-endian word: lane 4q + b's bytes of those rows, row 4t highest.
__device__ __forceinline__ uint32_t tile_gather_be(const uint4& v, uint32_t sel) {
  return __byte_perm(__byte_perm(v.w, v.z, sel), __byte_perm(v.y, v.x, sel), 0x5410);
}

// The same as one little-endian word, row 4t lowest.
__device__ __forceinline__ uint32_t tile_gather_le(const uint4& v, uint32_t sel) {
  return __byte_perm(__byte_perm(v.x, v.y, sel), __byte_perm(v.z, v.w, sel), 0x5410);
}

// A 64-row block of 32 lanes (K14, K16), thread l of the warp: the wide
// path's row segments of rows row0 .. row0 + 63 below len_max, v[i] = the
// 16 bytes of row row0 + 16 i + l / 2 at lanes 16 (l % 2) .. + 15 (if
// seg_in: they lie in the batch); col = this thread's byte of row l / 2.
__device__ __forceinline__ void tile_load_rows64(const uint8_t* __restrict__ col, int64_t B,
                                                 int l, uint32_t row0, uint32_t len_max,
                                                 bool seg_in, uint4 v[4]) {
#pragma unroll
  for (int i = 0; i < 4; i++)
    if (seg_in && row0 + 16 * i + (l >> 1) < len_max)
      v[i] = __ldg(reinterpret_cast<const uint4*>(col + (int64_t)(row0 + 16 * i) * B));
}

// Those segments into the tile: row 16 i + l / 2 of quads 4 (l % 2) .. + 3.
__device__ __forceinline__ void tile_store_rows64(uint32_t (*tile)[TILE64_STRIDE],
                                                  const uint4 v[4], int l, uint32_t row0,
                                                  uint32_t len_max) {
  const int q0 = 4 * (l & 1);
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int r = 16 * i + (l >> 1);
    if (row0 + r < len_max) {
      tile[q0][r] = v[i].x;
      tile[q0 + 1][r] = v[i].y;
      tile[q0 + 2][r] = v[i].z;
      tile[q0 + 3][r] = v[i].w;
    }
  }
}

// The narrow path's bytes of a 64-row block, rows row0 .. row0 + 63 below
// len_max, of the lane whose row-0 byte is at p: raw[r] = byte row0 + r.
// A whole block's 64 loads are unguarded.
__device__ __forceinline__ void tile_load_bytes64(const uint8_t* __restrict__ p, int64_t B,
                                                  uint32_t row0, uint32_t len_max,
                                                  uint32_t raw[64]) {
  const uint8_t* q = p + (int64_t)row0 * B;
  if (row0 + 64 <= len_max) {
#pragma unroll
    for (int r = 0; r < 64; r++) raw[r] = __ldg(q + r * B);
  } else {
#pragma unroll
    for (int r = 0; r < 64; r++)
      if (row0 + r < len_max) raw[r] = __ldg(q + r * B);
  }
}
