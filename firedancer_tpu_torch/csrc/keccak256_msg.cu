// K17 keccak256_msg: batched Keccak-256 of variable-length messages (the
// legacy 0x01 padding of sol_keccak256 and secp256k1_recover, not SHA-3's
// 0x06), each state on two threads, 16 messages a one-warp block.
//
// Replaces: firedancer_tpu/ops/keccak256.py:148 keccak256_msg (permutation
// _keccak_f :116).
//
// Bound: the dependent chain.  A lane's blocks are strictly serial, and
// keccak-f[1600] is 24 dependent rounds of ~130 64-bit operations
// (chip_smoke.py KECCAK_OPS_PER_PERMUTATION counts each as two 32-bit
// ones).  At the batches the callers give (a few warps an SM) the time is
// the longest lane's block count times what one warp issues a block.
//
// What the parent's SASS showed (one state a thread as 25 uint64, one-warp
// blocks of 32 messages; cuobjdump, nvcc 12.8): the block loop 2,091
// instructions (136 LDG, each behind ISETP and SEL for `pos < len`, 273
// LDC, 557 IMAD of addressing), the round loop 199 (LOP3 136, SHF 58;
// dependent depth 9), so 6,867 a block; no LDL/STL (80 registers).  An
// H100 took 154 us at B = 4,096 for the longest lane's 10 blocks, ~4.4
// clocks an instruction: the loads' latency in series.  Tiling the loads
// alone (K10's byte tile, PRMT) leaves 24 x 200 instructions a block on
// one warp, LOP3 and SHF, each two clocks of its scheduler's INT32 pipe:
// that build ran 60.5 us at B = 4,096 (0.39x the parent).  So the
// permutation is split too, over the two 32-bit halves of every lane:
//   - thread j of a warp holds half h = j / 16 (0 low, 1 high) of message
//     j % 16's 25 lanes.  XOR, AND and NOT act on each half alone; a
//     64-bit rotation takes the partner's half (one shfl.xor by 16, the
//     same code on both threads: new = funnel(other, own, n) for n < 32,
//     funnel(own, other, n - 32) after), so a round is 134 SASS
//     instructions a thread (LOP3 68, SHF 30, SHFL 29) where one thread a
//     state issued 199;
//   - the warp's 16 messages are 16 contiguous bytes of a row, so a row
//     segment is one uint4 load: the block's 136 rows come in 32 rows a
//     warp instruction, the next Keccak block's during this one's
//     permutation, into a byte tile (tile[q][r]: row r of messages 4q ..
//     4q+3; 136 words a quad, so the stores and the LDS.128 of both halves
//     hit distinct banks), from which each thread gathers its half of the
//     17 words (one LDS.128 and three PRMT, little-endian) and pads by
//     mask: 0x01 at len, zeros after, 0x80 XORed into byte 135 of the
//     final block len / 136 (the same byte when len % 136 == 135).
// Every thread runs every permutation up to the warp's longest message
// (the shuffles need the whole warp); a message's digest is taken after
// its own final block.  Other batches than multiples of 16, and rows not
// 16-byte aligned, take the narrow path: each thread loads the 68 bytes of
// its half of the next block's words as single bytes, a block ahead, and
// packs them with PRMT.  Lanes past B read the batch's last message and
// store nothing.  The wide instantiation's block loop is 458 instructions
// (PRMT 51, STS 20, LDS 17, LDG 5) besides the 24 rounds (cuobjdump, nvcc
// 12.8, sm_90a).  ptxas: wide 81 registers and 2,176 bytes of shared
// memory, narrow 197 registers; no spills.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so a warp's
// loads of a row coalesce; len (B,) int32, each in [0, max_len] (the wrapper
// checks); out (32, B) uint8, the first 4 lanes little-endian.
#include "msg_tile.cuh"

#define KECCAK_RATE 136
#define KECCAK_MSGS 16       // messages a one-warp block, two threads each
#define KECCAK_LOADS 5       // uint4 row loads a thread a block: rows j, j + 32, ... below 136
#define KECCAK_TILE_STRIDE 136  // words of a message quad's column of the byte tile

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

// This thread's half of rotl64(lane, n), the partner (lane j ^ 16) holding
// the other half; called with constant n after unrolling, by the whole warp.
__device__ __forceinline__ uint32_t keccak_rot_half(uint32_t own, int n) {
  if (n == 0) return own;
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 16);
  return n < 32 ? __funnelshift_l(other, own, n) : __funnelshift_l(own, other, n - 32);
}

// keccak-f[1600] on half h of the 25 lanes (the partner runs the other).
__device__ __forceinline__ void keccak_f_half(uint32_t a[25], int h) {
  // rotation offsets, lane index x + 5 y (the JAX package's _ROT)
  constexpr int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                           25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    uint32_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint32_t d = c[(x + 4) % 5] ^ keccak_rot_half(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
    }
#pragma unroll
    for (int x = 0; x < 5; x++)
#pragma unroll
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = keccak_rot_half(a[x + 5 * y], ROT[x + 5 * y]);
#pragma unroll
    for (int i = 0; i < 25; i++)
      a[i] = b[i] ^ (~b[(i + 1) % 5 + 5 * (i / 5)] & b[(i + 2) % 5 + 5 * (i / 5)]);
    a[0] ^= (uint32_t)(KECCAK_RC[r] >> (32 * h));
  }
}

// The wide path's row segments of Keccak block bi: v[i] = the 16 bytes of
// row 136 bi + 32 i + j (below 136 and len_max) at the warp's messages;
// col = this thread's row j at the warp's first message.
__device__ __forceinline__ void keccak_load_rows(const uint8_t* __restrict__ col, int64_t B,
                                                 int j, uint32_t bi, uint32_t len_max,
                                                 uint4 v[KECCAK_LOADS]) {
  const uint32_t row0 = KECCAK_RATE * bi;
#pragma unroll
  for (int i = 0; i < KECCAK_LOADS; i++)
    if (32 * i + j < KECCAK_RATE && row0 + 32 * i + j < len_max)
      v[i] = __ldg(reinterpret_cast<const uint4*>(col + (int64_t)(row0 + 32 * i) * B));
}

// The narrow path's bytes of Keccak block bi that half h of the lane at p
// (its row-0 byte) absorbs: raw[4 i + c] = row 136 bi + 8 i + 4 h + c, for
// rows below len_max.  A whole block's 68 loads are unguarded.
__device__ __forceinline__ void keccak_load_bytes(const uint8_t* __restrict__ p, int64_t B,
                                                  int h, uint32_t bi, uint32_t len_max,
                                                  uint32_t raw[68]) {
  const uint32_t row0 = KECCAK_RATE * bi + 4 * h;
  const uint8_t* q = p + (int64_t)row0 * B;
  if (KECCAK_RATE * (bi + 1) <= len_max) {
#pragma unroll
    for (int k = 0; k < 68; k++) raw[k] = __ldg(q + (8 * (k >> 2) + (k & 3)) * B);
  } else {
#pragma unroll
    for (int k = 0; k < 68; k++) {
      const int r = 8 * (k >> 2) + (k & 3);
      if (row0 + r < len_max) raw[k] = __ldg(q + r * B);
    }
  }
}

// K17: KECCAK_MSGS messages a one-warp block, thread j on half j / 16 of
// message j % 16.  For each Keccak block up to the warp's longest message:
// this half of the 17 words (wide: the rows into the tile, then out of it;
// narrow: the thread's bytes, packed) with the pad, the next block's rows
// or bytes issued, keccak-f on both halves, and the digest's half kept
// after the message's own final block.  One instantiation a path, as K14.
template <bool WIDE>
__global__ void __launch_bounds__(32)
keccak256_msg_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len,
                     uint8_t* __restrict__ out, int64_t B) {
  __shared__ __align__(16) uint32_t tile[4][KECCAK_TILE_STRIDE];
  const int j = threadIdx.x, m = j & 15, h = j >> 4, q = m >> 2;
  const int64_t base = (int64_t)blockIdx.x * KECCAK_MSGS;
  const bool in_batch = base + m < B;
  const int64_t lane = in_batch ? base + m : B - 1;
  const uint32_t n = (uint32_t)__ldg(len + lane);
  const uint32_t final_block = n / KECCAK_RATE;
  const uint32_t nb_max = __reduce_max_sync(0xffffffffu, final_block + 1);
  const uint32_t len_max = __reduce_max_sync(0xffffffffu, n);
  const uint32_t sel = tile_sel(m);
  const uint8_t* col = msg + (int64_t)j * B + base;
  uint4 next[KECCAK_LOADS];  // the wide path's rows of the next block
  uint32_t raw[68];          // the narrow path's bytes of the next block
  if (WIDE)
    keccak_load_rows(col, B, j, 0, len_max, next);
  else
    keccak_load_bytes(msg + lane, B, h, 0, len_max, raw);
  uint32_t a[25], dig[4];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0;
#pragma unroll 1
  for (uint32_t bi = 0; bi < nb_max; bi++) {
    const uint32_t row0 = KECCAK_RATE * bi;
    // bytes at or past n: 0x01 at n (in word tb), zeros after, applied in
    // each path's word loop; a message's blocks past its final one are
    // absorbed too, and never read
    const int rem = (int)n - (int)row0, tb = rem >> 3, ob = rem & 7;
    const uint32_t keep = (uint32_t)((((1ull << (8 * ob)) - 1)) >> (32 * h));
    const uint32_t pad = (uint32_t)((1ull << (8 * ob)) >> (32 * h));
    if (WIDE) {
      __syncwarp();  // the last block's words are read before its rows are replaced
#pragma unroll
      for (int i = 0; i < KECCAK_LOADS; i++) {
        const int r = 32 * i + j;
        if (r < KECCAK_RATE && row0 + r < len_max) {
          tile[0][r] = next[i].x;
          tile[1][r] = next[i].y;
          tile[2][r] = next[i].z;
          tile[3][r] = next[i].w;
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < KECCAK_RATE / 8; i++) {
        const uint32_t x =
            tile_gather_le(*reinterpret_cast<const uint4*>(&tile[q][8 * i + 4 * h]), sel);
        a[i] ^= i < tb ? x : (i == tb ? (x & keep) | pad : 0u);
      }
      if (bi + 1 < nb_max) keccak_load_rows(col, B, j, bi + 1, len_max, next);
    } else {
#pragma unroll
      for (int i = 0; i < KECCAK_RATE / 8; i++) {  // little-endian: byte 4i lowest
        const uint32_t x = __byte_perm(__byte_perm(raw[4 * i], raw[4 * i + 1], 0x0040),
                                       __byte_perm(raw[4 * i + 2], raw[4 * i + 3], 0x0040),
                                       0x5410);
        a[i] ^= i < tb ? x : (i == tb ? (x & keep) | pad : 0u);
      }
      if (bi + 1 < nb_max) keccak_load_bytes(msg + lane, B, h, bi + 1, len_max, raw);
    }
    if (bi == final_block && h == 1) a[KECCAK_RATE / 8 - 1] ^= 0x80000000u;
    keccak_f_half(a, h);
    if (bi == final_block) {
#pragma unroll
      for (int k = 0; k < 4; k++) dig[k] = a[k];
    }
  }
  if (in_batch) {
#pragma unroll
    for (int k = 0; k < 4; k++)
#pragma unroll
      for (int c = 0; c < 4; c++)
        out[(int64_t)(8 * k + 4 * h + c) * B + lane] = (uint8_t)(dig[k] >> (8 * c));
  }
}

FD_EXPORT int fd_keccak256_msg(const void* msg, const void* len, void* out, int64_t B,
                               int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const bool wide = B % 16 == 0 && (uintptr_t)msg % 16 == 0;
  const int64_t blocks = (B + KECCAK_MSGS - 1) / KECCAK_MSGS;
  if (wide)
    keccak256_msg_kernel<true><<<(unsigned)blocks, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  else
    keccak256_msg_kernel<false><<<(unsigned)blocks, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
