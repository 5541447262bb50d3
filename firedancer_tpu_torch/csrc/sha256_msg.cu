// K14 sha256_msg: batched SHA-256 of variable-length messages, 32 messages
// a two-warp block; K15 sha256_mix32: sha256(state || mixin) of 32-byte
// rows, the PoH mixin step, one a thread.
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
// warp on MSG_BAR_FREE(buf) once it has read the buffer.
#define MSG_BAR_WK(buf, c) (1 + MSG_CHUNKS * (buf) + (c))
#define MSG_BAR_FREE(buf) (1 + 2 * MSG_CHUNKS + (buf))

__device__ __forceinline__ void msg_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(MSG_THREADS) : "memory");
}

__device__ __forceinline__ void msg_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(MSG_THREADS) : "memory");
}

// The message warp, thread l for lane l of the block: for each SHA block,
// lane l's 16 words (WIDE: the block's 64 rows into the tile, then out of
// it; else the lane's own 64 bytes, loaded a block ahead, packed with
// PRMT), the pad, and W + K for the 64 rounds into wk in four chunks (word
// 16 c + j replaces w[j]).  On the wide path a half block (B an odd
// multiple of 16) loads only its first 16 lanes' segments.
template <bool WIDE>
__device__ __forceinline__ void msg_message_warp(
    const uint8_t* __restrict__ msg, int64_t B, int64_t base, int64_t lane, int l,
    uint32_t len, uint32_t len_max, uint32_t nb, uint32_t nb_max,
    uint32_t (*tile)[TILE64_STRIDE], uint4 (*wk)[MSG_CHUNKS * 4][MSG_LANES]) {
  const bool seg_in = base + 16 * (l & 1) + 16 <= B;
  const uint32_t sel = tile_sel(l);
  const int q = l >> 2;
  const uint8_t* col = msg + (int64_t)(l >> 1) * B + base + 16 * (l & 1);
  uint4 next[4];     // the wide path's rows of the next SHA block, loaded a block ahead
  uint32_t raw[64];  // the narrow path's bytes of the next SHA block
  if (WIDE)
    tile_load_rows64(col, B, l, 0, len_max, seg_in, next);
  else
    tile_load_bytes64(msg + lane, B, 0, len_max, raw);
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
      if (blk + 1 < nb_max) tile_load_rows64(col, B, l, row0 + 64, len_max, seg_in, next);
    } else {
#pragma unroll
      for (int t = 0; t < 16; t++) {  // big-endian: byte 4t in the top
        const uint32_t x = __byte_perm(__byte_perm(raw[4 * t + 3], raw[4 * t + 2], 0x0040),
                                       __byte_perm(raw[4 * t + 1], raw[4 * t], 0x0040), 0x5410);
        w[t] = t < tb ? x : (t == tb ? (x & keep) | pad : 0u);
      }
      if (blk + 1 < nb_max) tile_load_bytes64(msg + lane, B, row0 + 64, len_max, raw);
    }
    if (blk + 1 == nb) {  // the 64-bit bit length
      w[14] = len >> 29;
      w[15] = len << 3;
    }
    if (blk >= 2) msg_bar_sync(MSG_BAR_FREE(buf));
#pragma unroll
    for (int i = 0; i < 4; i++)
      wk[buf][i][l] = make_uint4(w[4 * i] + SHA256_K[4 * i], w[4 * i + 1] + SHA256_K[4 * i + 1],
                                 w[4 * i + 2] + SHA256_K[4 * i + 2],
                                 w[4 * i + 3] + SHA256_K[4 * i + 3]);
    msg_bar_arrive(MSG_BAR_WK(buf, 0));
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
      msg_bar_arrive(MSG_BAR_WK(buf, c));
    }
  }
}

// The round warp, thread l for lane l: the 64 rounds of each SHA block on
// W + K from wk, the feed-forward while the lane's message lasts.
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
      msg_bar_sync(MSG_BAR_WK(buf, ch));
      uint4 quad;
#pragma unroll
      for (int i = 0; i < 16; i++) {
        if ((i & 3) == 0) quad = wk[buf][4 * ch + (i >> 2)][l];
        const uint32_t wkt = (i & 3) == 0 ? quad.x : (i & 3) == 1 ? quad.y
                           : (i & 3) == 2 ? quad.z : quad.w;
        // h + W + K and d + h + W + K do not wait for e (K4's form)
        const uint32_t hw = h + wkt, dhw = d + hw;
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
    }
    if (blk + 2 < nb_max) msg_bar_arrive(MSG_BAR_FREE(buf));
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
    msg_message_warp<WIDE>(msg, B, base, lane, l, len, __reduce_max_sync(0xffffffffu, len),
                           nb, nb_max, tile_s, wk_s);
    return;
  }
  uint32_t st[8];
  msg_round_warp(nb, nb_max, l, st, wk_s);
  if (in_batch) sha256_store_digest(out, B, lane, st);
}

__global__ void __launch_bounds__(32)
sha256_mix32_kernel(const uint8_t* __restrict__ state, const uint8_t* __restrict__ mixin,
                    uint8_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t st[8], w[16];
  sha256_load_words32(state, B, lane, w);
  sha256_load_words32(mixin, B, lane, w + 8);
  sha256_init(st);
  sha256_compress(st, w);
  // the constant pad block of a 64-byte message: 0x80, zeros, 512 bits
  w[0] = 0x80000000u;
#pragma unroll
  for (int i = 1; i < 15; i++) w[i] = 0u;
  w[15] = 512u;
  sha256_compress(st, w);
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

FD_EXPORT int fd_sha256_mix32(const void* state, const void* mixin, void* out, int64_t B,
                              int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  sha256_mix32_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)state, (const uint8_t*)mixin, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
