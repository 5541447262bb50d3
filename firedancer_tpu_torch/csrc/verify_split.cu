// K9-K12, the split rung of the verify ladder: K1's per-signature work cut
// into four launches: K9 and K10 32 signatures a two-warp block, K11 four
// threads a signature, K12 one signature a thread.
//
// Replaces: firedancer_tpu/ops/sigverify.py:216 _phase_validate (K9),
// :229 _phase_hash (K10), :239 _phase_dsm (K11) and :245 _phase_compare
// (K12), which ed25519_verify_batch_split (:249) chains.  They reuse K1's
// __device__ functions (curve.cuh, curve_quad.cuh, sha512.cuh), and K11
// runs K1's quad ladder, so the split mask equals K1's mask on every lane.
//
// K9 decompresses and checks A and R.  One signature a thread put both
// decompressions (~600 multiplies through the out-of-line fe_mul, 100
// products a squaring) in one thread's chain, 128 threads a block: 8
// blocks on 8 of 132 SMs at the split pipeline's B = 1,024.  Here warp 0
// takes the block's 32 A's and warp 1 its 32 R's, one point a thread on
// ge_decompress_strict_q (inlined multiplies, 55-product squarings, the
// same limbs), so B = 1,024 is 32 blocks, 64 warps, each alone on its
// scheduler.  ptxas (nvcc 12.8, sm_90a): 254 registers, 16 bytes of stack
// (16 bytes of spill in ge_decompress_strict_q), so 4 blocks an SM and B =
// 16,384 (512 blocks) runs in one wave; a build for more blocks an SM, or
// one-warp blocks, would add no warps an SM there.  The time is one
// thread's squarings: 336 SASS instructions each (cuobjdump), where 55
// products and a carry need ~150, because each signed 32 x 32 -> 64
// product is lowered as IMAD.WIDE.U32 plus two IMAD and an IADD3 of sign
// corrections.
//
// K10 hashes R || A || msg.  One signature a thread issued, on one warp,
// 128 single-byte loads a SHA block (each behind the source's branch and
// the pad's compares), the 64 schedule steps and the 80 rounds: 6,589
// SASS instructions a SHA block (223 LDG, 353 ISETP, 127 BRA), ~6 clocks
// each on an H100, the loads' latency in series, its time flat in B.
// Here a block is two warps for 32 signatures: the message warp loads the
// block's row segments (32 contiguous bytes a row, uint4 loads, the next
// SHA block's during this one's schedule), turns them into each lane's
// words through shared memory (PRMT), pads, expands the schedule and hands
// W + K over in chunks of 16 rounds (named barriers, two buffers); the
// round warp runs only the rounds, the feed-forward, sc_reduce512 and the
// stores.  Both warps loop over the chunks (16 rounds or schedule steps a
// loop body): unrolled over all 80, their SHA-block loops were 2,484 and
// 2,589 SASS instructions (~40 KB of code each) and ran slower on an H100
// at every shape measured, with the same instructions issued (instruction
// fetch is the suspect; not profiled).  SASS (cuobjdump, nvcc 12.8): the
// round warp's chunk loop 504 instructions, its block loop 551 (one chunk
// and the feed-forward); the message warp's chunk loop 414, its block
// loop 1,318 (the tile, the words, the pad, chunk 0 and one chunk).  So
// each warp issues ~2,560 instructions a SHA block, side by side.  ptxas:
// 128 registers, no spills, 45,184 bytes of shared memory, so 4 blocks an
// SM (the shared memory) and B = 16,384 runs in one wave.
//
// K11 is the split's long phase: ~3,235 field multiplies a lane
// (ops/sigverify.py K11_SQUARINGS_PER_LANE and K11_MULS_PER_LANE), no
// decompression and no hash.
// On one thread a signature it was one dependent chain of ~3,100
// multiplies, 128 threads a block: 8 blocks on 8 of 132 SMs at the split
// pipeline's B = 1,024.  On K1's quad ladder a doubling or an addition is
// two multiply latencies (the ladder's chain ~640 multiplies), and B =
// 1,024 is 128 one-warp blocks on 128 SMs.  ptxas (nvcc 12.8, sm_90a): 166
// registers, no spills, 336 bytes of stack, 20 KB of table a block; so 10
// blocks an SM (the table's shared memory), and B = 16,384 runs in 1.55
// waves.  (With the ladder copied into this file ptxas took 254 registers,
// 8 blocks an SM; the times on an H100 were the same.)
//
// Between phases every lane's values sit on the trailing axis, so each
// thread's loads and stores coalesce with its neighbours':
//   a_pt, r_pt, r_cmp  (4, 10, B) int32: X, Y, Z, T, each 10 limbs of
//                      radix 2^25.5 in the carried form;
//   k                  (32, B) uint8: SHA512(R || A || msg) mod L, little-endian;
//   ok                 (B,) bool.
// No phase branches on another's verdict except K12, so a lane that failed
// a check still gets defined values: K9 writes what decompression computed
// for a point that does not decode, K10 hashes a message length clamped to
// [0, max_len], and K11 runs the ladder on whatever K9 wrote.  Nothing reads
// outside the input rows.
#include "curve_quad.cuh"
#include "sha512.cuh"

#define VAL_SIGS 32  // K9: signatures a two-warp block
#define VAL_THREADS (2 * VAL_SIGS)
#define HASH_SIGS 32  // K10: signatures a two-warp block
#define HASH_THREADS (2 * HASH_SIGS)
#define HASH_CHUNKS 5  // K10: W + K handed over in chunks of 16 rounds
#define HASH_TILE_STRIDE 132  // K10: words of a lane quad's column of the byte tile (128 rows + 4)
#define DSM_SIGS 8  // K11: signatures a one-warp block
#define DSM_THREADS (4 * DSM_SIGS)

__device__ __forceinline__ void fe_store_lane(const fe& a, int32_t* __restrict__ out,
                                              int64_t B, int64_t lane) {
#pragma unroll
  for (int i = 0; i < 10; i++) out[(int64_t)i * B + lane] = a.v[i];
}

__device__ __forceinline__ fe fe_load_lane(const int32_t* __restrict__ in, int64_t B,
                                           int64_t lane) {
  fe a;
#pragma unroll
  for (int i = 0; i < 10; i++) a.v[i] = __ldg(in + (int64_t)i * B + lane);
  return a;
}

// One point of a (4, 10, B) array: coordinate c at rows 10 c .. 10 c + 9.
__device__ __forceinline__ void ge_store_lane(const ge& p, int32_t* __restrict__ out,
                                              int64_t B, int64_t lane) {
  fe_store_lane(p.X, out, B, lane);
  fe_store_lane(p.Y, out + 10 * B, B, lane);
  fe_store_lane(p.Z, out + 20 * B, B, lane);
  fe_store_lane(p.T, out + 30 * B, B, lane);
}

// K9: s < L, 0 <= msg_len <= max_len (K1's range check), A and R
// decompressed, neither of small order; VAL_SIGS signatures a two-warp
// block.  Warp 0 decompresses and checks the 32 A's, warp 1 the 32 R's,
// one point a thread (ge_decompress_strict_q, as K1, K6 and K7 do), each
// storing its point's four coordinates (a coalesced store over the warp's
// 32 lanes a limb).  Both points are always decompressed and written,
// whatever the checks say.  Warp 1 hands R's verdict over in shared memory,
// and warp 0 joins it with A's, s < L and the length, and writes ok.  The
// lanes of a ragged tail read the batch's last lane and store nothing.
__global__ void __launch_bounds__(VAL_THREADS)
phase_validate_kernel(const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
                      const int32_t* __restrict__ msg_len, int32_t* __restrict__ a_out,
                      int32_t* __restrict__ r_out, bool* __restrict__ ok_out, int64_t B,
                      int max_len) {
  __shared__ int32_t r_ok_s[VAL_SIGS];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int64_t s_idx = (int64_t)blockIdx.x * VAL_SIGS + l;
  const bool in_batch = s_idx < B;
  const int64_t lane = in_batch ? s_idx : B - 1;  // loads stay inside the batch
  bool ok = true;
  if (warp == 0) {
    uint64_t sw[4];
    fd_load32(sig + 32 * B, B, lane, sw);
    const int32_t ln = __ldg(msg_len + lane);
    ok = sc_validate(sw) && ln >= 0 && ln <= max_len;
  }
  uint64_t w[4];
  fd_load32(warp == 0 ? pk : sig, B, lane, w);
  const ge_ok d = ge_decompress_strict_q(w[0], w[1], w[2], w[3]);
  if (in_batch) ge_store_lane(d.p, warp == 0 ? a_out : r_out, B, lane);
  if (warp == 1) r_ok_s[l] = d.ok;
  __syncthreads();
  if (warp == 0 && in_batch) ok_out[lane] = ok && d.ok && r_ok_s[l];
}

// K10's named barriers (barrier 0 is __syncthreads'): the message warp
// arrives on HASH_BAR_WK(buf, c) once chunk c of buffer buf holds W + K,
// and the round warp on HASH_BAR_FREE(buf) once it has read the buffer.
#define HASH_BAR_WK(buf, c) (1 + HASH_CHUNKS * (buf) + (c))
#define HASH_BAR_FREE(buf) (1 + 2 * HASH_CHUNKS + (buf))

__device__ __forceinline__ void hash_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(HASH_THREADS) : "memory");
}

__device__ __forceinline__ void hash_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(HASH_THREADS) : "memory");
}

// Row p of R || A || msg: sig rows 0-31, pubkey rows, then msg rows.
__device__ __forceinline__ const uint8_t* hash_row(const uint8_t* __restrict__ sig,
                                                   const uint8_t* __restrict__ pk,
                                                   const uint8_t* __restrict__ msg,
                                                   int64_t B, uint32_t p) {
  return p < 32 ? sig + (int64_t)p * B
                : (p < 64 ? pk + (int64_t)(p - 32) * B : msg + (int64_t)(p - 64) * B);
}

// Bytes b of the four words of v (rows 4i .. 4i+3 of one lane quad), as
// one big-endian word: lane 4q + b's bytes of those rows.
__device__ __forceinline__ uint32_t hash_gather(const uint4& v, uint32_t sel) {
  return __byte_perm(__byte_perm(v.w, v.z, sel), __byte_perm(v.y, v.x, sel), 0x5410);
}

// The wide path's row segments of one SHA block, rows row0 .. row0 + 127
// below len_max: v[i] = the 16 bytes of row row0 + 16 i + l / 2 at this
// thread's lanes, from bases[] = this thread's byte of row l / 2 of sig,
// pubkey and msg.  Row groups never straddle a source: the first SHA block
// is sig (i = 0, 1), pubkey (2, 3) and msg (4-7), a later one all msg.
__device__ __forceinline__ void hash_load_rows(const uint8_t* const bases[3], int64_t B,
                                               int l, uint32_t row0, uint32_t len_max,
                                               uint4 v[8]) {
  const int64_t step = 16 * B;  // 16 rows
  const uint8_t* later = bases[2] + (row0 == 0 ? 0 : (int64_t)((row0 - 64) >> 4) * step);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint8_t* first = i < 2 ? bases[0] + i * step
                                 : (i < 4 ? bases[1] + (i - 2) * step : bases[2] + (i - 4) * step);
    if (row0 + 16 * i + (l >> 1) < len_max)
      v[i] = __ldg(reinterpret_cast<const uint4*>(row0 == 0 ? first : later + i * step));
  }
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
// block's while this one's schedule runs; otherwise each thread loads its
// own lane's byte of each row.
__device__ __forceinline__ void hash_message_warp(
    const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
    const uint8_t* __restrict__ msg, int64_t B, int64_t base, int64_t lane, int l,
    uint32_t len, uint32_t len_max, uint32_t nb, uint32_t nb_max, bool wide,
    uint32_t (*tile)[HASH_TILE_STRIDE], ulonglong2 (*wk)[HASH_CHUNKS * 8][HASH_SIGS]) {
  const bool full = wide && base + HASH_SIGS <= B;
  const uint32_t sel = (uint32_t)(l & 3) | ((uint32_t)((l & 3) + 4) << 4);
  const int q = l >> 2, q0 = 4 * (l & 1);
  const int64_t col = (int64_t)(l >> 1) * B + base + 16 * (l & 1);
  const uint8_t* const bases[3] = {sig + col, pk + col, msg + col};
  uint4 next[8];  // the wide path's rows of the next SHA block, loaded a block ahead
  if (full) hash_load_rows(bases, B, l, 0, len_max, next);
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
        if (row0 + r < len_max) col_b[4 * r] = __ldg(hash_row(sig, pk, msg, B, row0 + r) + lane);
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
      const uint64_t x = ((uint64_t)hash_gather(hi, sel) << 32) | hash_gather(lo, sel);
      w[t] = t < tb ? x : (t == tb ? (x & keep) | pad : 0ull);
    }
    __syncwarp();  // the tile is read before the next block's rows land in it
    if (full && blk + 1 < nb_max)
      hash_load_rows(bases, B, l, row0 + 128, len_max, next);
    if (blk + 1 == nb) w[15] = (uint64_t)len * 8;  // 128-bit length, high word 0
    if (blk >= 2) hash_bar_sync(HASH_BAR_FREE(buf));
#pragma unroll
    for (int i = 0; i < 8; i++)
      wk[buf][i][l] = make_ulonglong2(w[2 * i] + SHA512_K[2 * i],
                                      w[2 * i + 1] + SHA512_K[2 * i + 1]);
    hash_bar_arrive(HASH_BAR_WK(buf, 0));
    // chunks 1-4, one loop body (word 16 c + j replaces w[j])
#pragma unroll 1
    for (int c = 1; c < HASH_CHUNKS; c++) {
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
      hash_bar_arrive(HASH_BAR_WK(buf, c));
    }
  }
}

// The round warp, thread l for lane l: the 80 rounds of each SHA block on
// W + K from wk (one LDS.128 for two rounds), the feed-forward while the
// lane's message lasts (a lane whose message has ended keeps its state).
__device__ __forceinline__ void hash_round_warp(
    uint32_t nb, uint32_t nb_max, int l, uint64_t st[8],
    const ulonglong2 (*wk)[HASH_CHUNKS * 8][HASH_SIGS]) {
  st[0] = 0x6A09E667F3BCC908ull; st[1] = 0xBB67AE8584CAA73Bull;
  st[2] = 0x3C6EF372FE94F82Bull; st[3] = 0xA54FF53A5F1D36F1ull;
  st[4] = 0x510E527FADE682D1ull; st[5] = 0x9B05688C2B3E6C1Full;
  st[6] = 0x1F83D9ABFB41BD6Bull; st[7] = 0x5BE0CD19137E2179ull;
#pragma unroll 1
  for (uint32_t blk = 0; blk < nb_max; blk++) {
    const int buf = blk & 1;
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 1
    for (int ch = 0; ch < HASH_CHUNKS; ch++) {
      hash_bar_sync(HASH_BAR_WK(buf, ch));
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
    if (blk + 2 < nb_max) hash_bar_arrive(HASH_BAR_FREE(buf));
    if (blk < nb) {
      st[0] += a; st[1] += b; st[2] += c; st[3] += d;
      st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
  }
}

// K10: k = SHA512(R || A || msg) mod L over a length clamped to [0,
// max_len], HASH_SIGS signatures a two-warp block: warp 1 turns the input
// rows into W + K (hash_message_warp), warp 0 runs the rounds, reduces and
// writes k as 32 byte rows (hash_round_warp).  Both warps run to the
// block's longest message; the lanes of a ragged tail read the batch's
// last lane, take part in every barrier and store nothing.
__global__ void __launch_bounds__(HASH_THREADS)
phase_hash_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ msg_len,
                  const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
                  uint8_t* __restrict__ k_out, int64_t B, int max_len, bool wide) {
  __shared__ __align__(16) ulonglong2 wk_s[2][HASH_CHUNKS * 8][HASH_SIGS];
  __shared__ __align__(16) uint32_t tile_s[8][HASH_TILE_STRIDE];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * HASH_SIGS;
  const bool in_batch = base + l < B;
  const int64_t lane = in_batch ? base + l : B - 1;
  int32_t ln = __ldg(msg_len + lane);
  ln = ln < 0 ? 0 : (ln > max_len ? max_len : ln);
  const uint32_t len = (uint32_t)ln + 64;
  const uint32_t nb = (len + 17 + 127) / 128;
  const uint32_t nb_max = __reduce_max_sync(0xffffffffu, nb);
  if (warp == 1) {
    hash_message_warp(sig, pk, msg, B, base, lane, l, len,
                      __reduce_max_sync(0xffffffffu, len), nb, nb_max, wide, tile_s, wk_s);
    return;
  }
  uint64_t st[8], kw[4];
  hash_round_warp(nb, nb_max, l, st, wk_s);
  sc_reduce512(st, kw);
  if (in_batch) {
#pragma unroll
    for (int i = 0; i < 32; i++)
      k_out[(int64_t)i * B + lane] = (uint8_t)(kw[i >> 3] >> (8 * (i & 7)));
  }
}

// K11: r_cmp = [s]B + [k](-A) on K1's quad ladder (curve_quad.cuh
// quad_double_scalar_mul_base), DSM_SIGS a one-warp block: thread c of a
// quad loads coordinate c of A straight from rows 10c .. 10c+9 of a_pt
// (already the quad layout, so nothing is exchanged), negates it (X and
// T), and stores coordinate c of the result.  Every lane runs, whatever
// K9 decided (K12 decides); the lanes of a ragged tail read the batch's
// last lane, run the ladder with the rest of the warp (its shuffles need
// all 32 threads) and store nothing.
__global__ void __launch_bounds__(DSM_THREADS)
phase_dsm_kernel(const uint8_t* __restrict__ k, const int32_t* __restrict__ a_pt,
                 const uint8_t* __restrict__ sig, const int32_t* __restrict__ comb,
                 int32_t* __restrict__ r_out, int64_t B) {
  __shared__ int32_t tbl_s[16 * 10 * DSM_THREADS];  // entry m, limb i: [(m * 10 + i) * DSM_THREADS + t]
  const int t = threadIdx.x;
  const QuadRole role = quad_role(t & 3);
  const int64_t s_idx = (int64_t)blockIdx.x * DSM_SIGS + (t >> 2);
  const bool in_batch = s_idx < B;
  const int64_t lane = in_batch ? s_idx : B - 1;
  uint64_t kw[4], sw[4];
  fd_load32(k, B, lane, kw);
  fd_load32(sig + 32 * B, B, lane, sw);
  fe a = fe_load_lane(a_pt + 10 * role.c * B, B, lane);
  if (role.c == 0 || role.c == 3) a = fe_neg(a);
  const fe r = quad_double_scalar_mul_base<DSM_THREADS>(a, kw, sw, comb, tbl_s + t, role);
  if (in_batch) fe_store_lane(r, r_out + 10 * role.c * B, B, lane);
}

// K12: ok and r_cmp == R (R has Z = 1).  Only X, Y of R and X, Y, Z of
// r_cmp are read, and only on lanes still ok.
__global__ void __launch_bounds__(128)
phase_compare_kernel(const int32_t* __restrict__ r_cmp, const int32_t* __restrict__ r_pt,
                     const bool* __restrict__ ok, bool* __restrict__ mask, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bool m = ok[lane];
  if (m) {
    ge p, q;
    p.X = fe_load_lane(r_cmp, B, lane);
    p.Y = fe_load_lane(r_cmp + 10 * B, B, lane);
    p.Z = fe_load_lane(r_cmp + 20 * B, B, lane);
    q.X = fe_load_lane(r_pt, B, lane);
    q.Y = fe_load_lane(r_pt + 10 * B, B, lane);
    m = ge_eq_z1(p, q);
  }
  mask[lane] = m;
}

static inline unsigned fd_blocks(int64_t B) { return (unsigned)((B + 127) / 128); }

FD_EXPORT int fd_phase_validate(const void* sig, const void* pk, const void* msg_len,
                                void* a_out, void* r_out, void* ok_out, int64_t B,
                                int max_len, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int64_t blocks = (B + VAL_SIGS - 1) / VAL_SIGS;
  phase_validate_kernel<<<(unsigned)blocks, VAL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sig, (const uint8_t*)pk, (const int32_t*)msg_len, (int32_t*)a_out,
      (int32_t*)r_out, (bool*)ok_out, B, max_len);
  return (int)cudaGetLastError();
}

FD_EXPORT int fd_phase_hash(const void* msg, const void* msg_len, const void* sig,
                            const void* pk, void* k_out, int64_t B, int max_len,
                            int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const bool wide = B % 16 == 0 && ((uintptr_t)msg | (uintptr_t)sig | (uintptr_t)pk) % 16 == 0;
  const int64_t blocks = (B + HASH_SIGS - 1) / HASH_SIGS;
  phase_hash_kernel<<<(unsigned)blocks, HASH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)msg_len, (const uint8_t*)sig,
      (const uint8_t*)pk, (uint8_t*)k_out, B, max_len, wide);
  return (int)cudaGetLastError();
}

FD_EXPORT int fd_phase_dsm(const void* k, const void* a_pt, const void* sig,
                           const void* comb, void* r_out, int64_t B, int device,
                           void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int64_t blocks = (B + DSM_SIGS - 1) / DSM_SIGS;
  phase_dsm_kernel<<<(unsigned)blocks, DSM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)k, (const int32_t*)a_pt, (const uint8_t*)sig, (const int32_t*)comb,
      (int32_t*)r_out, B);
  return (int)cudaGetLastError();
}

FD_EXPORT int fd_phase_compare(const void* r_cmp, const void* r_pt, const void* ok,
                               void* mask, int64_t B, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  phase_compare_kernel<<<fd_blocks(B), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r_cmp, (const int32_t*)r_pt, (const bool*)ok, (bool*)mask, B);
  return (int)cudaGetLastError();
}
