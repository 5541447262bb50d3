// K9-K12, the split rung of the verify ladder: K1's per-signature work cut
// into four launches: K9 and K10 32 signatures a two-warp block, K11 four
// threads a signature, K12 two threads a signature.
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
// Here a block is two warps for 32 signatures, sha512.cuh's warp pair
// (shared with K3 csrc/sha512_batch.cu; its design and SASS counts are
// noted there) on the row source Sha512RowsRAM: the message warp loads,
// pads and schedules, and the round warp runs the rounds, sc_reduce512
// and the stores.  ptxas: 128 registers, no spills, 45,184 bytes of
// shared memory, so 4 blocks an SM (the shared memory) and B = 16,384
// runs in one wave.
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

// K10: k = SHA512(R || A || msg) mod L over a length clamped to [0,
// max_len], SHA512_LANES signatures a two-warp block (sha512.cuh's warp
// pair on the source Sha512RowsRAM): warp 1 turns the input rows into W +
// K (sha512_message_warp), warp 0 runs the rounds (sha512_round_warp),
// reduces and writes k as 32 byte rows.  Both warps run to the block's
// longest message; the lanes of a ragged tail read the batch's last lane,
// take part in every barrier and store nothing.
__global__ void __launch_bounds__(SHA512_THREADS)
phase_hash_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ msg_len,
                  const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
                  uint8_t* __restrict__ k_out, int64_t B, int max_len, bool wide) {
  __shared__ __align__(16) ulonglong2 wk_s[2][SHA512_CHUNKS * 8][SHA512_LANES];
  __shared__ __align__(16) uint32_t tile_s[8][SHA512_TILE_STRIDE];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * SHA512_LANES;
  const bool in_batch = base + l < B;
  const int64_t lane = in_batch ? base + l : B - 1;
  int32_t ln = __ldg(msg_len + lane);
  ln = ln < 0 ? 0 : (ln > max_len ? max_len : ln);
  const uint32_t len = (uint32_t)ln + 64;
  const uint32_t nb = (len + 17 + 127) / 128;
  const uint32_t nb_max = __reduce_max_sync(0xffffffffu, nb);
  if (warp == 1) {
    sha512_message_warp(Sha512RowsRAM{sig, pk, msg}, B, base, lane, l, len,
                        __reduce_max_sync(0xffffffffu, len), nb, nb_max, wide, tile_s, wk_s);
    return;
  }
  uint64_t st[8], kw[4];
  sha512_round_warp(nb, nb_max, l, st, wk_s);
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

// K12: ok and r_cmp == R (R has Z = 1), as ok && X_R Z == X && Y_R Z == Y.
// One thread a lane ran both products and both canonicalisations in one
// chain, behind a load of ok that gated its 50 limb loads (two memory round
// trips in series), 128 threads a block: 8 blocks on 8 of 132 SMs at the
// split pipeline's B = 1,024; 3.7 us device only against probe_add's 2.09
// us launch floor.  Here a lane is two threads of a half-warp pair: thread
// c of the pair (c = 0: X, c = 1: Y) loads ok, Z of r_cmp and its own
// coordinate of r_cmp and of R all at once (one round trip), runs one
// inlined product and one canonicalisation, and the pair joins by one
// shuffle; 16 lanes a one-warp block, so B = 1,024 is 64 blocks and B =
// 16,384 one wave.  A refused lane (K9 may leave any bits in r_pt there)
// computes on what it loaded, unchecked, and reads false: no load waits on
// ok, and the integer products wrap; nothing is read past the batch.
#define CMP_LANES 16  // K12: lanes a one-warp block
#define CMP_THREADS (2 * CMP_LANES)

__global__ void __launch_bounds__(CMP_THREADS)
phase_compare_kernel(const int32_t* __restrict__ r_cmp, const int32_t* __restrict__ r_pt,
                     const bool* __restrict__ ok, bool* __restrict__ mask, int64_t B) {
  const int t = threadIdx.x;
  const int c = t / CMP_LANES;
  const int64_t l = (int64_t)blockIdx.x * CMP_LANES + t % CMP_LANES;
  const bool in_batch = l < B;
  const int64_t lane = in_batch ? l : B - 1;
  const bool m = ok[lane];
  const fe z = fe_load_lane(r_cmp + 20 * B, B, lane);
  const fe p = fe_load_lane(r_cmp + 10 * c * B, B, lane);
  const fe q = fe_load_lane(r_pt + 10 * c * B, B, lane);
  const bool eq = fe_eq(fe_mul_q(q, z), p);
  // every thread shuffles (no early exit), then the X thread stores
  const bool other = __shfl_xor_sync(0xffffffffu, (int)eq, CMP_LANES) != 0;
  if (in_batch && c == 0) mask[l] = m && eq && other;
}

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
  const int64_t blocks = (B + SHA512_LANES - 1) / SHA512_LANES;
  phase_hash_kernel<<<(unsigned)blocks, SHA512_THREADS, 0, (cudaStream_t)stream>>>(
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
  const int64_t blocks = (B + CMP_LANES - 1) / CMP_LANES;
  phase_compare_kernel<<<(unsigned)blocks, CMP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)r_cmp, (const int32_t*)r_pt, (const bool*)ok, (bool*)mask, B);
  return (int)cudaGetLastError();
}
