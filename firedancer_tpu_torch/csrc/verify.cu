// K1 verify_batch: batched ed25519 signature verification, four threads a
// signature, one launch per batch.
//
// Replaces: firedancer_tpu/ops/sigverify.py:97 ed25519_verify_batch_fused
// (body _verify_ok :39) and :75 ed25519_verify_batch (the same kernel with
// n_real = B), with everything they trace inlined as __device__ functions:
// ops/limbs.py (field), ops/scalar.py (sc_validate, sc_reduce512),
// ops/sha512.py (sha512_msg) and ops/curve.py (decompress, small order,
// double_scalar_mul_base, point_eq_z1).
//
// Per signature: reject s >= L and a length outside [0, max_len]; decompress
// A and R and reject failures; reject small-order A and R; k = SHA512(R ||
// A || msg) mod L, hashed straight out of the three input arrays; accept
// iff [s]B + [k](-A) == R (Z2 = 1).  Lanes >= n_real write false.  The
// ok-count goes through atomicAdd into an int32 the wrapper zeroes before
// the launch.  The mask is the AND of every check.
//
// Bound: integer multiplies.  ~3,800 field multiplies per signature (two
// pow2523 chains, 256 doublings, ~140 cached adds), 1,558 of them squarings
// of 55 32x32->64 products and 2,277 multiplies of 100 (313,390 products,
// ops/sigverify.py K1_PRODUCTS_PER_VALID_LANE), against < 1.4 KB of input.
// One thread per signature made that one dependent chain of ~3,800
// multiplies; here a quad of four adjacent threads shares a signature
// (csrc/curve_quad.cuh), and the chain is cut:
//   - thread 0 decompresses A and checks its order while thread 1 does R
//     (ge_decompress_strict_q: inlined multiplies, 55-product squarings),
//     and thread 2 hashes and reduces k (sha512.cuh, curve.cuh);
//   - the [0..15](-A) table is built and the 64-window ladder [k](-A) runs
//     as quad point operations, thread c holding coordinate c: two
//     multiply latencies a doubling or an addition, where one thread took
//     eight (the ladder's ~3,100 dependent multiplies become ~640);
//   - [s]B is four partial sums over the base comb (which holds [m 16^j]B
//     for every window j, so no doublings), thread c adding windows 16c to
//     16c+15 alone (curve.cuh's ge_add_cached); the four sums join the
//     ladder's result by four quad additions;
//   - thread 0 compares and writes the mask and the count.
// Each thread keeps its coordinate of the 16 table entries in shared
// memory (limb-major, conflict-free): 640 bytes a thread, 2,560 a
// signature.  Blocks are one warp of 8 signatures (20 KB of table and
// 1.25 KB for R), so B = 1,024 gives 128 blocks on 128 of the 132 SMs.
// ptxas: 255 registers, 8 bytes of spill stores and loads (8 bytes of
// stack); the registers let 8 blocks share an SM (the shared memory would
// let 10), 2 warps a scheduler, so B = 16,384 runs in 1.94 waves.
// (Capping the registers for 9 or 10 blocks an SM spills more and runs
// slower.)  A warp whose lanes all failed a
// check before the ladder, or all lie past n_real, stops there.  The 164
// KB base comb is uploaded once per device to global memory and read with
// 16-byte __ldg loads.
#include "curve_quad.cuh"
#include "sha512.cuh"

#define VERIFY_SIGS_PER_BLOCK 8
#define VERIFY_THREADS (4 * VERIFY_SIGS_PER_BLOCK)
#define VERIFY_TBL_INTS (16 * 10 * VERIFY_THREADS)

__global__ void __launch_bounds__(VERIFY_THREADS)
verify_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ msg_len,
              const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
              const int32_t* __restrict__ comb, bool* __restrict__ mask,
              int32_t* __restrict__ ok_count, int64_t B, int max_len,
              int64_t n_real) {
  __shared__ int32_t tbl_s[VERIFY_TBL_INTS];   // entry m, limb i: [(m * 10 + i) * T + t]
  __shared__ int32_t r_s[10 * VERIFY_THREADS];  // thread 0: R.x, thread 1: R.y
  const int t = threadIdx.x;
  const QuadRole role = quad_role(t & 3);
  const int64_t s_idx = (int64_t)blockIdx.x * VERIFY_SIGS_PER_BLOCK + (t >> 2);
  const bool in_batch = s_idx < B;
  const int64_t lane = in_batch ? s_idx : B - 1;  // loads stay inside the batch

  // every thread: s < L and the length
  uint64_t sw[4];
  fd_load32(sig + 32 * B, B, lane, sw);
  const int32_t len = __ldg(msg_len + lane);
  bool ok = in_batch && s_idx < n_real && sc_validate(sw) && len >= 0 && len <= max_len;
  if (!__any_sync(QUAD_FULL, ok)) {
    if (role.c == 0 && in_batch) mask[s_idx] = false;
    return;
  }

  // thread 0: A, thread 1: R, each decompressed and checked for small
  // order; thread 2: k = SHA512(R || A || msg) mod L
  ge P = ge_identity();
  uint64_t kw[4] = {0, 0, 0, 0};
  int pt_ok = 1;
  if (role.c < 2) {
    uint64_t w[4];
    fd_load32(role.c == 0 ? pk : sig, B, lane, w);
    const ge_ok d = ge_decompress_strict_q(w[0], w[1], w[2], w[3]);
    P = d.p;
    pt_ok = d.ok;
  } else if (role.c == 2) {
    uint64_t st[8];
    const int32_t hl = len < 0 ? 0 : (len > max_len ? max_len : len);
    sha512_lane(VerifySrc{sig, pk, msg, B, lane}, (uint32_t)hl + 64, st);
    sc_reduce512(st, kw);
  }
  __syncwarp();
  // every thread shuffles (no short circuit: a shuffle waits for all 32)
  const int ok_a = __shfl_sync(QUAD_FULL, pt_ok, 0, 4);
  const int ok_r = __shfl_sync(QUAD_FULL, pt_ok, 1, 4);
  ok = ok && ok_a && ok_r;
  if (!__any_sync(QUAD_FULL, ok)) {
    if (role.c == 0 && in_batch) mask[s_idx] = false;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const uint32_t lo = __shfl_sync(QUAD_FULL, (uint32_t)kw[i], 2, 4);
    const uint32_t hi = __shfl_sync(QUAD_FULL, (uint32_t)(kw[i] >> 32), 2, 4);
    kw[i] = ((uint64_t)hi << 32) | lo;
  }
  // -A and R into the quad layout: this thread's coordinate of each
  fe a = quad_take(P, 0, role);
  if (role.c == 0 || role.c == 3) a = fe_neg(a);
  fe_store_cols<VERIFY_THREADS>(r_s + t, quad_take(P, 1, role));

  // [s]B + [k](-A) (curve_quad.cuh, K11's ladder too)
  const fe acc = quad_double_scalar_mul_base<VERIFY_THREADS>(a, kw, sw, comb, tbl_s + t, role);

  // R == acc at Z2 = 1: thread 0 checks x, thread 1 y
  const fe z = fe_shfl(acc, 2);
  const int eq = fe_eq(fe_mul_q(fe_load_cols<VERIFY_THREADS>(r_s + t), z), acc);
  const int eq_x = __shfl_sync(QUAD_FULL, eq, 0, 4);
  const int eq_y = __shfl_sync(QUAD_FULL, eq, 1, 4);
  ok = ok && eq_x && eq_y;
  if (role.c == 0 && in_batch) {
    mask[s_idx] = ok;
    if (ok) atomicAdd(ok_count, 1);
  }
}

FD_EXPORT int fd_verify_batch(const void* msg, const void* msg_len, const void* sig,
                              const void* pk, const void* comb, void* mask,
                              void* ok_count, int64_t B, int max_len,
                              int64_t n_real, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int64_t blocks = (B + VERIFY_SIGS_PER_BLOCK - 1) / VERIFY_SIGS_PER_BLOCK;
  verify_kernel<<<(unsigned)blocks, VERIFY_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)msg_len, (const uint8_t*)sig,
      (const uint8_t*)pk, (const int32_t*)comb, (bool*)mask, (int32_t*)ok_count,
      B, max_len, n_real);
  return (int)cudaGetLastError();
}
