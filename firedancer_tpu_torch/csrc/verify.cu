// K1 verify_batch: batched ed25519 signature verification, one signature
// per thread, one launch per batch.
//
// Replaces: firedancer_tpu/ops/sigverify.py:97 ed25519_verify_batch_fused
// (body _verify_ok :39) and :75 ed25519_verify_batch (the same kernel with
// n_real = B), with everything they trace inlined as __device__ functions:
// ops/limbs.py (field), ops/scalar.py (sc_validate, sc_reduce512),
// ops/sha512.py (sha512_msg) and ops/curve.py (decompress, small order,
// double_scalar_mul_base, point_eq_z1).
//
// Per lane: reject s >= L; decompress A and R and reject failures; reject
// small-order A and R; k = SHA512(R || A || msg) mod L, hashed straight out
// of the three input arrays; accept iff [s]B + [k](-A) == R (Z2 = 1).
// Lanes >= n_real write false.  The ok-count goes through atomicAdd into
// an int32 the wrapper zeroes before the launch.  A lane stops at its first
// failed check: the mask is the AND of all checks either way.
//
// Bound: integer multiplies.  ~4,000 field multiplies per signature (two
// pow2523 chains, 256 doublings, ~140 cached adds), each 100 32x32->64
// products, against < 1.4 KB of input.  Design: 10 x int32 limbs with int64
// accumulators (one IMAD.WIDE per product); the per-lane [0..15](-A) table
// lives in local memory; the 164 KB base comb is uploaded once per device
// to global memory and read with __ldg (too large for __constant__); a
// direct indexed load replaces the TPU's branchless 16-way select, since
// verification works on public data.
#include "curve.cuh"
#include "sha512.cuh"

__device__ bool verify_lane(const uint8_t* __restrict__ msg, int32_t msg_len,
                            const uint8_t* __restrict__ sig,
                            const uint8_t* __restrict__ pk,
                            const int32_t* __restrict__ comb, int64_t B,
                            int64_t lane, int max_len) {
  uint64_t sw[4];
  fd_load32(sig + 32 * B, B, lane, sw);
  if (!sc_validate(sw)) return false;
  if (msg_len < 0 || msg_len > max_len) return false;
  uint64_t aw[4], rw[4];
  fd_load32(pk, B, lane, aw);
  ge A, R;
  if (!ge_decompress(aw, A)) return false;
  if (ge_is_small_order(A)) return false;
  fd_load32(sig, B, lane, rw);
  if (!ge_decompress(rw, R)) return false;
  if (ge_is_small_order(R)) return false;

  uint64_t st[8], kwords[4];
  VerifySrc src{sig, pk, msg, B, lane};
  sha512_lane(src, (uint32_t)msg_len + 64, st);
  sc_reduce512(st, kwords);

  uint8_t kw[64], s_w[64];
  sc_windows(kwords, kw);
  sc_windows(sw, s_w);
  ge r_cmp = ge_double_scalar_mul_base(kw, ge_neg(A), s_w, comb);
  return ge_eq_z1(r_cmp, R);
}

__global__ void __launch_bounds__(128)
verify_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ msg_len,
              const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
              const int32_t* __restrict__ comb, bool* __restrict__ mask,
              int32_t* __restrict__ ok_count, int64_t B, int max_len,
              int64_t n_real) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bool ok = false;
  if (lane < n_real)
    ok = verify_lane(msg, msg_len[lane], sig, pk, comb, B, lane, max_len);
  mask[lane] = ok;
  if (ok) atomicAdd(ok_count, 1);
}

FD_EXPORT int fd_verify_batch(const void* msg, const void* msg_len, const void* sig,
                              const void* pk, const void* comb, void* mask,
                              void* ok_count, int64_t B, int max_len,
                              int64_t n_real, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  verify_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)msg_len, (const uint8_t*)sig,
      (const uint8_t*)pk, (const int32_t*)comb, (bool*)mask, (int32_t*)ok_count,
      B, max_len, n_real);
  return (int)cudaGetLastError();
}
