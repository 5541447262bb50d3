// K6 verify_cached: batched ed25519 verification for signers whose comb of
// -A is resident in the bank, one signature per thread, one launch per
// batch of the stage's cached lane.
//
// Replaces: firedancer_tpu/ops/sigverify.py:138 ed25519_verify_batch_cached
// with ops/curve.py:429 double_scalar_mul_comb inlined (and the fused
// contract of K1: pad lanes >= n_real write false, the ok-count goes
// through atomicAdd into an int32 the wrapper zeroes).
//
// Per lane: reject s >= L; reject a length outside [0, max_len];
// decompress R and reject failures and small-order R; k = SHA512(R || A ||
// msg) mod L, hashed in place (VerifySrc); accept iff [s]B + [k](-A) == R
// (Z2 = 1) with [k](-A) from the signer's bank slot.  A's decompression and
// small-order check were made once, by comb_fill, when the slot was filled:
// a pubkey that fails them never enters the bank.  Lanes >= n_real read no
// bank.
//
// Bound: integer multiplies.  ~1,330 field multiplies per lane (R's
// decompression and small-order check ~300, 128 cached adds x 8, the
// compare) plus SHA-512 over 64 + len bytes, about a third of K1's ~4,000;
// and 64 x 160 bytes read from the signer's slot.  A 2,048-slot bank is
// 336 MB, larger than L2, so those reads come from HBM: 168 MB at
// B = 16,384, ~50 us at 3.35 TB/s.  Design: K1's launch shape and lane
// code, no per-lane table and no doublings; each bank entry is one
// contiguous 160-byte read as ten 16-byte __ldg loads.
#include "curve.cuh"
#include "sha512.cuh"

__device__ bool verify_cached_lane(const uint8_t* __restrict__ msg, int32_t msg_len,
                                   const uint8_t* __restrict__ sig,
                                   const uint8_t* __restrict__ pk,
                                   const int32_t* __restrict__ slot,
                                   const int32_t* __restrict__ comb, int64_t B,
                                   int64_t lane, int max_len) {
  uint64_t sw[4];
  fd_load32(sig + 32 * B, B, lane, sw);
  if (!sc_validate(sw)) return false;
  if (msg_len < 0 || msg_len > max_len) return false;
  uint64_t rw[4];
  fd_load32(sig, B, lane, rw);
  ge R;
  if (!ge_decompress(rw, R)) return false;
  if (ge_is_small_order(R)) return false;

  uint64_t st[8], kwords[4];
  VerifySrc src{sig, pk, msg, B, lane};
  sha512_lane(src, (uint32_t)msg_len + 64, st);
  sc_reduce512(st, kwords);

  uint8_t kw[64], s_w[64];
  sc_windows(kwords, kw);
  sc_windows(sw, s_w);
  ge r_cmp = ge_double_scalar_mul_comb(kw, s_w, slot, comb);
  return ge_eq_z1(r_cmp, R);
}

__global__ void __launch_bounds__(128)
verify_cached_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ msg_len,
                     const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
                     const int32_t* __restrict__ bank, const int32_t* __restrict__ slots,
                     const int32_t* __restrict__ comb, bool* __restrict__ mask,
                     int32_t* __restrict__ ok_count, int64_t B, int max_len,
                     int64_t n_real) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bool ok = false;
  if (lane < n_real)
    ok = verify_cached_lane(msg, msg_len[lane], sig, pk,
                            bank + (int64_t)slots[lane] * COMB_SLOT_INTS, comb, B,
                            lane, max_len);
  mask[lane] = ok;
  if (ok) atomicAdd(ok_count, 1);
}

FD_EXPORT int fd_verify_cached(const void* msg, const void* msg_len, const void* sig,
                               const void* pk, const void* bank, const void* slots,
                               const void* comb, void* mask, void* ok_count, int64_t B,
                               int max_len, int64_t n_real, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  verify_cached_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)msg_len, (const uint8_t*)sig,
      (const uint8_t*)pk, (const int32_t*)bank, (const int32_t*)slots,
      (const int32_t*)comb, (bool*)mask, (int32_t*)ok_count, B, max_len, n_real);
  return (int)cudaGetLastError();
}
