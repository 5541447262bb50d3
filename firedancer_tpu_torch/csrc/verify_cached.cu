// K6 verify_cached: batched ed25519 verification for signers whose comb of
// -A is resident in the bank, four threads a signature, one launch per
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
// a pubkey that fails them never enters the bank.  Lanes >= n_real, and
// lanes rejected before the sum, read no bank.
//
// Bound: integer multiplies, 123,185 32x32->64 products a valid lane
// (ops/sigverify.py PRODUCTS_PER_CACHED_LANE: R's decompression and small
// order, 267 squarings of 55 and 32 multiplies; 128 cached adds of 8
// multiplies; the join and the compare) plus SHA-512 over 64 + len bytes;
// and 128 x 160 bytes of bank and base-comb entries.  A 2,048-slot bank is
// 336 MB, larger than L2, so the bank's reads come from HBM.
//
// The one-thread kernel ran each lane as one dependent chain (R, the hash,
// 128 cached adds through one accumulator: ~1,330 multiplies) at 128
// threads a block, so B = 1,024 was 8 blocks on 8 of 132 SMs and its time
// did not move with B.  The comb sum has no doublings, so it is
// associative.  Here a block is 128 threads, four warps, for 32
// signatures:
//   - phase A, one signature a thread: warp 0 decompresses and checks the
//     32 R's (ge_decompress_strict_q: inlined multiplies, 55-product
//     squarings) while warp 1 hashes and reduces the 32 k's; neither warp
//     diverges, and the two run side by side on their own schedulers.  (On
//     one quad, thread 1 taking R and thread 2 the hash, the two paths
//     diverged and ran in turn, on a quarter of the lanes: 0.333 ms at B =
//     1,024 but 1.064 ms at 16,384, slower than the one-thread kernel's
//     0.765, on an H100 80GB HBM3 at 700 W.)  A block whose lanes all
//     failed s < L or the length, or all lie past n_real, stops before it;
//   - phase B, four threads a signature (csrc/curve_quad.cuh), 8 a warp:
//     thread c sums windows 16c .. 16c+15 of both the signer's slot and
//     the base comb, 32 one-thread cached adds (curve.cuh ge_add_cached),
//     the same code on all four threads; each entry's 160 bytes are
//     fetched by cp.async into shared memory one add ahead (two stages,
//     40 KB a block), so the HBM latency hides behind the add before it;
//     a warp whose lanes all failed stops first;
//   - the four partial sums join as a quad point: thread 0's sum, then
//     quad additions of threads 1-3's cached forms; thread 0 compares x
//     and thread 1 y with R at Z = 1.
// The critical path is max(R's decompression, the hash), 32 cached adds
// and the join, where it was ~1,330 multiplies and the hash.  At the
// stage's B = 1,024 the batch is 32 blocks, 4 warps on each of 32 SMs,
// and latency sets the time: the kernel takes all the registers it wants
// (two blocks an SM).  Past one such wave (B > 64 x the SMs) throughput
// does, and the kernel built for four blocks an SM (128 registers) keeps
// 16 warps an SM busy where the other would keep 8.
// ptxas (nvcc 12.8, sm_90a): for two blocks an SM, 255 registers, 52 bytes
// of spill stores and 32 of loads (272 bytes of stack), 44,672 bytes of
// shared memory; for four, 128 registers, 352 and 408 bytes of spills (864
// of stack); ge_decompress_strict_q spills 60 / 104 and 668 / 828 bytes.
#include "curve_quad.cuh"
#include "sha512.cuh"

#define CACHED_SIGS_PER_BLOCK 32
#define CACHED_THREADS (4 * CACHED_SIGS_PER_BLOCK)
#define CACHED_PIECES (COMB_ENTRY_INTS / 4)  // 16-byte pieces of an entry
#define CACHED_ADDS 32                        // a thread's cached adds
#define CACHED_WIDE_BLOCKS 4                  // blocks an SM when the batch is wide

__device__ __forceinline__ void cp_async16(int4* smem, const int4* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Add i of a thread's sum (i = 0 .. 31): window i / 2 of its sixteen,
// from the signer's comb `win` for even i (k's digit) and from the base
// comb `bwin` for odd i (s's digit).
__device__ __forceinline__ const int4* cached_entry(const int32_t* win, const int32_t* bwin,
                                                    uint64_t kword, uint64_t sword, int i) {
  const int w = i >> 1;
  const int dig = (int)(((i & 1 ? sword : kword) >> (4 * w)) & 15);
  return reinterpret_cast<const int4*>((i & 1 ? bwin : win) + w * COMB_WINDOW_INTS +
                                       dig * COMB_ENTRY_INTS);
}

template <int MIN_BLOCKS>
__global__ void __launch_bounds__(CACHED_THREADS, MIN_BLOCKS)
verify_cached_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ msg_len,
                     const uint8_t* __restrict__ sig, const uint8_t* __restrict__ pk,
                     const int32_t* __restrict__ bank, const int32_t* __restrict__ slots,
                     const int32_t* __restrict__ comb, bool* __restrict__ mask,
                     int32_t* __restrict__ ok_count, int64_t B, int max_len,
                     int64_t n_real) {
  // the entries in flight: stage, 16-byte piece, thread (conflict-free)
  __shared__ int4 buf_s[2][CACHED_PIECES][CACHED_THREADS];
  // phase A's results a signature: R's x and y (limb-major), R's check, k
  __shared__ int32_t r_s[20][CACHED_SIGS_PER_BLOCK];
  __shared__ int32_t r_ok_s[CACHED_SIGS_PER_BLOCK];
  __shared__ uint64_t k_s[4][CACHED_SIGS_PER_BLOCK];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * CACHED_SIGS_PER_BLOCK;

  // every thread: its signature's s < L and length (thread c of quad q
  // holds signature base + q); a block whose lanes all failed, or all lie
  // past n_real, stops
  const QuadRole role = quad_role(t & 3);
  const int q = t >> 2;
  const int64_t s_idx = base + q;
  const bool in_batch = s_idx < B;
  const int64_t lane = in_batch ? s_idx : B - 1;  // loads stay inside the batch
  uint64_t sw[4];
  fd_load32(sig + 32 * B, B, lane, sw);
  const int32_t len = __ldg(msg_len + lane);
  bool ok = in_batch && s_idx < n_real && sc_validate(sw) && len >= 0 && len <= max_len;
  if (!__syncthreads_or(ok)) {
    if (role.c == 0 && in_batch) mask[s_idx] = false;
    return;
  }

  // phase A, one signature a thread: warp 0 decompresses and checks R,
  // warp 1 hashes and reduces k, each for the block's 32 signatures (two
  // warps side by side, neither diverging); warps 2-3 wait
  const int warp = t >> 5, l = t & 31;
  if (warp < 2) {
    const int64_t lane_a = base + l < B ? base + l : B - 1;
    if (warp == 0) {
      uint64_t w[4];
      fd_load32(sig, B, lane_a, w);
      const ge_ok d = ge_decompress_strict_q(w[0], w[1], w[2], w[3]);
#pragma unroll
      for (int i = 0; i < 10; i++) {
        r_s[i][l] = d.p.X.v[i];
        r_s[10 + i][l] = d.p.Y.v[i];
      }
      r_ok_s[l] = d.ok;
    } else {
      const int32_t la = __ldg(msg_len + lane_a);
      const int32_t hl = la < 0 ? 0 : (la > max_len ? max_len : la);
      uint64_t st[8], kw[4];
      sha512_lane(VerifySrc{sig, pk, msg, B, lane_a}, (uint32_t)hl + 64, st);
      sc_reduce512(st, kw);
#pragma unroll
      for (int i = 0; i < 4; i++) k_s[i][l] = kw[i];
    }
  }
  __syncthreads();

  // phase B, four threads a signature; a warp whose lanes all failed stops
  ok = ok && r_ok_s[q];
  if (!__any_sync(QUAD_FULL, ok)) {
    if (role.c == 0 && in_batch) mask[s_idx] = false;
    return;
  }
  uint64_t kw[4];
#pragma unroll
  for (int i = 0; i < 4; i++) kw[i] = k_s[i][q];
  // R's x for thread 0, its y for thread 1 (the compare's operands)
  fe r_own;
#pragma unroll
  for (int i = 0; i < 10; i++) r_own.v[i] = r_s[(role.c == 0 ? 0 : 10) + i][q];

  // the comb sum: thread c adds windows 16c .. 16c+15, each the signer's
  // entry for k's digit, then the base comb's for s's; a lane that failed
  // reads the base comb in its slot's place
  const int32_t* slot = ok ? bank + (int64_t)__ldg(slots + lane) * COMB_SLOT_INTS : comb;
  const uint64_t kword = pick4(kw, role.c), sword = pick4(sw, role.c);
  const int32_t* win = slot + 16 * role.c * COMB_WINDOW_INTS;
  const int32_t* bwin = comb + 16 * role.c * COMB_WINDOW_INTS;
  {
    const int4* e = cached_entry(win, bwin, kword, sword, 0);
#pragma unroll
    for (int p = 0; p < CACHED_PIECES; p++) cp_async16(&buf_s[0][p][t], e + p);
    cp_async_commit();
  }
  ge part = ge_identity();
#pragma unroll 1
  for (int i = 0; i < CACHED_ADDS; i++) {
    if (i + 1 < CACHED_ADDS) {
      const int4* e = cached_entry(win, bwin, kword, sword, i + 1);
#pragma unroll
      for (int p = 0; p < CACHED_PIECES; p++) cp_async16(&buf_s[(i + 1) & 1][p][t], e + p);
    }
    cp_async_commit();  // empty at the last add: the wait below counts groups
    cp_async_wait_one();
    int4 x[CACHED_PIECES];
#pragma unroll
    for (int p = 0; p < CACHED_PIECES; p++) x[p] = buf_s[i & 1][p][t];
    part = ge_add_cached(part, gec_from_pieces(x));
  }

  // the join: thread 0's sum as a quad point, plus threads 1-3's
  const gec pc = ge_to_cached(part);
  fe acc = quad_take(part, 0, role);
#pragma unroll 1
  for (int src = 1; src < 4; src++) acc = quad_add(acc, quad_take_cached(pc, src, role), role);

  // R == acc at Z2 = 1: thread 0 checks x, thread 1 y
  const fe z = fe_shfl(acc, 2);
  const int eq = fe_eq(fe_mul_q(r_own, z), acc);
  const int eq_x = __shfl_sync(QUAD_FULL, eq, 0, 4);
  const int eq_y = __shfl_sync(QUAD_FULL, eq, 1, 4);
  ok = ok && eq_x && eq_y;
  if (role.c == 0 && in_batch) {
    mask[s_idx] = ok;
    if (ok) atomicAdd(ok_count, 1);
  }
}

FD_EXPORT int fd_verify_cached(const void* msg, const void* msg_len, const void* sig,
                               const void* pk, const void* bank, const void* slots,
                               const void* comb, void* mask, void* ok_count, int64_t B,
                               int max_len, int64_t n_real, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  int sms = 0;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc) return rc;
  const int64_t blocks = (B + CACHED_SIGS_PER_BLOCK - 1) / CACHED_SIGS_PER_BLOCK;
  // one wave at two blocks an SM: all the registers; wider: 128 a thread
  auto kernel = &verify_cached_kernel<1>;
  if (blocks > 2 * (int64_t)sms) kernel = &verify_cached_kernel<CACHED_WIDE_BLOCKS>;
  kernel<<<(unsigned)blocks, CACHED_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)msg_len, (const uint8_t*)sig,
      (const uint8_t*)pk, (const int32_t*)bank, (const int32_t*)slots,
      (const int32_t*)comb, (bool*)mask, (int32_t*)ok_count, B, max_len, n_real);
  return (int)cudaGetLastError();
}
