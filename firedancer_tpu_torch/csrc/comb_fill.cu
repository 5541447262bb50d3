// K7 comb_fill: decompress and strictly check M pubkeys and build each
// one's comb of -A, [m 16^j](-A) for 64 windows x 16 digits, in the bank's
// slot layout (csrc/curve.cuh), four threads a point (csrc/curve_quad.cuh).
//
// Replaces: firedancer_tpu/ops/sigverify.py:175 comb_fill with
// ops/curve.py:399 comb_tables inlined.
//
// Per key: ok = A decompresses and is not of small order; the chain A_j =
// [16^j]A, four doublings a window; window j's 16 entries -[m]A_j, m =
// 0..15, from the identity, A_j, then [m]A_j = 2 [m/2]A_j for even m and
// [m-1]A_j + A_j for odd m (the JAX package's order, so the same
// projective points as its tables).  The tables are built for every
// column, ok or not, exactly as the plain version does (ops/curve.py
// comb_tables_quad, the same sums limb for limb); the caller installs only
// the ok columns.
//
// Bound: integer multiplies, 906,285 32x32->64 products a key
// (ops/sigverify.py PRODUCTS_PER_COMB_FILL: 3,067 squarings of 55, 7,376
// multiplies of 100), against 163,840 bytes written; at the stage's M = 32
// that is 1.7 us of products and 1.6 us of bytes.  What sets the time is
// the chain's latency: the one-thread kernel ran decompression, small
// order and 252 doublings on one thread, ~2,300 dependent multiplies,
// while 63 threads waited.  Here:
//   - a block is 256 threads, 64 quads, and holds `keys` keys (1 to 4);
//   - warp 0's quad q takes key q: its four threads each decompress and
//     check A (ge_decompress_strict_q: inlined multiplies, 55-product
//     squarings; the same data, so no divergence), keep coordinate c, and
//     run the chain as quad_dbl, two multiply latencies a doubling where
//     one thread waited for eight (~504 on the chain instead of ~2,016);
//     A_j goes to shared memory, [key][limb][j][c], 10 KB a key; warps 1-7
//     wait at the barrier;
//   - then quad j builds window j of each of the block's keys in turn,
//     each entry's point by quad_dbl or quad_add and its cached form by
//     quad_to_cached; thread c writes component c of each entry, (Y-X,
//     Y+X, Z, -2dT) of [m]A_j, so an entry is one contiguous 160-byte store
//     by four neighbouring threads.
// The critical path is one key's ~830 multiply latencies (decompression
// ~270, chain ~504, a window ~45) where it was ~2,450.
// keys = min(4, ceil(M / SMs)): the fewest keys a block that still give
// every SM a block.  At the stage's M = 32 that is one key a block, 32
// blocks, and the time is one key's critical path; the kernel takes all
// the registers it wants (one block an SM).  At the voting set's M = 1,544
// it is 4 keys a block, 386 blocks: warp 0 runs four chains for the
// latency of one, and the four keys' windows keep eight warps busy.  Past
// one wave (more blocks than SMs) the kernel built for two blocks an SM
// (128 registers) runs, so one block's windows overlap another's chain:
// 1.244 ms at M = 1,544 where one block an SM took 1.693 (H100 80GB HBM3
// at 700 W).
// ptxas (nvcc 12.8, sm_90a): for one block an SM, 255 registers, 12 bytes
// of spill stores and 8 of loads (688 bytes of stack: half[] below), 40,960
// bytes of shared memory; for two, 128 registers, 20 and 8 bytes of spills
// (1,344 of stack); ge_decompress_strict_q spills 8 / 16 and 960 / 1,200.
#include "curve_quad.cuh"

#define FILL_THREADS 256
#define FILL_MAX_KEYS 4
#define FILL_AJ_INTS (64 * 4 * 10)  // one key's A_0 .. A_63 in the quad layout
#define FILL_WIDE_BLOCKS 2  // blocks an SM past one wave

// Component c of a comb entry (COMB_ENTRY_INTS int32 at e, 16-byte aligned):
// ten int32 at e + 10 c as five 8-byte stores; thread 3 stores -2dT.
__device__ __forceinline__ void quad_store_entry(int32_t* __restrict__ e, const fe& v,
                                                 const QuadRole& r) {
  const fe o = fe_select(r.c == 3, fe_neg(v), v);
  int2* q = reinterpret_cast<int2*>(e + 10 * r.c);
#pragma unroll
  for (int k = 0; k < 5; k++) q[k] = make_int2(o.v[2 * k], o.v[2 * k + 1]);
}

template <int MIN_BLOCKS>
__global__ void __launch_bounds__(FILL_THREADS, MIN_BLOCKS)
comb_fill_kernel(const uint8_t* __restrict__ pk, int32_t* __restrict__ tables,
                 bool* __restrict__ ok, int64_t M, int keys) {
  __shared__ int32_t aj_s[FILL_MAX_KEYS * FILL_AJ_INTS];  // [key][limb][j][c]
  const int t = threadIdx.x;
  const QuadRole role = quad_role(t & 3);
  const int q = t >> 2;
  const int64_t key0 = (int64_t)blockIdx.x * keys;

  if (t < 32) {
    // warp 0: quad q decompresses key0 + q and runs its chain (the quads
    // past the block's keys run key0's and store nothing)
    const bool mine = q < keys && key0 + q < M;
    const int64_t key = mine ? key0 + q : key0;
    uint64_t w[4];
    fd_load32(pk, M, key, w);
    const ge_ok d = ge_decompress_strict_q(w[0], w[1], w[2], w[3]);
    if (mine && role.c == 0) ok[key] = d.ok;
    fe a = fe_select(role.c == 0, d.p.X,
                     fe_select(role.c == 1, d.p.Y, fe_select(role.c == 2, d.p.Z, d.p.T)));
    int32_t* s = aj_s + (mine ? q : 0) * FILL_AJ_INTS + role.c;
#pragma unroll 1
    for (int j = 0; j < 64; j++) {
      if (j) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) a = quad_dbl(a, role);
      }
      if (mine) {
#pragma unroll
        for (int i = 0; i < 10; i++) s[(i * 64 + j) * 4] = a.v[i];
      }
    }
  }
  __syncthreads();

  // quad j: window j of each key, in the JAX package's order
  const int j = q;
#pragma unroll 1
  for (int k = 0; k < keys; k++) {
    const int64_t key = key0 + k;
    if (key >= M) break;  // the same for the whole block
    const int32_t* s = aj_s + k * FILL_AJ_INTS + role.c;
    fe a;
#pragma unroll
    for (int i = 0; i < 10; i++) a.v[i] = s[(i * 64 + j) * 4];
    int32_t* out = tables + key * COMB_SLOT_INTS + (int64_t)j * COMB_WINDOW_INTS;
    quad_store_entry(out, quad_cached_identity(role), role);
    const fe c1 = quad_to_cached(a, role);
    quad_store_entry(out + COMB_ENTRY_INTS, c1, role);
    fe half[8];  // [m]A_j for m < 8, the operands of the doublings
    half[1] = a;
    fe prev = a;
#pragma unroll 1
    for (int m = 2; m < 16; m++) {
      const fe p = (m & 1) ? quad_add(prev, c1, role) : quad_dbl(half[m >> 1], role);
      if (m < 8) half[m] = p;
      quad_store_entry(out + m * COMB_ENTRY_INTS, quad_to_cached(p, role), role);
      prev = p;
    }
  }
}

FD_EXPORT int fd_comb_fill(const void* pk, void* tables, void* ok, int64_t M,
                           int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (M == 0) return 0;
  int sms = 0;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc) return rc;
  const int64_t per_sm = (M + sms - 1) / sms;
  const int keys = (int)(per_sm < FILL_MAX_KEYS ? per_sm : FILL_MAX_KEYS);
  const int64_t blocks = (M + keys - 1) / keys;
  // one wave at one block an SM: all the registers; wider: 128 a thread
  auto kernel = &comb_fill_kernel<1>;
  if (blocks > sms) kernel = &comb_fill_kernel<FILL_WIDE_BLOCKS>;
  kernel<<<(unsigned)blocks, FILL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (int32_t*)tables, (bool*)ok, M, keys);
  return (int)cudaGetLastError();
}
