// K5 gf256_apply: a GF(2^8) matrix applied to byte columns, batched over
// sets:  out[t, r, s] = XOR_c gf_mul(mat[t * stride, r, c], data[t, c, s]),
// POLY 0x11D.  With stride 0 every set shares one matrix (Reed-Solomon
// encode: the generator's parity rows); with stride m * k each set has its
// own (recover: one rebuild matrix per erasure pattern).
//
// Replaces: firedancer_tpu/ops/gf256.py:64 _gf2_matmul_bits (reached from
// reedsol.encode_core :59, encode :71, recover :158) and :82 _gf2_bmm_bits
// (reedsol.recover_batch :197), with unpack_bits/pack_bits (:49/:56).  Like
// the TPU program, it lifts the matrix to its (8m, 8k) GF(2) bit matrix and
// takes the product on the matrix unit: int8 tensor cores with int32 sums,
// keeping one bit of each sum.
//
// Bound.  The main paths launch one FEC set at a time: (19 + 27) x 1,019 B
// and (8 + 22) x 1,039 B encodes, (46 x 19) x 1,019 B rebuilds.  There the
// bytes, the tensor-core operations (8m x 8k x S multiply-adds) and a
// table-lookup form's instructions all take well under a microsecond, so
// what bounds a launch is its latency: the launch, one round trip to
// memory for the coefficients and the data, the product's dependent steps,
// and how many SMs share the work.  At the plane's batch encode (1,024
// sets of 32 + 32 x 1,024 B) the tensor-core operations bind (0.069 ms at
// 1,979 TOP/s int8; the bytes 0.020 ms).
//
// Design.
// - The product: mma.sync m16n8k32 s8 x s8 -> s32.  A is the matrix side,
//   B the data side, N the data columns.  A block takes one set, one group
//   of 16 output rows (bytes) and a run of 64-column chunks; it expands its
//   16 rows of coefficients into A itself (recover has a matrix per set),
//   in shared memory in fragment order: one 16-byte load a lane feeds the
//   four MMAs of a bit tile and k-step.
// - A's rows: 8 bit tiles of 16 rows; tile i, row g is bit i of output
//   byte g (g < 16).  Its entries are 2^i or 0 (the product's bit i, left
//   in place), so bit i of the int32 sum is the XOR: a thread's four
//   accumulators of tiles 0-7 hold all eight bits of its output bytes, and
//   an output byte is eight LOP3s with no shuffle.  (2^7 is -128 as s8;
//   -128 * n and 128 * n agree in bit 7.)  Sums stay below 128 * 8 * 68.
// - A's columns: a k-step of 32 bits is 4 input bytes; the thread that
//   holds B rows 4t..4t+3 and 16+4t..16+4t+3 gets all eight bits of input
//   byte 4 * step + t, so a data byte unpacks in its own registers: each
//   nibble spreads to four int8 lanes with one multiply and one mask
//   (n * 0x00204081 & 0x01010101).  k is padded to a multiple of 4 bytes
//   with zero columns in A (at most 68: the RS maximum d = 67).
// - B's columns: n-tile nt's column g is data column 4g + nt of a warp's
//   32-column group, so one 32-bit shared load gives a thread its byte for
//   four n-tiles, and its accumulators (columns 2t, 2t + 1 of each n-tile)
//   are the 8 consecutive columns 8t..8t+7 of rows g and g + 8: one 8-byte
//   store a row when rows are 8-byte aligned, else byte stores.
// - Data tiles: a warp's k x 32 bytes in shared memory (rows of 32 bytes:
//   the four rows of one load fall on four disjoint bank octets).  When
//   rows are 16-byte aligned they come by cp.async, double-buffered over
//   the warp's groups; else each lane loads its column's bytes, all k in
//   flight at once.
// - The grid is (set, row group, column run).  The entry point gives each
//   block as few 64-column chunks as keep 4 blocks an SM in the grid, so
//   one set (1, 27 x 19, 1,019) spreads over 32 blocks of 2 warps, while a
//   batch of sets takes whole rows a block and expands A once for them.
//
// Layout: mat (T or 1, m, k) uint8, data (T, k, S) uint8, out (T, m, S)
// uint8, all contiguous.  ops/gf256.py `bit_tiles` builds the same A
// operand on the host, for the CPU tests of this layout.
#include "fd_common.cuh"

#define GF_WARPS 2                 // warps a block; a chunk is 32 columns a warp
#define GF_THREADS (32 * GF_WARPS)
#define GF_ROWS 16                 // output rows (bytes) a block
#define GF_TILES 8                 // bit tiles of 16 A rows: one per output bit
#define GF_KMAX 68                 // input bytes, padded to a multiple of 4
#define GF_COEF_ITERS ((GF_ROWS * GF_KMAX + GF_THREADS - 1) / GF_THREADS)
#define GF_VEC_ITERS ((2 * GF_KMAX + 31) / 32)

__device__ __forceinline__ void gf_mma(int (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Four bits (a nibble) to four int8 lanes of 0 or 1, low bit in lane 0.
__device__ __forceinline__ uint32_t gf_spread(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void gf_cp_async16(uint8_t* dst, const uint8_t* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// One warp's 32-column group from 16-byte aligned rows into `tile` (k rows
// of 32 bytes, zeros past k and past S), asynchronously; then a commit.
__device__ __forceinline__ void gf_tile_async(uint8_t* tile, const uint8_t* __restrict__ dset,
                                              int k, int kpad, int64_t S, int64_t grp,
                                              int lane) {
#pragma unroll
  for (int u = 0; u < GF_VEC_ITERS; u++) {
    const int idx = lane + 32 * u, row = idx >> 1, half = idx & 1;
    const int64_t col = grp * 32 + 16 * half;
    if (row < kpad) {
      const bool full = row < k && col < S;
      gf_cp_async16(tile + row * 32 + 16 * half, full ? dset + row * S + col : dset, full);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The same group from rows of any alignment: lane = column, one byte a row,
// every load issued before the first store.
__device__ __forceinline__ void gf_tile_bytes(uint8_t* tile, const uint8_t* __restrict__ dset,
                                              int k, int kpad, int64_t S, int64_t grp,
                                              int lane) {
  const int64_t col = grp * 32 + lane;
  uint32_t v[GF_KMAX];
#pragma unroll
  for (int c = 0; c < GF_KMAX; c++)
    v[c] = (c < k && col < S) ? (uint32_t)__ldg(dset + c * S + col) : 0u;
#pragma unroll
  for (int c = 0; c < GF_KMAX; c++)
    if (c < kpad) tile[c * 32 + lane] = (uint8_t)v[c];
}

// One warp's 16 rows x 32 columns: the k-steps' MMAs over the 8 bit tiles
// and 4 n-tiles, then each output byte from bit i of tile i's sums.
__device__ __forceinline__ void gf_group(const uint4* __restrict__ sA, const uint8_t* tile,
                                         int ks_n, uint8_t* __restrict__ oset, int r0, int m,
                                         int64_t S, int64_t grp, int lane, bool vec_out) {
  const int g = lane >> 2, t = lane & 3;
  int acc[4][GF_TILES][4];
#pragma unroll
  for (int nt = 0; nt < 4; nt++)
#pragma unroll
    for (int i = 0; i < GF_TILES; i++)
#pragma unroll
      for (int e = 0; e < 4; e++) acc[nt][i][e] = 0;
  for (int ks = 0; ks < ks_n; ks++) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + (4 * ks + t) * 32 + 4 * g);
    uint32_t b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; nt++) {
      b[nt][0] = gf_spread((w >> (8 * nt)) & 0xFu);
      b[nt][1] = gf_spread((w >> (8 * nt + 4)) & 0xFu);
    }
    const uint4* a_ks = sA + ks * GF_TILES * 32 + lane;
#pragma unroll
    for (int i = 0; i < GF_TILES; i++) {
      const uint4 a = a_ks[i * 32];
#pragma unroll
      for (int nt = 0; nt < 4; nt++) gf_mma(acc[nt][i], a, b[nt][0], b[nt][1]);
    }
  }
  // accumulator e: row g + 8 * (e >> 1), column 2t + (e & 1) of each
  // n-tile, i.e. data columns 8t + 4 * (e & 1) + nt
#pragma unroll
  for (int rr = 0; rr < 2; rr++) {
    const int r = r0 + g + 8 * rr;
    if (r >= m) continue;
    uint32_t word[2];
#pragma unroll
    for (int h = 0; h < 2; h++) {
      uint32_t wd = 0;
#pragma unroll
      for (int nt = 0; nt < 4; nt++) {
        uint32_t byte = 0;
#pragma unroll
        for (int i = 0; i < GF_TILES; i++) byte |= (uint32_t)acc[nt][i][2 * rr + h] & (1u << i);
        wd |= byte << (8 * nt);
      }
      word[h] = wd;
    }
    const int64_t col = grp * 32 + 8 * t;
    uint8_t* orow = oset + (int64_t)r * S;
    if (vec_out) {
      if (col < S) *reinterpret_cast<uint2*>(orow + col) = make_uint2(word[0], word[1]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; j++)
        if (col + j < S) orow[col + j] = (uint8_t)(word[j >> 2] >> (8 * (j & 3)));
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(GF_THREADS)
gf256_apply_kernel(const uint8_t* __restrict__ mat, int64_t mat_stride,
                   const uint8_t* __restrict__ data, uint8_t* __restrict__ out, int m, int k,
                   int64_t S, int groups_per_block, bool vec_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int kpad = (k + 3) & ~3, ks_n = kpad >> 2;
  uint4* sA = reinterpret_cast<uint4*>(smem);  // (ks_n, 8 tiles, 32 lanes) x 16 B
  uint8_t* sD = smem + (size_t)ks_n * GF_TILES * 32 * 16;  // 2 tiles a warp
  uint8_t* sC = sD + GF_WARPS * 2 * kpad * 32;             // the block's 16 x k coefficients
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t set = blockIdx.x;
  const int r0 = blockIdx.y * GF_ROWS;
  const int64_t grp1 = min((S + 31) >> 5, (int64_t)(blockIdx.z + 1) * groups_per_block);
  const uint8_t* dset = data + set * (int64_t)k * S;
  uint8_t* oset = out + set * (int64_t)m * S;
  uint8_t* const tile0 = sD + warp * 2 * kpad * 32;  // the warp's tiles: tile0 + buf * kpad * 32
  int64_t grp = (int64_t)blockIdx.z * groups_per_block + warp;

  // The first data tile and the coefficients, all loads in flight at once.
  // Rows r0..r0+15 of the set's (m, k) matrix are contiguous.
  if (VEC) {
    if (grp < grp1) gf_tile_async(tile0, dset, k, kpad, S, grp, lane);
  } else if (grp < grp1) {
    gf_tile_bytes(tile0, dset, k, kpad, S, grp, lane);
  }
  {
    const uint8_t* mrows = mat + set * mat_stride + (int64_t)r0 * k;
    const int ncoef = min(GF_ROWS, m - r0) * k;
    uint32_t cv[GF_COEF_ITERS];
#pragma unroll
    for (int u = 0; u < GF_COEF_ITERS; u++) {
      const int i = threadIdx.x + GF_THREADS * u;
      cv[u] = i < ncoef ? (uint32_t)__ldg(mrows + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < GF_COEF_ITERS; u++) {
      const int i = threadIdx.x + GF_THREADS * u;
      if (i < ncoef) sC[i] = (uint8_t)cv[u];
    }
  }
  __syncthreads();
  // A in fragment order: lane (g, t) of k-step ks holds, for tile i, the
  // products a * x^j (j = 0..3 in words 0-1, 4..7 in words 2-3) of
  // a = mat[r0 + g, c] (words 0, 2) and mat[r0 + g + 8, c] (words 1, 3),
  // c = 4 ks + t, each byte masked to bit i
  for (int it = threadIdx.x; it < ks_n * 32; it += GF_THREADS) {
    const int ks = it >> 5, ln = it & 31, gg = ln >> 2, c = 4 * ks + (ln & 3);
    uint32_t a0 = 0, a1 = 0;
    if (c < k) {
      if (r0 + gg < m) a0 = sC[gg * k + c];
      if (r0 + gg + 8 < m) a1 = sC[(gg + 8) * k + c];
    }
    uint32_t p = a0 | (a1 << 8), lo0 = 0, lo1 = 0, hi0 = 0, hi1 = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const uint32_t p0 = p & 0xFFu, p1 = (p >> 8) & 0xFFu;
      if (j < 4) {
        lo0 |= p0 << (8 * j);
        lo1 |= p1 << (8 * j);
      } else {
        hi0 |= p0 << (8 * (j - 4));
        hi1 |= p1 << (8 * (j - 4));
      }
      p = ((p << 1) & 0xFEFEu) ^ (((p >> 7) & 0x0101u) * 0x1Du);  // both times x
    }
    uint4* dst = sA + ks * GF_TILES * 32 + ln;
#pragma unroll
    for (int i = 0; i < GF_TILES; i++) {
      const uint32_t mi = 0x01010101u << i;
      dst[i * 32] = make_uint4(lo0 & mi, lo1 & mi, hi0 & mi, hi1 & mi);
    }
  }
  __syncthreads();

  if (VEC) {
    for (int buf = 0; grp < grp1; grp += GF_WARPS, buf ^= 1) {
      if (grp + GF_WARPS < grp1) {  // the next group's tile, while this one computes
        gf_tile_async(tile0 + (buf ^ 1) * kpad * 32, dset, k, kpad, S, grp + GF_WARPS, lane);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();
      gf_group(sA, tile0 + buf * kpad * 32, ks_n, oset, r0, m, S, grp, lane, vec_out);
      __syncwarp();  // every lane is done with this tile before it is refilled
    }
  } else {
    for (bool first = true; grp < grp1; grp += GF_WARPS, first = false) {
      if (!first) {  // the first group's tile came with the coefficients
        __syncwarp();
        gf_tile_bytes(tile0, dset, k, kpad, S, grp, lane);
        __syncwarp();
      }
      gf_group(sA, tile0, ks_n, oset, r0, m, S, grp, lane, vec_out);
    }
  }
}

FD_EXPORT int fd_gf256_apply(const void* mat, int64_t mat_stride, const void* data, void* out,
                             int64_t T, int m, int k, int64_t S, int vec, int device,
                             void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (T == 0 || S == 0 || m == 0) return 0;
  const int rg_n = (m + GF_ROWS - 1) / GF_ROWS;
  if (k < 0 || k > GF_KMAX || rg_n > 65535 || T > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int sms = 0;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc) return rc;
  // column runs: as few 64-column chunks a block as keep 4 blocks an SM
  const int64_t n64 = (S + 63) / 64, pairs = T * rg_n, want = 4 * (int64_t)sms;
  int64_t runs = pairs >= want ? 1 : (want + pairs - 1) / pairs;
  runs = runs > n64 ? n64 : (runs > 65535 ? 65535 : runs);
  const int64_t per_run = (n64 + runs - 1) / runs;
  runs = (n64 + per_run - 1) / per_run;
  const int kpad = (k + 3) & ~3;
  const size_t smem = (size_t)(kpad / 4) * GF_TILES * 32 * 16 + (size_t)GF_WARPS * 2 * kpad * 32 +
                      (size_t)GF_ROWS * k;
  const bool vec_out = S % 8 == 0 && ((uintptr_t)out & 7) == 0;
  const dim3 grid((unsigned)T, (unsigned)rg_n, (unsigned)runs);
  const int gpb = (int)(2 * per_run);
  if (vec) {
    if (smem > 48 * 1024) {
      rc = (int)cudaFuncSetAttribute(gf256_apply_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc) return rc;
    }
    gf256_apply_kernel<true><<<grid, GF_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)mat, mat_stride, (const uint8_t*)data, (uint8_t*)out, m, k, S, gpb,
        vec_out);
  } else {
    if (smem > 48 * 1024) {
      rc = (int)cudaFuncSetAttribute(gf256_apply_kernel<false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc) return rc;
    }
    gf256_apply_kernel<false><<<grid, GF_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)mat, mat_stride, (const uint8_t*)data, (uint8_t*)out, m, k, S, gpb,
        vec_out);
  }
  return (int)cudaGetLastError();
}

// The native shredder's parity call (firedancer_tpu_torch/native/fd_shred.cpp,
// once a FEC set): the p x d generator and the d RS rows of sz bytes are
// host memory; they go to the device scratch in `user`, K5 runs with T = 1,
// m = p, k = d on user's stream, the parity rows come back to `out`, and
// the stream is synchronized before return.  The scratch is allocated and
// kept alive by the caller (runtime/shred_native.py: torch tensors), so
// nothing here allocates.  Returns a cudaError_t (0 = ok); d > 67, p > 67
// or sz > 1,139 (the shredder's limits) are cudaErrorInvalidValue.
// `launches` counts the launches this entry made: the caller folds it into
// its launch counter.
struct fd_gf256_host_user {
  int64_t device;
  void* stream;  // cudaStream_t
  uint8_t* gen;  // >= 67 x 67 bytes on the device
  uint8_t* data;  // >= 67 x 1,139
  uint8_t* out;  // >= 67 x 1,139
  uint64_t launches;
};

FD_EXPORT int fd_gf256_encode_host(void* user, const uint8_t* gen, const uint8_t* data, uint64_t d,
                                   uint64_t p, uint64_t sz, uint8_t* out) {
  fd_gf256_host_user* u = (fd_gf256_host_user*)user;
  if (!u || d == 0 || d > 67 || p == 0 || p > 67 || sz == 0 || sz > 1139)
    return (int)cudaErrorInvalidValue;
  const int dev = (int)u->device;
  int rc = fd_set_device(dev);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)u->stream;
  rc = (int)cudaMemcpyAsync(u->gen, gen, p * d, cudaMemcpyHostToDevice, st);
  if (rc) return rc;
  rc = (int)cudaMemcpyAsync(u->data, data, d * sz, cudaMemcpyHostToDevice, st);
  if (rc) return rc;
  const int vec = sz % 16 == 0 && ((uintptr_t)u->data & 15) == 0;
  rc = fd_gf256_apply(u->gen, 0, u->data, u->out, 1, (int)p, (int)d, (int64_t)sz, vec, dev,
                      u->stream);
  if (rc) return rc;
  u->launches++;
  rc = (int)cudaMemcpyAsync(out, u->out, p * sz, cudaMemcpyDeviceToHost, st);
  if (rc) return rc;
  return (int)cudaStreamSynchronize(st);
}
