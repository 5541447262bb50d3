// K5 gf256_apply: a GF(2^8) matrix applied to byte columns, batched over
// sets:  out[t, r, s] = XOR_c gf_mul(mat[t * stride, r, c], data[t, c, s]),
// POLY 0x11D.  With stride 0 every set shares one matrix (Reed-Solomon
// encode: the generator's parity rows); with stride m * k each set has its
// own (batched recover: one rebuild matrix per erasure pattern).
//
// Replaces: firedancer_tpu/ops/gf256.py:64 _gf2_matmul_bits (reached from
// reedsol.encode_core :59, encode :71, recover :158) and :82 _gf2_bmm_bits
// (reedsol.recover_batch :197), with unpack_bits/pack_bits (:49/:56).  The
// TPU lifts the matrix to an (8m, 8k) GF(2) bit-block matrix to reach the
// MXU; this kernel does not carry that over and works on bytes instead.
//
// Bound: operations.  Each output byte costs k table multiply-adds; the
// inner loop spends ~3.5 instructions per multiply-add (per row and 4
// columns: 1 shared load of the coefficient's log, 4 adds, 4 shared byte
// loads from the exp table, 3 shifts and 3 LOP3 to merge and XOR), while
// the bytes are (k + m) per column.  At the full-block shape (T = 1,024
// sets, 32 x 32, S = 1,024) that is ~0.2 ms of instructions against
// ~0.02 ms of device memory.  A tensor-core design (int8 wgmma over the
// bit-block matrix with a mod-2 epilogue) could beat this design's bound;
// that is a later redesign.
//
// Design: one block per (set, 1,024 columns); the block copies the set's
// m x k coefficient logs, the 256-entry log table and the exp table into
// shared memory.  Zero needs no test: log(0) is stored as 511 and the exp
// table is 1,024 entries, exp[i] = alpha^(i mod 255) below 510 and 0 from
// 510 on, so any product with a zero factor indexes past 510 and reads 0.
// Each thread owns 4 consecutive columns (one uint32 load per data row,
// coalesced along S), looks up the data bytes' logs once per input row and
// accumulates a tile of 32 output rows in registers (4 bytes packed per
// row); taller matrices (recover's n rows) loop over row tiles.
//
// Layout: mat (T or 1, m, k) uint8, data (T, k, S) uint8, out (T, m, S)
// uint8, all contiguous; exp_tbl 1,024 uint8 and log_tbl 256 uint16 come
// from ops/ref/gf256_ref.py's tables (ops/gf256.py builds them).
#include "fd_common.cuh"

#define GF_THREADS 256
#define GF_COLS_PER_THREAD 4
#define GF_ROW_TILE 32

__device__ __forceinline__ uint32_t gf_load4(const uint8_t* __restrict__ row,
                                             int64_t s0, int64_t S, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + s0));
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; j++)
    if (s0 + j < S) v |= (uint32_t)__ldg(row + s0 + j) << (8 * j);
  return v;
}

__device__ __forceinline__ void gf_store4(uint8_t* __restrict__ row, int64_t s0,
                                          int64_t S, bool vec, uint32_t v) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(row + s0) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; j++)
    if (s0 + j < S) row[s0 + j] = (uint8_t)(v >> (8 * j));
}

__global__ void __launch_bounds__(GF_THREADS)
gf256_apply_kernel(const uint8_t* __restrict__ mat, int64_t mat_stride,
                   const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                   const uint8_t* __restrict__ exp_tbl,
                   const uint16_t* __restrict__ log_tbl, int m, int k, int64_t S,
                   bool vec) {
  extern __shared__ uint8_t smem[];
  uint8_t* s_exp = smem;                                        // 1,024 B
  uint16_t* s_log = reinterpret_cast<uint16_t*>(smem + 1024);   // 512 B
  uint16_t* s_mlog = reinterpret_cast<uint16_t*>(smem + 1536);  // m * k * 2 B
  const int64_t t = blockIdx.x;
  const uint8_t* mt = mat + t * mat_stride;
  for (int i = threadIdx.x; i < 1024; i += GF_THREADS) s_exp[i] = exp_tbl[i];
  for (int i = threadIdx.x; i < 256; i += GF_THREADS) s_log[i] = log_tbl[i];
  __syncthreads();
  for (int i = threadIdx.x; i < m * k; i += GF_THREADS) s_mlog[i] = s_log[mt[i]];
  __syncthreads();

  const int64_t s0 =
      ((int64_t)blockIdx.y * GF_THREADS + threadIdx.x) * GF_COLS_PER_THREAD;
  if (s0 >= S) return;
  const uint8_t* dset = data + t * (int64_t)k * S;
  uint8_t* oset = out + t * (int64_t)m * S;
  for (int r0 = 0; r0 < m; r0 += GF_ROW_TILE) {
    const int rows = min(GF_ROW_TILE, m - r0);
    uint32_t acc[GF_ROW_TILE];
#pragma unroll
    for (int r = 0; r < GF_ROW_TILE; r++) acc[r] = 0;
    for (int c = 0; c < k; c++) {
      const uint32_t dw = gf_load4(dset + (int64_t)c * S, s0, S, vec);
      const uint32_t l0 = s_log[dw & 0xFF], l1 = s_log[(dw >> 8) & 0xFF];
      const uint32_t l2 = s_log[(dw >> 16) & 0xFF], l3 = s_log[dw >> 24];
      const uint16_t* mrow = s_mlog + (int64_t)r0 * k + c;
#pragma unroll
      for (int r = 0; r < GF_ROW_TILE; r++) {
        if (r < rows) {
          const uint32_t ml = mrow[r * k];
          acc[r] ^= (uint32_t)s_exp[ml + l0] | ((uint32_t)s_exp[ml + l1] << 8) |
                    ((uint32_t)s_exp[ml + l2] << 16) | ((uint32_t)s_exp[ml + l3] << 24);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GF_ROW_TILE; r++)
      if (r < rows) gf_store4(oset + (int64_t)(r0 + r) * S, s0, S, vec, acc[r]);
  }
}

FD_EXPORT int fd_gf256_apply(const void* mat, int64_t mat_stride, const void* data,
                             void* out, const void* exp_tbl, const void* log_tbl,
                             int64_t T, int m, int k, int64_t S, int vec, int device,
                             void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (T == 0 || S == 0 || m == 0) return 0;
  const int64_t cols_per_block = (int64_t)GF_THREADS * GF_COLS_PER_THREAD;
  const dim3 grid((unsigned)T, (unsigned)((S + cols_per_block - 1) / cols_per_block));
  const size_t smem = 1536 + (size_t)m * k * 2;
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(gf256_apply_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    if (rc) return rc;
  }
  gf256_apply_kernel<<<grid, GF_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mat, mat_stride, (const uint8_t*)data, (uint8_t*)out,
      (const uint8_t*)exp_tbl, (const uint16_t*)log_tbl, m, k, S, vec != 0);
  return (int)cudaGetLastError();
}
