// K7 comb_fill: decompress and strictly check M pubkeys and build each
// one's comb of -A, [m 16^j](-A) for 64 windows x 16 digits, in the bank's
// slot layout (csrc/curve.cuh).
//
// Replaces: firedancer_tpu/ops/sigverify.py:175 comb_fill with
// ops/curve.py:399 comb_tables inlined.
//
// One block of 64 threads per pubkey.  Thread 0 decompresses A, checks it
// (ok = decompresses and is not of small order) and runs the serial chain
// A_j = [16^j]A, four doublings per window, into shared memory (64 points,
// 10 KB).  After the barrier, thread j builds window j's 16 entries from
// A_j (ge_comb_window: 7 doublings, 7 cached adds, 16 conversions to
// cached form) and writes them, 2,560 contiguous bytes per thread.  The
// tables are built for every column, ok or not, exactly as the plain
// version does; the caller installs only the ok columns.
//
// Bound: integer multiplies, ~10,500 field multiplies per pubkey (~2,300
// on the serial chain: decompression, small order, 252 doublings; then
// 64 x 128 in parallel), against 163,840 bytes written per pubkey.  At the
// stage's 32 keys per call this is 32 blocks on 32 SMs and the chain's
// latency sets the time; the split into a serial chain and 64 parallel
// windows shortens that critical path ~4x against one pubkey per thread.
#include "curve.cuh"

__global__ void __launch_bounds__(64)
comb_fill_kernel(const uint8_t* __restrict__ pk, int32_t* __restrict__ tables,
                 bool* __restrict__ ok, int64_t M) {
  __shared__ ge aj[64];
  const int64_t key = blockIdx.x;
  const int j = threadIdx.x;
  if (j == 0) {
    uint64_t w[4];
    fd_load32(pk, M, key, w);
    ge a;
    const bool dec = ge_decompress(w, a);
    ok[key] = dec && !ge_is_small_order(a);
    aj[0] = a;
    for (int i = 1; i < 64; i++) {
      for (int d = 0; d < 4; d++) a = ge_dbl(a);
      aj[i] = a;
    }
  }
  __syncthreads();
  ge_comb_window(aj[j], tables + key * COMB_SLOT_INTS + (int64_t)j * COMB_WINDOW_INTS);
}

FD_EXPORT int fd_comb_fill(const void* pk, void* tables, void* ok, int64_t M,
                           int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (M == 0) return 0;
  comb_fill_kernel<<<(unsigned)M, 64, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (int32_t*)tables, (bool*)ok, M);
  return (int)cudaGetLastError();
}
