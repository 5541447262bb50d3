// K8 bank_install: write M combs into their bank slots in place,
// bank[slots[i]] = tables[i], each a row of 40,960 int32 (160 KB).
//
// Replaces: firedancer_tpu/ops/sigverify.py:188 bank_install (a donated
// scatter on the bank's trailing slot axis).  It is a kernel of its own,
// not fused into comb_fill, because the stage learns which columns are
// valid only from comb_fill's ok mask and assigns slots between the two
// launches (runtime/verify.py _fill_bank).
//
// Bound: bytes, 2 x M x 163,840 (each table read once, each slot written
// once), ~3 us at M = 32 on 3.35 TB/s.  Design: one block of 256 threads
// per (column, 16 KB chunk), 16-byte loads and stores, neighbouring threads
// on neighbouring addresses; slots come as int64 (the index type of
// torch.index_copy_, the plain version).
#include "fd_common.cuh"

#define SLOT_INT4 (40960 / 4)
#define CHUNK_INT4 1024
#define CHUNKS_PER_SLOT (SLOT_INT4 / CHUNK_INT4)

__global__ void __launch_bounds__(256)
bank_install_kernel(int4* __restrict__ bank, const int4* __restrict__ tables,
                    const int64_t* __restrict__ slots) {
  const int64_t col = blockIdx.x / CHUNKS_PER_SLOT;
  const int64_t off = (int64_t)(blockIdx.x % CHUNKS_PER_SLOT) * CHUNK_INT4;
  int4* dst = bank + slots[col] * SLOT_INT4 + off;
  const int4* src = tables + col * SLOT_INT4 + off;
#pragma unroll
  for (int i = threadIdx.x; i < CHUNK_INT4; i += 256) dst[i] = __ldg(src + i);
}

FD_EXPORT int fd_bank_install(void* bank, const void* tables, const void* slots,
                              int64_t M, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (M == 0) return 0;
  bank_install_kernel<<<(unsigned)(M * CHUNKS_PER_SLOT), 256, 0, (cudaStream_t)stream>>>(
      (int4*)bank, (const int4*)tables, (const int64_t*)slots);
  return (int)cudaGetLastError();
}
