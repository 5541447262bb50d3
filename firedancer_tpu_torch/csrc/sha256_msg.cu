// K14 sha256_msg: batched SHA-256 of variable-length messages, one message
// per thread; K15 sha256_mix32: sha256(state || mixin) of 32-byte rows, the
// PoH mixin step.
//
// Replaces: firedancer_tpu/ops/sha256.py:122 sha256_msg (with sha256_pad
// :89, _compress_block :57 and _state_to_bytes :112) and :182 sha256_mix32;
// K14 is also the hash under the merkle layers of ops/bmtree.py
// (hash_leaves_batch, _merge_layer, layers_batch, root_batch).
//
// Bound: the dependent chain.  A message's blocks are strictly serial, and
// a compression is 64 dependent rounds, so at the batches the callers give
// (a few thousand lanes, under two warps per SM) the kernel is
// latency-bound: its time is about the longest lane's block count times one
// compression's latency.  The operations bound counts ~1,320 32-bit
// instructions per compression (chip_smoke.py SHA256_OPS_PER_COMPRESSION).
//
// Design: the TPU version pads every lane into an (NB, 16, B) word buffer in
// HBM and runs all NB blocks for every lane, keeping each lane's final-block
// state.  Here each thread pads in registers from its own length (0x80 and
// the 64-bit bit length) and stops after its own final block, so no padded
// buffer exists and a short lane costs only its own blocks.  Blocks of 32
// threads spread the warps over every SM.
//
// Layout (the JAX package's): msg (max_len, B) uint8 row-major, so byte i of
// neighbouring lanes sits at neighbouring addresses and a warp's loads of a
// row coalesce; len (B,) int32, each in [0, max_len] (the wrapper checks);
// out (32, B) uint8.  K15: state and mixin (32, B) uint8 -> out (32, B).
#include "sha256.cuh"

__global__ void __launch_bounds__(32)
sha256_msg_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ len,
                  uint8_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t st[8];
  sha256_lane(Sha256RowSrc{msg, B, lane}, (uint32_t)len[lane], st);
  sha256_store_digest(out, B, lane, st);
}

__global__ void __launch_bounds__(32)
sha256_mix32_kernel(const uint8_t* __restrict__ state, const uint8_t* __restrict__ mixin,
                    uint8_t* __restrict__ out, int64_t B) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t st[8], w[16];
  sha256_load_words32(state, B, lane, w);
  sha256_load_words32(mixin, B, lane, w + 8);
  sha256_init(st);
  sha256_compress(st, w);
  // the constant pad block of a 64-byte message: 0x80, zeros, 512 bits
  w[0] = 0x80000000u;
#pragma unroll
  for (int i = 1; i < 15; i++) w[i] = 0u;
  w[15] = 512u;
  sha256_compress(st, w);
  sha256_store_digest(out, B, lane, st);
}

FD_EXPORT int fd_sha256_msg(const void* msg, const void* len, void* out, int64_t B,
                            int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  sha256_msg_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (const int32_t*)len, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}

FD_EXPORT int fd_sha256_mix32(const void* state, const void* mixin, void* out, int64_t B,
                              int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  sha256_mix32_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)state, (const uint8_t*)mixin, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
