// K4 sha256_iter32: n-fold iterated SHA-256 of B independent 32-byte
// states (the PoH hash chain, fd_poh_append), one chain per thread.
//
// Replaces: firedancer_tpu/ops/sha256.py:171 sha256_iter32 (with
// _iter32_block :158 and _compress_block :55), the PoH lane of the serving
// step (parallel/serve.py:176) and of runtime/poh.py:106 verify_segments_tpu.
//
// Bound: the dependent chain.  A chain's hashes are strictly serial (hash
// k + 1 reads hash k), so one chain can never be split across threads; a
// compression is 64 dependent rounds of ~5 instructions on the critical
// path each.  At B = 4,096 chains there are 128 warps, under one per SM,
// so the kernel is latency-bound: time ~ n x (one compression's latency),
// flat in B up to several warps per SM.  Throughput grows only with more
// chains, or with more independent work per thread (interleaving 2-4
// chains per thread for ILP), which is later work.  The operations bound
// counts ~1,320 32-bit instructions per compression (48 schedule steps x
// 10: two 3-term sigma = 2 SHF + 1 SHR + 1 LOP3 each, 2 IADD3; 64 rounds x
// 13: Sigma1/Sigma0 = 3 SHF + 1 LOP3 each, ch and maj 1 LOP3 each, 3 IADD3
// for t1, e and a; 8 final adds) before constant folding.
//
// Design: the state lives in 8 registers; each iteration compresses
// state || the constant pad block (words 8-15 = 0x80000000, 0 x 6, 256), so
// the first 16 schedule words need no loads and the compiler folds the
// pad's terms; K lives in __constant__; blocks of 32 threads spread the
// warps over every SM.  The compression is csrc/sha256.cuh's, shared with
// K14 and K15.
//
// Layout (the JAX package's): in/out (32, B) uint8 row-major, byte i of
// chain j at i * B + j, so neighbouring threads read neighbouring bytes.
// n is a runtime argument; n = 0 copies the input.
#include "sha256.cuh"

// s <- sha256(s) for a 32-byte message s (8 big-endian words).
__device__ __forceinline__ void sha256_iter32_once(uint32_t s[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = s[i];
  w[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; i++) w[i] = 0u;
  w[15] = 256u;
  sha256_init(s);
  sha256_compress(s, w);
}

__global__ void __launch_bounds__(32)
sha256_iter32_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int64_t B, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t s[8];
  sha256_load_words32(in, B, lane, s);
  for (int64_t it = 0; it < n; it++) sha256_iter32_once(s);
  sha256_store_digest(out, B, lane, s);
}

FD_EXPORT int fd_sha256_iter32(const void* in, void* out, int64_t B, int64_t n,
                               int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int threads = 32;
  const int64_t blocks = (B + threads - 1) / threads;
  sha256_iter32_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, B, n);
  return (int)cudaGetLastError();
}
