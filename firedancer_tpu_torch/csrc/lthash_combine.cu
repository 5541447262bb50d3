// K13 lthash_combine: the signed lattice sum of N account hashes,
// out[j] = sum_i signs[i] * values[i][j] mod 2^16 over (N, 1024) u16 rows.
//
// Replaces: firedancer_tpu/ops/lthash.py:43 combine_device (XLA: widen to
// int32, multiply by the row's sign, sum over rows, mask 0xFFFF), the
// accounts-delta reduction of every slot's bank hash
// (flamenco/runtime.py:1102, inside SlotExecution.seal).
//
// Bound: bytes, N x (2,048 + 1) read once plus 4 KB written; at a seal's
// ~1,000 rows that is ~0.6 us on 3.35 TB/s, below one launch's own ~2 us,
// so fixed costs set the time there.  The parent paid three launches (a
// zero fill of the output, the sum with atomicAdd into it, a mask pass);
// each thread read one 32-bit word a row, 4 KB in flight a block.
//
// Design: one launch that writes the answer.
//   - Loads: a block of 256 threads takes a chunk of rows (a multiple of
//     8); thread t reads 16-byte vectors (8 lanes) of column t % 128, rows
//     of parity t / 128, four rows in flight, so a block has 16 KB of
//     loads outstanding, and the sign once a row for its 8 lanes.
//   - Exact u16 lanes from 32-bit words: a thread keeps, for each word of
//     two lanes, full = sum s * word and lo = sum s * (word & 0xFFFF), both
//     mod 2^32.  lo's low 16 bits are the even lane's sum, and full - lo
//     = 2^16 x the odd lane's sum mod 2^32, so (full - lo) >> 16 is the
//     odd lane's sum mod 2^16, whatever the carries and the row order.
//   - The sum across blocks, in the same launch.  Blocks run in clusters
//     of 4: each block's two row parities meet in shared memory as 512
//     lane pairs (a u64: the even lane in bits 0-23, the odd in 24-47),
//     and block r of a cluster adds words 128 r .. 128 r + 127 of its 4
//     blocks through distributed shared memory, so a cluster sends 512
//     atomics, not 2,048.  With one global atomicAdd a block a word the
//     atomics to the same words serialize, and the kernel ran slower than
//     a zero fill, a sum and a mask pass together; clusters of 4 ran a
//     little faster than 8 or 16 on an H100 (PERF.md section 5).
//   - Which cluster finishes a word: each cluster adds its lane pair,
//     each lane reduced mod 2^16, plus 1 << 48 into the word of a
//     per-stream accumulator with one atomicAdd that returns the old value.
//     Bits 48-63 count the clusters that have added; the one that reads
//     clusters - 1 there added last, so old + its own sum is the word's
//     total: it writes the two lanes' low 16 bits to out and stores 0 back.
//     Each word is its own ticket, so no fence, no second atomic and no
//     read-back wait on other words; at most 256 clusters keep each lane's
//     sum (< 256 x 2^16) inside its 24 bits.  The accumulator is zeroed once
//     when the wrapper allocates it (ops/lthash.py) and every launch leaves
//     it zero, so no fill or mask pass runs.
// signs == nullptr means every row counts +1.
#include <cooperative_groups.h>

#include "fd_common.cuh"

#define LT_VECS 128    // a row's 1,024 u16 lanes as 128 uint4 of 8 lanes
#define LT_WORDS 512   // the same as 32-bit words of two lanes
#define LT_SLOTS 2     // row parities a block
#define LT_THREADS (LT_VECS * LT_SLOTS)
#define LT_UNROLL 4    // rows in flight a thread
#define LT_STEP (LT_SLOTS * LT_UNROLL)  // rows a block reads an iteration; a chunk is a multiple
#ifndef LT_CLUSTER  // a build may set 8 or 16 (chip_smoke.py --parent times them)
#define LT_CLUSTER 4     // blocks a cluster
#endif
#define LT_CLUSTER_WORDS (LT_WORDS / LT_CLUSTER)  // words each block of a cluster adds
#define LT_MAX_CLUSTERS 256  // lane sums below 2^24, cluster counts below 2^16
#define LT_ODD_SHIFT 24      // the odd lane's field of a lane pair
#define LT_COUNT_SHIFT 48    // the cluster count's field

__device__ __forceinline__ void lt_add(uint32_t full[4], uint32_t lo[4], const uint4& v,
                                       uint32_t s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    full[i] += s * w[i];
    lo[i] += s * (w[i] & 0xFFFFu);
  }
}

template <bool SIGNED>
__device__ __forceinline__ uint32_t lt_sign(const int8_t* __restrict__ signs, int64_t r) {
  return SIGNED ? (uint32_t)(int32_t)__ldg(signs + r) : 1u;
}

// acc: LT_WORDS u64, zero between launches; out: (1024,) int32 as LT_WORDS
// int2 (lanes 2w, 2w + 1).  gridDim.x is a multiple of LT_CLUSTER.
template <bool SIGNED>
__global__ void __cluster_dims__(LT_CLUSTER, 1, 1) __launch_bounds__(LT_THREADS)
lthash_combine_kernel(const uint4* __restrict__ values, const int8_t* __restrict__ signs,
                      int64_t n, int64_t rows_per_chunk, unsigned long long* __restrict__ acc,
                      int2* __restrict__ out) {
  __shared__ uint4 part_s[2][LT_VECS];             // parity 1's full and lo sums
  __shared__ unsigned long long pair_s[LT_WORDS];  // this block's lane pairs
  const int c = threadIdx.x % LT_VECS, slot = threadIdx.x / LT_VECS;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_chunk;
  const int64_t r1 = min(n, r0 + rows_per_chunk);
  uint32_t full[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
  int64_t r = r0 + slot;
  for (; r + LT_SLOTS * (LT_UNROLL - 1) < r1; r += LT_STEP) {
    uint4 v[LT_UNROLL];
    uint32_t s[LT_UNROLL];
#pragma unroll
    for (int k = 0; k < LT_UNROLL; k++) {
      v[k] = __ldg(values + (r + LT_SLOTS * k) * LT_VECS + c);
      s[k] = lt_sign<SIGNED>(signs, r + LT_SLOTS * k);
    }
#pragma unroll
    for (int k = 0; k < LT_UNROLL; k++) lt_add(full, lo, v[k], s[k]);
  }
  for (; r < r1; r += LT_SLOTS)
    lt_add(full, lo, __ldg(values + r * LT_VECS + c), lt_sign<SIGNED>(signs, r));
  if (slot == 1) {
    part_s[0][c] = make_uint4(full[0], full[1], full[2], full[3]);
    part_s[1][c] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();
  if (slot == 0) {
    const uint4 pf = part_s[0][c], pl = part_s[1][c];
    const uint32_t f2[4] = {full[0] + pf.x, full[1] + pf.y, full[2] + pf.z, full[3] + pf.w};
    const uint32_t l2[4] = {lo[0] + pl.x, lo[1] + pl.y, lo[2] + pl.z, lo[3] + pl.w};
#pragma unroll
    for (int i = 0; i < 4; i++)
      pair_s[4 * c + i] = (unsigned long long)(l2[i] & 0xFFFFu)
                          | ((unsigned long long)((f2[i] - l2[i]) >> 16) << LT_ODD_SHIFT);
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const bool adder = threadIdx.x < LT_CLUSTER_WORDS;
  const int w = cluster.block_rank() * LT_CLUSTER_WORDS + threadIdx.x;
  unsigned long long mine = 0;
  if (adder) {
    unsigned long long sum = 0;  // each lane's field < LT_CLUSTER x 2^16 <= 2^20: no carry
#pragma unroll
    for (int b = 0; b < LT_CLUSTER; b++) sum += *cluster.map_shared_rank(pair_s + w, b);
    mine = (sum & 0xFFFFull) | (((sum >> LT_ODD_SHIFT) & 0xFFFFull) << LT_ODD_SHIFT)
           | (1ull << LT_COUNT_SHIFT);
  }
  // the other blocks' shared memory is read: arrive now and wait only
  // before leaving (no block leaves while another reads it), so the
  // atomic's round trip overlaps the cluster barrier
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (adder) {
    const unsigned long long old = atomicAdd(acc + w, mine);
    if ((old >> LT_COUNT_SHIFT) == gridDim.x / LT_CLUSTER - 1) {  // the last cluster here
      const unsigned long long t = old + mine;
      out[w] = make_int2((int)(t & 0xFFFFu), (int)((t >> LT_ODD_SHIFT) & 0xFFFFu));
      acc[w] = 0ull;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// values: (n, 1024) u16 rows, contiguous, 16-byte aligned; signs: (n,) int8
// in {-1, 0, 1} or nullptr; scratch: LT_WORDS u64, zero (and left zero),
// one per stream; out: (1024,) int32.  chunks: blocks asked for (rows a
// chunk rounded up to a multiple of LT_STEP, blocks up to a multiple of
// LT_CLUSTER).  n >= 1.
FD_EXPORT int fd_lthash_combine(const void* values, const void* signs, void* scratch, void* out,
                                int64_t n, int64_t chunks, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t most = (int64_t)LT_CLUSTER * LT_MAX_CLUSTERS;
  chunks = chunks < 1 ? 1 : (chunks > most ? most : chunks);
  const int64_t rows = ((n + chunks - 1) / chunks + LT_STEP - 1) / LT_STEP * LT_STEP;
  const int64_t blocks = ((n + rows - 1) / rows + LT_CLUSTER - 1) / LT_CLUSTER * LT_CLUSTER;
  const uint4* v = (const uint4*)values;
  unsigned long long* acc = (unsigned long long*)scratch;
#if LT_CLUSTER > 8  // past the portable cluster size
  rc = (int)cudaFuncSetAttribute(lthash_combine_kernel<true>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (!rc)
    rc = (int)cudaFuncSetAttribute(lthash_combine_kernel<false>,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc) return rc;
#endif
  if (signs)
    lthash_combine_kernel<true><<<(unsigned)blocks, LT_THREADS, 0, (cudaStream_t)stream>>>(
        v, (const int8_t*)signs, n, rows, acc, (int2*)out);
  else
    lthash_combine_kernel<false><<<(unsigned)blocks, LT_THREADS, 0, (cudaStream_t)stream>>>(
        v, nullptr, n, rows, acc, (int2*)out);
  return (int)cudaGetLastError();
}
