// K2 fe_mul_chain: k chained field multiplies per lane, (x, y) -> (x*y, x).
//
// Replaces: the Pallas microbenchmark make_pallas13 (scripts/perf_fe.py:114,
// body _pallas_mul_body :81), a radix-2^13 chained fe_mul.  The limbs are
// the port's radix 2^25.5 (csrc/fe_field.cuh), and every column h_k and
// every carry step is the integer the plain version computes
// (ops/limbs.py fe_mul, fe_carry), so the raw limbs equal
// fe_mul_chain_plain's.
//
// K2 has its own product.  fe_field.cuh's fe_mul and curve_quad.cuh's
// fe_mul_q / fe_sq_q, which the verify kernels (K1, K6, K7, K9, K11, K12)
// run, keep theirs (every product an IMAD.WIDE); K2 is the testbed for the
// product form they could take later.
//
// Bound: the FMA pipe and, with one warp a scheduler, latency.  A product
// as IMAD.WIDE (`acc + (int64_t)a * b`) is scheduled ~4 clocks apart from
// the next (ptxas's stall counts), so a multiply's 100 of them hold a
// scheduler ~400 clocks, while the FP64 pipe idles.  What the design does
// about it:
//   - 54 of the 55 products below 2^255 (i + j = k, no factor 19) go to
//     the FP64 pipe as DFMA: each limb is an exact double (converted
//     once, by the 2^52 + 2^31 bias trick: a LOP3 and a DADD), every
//     product and partial sum of a column is an integer below 2^53 (so
//     exact), and one F2I.S64 a column brings the sum back, issued as
//     soon as the column's last DFMA is (the products are summed operand
//     by operand, and column k's last one below 2^255 is operand k's), so
//     the carry does not wait on its variable latency.  Column 8's nine
//     such products could reach 2^53 at the carried extremes, so its
//     f_0 g_8 stays an IMAD.WIDE; the 45 products past 2^255 (f_i 19 g_j)
//     are too wide for a double and stay IMAD.WIDE.  Those bounds hold for
//     carried limbs, so the chain's first two multiplies, which read an
//     input limb (canonical limbs reach 2^26), take every product as
//     IMAD.WIDE; from the third on both operands are this kernel's own
//     carried results.  K2_DFMA=0 builds every product as IMAD.WIDE (the
//     [K2-knobs] comparison);
//   - the carry's rounding half of each column starts its accumulator, so
//     a step is a 64-bit add of the carry in, a 64-bit shift for the carry
//     out and the kept limb from the low word;
//   - the multiply is inlined, the products are summed operand by operand
//     (consecutive products into different columns), and the loop runs two
//     multiplies an iteration with the new value as the second operand, so
//     the chain's (a, b) -> (a*b, a) needs no moves;
//   - one lane a thread, limbs (10, B) so the loads and stores coalesce,
//     128-thread blocks: at 16,384 lanes, 128 SMs with one warp on each
//     scheduler.
// Limb bounds (checked in tests/test_torch_field.py): carried limbs,
// |limb| <= 1.1 * 2^25 (26-bit) or 1.1 * 2^24 (25-bit), keep 19 g_j and
// 2 f_i in int32, every int64 accumulator, carry in and bias below 2^58,
// and every FP64 partial sum below 2^53; every result is carried.
#include "fd_common.cuh"

#ifndef K2_DFMA
#define K2_DFMA 1  // 1: the products below 2^255 as DFMA; 0: every product IMAD.WIDE
#endif

#define K2_THREADS 128

// A field element as int32 limbs and, for the FP64 products, the same
// limbs as doubles.
struct k2fe {
  int32_t v[10];
  double d[10];
};

// int32 -> double, exact: the double 2^52 + (v + 2^31), less 2^52 + 2^31
__device__ __forceinline__ double k2_f64(int32_t v) {
  return __hiloint2double(0x43300000, v ^ 0x80000000) - 4503601774854144.0;
}

__device__ __forceinline__ void k2_set_f64(k2fe& a) {
#if K2_DFMA
#pragma unroll
  for (int i = 0; i < 10; i++) a.d[i] = k2_f64(a.v[i]);
#endif
}

// r = f * g mod p in carried form: h_k = sum_{i+j=k} f_i g_j w_ij
// + sum_{i+j=k+10} f_i (19 g_j) w_ij, w_ij = 2 when i and j are both odd,
// then fe_carry: limb 0 -> 9, limb 9's carry times 19 into limb 0, then
// one more carry out of limb 0.  F64: the products below 2^255 in FP64
// (both operands carried).  r may be f or g.
template <bool F64>
__device__ __forceinline__ void k2_mul(const k2fe& f, const k2fe& g, k2fe& r) {
  constexpr bool split = F64 && K2_DFMA;
  int32_t g19[10], f2[10];
  double fd2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    if constexpr (split) fd2[i] = (i & 1) ? f.d[i] + f.d[i] : f.d[i];
  }
  int64_t h[10];
  double hd[10];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    h[k] = (int64_t)1 << ((k & 1) ? 24 : 25);  // the carry's rounding half
    hd[k] = 0.0;
  }
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int k = 0; k < 10; k++) {
      const int j = k - i;
      const bool dbl = (i & 1) && (j & 1);
      if (j < 0)
        h[k] += (int64_t)(dbl ? f2[i] : f.v[i]) * g19[j + 10];
      else if (!split || (k == 8 && i == 0))
        h[k] += (int64_t)(dbl ? f2[i] : f.v[i]) * g.v[j];
      else
        hd[k] = fma(dbl ? fd2[i] : f.d[i], g.d[j], hd[k]);
    }
    // column i's FP64 products end at operand i: its F2I runs beside the
    // products still to come instead of in front of the carry
    if constexpr (split) h[i] += __double2ll_rn(hd[i]);
  }
  // each column holds its half already: the carry out is x >> w, the kept
  // limb the low w bits less the half (exact in the low word)
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < 10; k++) {
    const int w = (k & 1) ? 25 : 26;
    const int64_t x = h[k] + c;
    c = x >> w;
    r.v[k] = ((int32_t)x & ((1 << w) - 1)) - (1 << (w - 1));
  }
  const int64_t y = 19 * c + (r.v[0] + (1 << 25));  // |y| < 2^39
  const int32_t c0 = (int32_t)(y >> 26);
  r.v[0] = ((int32_t)y & ((1 << 26) - 1)) - (1 << 25);
  r.v[1] += c0;
  k2_set_f64(r);
}

__global__ void __launch_bounds__(K2_THREADS)
fe_mul_chain_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                    int32_t* __restrict__ xo, int32_t* __restrict__ yo,
                    int64_t B, int k) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  k2fe a, b;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    a.v[i] = x[(int64_t)i * B + lane];
    b.v[i] = y[(int64_t)i * B + lane];
  }
  // one step is (a, b) -> (a*b, a): steps 1 and 2 multiply an input
  int done = 0;
  for (; done < 2 && done < k; done++) {
    k2fe r;
    k2_mul<false>(b, a, r);
    b = a;
    a = r;
  }
  if ((k - done) & 1) {
    k2fe r;
    k2_mul<true>(b, a, r);
    b = a;
    a = r;
    done++;
  }
  // two steps an iteration: b := b*a, then a := a*b, so (a, b) -> (a*b*a, a*b)
  for (; done < k; done += 2) {
    k2_mul<true>(b, a, b);
    k2_mul<true>(a, b, a);
  }
#pragma unroll
  for (int i = 0; i < 10; i++) {
    xo[(int64_t)i * B + lane] = a.v[i];
    yo[(int64_t)i * B + lane] = b.v[i];
  }
}

FD_EXPORT int fd_fe_mul_chain(const void* x, const void* y, void* xo, void* yo,
                              int B, int k, int device, void* stream) {
  int rc = fd_set_device(device);
  if (rc) return rc;
  if (B == 0) return 0;
  const int blocks = (B + K2_THREADS - 1) / K2_THREADS;
  fe_mul_chain_kernel<<<blocks, K2_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (int32_t*)xo, (int32_t*)yo, B, k);
  return (int)cudaGetLastError();
}
