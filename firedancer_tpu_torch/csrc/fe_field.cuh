// GF(2^255-19) arithmetic for one lane per thread: 10 signed limbs of
// alternating 26 and 25 bits (radix 2^25.5, ref10 layout), int32 limbs and
// int64 accumulators.  The plain PyTorch twin is ops/limbs.py; both do the
// same integer arithmetic, so their limbs agree exactly.
//
// Every function returns the "carried" form: |limb| <= 1.1 * 2^25 (26-bit
// limbs) or 1.1 * 2^24 (25-bit limbs).  fe_freeze gives canonical limbs.
#pragma once

#include "fd_common.cuh"

struct fe {
  int32_t v[10];
};

#define FE_W(i) (((i) & 1) ? 25 : 26)

// Sequential signed rounding carry, limb 0 -> 9, limb 9's carry folded into
// limb 0 times 19 (2^255 = 19 mod p), then one more carry out of limb 0.
__device__ __forceinline__ fe fe_carry64(int64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int w = FE_W(i);
    int64_t c = (h[i] + ((int64_t)1 << (w - 1))) >> w;
    h[i] -= c * ((int64_t)1 << w);
    if (i < 9)
      h[i + 1] += c;
    else
      h[0] += 19 * c;
  }
  int64_t c = (h[0] + ((int64_t)1 << 25)) >> 26;
  h[0] -= c * ((int64_t)1 << 26);
  h[1] += c;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

// The same carry for small inputs (|limb| < 2^29): int32 throughout.
__device__ __forceinline__ fe fe_carry32(int32_t h[10]) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int w = FE_W(i);
    int32_t c = (h[i] + (1 << (w - 1))) >> w;
    h[i] -= c * (1 << w);
    if (i < 9)
      h[i + 1] += c;
    else
      h[0] += 19 * c;
  }
  int32_t c = (h[0] + (1 << 25)) >> 26;
  h[0] -= c * (1 << 26);
  h[1] += c;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = h[i];
  return r;
}

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i] + b.v[i];
  return fe_carry32(h);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i] - b.v[i];
  return fe_carry32(h);
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = -a.v[i];
  return fe_carry32(h);
}

// Schoolbook 10x10: h_k = sum_{i+j=k} f_i g_j w_ij + sum_{i+j=k+10} f_i (19 g_j) w_ij,
// w_ij = 2 when i and j are both odd.  ptxas makes each product one
// IMAD.WIDE with its 64-bit addend: 100 IMAD.WIDE and ~193 instructions
// a call (chip_smoke.py's [K2-sass] of a K2 build that calls it).
// Out of line (arguments by value, in registers): one copy instead of one
// per call site keeps the verify kernel small.
__device__ __noinline__ fe fe_mul(fe f, fe g) {
  int32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    int64_t acc = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      const int j = k - i;
      if (j >= 0) {
        const int32_t fi = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
        acc += (int64_t)fi * g.v[j];
      } else {
        const int jj = j + 10;
        const int32_t fi = ((i & 1) && (jj & 1)) ? f2[i] : f.v[i];
        acc += (int64_t)fi * g19[jj];
      }
    }
    h[k] = acc;
  }
  return fe_carry64(h);
}

// Canonical limbs in [0, 2^w): q = floor(h / p) from the top, h - q p, then
// a sequential floor carry (ref10 fe_tobytes).
__device__ __forceinline__ fe fe_freeze(const fe& a) {
  int32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = a.v[i];
  fe c = fe_carry32(t);
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = c.v[i];
  int32_t q = (19 * h[9] + (1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; i++) q = (h[i] + q) >> FE_W(i);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int w = FE_W(i);
    int32_t cc = h[i] >> w;
    h[i] -= cc * (1 << w);
    if (i < 9) h[i + 1] += cc;
  }
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = h[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  fe f = fe_freeze(a);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= f.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  return fe_is_zero(fe_sub(a, b));
}

__device__ __forceinline__ int fe_parity(const fe& a) {
  return fe_freeze(a).v[0] & 1;
}

__device__ __forceinline__ fe fe_select(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// 256-bit little-endian value (4 words) -> carried field element; with
// mask_msb the top bit (a point encoding's x sign) is dropped.  The value
// is not reduced: a non-canonical y >= p folds mod p in arithmetic.
__device__ __forceinline__ fe fe_frombytes(uint64_t w0, uint64_t w1,
                                           uint64_t w2, uint64_t w3,
                                           bool mask_msb) {
  uint64_t w[4] = {w0, w1, w2, mask_msb ? (w3 & 0x7FFFFFFFFFFFFFFFull) : w3};
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++)
    h[i] = (int32_t)fd_bits(w, 4, off[i], i < 9 ? FE_W(i) : 26);
  return fe_carry32(h);
}
