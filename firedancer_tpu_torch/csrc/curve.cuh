// Scalars mod L and ed25519 group operations for one lane per thread.
// Plain PyTorch twins: ops/scalar.py and ops/curve.py (same formulas, same
// order of operations).
//
// Points are extended twisted Edwards (X, Y, Z, T); the addition law is
// complete, so identity and torsion points need no special cases.  Cached
// form (Y+X, Y-X, Z, 2dT) is the right operand of repeated additions.
#pragma once

#include "fe_field.cuh"

// Canonical limbs of d, 2d and sqrt(-1) (checked against ops/limbs.py by
// tests/test_torch_curve.py).
#define FE_D {56195235, 13857412, 51736253, 6949390, 114729, 24766616, 60832955, 30306712, 48412415, 21499315}
#define FE_D2 {45281625, 27714825, 36363642, 13898781, 229458, 15978800, 54557047, 27058993, 29715967, 9444199}
#define FE_SQRTM1 {34513072, 25610706, 9377949, 3500415, 12389472, 33281959, 41962654, 31548777, 326685, 11406482}

// ---------------------------------------------------------------- scalars

// s < L, on the little-endian 256-bit value in 4 words.
__device__ __forceinline__ bool sc_validate(const uint64_t s[4]) {
  const uint64_t L[4] = {0x5812631A5CF5D3EDull, 0x14DEF9DEA2F79CD6ull, 0x0ull,
                         0x1000000000000000ull};
#pragma unroll
  for (int i = 3; i >= 0; i--) {
    if (s[i] < L[i]) return true;
    if (s[i] > L[i]) return false;
  }
  return false;
}

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  return ((uint64_t)__byte_perm(lo, 0, 0x0123) << 32) | __byte_perm(hi, 0, 0x0123);
}

// 2^252 = -C (mod L); -C in signed radix-2^21 limbs.
#define SC_FOLD(s, k)                                  \
  do {                                                 \
    s[(k)-12] += s[k] * 666643;                        \
    s[(k)-11] += s[k] * 470296;                        \
    s[(k)-10] += s[k] * 654183;                        \
    s[(k)-9] -= s[k] * 997805;                         \
    s[(k)-8] += s[k] * 136657;                         \
    s[(k)-7] -= s[k] * 683901;                         \
    s[k] = 0;                                          \
  } while (0)
#define SC_CARRY_R(s, i)                               \
  do {                                                 \
    int64_t c_ = (s[i] + ((int64_t)1 << 20)) >> 21;    \
    s[(i) + 1] += c_;                                  \
    s[i] -= c_ * ((int64_t)1 << 21);                   \
  } while (0)
#define SC_CARRY_F(s, i)                               \
  do {                                                 \
    int64_t c_ = s[i] >> 21;                           \
    s[(i) + 1] += c_;                                  \
    s[i] -= c_ * ((int64_t)1 << 21);                   \
  } while (0)

// SHA-512 state words (big-endian digest words) -> the digest, read as a
// little-endian 512-bit integer, mod L; out as 4 little-endian words.
// ref10's sc_reduce: 24 signed limbs of 21 bits, folds at 2^252.
__device__ __forceinline__ void sc_reduce512(const uint64_t st[8], uint64_t out[4]) {
  uint64_t le[8];
#pragma unroll
  for (int i = 0; i < 8; i++) le[i] = bswap64(st[i]);
  int64_t s[24];
#pragma unroll
  for (int i = 0; i < 24; i++) s[i] = (int64_t)fd_bits(le, 8, 21 * i, i < 23 ? 21 : 29);
#pragma unroll
  for (int k = 23; k >= 18; k--) SC_FOLD(s, k);
#pragma unroll
  for (int i = 6; i <= 16; i += 2) SC_CARRY_R(s, i);
#pragma unroll
  for (int i = 7; i <= 15; i += 2) SC_CARRY_R(s, i);
#pragma unroll
  for (int k = 17; k >= 12; k--) SC_FOLD(s, k);
#pragma unroll
  for (int i = 0; i <= 10; i += 2) SC_CARRY_R(s, i);
#pragma unroll
  for (int i = 1; i <= 11; i += 2) SC_CARRY_R(s, i);
  SC_FOLD(s, 12);
#pragma unroll
  for (int i = 0; i <= 11; i++) SC_CARRY_F(s, i);
  SC_FOLD(s, 12);
#pragma unroll
  for (int i = 0; i <= 10; i++) SC_CARRY_F(s, i);
#pragma unroll
  for (int q = 0; q < 4; q++) out[q] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const int lo = 21 * i, q = lo >> 6, sh = lo & 63;
    const uint64_t v = (uint64_t)s[i];
    out[q] |= v << sh;
    if (sh + 22 > 64 && q + 1 < 4) out[q + 1] |= v >> (64 - sh);
  }
}

// ------------------------------------------------------------------ points

struct ge {
  fe X, Y, Z, T;
};

struct gec {
  fe ypx, ymx, z, t2d;
};

__device__ __forceinline__ fe fe_lit(const int32_t (&c)[10]) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ ge ge_identity() {
  return ge{fe_zero(), fe_one(), fe_one(), fe_zero()};
}

__device__ __forceinline__ gec ge_to_cached(const ge& p) {
  const int32_t d2[10] = FE_D2;
  return gec{fe_add(p.Y, p.X), fe_sub(p.Y, p.X), p.Z, fe_mul(p.T, fe_lit(d2))};
}

// add-2008-hwcd-3 with a = -1: extended + cached -> extended.
__device__ __forceinline__ ge ge_add_cached(const ge& p, const gec& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.ymx);
  fe b = fe_mul(fe_add(p.Y, p.X), q.ypx);
  fe c = fe_mul(p.T, q.t2d);
  fe d = fe_mul(p.Z, q.z);
  d = fe_add(d, d);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// ------------------------------------------------------- per-signer combs
//
// A signer's comb is 64 windows x 16 digits of cached points, (64, 16, 4,
// 10) int32 in the layout of the base comb: entry (j, m) is 40 contiguous
// int32 (160 bytes, 16-byte aligned), components (Y+X, Y-X, Z, 2dT).  The
// per-signer entries hold -[m 16^j]A with a general Z:
// (Y-X, Y+X, Z, -2dT) of [m 16^j]A in those places (ops/curve.py
// comb_tables_quad).  One slot of the bank is one such comb, 40,960 int32.

#define COMB_ENTRY_INTS 40
#define COMB_WINDOW_INTS (16 * COMB_ENTRY_INTS)
#define COMB_SLOT_INTS (64 * COMB_WINDOW_INTS)

// An entry's ten 16-byte pieces as a cached point.
__device__ __forceinline__ gec gec_from_pieces(const int4 (&x)[COMB_ENTRY_INTS / 4]) {
  int32_t v[COMB_ENTRY_INTS];
#pragma unroll
  for (int k = 0; k < COMB_ENTRY_INTS / 4; k++) {
    v[4 * k] = x[k].x;
    v[4 * k + 1] = x[k].y;
    v[4 * k + 2] = x[k].z;
    v[4 * k + 3] = x[k].w;
  }
  gec r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    r.ypx.v[i] = v[i];
    r.ymx.v[i] = v[10 + i];
    r.z.v[i] = v[20 + i];
    r.t2d.v[i] = v[30 + i];
  }
  return r;
}

// One cached entry from global memory: ten 16-byte read-only loads.
__device__ __forceinline__ gec gec_load(const int32_t* __restrict__ e) {
  const int4* q = reinterpret_cast<const int4*>(e);
  int4 x[COMB_ENTRY_INTS / 4];
#pragma unroll
  for (int k = 0; k < COMB_ENTRY_INTS / 4; k++) x[k] = __ldg(q + k);
  return gec_from_pieces(x);
}
