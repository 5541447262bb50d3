// ed25519 point operations on a quad: four adjacent threads of a warp hold
// one point, thread c (c = lane & 3) coordinate c of the extended point
// (X, Y, Z, T).  The formulas are curve.cuh's (dbl-2008-hwcd and
// add-2008-hwcd-3 with a = -1); only their distribution changes: the four
// independent multiplies of each round run one per thread, and the linear
// combinations between rounds are exchanged with __shfl_sync inside the
// quad.  A doubling or an addition is two multiply latencies, where one
// thread alone waits for eight.  This is the four-way form the reference
// validator's AVX-512 code uses (four coordinates side by side in one
// vector; Hisil, Wong, Carter, Dawson, "Twisted Edwards Curves
// Revisited", 2008).  The plain PyTorch twin is ops/curve.py's *_quad
// functions: same rounds, same exchanges, same coefficients.
//
// A cached operand is held the same way, one component of (Y+X, Y-X, Z,
// 2dT) a thread: thread 0 Y-X, thread 1 Y+X, thread 2 Z, thread 3 2dT, the
// factor each thread's first-round multiply needs.
//
// Every call must be made by all 32 threads of the warp (full-mask
// shuffles): callers keep whole warps on the same path.
#pragma once

#include "curve.cuh"

#define QUAD_FULL 0xffffffffu

// The exchange coefficients, one row per thread (tests/test_torch_curve.py
// checks them against ops/curve.py).  Before an addition's first round and
// in to_cached, thread c combines its own coordinate and its partner's
// (c ^ 1): Y-X, Y+X, Z, T.
#define QUAD_PAIR {{-1, 1}, {1, 1}, {1, 0}, {1, 0}}
// Before a doubling's first round, over (own, X, Y): thread 3 squares X+Y.
#define QUAD_DBL_IN {{1, 0, 0}, {1, 0, 0}, {1, 0, 0}, {0, 1, 1}}
// The second round's operands over the first round's four products: a
// doubling's (X^2, Y^2, Z^2, (X+Y)^2) give e = (X+Y)^2 - X^2 - Y^2,
// f = Y^2 - X^2 - 2 Z^2, g = Y^2 - X^2, h = -X^2 - Y^2; an addition's
// (A, B, D, C) = ((Y-X)(Y2-X2), (Y+X)(Y2+X2), Z Z2, T 2dT2) give e = B - A,
// f = 2D - C, g = 2D + C, h = B + A.  Thread c multiplies OP1[c] OP2[c]:
// X3 = f e, Y3 = g h, Z3 = f g, T3 = e h; every OP2 row sums to at most 3
// in absolute value (fe_mul_q's second operand, see fe_lin).
#define QUAD_DBL_OP1 {{-1, 1, -2, 0}, {-1, 1, 0, 0}, {-1, 1, -2, 0}, {-1, -1, 0, 1}}
#define QUAD_DBL_OP2 {{-1, -1, 0, 1}, {-1, -1, 0, 0}, {-1, 1, 0, 0}, {-1, -1, 0, 0}}
#define QUAD_ADD_OP1 {{-1, 1, 0, 0}, {0, 0, 2, 1}, {0, 0, 2, -1}, {-1, 1, 0, 0}}
#define QUAD_ADD_OP2 {{0, 0, 2, -1}, {1, 1, 0, 0}, {0, 0, 2, 1}, {1, 1, 0, 0}}

// The per-thread coefficients, read once into registers.  The second
// round's are rotated: entry k applies to the product of thread
// src[k] = (c + k) & 3, so a thread reads the three others' products (its
// own is entry 0).
struct QuadRole {
  int c;                        // lane & 3
  int src[4];
  int pair[2], dbl_in[3];
  int dbl1[4], dbl2[4], add1[4], add2[4];
};

__device__ __forceinline__ QuadRole quad_role(int c) {
  const int pair[4][2] = QUAD_PAIR;
  const int dbl_in[4][3] = QUAD_DBL_IN;
  const int d1[4][4] = QUAD_DBL_OP1, d2[4][4] = QUAD_DBL_OP2;
  const int a1[4][4] = QUAD_ADD_OP1, a2[4][4] = QUAD_ADD_OP2;
  QuadRole r;
  r.c = c;
#pragma unroll
  for (int t = 0; t < 4; t++) {
    if (t != c) continue;
#pragma unroll
    for (int k = 0; k < 2; k++) r.pair[k] = pair[t][k];
#pragma unroll
    for (int k = 0; k < 3; k++) r.dbl_in[k] = dbl_in[t][k];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int s = (t + k) & 3;
      r.src[k] = s;
      r.dbl1[k] = d1[t][s];
      r.dbl2[k] = d2[t][s];
      r.add1[k] = a1[t][s];
      r.add2[k] = a2[t][s];
    }
  }
  return r;
}

// fe_field.cuh's fe_mul, inlined: each thread's one multiply of a round,
// with no call in the dependent chain.
__device__ __forceinline__ fe fe_mul_q(const fe& f, const fe& g) {
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

// f^2 with the 55 distinct products of fe_mul_q(f, f) (ref10's fe_sq):
// h_k sums c_ij f_i f_j over i <= j, i + j = k (mod 10), c_ij = 2 for
// i != j, times 2 for two odd limbs and 19 past 2^255, each split into a
// factor 1, 2 or 4 on f_i and 1, 2 or 19 on f_j, so both stay in int32
// for |limb| <= 2^26 (the sum of two carried elements).  The same integer
// sums as fe_mul_q(f, f), so the same limbs.
__device__ __forceinline__ fe fe_sq_q(const fe& f) {
  int32_t f2[10], f4[10], f19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f4[i] = 4 * f.v[i];
    f19[i] = 19 * f.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    int64_t acc = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
      for (int j = i; j < 10; j++) {
        if ((i + j) % 10 != k) continue;
        const int c = (i == j ? 1 : 2) * ((i & 1) && (j & 1) ? 2 : 1) * (i + j >= 10 ? 19 : 1);
        const int32_t a = c == 76 ? f4[i] : (c == 2 || c == 4 || c == 38) ? f2[i] : f.v[i];
        const int32_t b = c == 4 ? f2[j] : (c == 19 || c == 38 || c == 76) ? f19[j] : f.v[j];
        acc += (int64_t)a * b;
      }
    }
    h[k] = acc;
  }
  return fe_carry64(h);
}

// Thread `src` (0..3) of this quad's value of a.
__device__ __forceinline__ fe fe_shfl(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_sync(QUAD_FULL, a.v[i], src, 4);
  return r;
}

__device__ __forceinline__ fe fe_shfl_xor(const fe& a, int m) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_xor_sync(QUAD_FULL, a.v[i], m, 4);
  return r;
}

// sum_k k_k v_k over carried inputs (|limb| <= 2^25), left uncarried:
// the next multiply takes it.  fe_mul_q's first operand may sum up to 4
// (2f stays below 2^27.01), its second up to 3 (19 g below 1.92e9, inside
// int32), and every int64 accumulator stays below 2^61.2; fe_sq_q takes
// sums up to 2.
__device__ __forceinline__ fe fe_lin2(const fe& a, const fe& b, const int k[2]) {
  fe o;
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = k[0] * a.v[i] + k[1] * b.v[i];
  return o;
}

__device__ __forceinline__ fe fe_lin3(const fe& a, const fe& b, const fe& c, const int k[3]) {
  fe o;
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = k[0] * a.v[i] + k[1] * b.v[i] + k[2] * c.v[i];
  return o;
}

__device__ __forceinline__ fe fe_lin4(const fe v[4], const int k[4]) {
  fe o;
#pragma unroll
  for (int i = 0; i < 10; i++)
    o.v[i] = k[0] * v[0].v[i] + k[1] * v[1].v[i] + k[2] * v[2].v[i] + k[3] * v[3].v[i];
  return o;
}

// The second round: read the other three threads' first-round products,
// form this thread's two operands, multiply.
__device__ __forceinline__ fe quad_round2(const fe& m, const QuadRole& r, const int op1[4],
                                          const int op2[4]) {
  fe v[4];
  v[0] = m;
#pragma unroll
  for (int k = 1; k < 4; k++) v[k] = fe_shfl(m, r.src[k]);
  return fe_mul_q(fe_lin4(v, op1), fe_lin4(v, op2));
}

// Identity (0, 1, 1, 0): this thread's coordinate.
__device__ __forceinline__ fe quad_identity(const QuadRole& r) {
  fe o = fe_zero();
  o.v[0] = (r.c == 1 || r.c == 2);
  return o;
}

// The cached identity (Y+X, Y-X, Z, 2dT) = (1, 1, 1, 0): this thread's component.
__device__ __forceinline__ fe quad_cached_identity(const QuadRole& r) {
  fe o = fe_zero();
  o.v[0] = (r.c != 3);
  return o;
}

// 2P (dbl-2008-hwcd): squarings of X, Y, Z and X+Y, then e f, g h, f g, e h.
__device__ __forceinline__ fe quad_dbl(const fe& p, const QuadRole& r) {
  const fe s = fe_lin3(p, fe_shfl(p, 0), fe_shfl(p, 1), r.dbl_in);
  return quad_round2(fe_sq_q(s), r, r.dbl1, r.dbl2);
}

// P + Q for Q in cached form (add-2008-hwcd-3): (Y-X)(Y2-X2),
// (Y+X)(Y2+X2), Z Z2, T 2dT2, then e f, g h, f g, e h.
__device__ __forceinline__ fe quad_add(const fe& p, const fe& qc, const QuadRole& r) {
  const fe m = fe_mul_q(fe_lin2(p, fe_shfl_xor(p, 1), r.pair), qc);
  return quad_round2(m, r, r.add1, r.add2);
}

// The cached form of P: Y-X, Y+X, Z, T 2d (threads 0-2 multiply by one,
// so the quad runs one multiply with no branch).
__device__ __forceinline__ fe quad_to_cached(const fe& p, const QuadRole& r) {
  const int32_t d2[10] = FE_D2;
  const fe k = r.c == 3 ? fe_lit(d2) : fe_one();
  return fe_mul_q(fe_lin2(p, fe_shfl_xor(p, 1), r.pair), k);
}

// Coordinate r.c of the extended point p that thread `src` holds whole.
__device__ __forceinline__ fe quad_take(const ge& p, int src, const QuadRole& r) {
  const fe x = fe_shfl(p.X, src), y = fe_shfl(p.Y, src);
  const fe z = fe_shfl(p.Z, src), t = fe_shfl(p.T, src);
  return fe_select(r.c == 0, x, fe_select(r.c == 1, y, fe_select(r.c == 2, z, t)));
}

// This thread's component (Y-X, Y+X, Z, 2dT) of the cached point c that
// thread `src` holds whole.
__device__ __forceinline__ fe quad_take_cached(const gec& c, int src, const QuadRole& r) {
  const fe ypx = fe_shfl(c.ypx, src), ymx = fe_shfl(c.ymx, src);
  const fe z = fe_shfl(c.z, src), t2d = fe_shfl(c.t2d, src);
  return fe_select(r.c == 0, ymx, fe_select(r.c == 1, ypx, fe_select(r.c == 2, z, t2d)));
}

// ---------------------------------------------- one thread: decompression

__device__ __forceinline__ fe fe_sq_n_q(fe f, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) f = fe_sq_q(f);
  return f;
}

// RFC 8032 5.1.3 decompression by x = u v^3 (u v^7)^((p-5)/8), accepting a
// non-canonical y and x = 0 with the sign bit set, then the small-order
// check [8]P == identity: the steps of ops/curve.py point_decompress and
// is_small_order (the ref10 exponent schedule, dbl-2008-hwcd), one thread
// a point, with the multiplies inlined and the squarings of 55 products
// (the same limbs).  ok is "decodes and not of small order".
struct ge_ok {
  ge p;
  bool ok;
};

__device__ __noinline__ ge_ok ge_decompress_strict_q(uint64_t w0, uint64_t w1, uint64_t w2,
                                                      uint64_t w3) {
  const uint64_t w[4] = {w0, w1, w2, w3};
  const int32_t dc[10] = FE_D;
  const int32_t sq[10] = FE_SQRTM1;
  const int sign = (int)(w[3] >> 63);
  const fe y = fe_frombytes(w[0], w[1], w[2], w[3], true);
  const fe one = fe_one();
  const fe y2 = fe_sq_q(y);
  const fe u = fe_sub(y2, one);
  const fe v = fe_add(fe_mul_q(fe_lit(dc), y2), one);
  const fe v3 = fe_mul_q(fe_sq_q(v), v);
  const fe v7 = fe_mul_q(fe_sq_q(v3), v);
  // (u v^7)^(2^252 - 3), the ref10 exponent schedule
  const fe b = fe_mul_q(u, v7);
  const fe z2 = fe_sq_q(b);
  const fe z9 = fe_mul_q(fe_sq_n_q(z2, 2), b);
  const fe z11 = fe_mul_q(z9, z2);
  const fe z_5_0 = fe_mul_q(fe_sq_q(z11), z9);
  const fe z_10_0 = fe_mul_q(fe_sq_n_q(z_5_0, 5), z_5_0);
  const fe z_20_0 = fe_mul_q(fe_sq_n_q(z_10_0, 10), z_10_0);
  const fe z_40_0 = fe_mul_q(fe_sq_n_q(z_20_0, 20), z_20_0);
  const fe z_50_0 = fe_mul_q(fe_sq_n_q(z_40_0, 10), z_10_0);
  const fe z_100_0 = fe_mul_q(fe_sq_n_q(z_50_0, 50), z_50_0);
  const fe z_200_0 = fe_mul_q(fe_sq_n_q(z_100_0, 100), z_100_0);
  const fe z_250_0 = fe_mul_q(fe_sq_n_q(z_200_0, 50), z_50_0);
  const fe pw = fe_mul_q(fe_sq_n_q(z_250_0, 2), b);
  fe x = fe_mul_q(fe_mul_q(u, v3), pw);
  const fe vx2 = fe_mul_q(v, fe_sq_q(x));
  const bool ok_direct = fe_eq(vx2, u);
  const bool ok_flip = fe_eq(vx2, fe_neg(u));
  x = fe_select(ok_direct, x, fe_mul_q(x, fe_lit(sq)));
  const bool flip = (fe_parity(x) ^ sign) != 0;
  x = fe_select(flip, fe_neg(x), x);
  const ge out{x, y, one, fe_mul_q(x, y)};
  // [8]P: three doublings (dbl-2008-hwcd), then X == 0 and Y == Z
  ge q = out;
#pragma unroll 1
  for (int i = 0; i < 3; i++) {
    const fe a = fe_sq_q(q.X), bb = fe_sq_q(q.Y), zz = fe_sq_q(q.Z);
    const fe c = fe_add(zz, zz);
    const fe e = fe_sub(fe_sub(fe_sq_q(fe_add(q.X, q.Y)), a), bb);
    const fe g = fe_sub(bb, a), f = fe_sub(g, c), h = fe_neg(fe_add(a, bb));
    q = ge{fe_mul_q(e, f), fe_mul_q(g, h), fe_mul_q(f, g), fe_mul_q(e, h)};
  }
  const bool small = fe_is_zero(q.X) && fe_eq(q.Y, q.Z);
  return ge_ok{out, (ok_direct || ok_flip) && !small};
}

// ------------------------------------------- the double-scalar ladder (K1, K11)

__device__ __forceinline__ uint64_t pick4(const uint64_t w[4], int i) {
  return i == 0 ? w[0] : (i == 1 ? w[1] : (i == 2 ? w[2] : w[3]));
}

// One field element in a block's shared table, limb i at p[i * T] (p = the
// thread's column, T = the block's threads): neighbouring threads,
// neighbouring banks.
template <int T>
__device__ __forceinline__ void fe_store_cols(int32_t* __restrict__ p, const fe& a) {
#pragma unroll
  for (int i = 0; i < 10; i++) p[i * T] = a.v[i];
}

template <int T>
__device__ __forceinline__ fe fe_load_cols(const int32_t* __restrict__ p) {
  fe a;
#pragma unroll
  for (int i = 0; i < 10; i++) a.v[i] = p[i * T];
  return a;
}

// [s]B + [k]P on a quad of a block of T threads, K1's and K11's ladder.
// `p` is this thread's coordinate of P (carried limbs); kw and sw are k and
// s as four little-endian words, the same on the quad's four threads; tb is
// this thread's column of a shared table of 16 x 10 x T int32 (entry m,
// limb i at tb[(m * 10 + i) * T]).
//   - the table [0..15]P in cached form: the identity, P, then [m]P =
//     [m-1]P + P by quad additions;
//   - [k]P: 64 windows, most significant first, of four quad doublings and
//     one quad addition from the table;
//   - [s]B: thread c sums the base comb's windows 16c .. 16c+15 alone
//     (curve.cuh's one-thread ge_add_cached; the comb holds [m 16^j]B for
//     every window j, so no doublings), and the four sums join [k]P by
//     four quad additions of their cached forms, thread 0's first.
// Returns this thread's coordinate of the sum.  Every quad operation ends
// in a multiply, so the result is carried.  ops/curve.py
// double_scalar_mul_base_quad runs the same steps on the same limbs.
template <int T>
__device__ __forceinline__ fe quad_double_scalar_mul_base(const fe& p, const uint64_t kw[4],
                                                          const uint64_t sw[4],
                                                          const int32_t* __restrict__ comb,
                                                          int32_t* __restrict__ tb,
                                                          const QuadRole& role) {
  fe_store_cols<T>(tb, quad_cached_identity(role));
  const fe c1 = quad_to_cached(p, role);
  fe_store_cols<T>(tb + 10 * T, c1);
  fe prev = p;
#pragma unroll 1
  for (int m = 2; m < 16; m++) {
    prev = quad_add(prev, c1, role);
    fe_store_cols<T>(tb + m * 10 * T, quad_to_cached(prev, role));
  }

  fe acc = quad_identity(role);
#pragma unroll 1
  for (int i = 63; i >= 0; i--) {
#pragma unroll 1
    for (int d = 0; d < 4; d++) acc = quad_dbl(acc, role);
    const int dig = (int)((pick4(kw, i >> 4) >> (4 * (i & 15))) & 15);
    acc = quad_add(acc, fe_load_cols<T>(tb + dig * 10 * T), role);
  }

  ge part = ge_identity();
  const uint64_t sword = pick4(sw, role.c);
#pragma unroll 1
  for (int j = 0; j < 16; j++) {
    const int dig = (int)((sword >> (4 * j)) & 15);
    part = ge_add_cached(part, gec_load(comb + ((16 * role.c + j) * 16 + dig) * COMB_ENTRY_INTS));
  }
  const gec pc = ge_to_cached(part);
#pragma unroll 1
  for (int src = 0; src < 4; src++) acc = quad_add(acc, quad_take_cached(pc, src, role), role);
  return acc;
}
