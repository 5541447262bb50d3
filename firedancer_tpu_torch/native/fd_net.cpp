// fd_net: the ingress sweep client, the port's copy of the JAX package's
// native/fd_net.cpp (the same wire handling, tables and counters), with no
// environment switch: the AES-NI/PCLMUL choice is a CPUID probe, and the
// scalar AES/GHASH path is taken only through fdn_simd_force(0).
//
// The QUIC short-header steady state in C: the per-packet work of 1-RTT
// packets from ESTABLISHED connections runs here (DCID -> connection
// lookup over an interned table, header-protection unmask, AES-128-GCM
// open with AES-NI + PCLMUL when the host has them and a scalar path
// byte-identical to ops/aes.py's plain version, the packet-number dedup
// window, the STREAM frame walk and fd_tpu_reasm-style reassembly), while
// everything else PUNTs back to the Python connection in arrival order:
// long headers (Initial/Retry/Handshake), version negotiation, unknown
// CIDs (stateless reset), migration (address<->CID mismatch), and any
// frame that touches control-plane state (CRYPTO, PATH_CHALLENGE/RESPONSE,
// CONNECTION_CLOSE, HANDSHAKE_DONE, multi-range ACKs).  waltz/quic.py stays
// the single source of truth for the control plane; this file only ever
// ACCEPTS work the Python lane would have accepted, byte for byte.
//
// The binding (runtime/net_native.py) declares every symbol's ctypes
// signature and reads the event queue, out-txn table and counters through
// zero-copy numpy views.  Completed txns land in a reusable arena with an
// (off, sz, sig, tsorig) table shaped for fdr_publish_burst: the
// credit-gated publish pops only the published prefix (fdn_out_pop); the
// unpublished tail stays queued here, never dropped.
//
// RX ONLY.  All transmission (ACK building, PTO, window updates, packet
// sealing) stays in waltz/quic.py: consumed packets surface as events
// (EV_PKT pn sync -> ack tracker, EV_ACK -> sent-packet cleanup, EV_WIN
// -> flow-window deltas) the stage applies synchronously after every
// crossing, so the Python Connection object remains authoritative.
//
// Plain UDP intake: fdn_udp_sweep drains a socket with recvmmsg straight
// into the out arena (fdn_udp_sweep_scalar: one recv per datagram, the
// byte-identical reference the tests hold it to).
//
// Single-threaded by contract (one ingress stage owns one ctx).
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <string.h>
#include <stdlib.h>
#include <stdint.h>
#include <stddef.h>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

#if defined(__linux__)
#include <sys/socket.h>
#include <errno.h>
#endif

#include "fd_metrics.h"

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int32_t i32;
typedef int64_t i64;
typedef unsigned __int128 u128;

// =============================================================================
// AES (FIPS-197) — scalar ground truth, byte-identical to ops/aes.py
// =============================================================================

static const u8 SBOX[256] = {
  0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
  0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
  0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
  0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
  0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
  0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
  0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
  0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
  0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
  0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
  0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
  0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
  0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
  0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
  0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
  0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16,
};
static const u8 RCON[14] = {0x01,0x02,0x04,0x08,0x10,0x20,0x40,0x80,
                            0x1b,0x36,0x6c,0xd8,0xab,0x4d};

static inline u8 xtime(u8 a) { return (u8)((a << 1) ^ ((a & 0x80) ? 0x1b : 0)); }

struct AesKS {
  u32 nr;          // 10 (AES-128) or 14 (AES-256)
  u8 rk[15][16];   // round keys
};

// generic nk in {4, 8} key expansion (ops/aes.py _expand_key)
static int aes_expand(const u8 *key, i32 keylen, AesKS *ks) {
  u32 nk = (u32)keylen / 4;
  if (nk != 4 && nk != 8) return -1;
  u32 nr = nk + 6;
  ks->nr = nr;
  u8 w[60][4];
  memcpy(w, key, (size_t)keylen);
  for (u32 i = nk; i < 4 * (nr + 1); i++) {
    u8 t[4];
    memcpy(t, w[i - 1], 4);
    if (i % nk == 0) {
      u8 tmp = t[0];
      t[0] = (u8)(SBOX[t[1]] ^ RCON[i / nk - 1]);
      u8 b2 = t[2], b3 = t[3];
      t[1] = SBOX[b2]; t[2] = SBOX[b3]; t[3] = SBOX[tmp];
    } else if (nk == 8 && i % nk == 4) {
      for (int j = 0; j < 4; j++) t[j] = SBOX[t[j]];
    }
    for (int j = 0; j < 4; j++) w[i][j] = (u8)(w[i - nk][j] ^ t[j]);
  }
  for (u32 r = 0; r <= nr; r++) memcpy(ks->rk[r], w[4 * r], 16);
  return 0;
}

static void aes_encrypt_scalar(const AesKS *ks, const u8 *in, u8 *out) {
  u8 s[16], t[16];
  for (int i = 0; i < 16; i++) s[i] = (u8)(in[i] ^ ks->rk[0][i]);
  for (u32 rnd = 1; rnd < ks->nr; rnd++) {
    for (int i = 0; i < 16; i++) t[i] = SBOX[s[(i + 4 * (i % 4)) % 16]];
    for (int c = 0; c < 4; c++) {
      u8 a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2], a3 = t[4 * c + 3];
      s[4 * c + 0] = (u8)(xtime(a0) ^ (u8)(xtime(a1) ^ a1) ^ a2 ^ a3);
      s[4 * c + 1] = (u8)(a0 ^ xtime(a1) ^ (u8)(xtime(a2) ^ a2) ^ a3);
      s[4 * c + 2] = (u8)(a0 ^ a1 ^ xtime(a2) ^ (u8)(xtime(a3) ^ a3));
      s[4 * c + 3] = (u8)((u8)(xtime(a0) ^ a0) ^ a1 ^ a2 ^ xtime(a3));
    }
    for (int i = 0; i < 16; i++) s[i] = (u8)(s[i] ^ ks->rk[rnd][i]);
  }
  // final round: SubBytes + ShiftRows (commuting per-byte ops) + key
  for (int i = 0; i < 16; i++) t[i] = SBOX[s[(i + 4 * (i % 4)) % 16]];
  for (int i = 0; i < 16; i++) out[i] = (u8)(t[i] ^ ks->rk[ks->nr][i]);
}

#if defined(__x86_64__)
__attribute__((target("aes,sse2")))
static void aes_encrypt_aesni(const AesKS *ks, const u8 *in, u8 *out) {
  __m128i b = _mm_loadu_si128((const __m128i *)in);
  b = _mm_xor_si128(b, _mm_loadu_si128((const __m128i *)ks->rk[0]));
  for (u32 r = 1; r < ks->nr; r++)
    b = _mm_aesenc_si128(b, _mm_loadu_si128((const __m128i *)ks->rk[r]));
  b = _mm_aesenclast_si128(b, _mm_loadu_si128((const __m128i *)ks->rk[ks->nr]));
  _mm_storeu_si128((__m128i *)out, b);
}
#endif

static int g_simd_init = 0;
static int g_aesni = 0;
static int g_pclmul = 0;

static void simd_detect(void) {
  if (g_simd_init) return;
  g_simd_init = 1;
#if defined(__x86_64__)
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return;
  // CPUID.1:ECX bit 25 = AESNI, bit 1 = PCLMULQDQ, bit 9 = SSSE3
  g_aesni = (c >> 25) & 1;
  g_pclmul = ((c >> 1) & 1) && ((c >> 9) & 1);
#endif
}

static inline void aes_encrypt(const AesKS *ks, const u8 *in, u8 *out) {
#if defined(__x86_64__)
  if (g_aesni) { aes_encrypt_aesni(ks, in, out); return; }
#endif
  aes_encrypt_scalar(ks, in, out);
}

// =============================================================================
// GHASH (SP 800-38D 6.3) — scalar u128 ground truth + PCLMUL fast path
// =============================================================================

static inline u128 be128_load(const u8 *p) {
  u128 v = 0;
  for (int i = 0; i < 16; i++) v = (v << 8) | p[i];
  return v;
}

static u128 gmul_scalar(u128 x, u128 y) {
  u128 z = 0, v = y;
  const u128 R = ((u128)0xE1) << 120;
  for (int i = 127; i >= 0; i--) {
    if ((x >> i) & 1) z ^= v;
    v = (v >> 1) ^ ((v & 1) ? R : 0);
  }
  return z;
}

#if defined(__x86_64__)
// Carry-less multiply + reduction over GF(2^128) with the GCM bit order,
// operands loaded big-endian (Intel CLMUL white paper, fig. 5 variant
// with the shift-left-by-one fixup).  The fuzz parity suite holds this
// byte-identical to gmul_scalar / ops/aes.py.
__attribute__((target("pclmul,ssse3")))
static __m128i gfmul_clmul(__m128i a, __m128i b) {
  __m128i t3 = _mm_clmulepi64_si128(a, b, 0x00);
  __m128i t4 = _mm_clmulepi64_si128(a, b, 0x10);
  __m128i t5 = _mm_clmulepi64_si128(a, b, 0x01);
  __m128i t6 = _mm_clmulepi64_si128(a, b, 0x11);
  t4 = _mm_xor_si128(t4, t5);
  t5 = _mm_slli_si128(t4, 8);
  t4 = _mm_srli_si128(t4, 8);
  t3 = _mm_xor_si128(t3, t5);
  t6 = _mm_xor_si128(t6, t4);
  __m128i t7 = _mm_srli_epi32(t3, 31);
  __m128i t8 = _mm_srli_epi32(t6, 31);
  t3 = _mm_slli_epi32(t3, 1);
  t6 = _mm_slli_epi32(t6, 1);
  __m128i t9 = _mm_srli_si128(t7, 12);
  t8 = _mm_slli_si128(t8, 4);
  t7 = _mm_slli_si128(t7, 4);
  t3 = _mm_or_si128(t3, t7);
  t6 = _mm_or_si128(t6, t8);
  t6 = _mm_or_si128(t6, t9);
  t7 = _mm_slli_epi32(t3, 31);
  t8 = _mm_slli_epi32(t3, 30);
  t9 = _mm_slli_epi32(t3, 25);
  t7 = _mm_xor_si128(t7, t8);
  t7 = _mm_xor_si128(t7, t9);
  t8 = _mm_srli_si128(t7, 4);
  t7 = _mm_slli_si128(t7, 12);
  t3 = _mm_xor_si128(t3, t7);
  __m128i t2 = _mm_srli_epi32(t3, 1);
  __m128i ta = _mm_srli_epi32(t3, 2);
  __m128i tb = _mm_srli_epi32(t3, 7);
  t2 = _mm_xor_si128(t2, ta);
  t2 = _mm_xor_si128(t2, tb);
  t2 = _mm_xor_si128(t2, t8);
  t3 = _mm_xor_si128(t3, t2);
  t6 = _mm_xor_si128(t6, t3);
  return t6;
}

__attribute__((target("pclmul,ssse3")))
static __m128i be128_load_sse(const u8 *p) {
  const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7,
                                   8, 9, 10, 11, 12, 13, 14, 15);
  return _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)p), rev);
}
#endif

struct GcmKS {
  AesKS aes;
  u128 h;        // scalar-form hash key
  u8 hbe[16];    // big-endian bytes of H (PCLMUL path reloads per use)
};

static int gcm_init(const u8 *key, i32 keylen, GcmKS *g) {
  if (aes_expand(key, keylen, &g->aes) != 0) return -1;
  u8 z[16] = {0};
  aes_encrypt(&g->aes, z, g->hbe);
  g->h = be128_load(g->hbe);
  return 0;
}

#if defined(__x86_64__)
__attribute__((target("pclmul,ssse3")))
static void ghash_blocks_clmul(const u8 *hbe, u8 *ybe,
                               const u8 *data, size_t n) {
  __m128i h = be128_load_sse(hbe);
  __m128i y = be128_load_sse(ybe);
  u8 pad[16];
  for (size_t off = 0; off < n; off += 16) {
    const u8 *blk = data + off;
    if (n - off < 16) {
      memset(pad, 0, 16);
      memcpy(pad, blk, n - off);
      blk = pad;
    }
    y = gfmul_clmul(_mm_xor_si128(y, be128_load_sse(blk)), h);
  }
  const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7,
                                   8, 9, 10, 11, 12, 13, 14, 15);
  _mm_storeu_si128((__m128i *)ybe, _mm_shuffle_epi8(y, rev));
}
#endif

static void ghash_blocks_scalar(u128 h, u8 *ybe, const u8 *data, size_t n) {
  u128 y = be128_load(ybe);
  u8 pad[16];
  for (size_t off = 0; off < n; off += 16) {
    const u8 *blk = data + off;
    if (n - off < 16) {
      memset(pad, 0, 16);
      memcpy(pad, blk, n - off);
      blk = pad;
    }
    y = gmul_scalar(y ^ be128_load(blk), h);
  }
  for (int i = 15; i >= 0; i--) { ybe[i] = (u8)y; y >>= 8; }
}

static inline void ghash_blocks(const GcmKS *g, u8 *ybe,
                                const u8 *data, size_t n) {
#if defined(__x86_64__)
  if (g_pclmul) { ghash_blocks_clmul(g->hbe, ybe, data, n); return; }
#endif
  ghash_blocks_scalar(g->h, ybe, data, n);
}

// GHASH(aad, ct) -> 16 bytes (ops/aes.py AesGcm._ghash)
static void gcm_ghash(const GcmKS *g, const u8 *aad, size_t aadlen,
                      const u8 *ct, size_t ctlen, u8 *out) {
  memset(out, 0, 16);
  ghash_blocks(g, out, aad, aadlen);
  ghash_blocks(g, out, ct, ctlen);
  u8 lens[16];
  u64 ab = (u64)aadlen * 8, cb = (u64)ctlen * 8;
  for (int i = 0; i < 8; i++) lens[i] = (u8)(ab >> (56 - 8 * i));
  for (int i = 0; i < 8; i++) lens[8 + i] = (u8)(cb >> (56 - 8 * i));
  ghash_blocks(g, out, lens, 16);
}

// CTR keystream xor (ops/aes.py AesGcm._ctr): counter starts at j0+1
static void gcm_ctr(const GcmKS *g, const u8 *j0, const u8 *in, size_t n,
                    u8 *out) {
  u8 blk[16], ks[16];
  memcpy(blk, j0, 12);
  u32 ctr = ((u32)j0[12] << 24) | ((u32)j0[13] << 16) |
            ((u32)j0[14] << 8) | (u32)j0[15];
  for (size_t off = 0; off < n; off += 16) {
    ctr += 1;
    blk[12] = (u8)(ctr >> 24); blk[13] = (u8)(ctr >> 16);
    blk[14] = (u8)(ctr >> 8);  blk[15] = (u8)ctr;
    aes_encrypt(&g->aes, blk, ks);
    size_t m = n - off < 16 ? n - off : 16;
    for (size_t i = 0; i < m; i++) out[off + i] = (u8)(in[off + i] ^ ks[i]);
  }
}

static void gcm_tag(const GcmKS *g, const u8 *j0, const u8 *aad,
                    size_t aadlen, const u8 *ct, size_t ctlen, u8 *tag) {
  u8 s[16], ej0[16];
  gcm_ghash(g, aad, aadlen, ct, ctlen, s);
  aes_encrypt(&g->aes, j0, ej0);
  for (int i = 0; i < 16; i++) tag[i] = (u8)(ej0[i] ^ s[i]);
}

static void gcm_seal_ks(const GcmKS *g, const u8 *iv, const u8 *aad,
                        size_t aadlen, const u8 *pt, size_t n,
                        u8 *ct, u8 *tag) {
  u8 j0[16];
  memcpy(j0, iv, 12);
  j0[12] = 0; j0[13] = 0; j0[14] = 0; j0[15] = 1;
  gcm_ctr(g, j0, pt, n, ct);
  gcm_tag(g, j0, aad, aadlen, ct, n, tag);
}

// -> 0 ok (pt written), -1 auth reject (pt untouched)
static int gcm_open_ks(const GcmKS *g, const u8 *iv, const u8 *aad,
                       size_t aadlen, const u8 *ct, size_t n,
                       const u8 *tag, u8 *pt) {
  u8 j0[16], expect[16];
  memcpy(j0, iv, 12);
  j0[12] = 0; j0[13] = 0; j0[14] = 0; j0[15] = 1;
  gcm_tag(g, j0, aad, aadlen, ct, n, expect);
  u8 diff = 0;
  for (int i = 0; i < 16; i++) diff |= (u8)(expect[i] ^ tag[i]);
  if (diff) return -1;
  gcm_ctr(g, j0, ct, n, pt);
  return 0;
}

// =============================================================================
// QUIC wire helpers
// =============================================================================

// varint (RFC 9000 §16); returns 0 ok / -1 truncated
static inline int vdec(const u8 *p, size_t n, size_t *off, u64 *out) {
  if (*off >= n) return -1;
  u32 ln = 1u << (p[*off] >> 6);
  if (*off + ln > n) return -1;
  u64 v = (u64)(p[*off] & 0x3F);
  for (u32 i = 1; i < ln; i++) v = (v << 8) | p[*off + i];
  *off += ln;
  *out = v;
  return 0;
}

// RFC 9000 §A.3 (waltz/quic.py decode_pn)
static i64 decode_pn(u64 truncated, int pn_nbits, i64 largest) {
  i64 expected = largest + 1;
  i64 win = (i64)1 << pn_nbits;
  i64 hwin = win >> 1;
  i64 cand = (expected & ~(win - 1)) | (i64)truncated;
  if (cand <= expected - hwin && cand + win < ((i64)1 << 62)) return cand + win;
  if (cand > expected + hwin && cand >= win) return cand - win;
  return cand;
}

// =============================================================================
// connection table + pn dedup window (_RecvTracker port)
// =============================================================================

#define NET_DCID_LEN 8
#define NET_MAX_RANGES 32
#define NET_STREAM_LIMIT ((u64)1 << 18)   // quic.DEFAULT_MAX_STREAM_DATA
#define NET_TXN_MTU 1232
#define NET_DONE_WIN 256   // finished streams remembered past done_base

struct PnWindow {
  i64 rng[NET_MAX_RANGES][2];  // ascending disjoint [lo, hi]
  i32 n;
};

static int pn_seen(const PnWindow *w, i64 pn) {
  for (i32 i = 0; i < w->n; i++)
    if (w->rng[i][0] <= pn && pn <= w->rng[i][1]) return 1;
  return 0;
}

static void pn_add(PnWindow *w, i64 pn) {
  for (i32 i = 0; i < w->n; i++) {
    i64 *r = w->rng[i];
    if (r[0] - 1 <= pn && pn <= r[1] + 1) {
      if (pn < r[0]) r[0] = pn;
      if (pn > r[1]) r[1] = pn;
      if (i + 1 < w->n && w->rng[i + 1][0] <= r[1] + 1) {
        if (w->rng[i + 1][1] > r[1]) r[1] = w->rng[i + 1][1];
        memmove(&w->rng[i + 1], &w->rng[i + 2],
                (size_t)(w->n - i - 2) * sizeof(w->rng[0]));
        w->n--;
      }
      return;
    }
    if (pn < r[0] - 1) {
      if (w->n == NET_MAX_RANGES) {
        // Python inserts then trims the oldest range back to 32: a
        // new range BELOW everything at capacity would be trimmed
        // right back out; otherwise the oldest range is forgotten
        if (i == 0) return;
        memmove(&w->rng[0], &w->rng[1],
                (size_t)(i - 1) * sizeof(w->rng[0]));
        w->rng[i - 1][0] = pn; w->rng[i - 1][1] = pn;
        return;
      }
      memmove(&w->rng[i + 1], &w->rng[i],
              (size_t)(w->n - i) * sizeof(w->rng[0]));
      w->rng[i][0] = pn; w->rng[i][1] = pn;
      w->n++;
      return;
    }
  }
  if (w->n == NET_MAX_RANGES) {  // bound state: forget the oldest range
    memmove(&w->rng[0], &w->rng[1],
            (size_t)(NET_MAX_RANGES - 1) * sizeof(w->rng[0]));
    w->n--;
  }
  w->rng[w->n][0] = pn; w->rng[w->n][1] = pn; w->n++;
}

static inline i64 pn_largest(const PnWindow *w) {
  return w->n ? w->rng[w->n - 1][1] : -1;
}

struct NetConn {
  u8 state;        // 0 free, 1 used, 2 tombstone (probe continuation)
  u8 gen;          // bumped per table-slot reuse: stale reasm slots die
  u32 addr_id;
  u64 dcid;        // the 8 raw DCID bytes, memcpy'd
  GcmKS pp;        // packet-protection (payload) key
  AesKS hp;        // header-protection key
  u8 iv[12];
  PnWindow win;
  u64 rx_max_data;    // synced down from the Python Connection
  u64 rx_data_total;  // mirrored flow accounting (sum of stream highs)
  // finished streams by stream type (sid & 3): every index (sid >> 2)
  // below done_base, and each past it whose bit is set.  A STREAM frame
  // of a finished stream is a retransmission (a lost or late ACK): it is
  // acked, and its txn is never delivered again
  u64 done_base[4];
  u64 done_bits[4][NET_DONE_WIN / 64];
};

static int stream_done(const NetConn *n, u64 sid) {
  u64 t = sid & 3, k = sid >> 2;
  if (k < n->done_base[t]) return 1;
  u64 d = k - n->done_base[t];
  if (d >= NET_DONE_WIN) return 0;
  return (int)((n->done_bits[t][d >> 6] >> (d & 63)) & 1);
}

// drop the window's first s bits (the bitmap moves toward index 0)
static void done_shift(u64 *bits, u64 s) {
  const u64 w = NET_DONE_WIN / 64;
  u64 q = s >> 6, r = s & 63;
  for (u64 i = 0; i < w; i++) {
    u64 lo = i + q < w ? bits[i + q] : 0;
    u64 hi = i + q + 1 < w ? bits[i + q + 1] : 0;
    bits[i] = r ? (lo >> r) | (hi << (64 - r)) : lo;
  }
}

static void stream_mark_done(NetConn *n, u64 sid) {
  u64 t = sid & 3, k = sid >> 2;
  u64 *bits = n->done_bits[t];
  if (k < n->done_base[t]) return;
  if (k - n->done_base[t] >= NET_DONE_WIN) {
    // past the window: the streams that fall below it count as finished
    // (one still open that far back is abandoned, as an evicted slot is)
    u64 s = k - n->done_base[t] - NET_DONE_WIN + 1;
    done_shift(bits, s);
    n->done_base[t] += s;
  }
  u64 d = k - n->done_base[t];
  bits[d >> 6] |= (u64)1 << (d & 63);
  u64 run = 0;  // the base moves past the finished prefix
  while (run < NET_DONE_WIN && ((bits[run >> 6] >> (run & 63)) & 1)) run++;
  if (run) {
    done_shift(bits, run);
    n->done_base[t] += run;
  }
}

// =============================================================================
// reassembly slots (tpu_reasm.py port + out-of-order ranges)
// =============================================================================

#define SLOT_MAX_RANGES 16

struct Slot {
  u8 used, dead, fin;
  u8 conn_gen;
  i32 conn_idx;
  u64 sid;
  u64 fin_size;
  u64 delivered;   // contiguous-from-zero extent
  u64 high;        // max(offset+len) seen (flow accounting)
  u64 lru;
  i32 nrg;
  u64 rg[SLOT_MAX_RANGES][2];  // received [off, end) ranges, ascending
  u8 buf[NET_TXN_MTU];
};

// =============================================================================
// context
// =============================================================================

enum { EV_PKT = 1, EV_ACK = 2, EV_WIN = 3 };

#define EV_CAP 4096
#define OUT_CAP 1024
#define OUT_ARENA_SZ (OUT_CAP * (NET_TXN_MTU + 48))

enum {
  C_RX_DGRAM = 0, C_CONSUMED, C_PUNT, C_DUP, C_BAD_PACKET, C_TXN,
  C_OVERSZ, C_EVICTED, C_FLOW_VIOLATION, C_AUTH_FAIL, C_UDP_PKTS,
  C_AESNI, C_PCLMUL, C_TAIL_RETAINED, C_COUNT,
};

struct NetCtx {
  i32 cap;          // conn table capacity (pow2)
  u32 mask;
  NetConn *conns;
  i32 depth;        // reasm slots
  Slot *slots;
  u64 lru_tick;
  u64 ev[EV_CAP][4];
  i32 ev_n;
  u64 out_tbl[OUT_CAP][4];  // off, sz, sig, tsorig
  i32 out_n;
  u64 arena_used;
  u8 *arena;
  u64 counters[C_COUNT];
  // shm metrics plane (fdn_set_metrics; null = dark): socket sweeps
  // observe the drain phase, per-datagram decrypt+apply the callback
  // phase — the publish phase rides the Python-side burst crossing
  fdm_plane *mplane;
  u8 scratch[2048];
};

// Source-stage drain observe: net has no fdr_sweep epilogue, so the
// socket sweep records its own crossing (drain hist + counters + the
// decimated flight trail).
static inline void net_obs_drain(NetCtx *c, u64 t0, i32 total) {
  fdm_plane *pl = c->mplane;
  if (!pl || total <= 0) return;
  if (pl->flags & FDM_F_PH)
    fdm_hist_obs(pl->met, &pl->ph[FDM_PH_DRAIN],
                 (double)(fdm_now_ns() - t0));
  fdm_ctr_add(pl, pl->c_frags_off, (u64)total);
  fdm_ctr_add(pl, pl->c_crossings_off, 1);
  if ((pl->crossings % FDM_FLIGHT_DECIMATE) == 0)
    fdm_flight(pl, FDM_EV_NSWEEP_DRAIN, (u64)total);
  pl->crossings++;
}

static inline u64 hash64(u64 x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33; return x;
}

static i32 conn_find(NetCtx *c, u64 dcid) {
  u32 i = (u32)hash64(dcid) & c->mask;
  for (i32 probes = 0; probes <= c->cap; probes++, i = (i + 1) & c->mask) {
    NetConn *n = &c->conns[i];
    if (n->state == 0) return -1;
    if (n->state == 1 && n->dcid == dcid) return (i32)i;
  }
  return -1;
}

extern "C" {

void *fdn_new(i32 max_conns, i32 reasm_depth) {
  simd_detect();
  if (max_conns < 1) max_conns = 1;
  if (reasm_depth < 1) reasm_depth = 1;
  i32 cap = 8;
  while (cap < 2 * max_conns) cap <<= 1;
  NetCtx *c = (NetCtx *)calloc(1, sizeof(NetCtx));
  if (!c) return NULL;
  c->cap = cap;
  c->mask = (u32)cap - 1;
  c->conns = (NetConn *)calloc((size_t)cap, sizeof(NetConn));
  c->depth = reasm_depth;
  c->slots = (Slot *)calloc((size_t)reasm_depth, sizeof(Slot));
  c->arena = (u8 *)malloc(OUT_ARENA_SZ);
  if (!c->conns || !c->slots || !c->arena) {
    free(c->conns); free(c->slots); free(c->arena); free(c);
    return NULL;
  }
  c->counters[C_AESNI] = (u64)g_aesni;
  c->counters[C_PCLMUL] = (u64)g_pclmul;
  return c;
}

void fdn_delete(void *ctx) {
  NetCtx *c = (NetCtx *)ctx;
  if (!c) return;
  free(c->conns); free(c->slots); free(c->arena); free(c);
}

// Install an ESTABLISHED connection's rx side.  ranges = 2*n_ranges i64
// (the Python _RecvTracker state, so the dedup window starts coherent).
// Returns the conn index, or -1 (table full / bad key).
i32 fdn_conn_add(void *ctx, const u8 *dcid, u32 addr_id, const u8 *key,
                 const u8 *iv, const u8 *hp, const i64 *ranges,
                 i32 n_ranges, u64 rx_max_data, u64 rx_data_total) {
  NetCtx *c = (NetCtx *)ctx;
  u64 k;
  memcpy(&k, dcid, 8);
  i32 existing = conn_find(c, k);
  u32 i;
  if (existing >= 0) {
    i = (u32)existing;       // re-add: refresh keys/state in place
  } else {
    i = (u32)hash64(k) & c->mask;
    i32 probes = 0;
    while (c->conns[i].state == 1) {
      if (++probes > c->cap) return -1;
      i = (i + 1) & c->mask;
    }
  }
  NetConn *n = &c->conns[i];
  u8 gen = (u8)(n->gen + 1);
  memset(&n->win, 0, sizeof(n->win));
  if (existing < 0) {  // a new connection has finished no stream
    memset(n->done_base, 0, sizeof(n->done_base));
    memset(n->done_bits, 0, sizeof(n->done_bits));
  }
  n->state = 1;
  n->gen = gen;
  n->dcid = k;
  n->addr_id = addr_id;
  n->rx_max_data = rx_max_data;
  n->rx_data_total = rx_data_total;
  memcpy(n->iv, iv, 12);
  if (gcm_init(key, 16, &n->pp) != 0) { n->state = 2; return -1; }
  if (aes_expand(hp, 16, &n->hp) != 0) { n->state = 2; return -1; }
  if (n_ranges > NET_MAX_RANGES) n_ranges = NET_MAX_RANGES;
  for (i32 r = 0; r < n_ranges; r++) {
    n->win.rng[r][0] = ranges[2 * r];
    n->win.rng[r][1] = ranges[2 * r + 1];
  }
  n->win.n = n_ranges;
  return (i32)i;
}

void fdn_conn_remove(void *ctx, i32 idx) {
  NetCtx *c = (NetCtx *)ctx;
  if (idx < 0 || idx >= c->cap || c->conns[idx].state != 1) return;
  c->conns[idx].state = 2;   // tombstone keeps probe chains intact
  for (i32 s = 0; s < c->depth; s++)
    if (c->slots[s].used && c->slots[s].conn_idx == idx)
      c->slots[s].used = 0;
}

void fdn_conn_set_addr(void *ctx, i32 idx, u32 addr_id) {
  NetCtx *c = (NetCtx *)ctx;
  if (idx < 0 || idx >= c->cap || c->conns[idx].state != 1) return;
  c->conns[idx].addr_id = addr_id;
}

// Window sync from the authoritative Python conn: after an EV_WIN-driven
// MAX_DATA advertisement (total is then an identity write), and after a
// punted datagram whose Python-lane STREAM frames moved the totals this
// side's flow check enforces.
void fdn_conn_window(void *ctx, i32 idx, u64 rx_max_data,
                     u64 rx_data_total) {
  NetCtx *c = (NetCtx *)ctx;
  if (idx < 0 || idx >= c->cap || c->conns[idx].state != 1) return;
  c->conns[idx].rx_max_data = rx_max_data;
  c->conns[idx].rx_data_total = rx_data_total;
}

// Reverse pn sync: the Python lane consumed an APPLICATION packet for a
// native-owned conn (a punted frame mix) — keep the dedup window honest.
void fdn_conn_pn_add(void *ctx, i32 idx, i64 pn) {
  NetCtx *c = (NetCtx *)ctx;
  if (idx < 0 || idx >= c->cap || c->conns[idx].state != 1) return;
  pn_add(&c->conns[idx].win, pn);
}

// Finished-stream sync with the Python lane: it asks before it delivers
// a punted datagram's stream, and records a stream it delivered whole,
// so neither side delivers a retransmitted txn the other delivered.
i32 fdn_conn_stream_is_done(void *ctx, i32 idx, u64 sid) {
  NetCtx *c = (NetCtx *)ctx;
  if (idx < 0 || idx >= c->cap || c->conns[idx].state != 1) return 0;
  return stream_done(&c->conns[idx], sid);
}

void fdn_conn_stream_done(void *ctx, i32 idx, u64 sid) {
  NetCtx *c = (NetCtx *)ctx;
  if (idx < 0 || idx >= c->cap || c->conns[idx].state != 1) return;
  stream_mark_done(&c->conns[idx], sid);
}

u64 *fdn_counters_ptr(void *ctx) { return ((NetCtx *)ctx)->counters; }
i32 fdn_counters_len(void *ctx) { (void)ctx; return C_COUNT; }
u64 *fdn_events_ptr(void *ctx) { return &((NetCtx *)ctx)->ev[0][0]; }
i32 fdn_events_count(void *ctx) { return ((NetCtx *)ctx)->ev_n; }
void fdn_events_clear(void *ctx) { ((NetCtx *)ctx)->ev_n = 0; }
u64 *fdn_out_tbl_ptr(void *ctx) { return &((NetCtx *)ctx)->out_tbl[0][0]; }
u8 *fdn_out_arena_ptr(void *ctx) { return ((NetCtx *)ctx)->arena; }
i32 fdn_out_count(void *ctx) { return ((NetCtx *)ctx)->out_n; }

// Retire the published prefix; the unpublished tail compacts to the
// front of the table AND the arena (credit-gated publish: never drop).
void fdn_out_pop(void *ctx, i32 n) {
  NetCtx *c = (NetCtx *)ctx;
  if (n < 0) n = 0;
  if (n >= c->out_n) { c->out_n = 0; c->arena_used = 0; return; }
  i32 rem = c->out_n - n;
  c->counters[C_TAIL_RETAINED] += (u64)rem;  // counted even on n == 0
  if (n == 0) return;
  u64 base = 0;
  for (i32 i = 0; i < rem; i++) {
    u64 off = c->out_tbl[n + i][0], sz = c->out_tbl[n + i][1];
    memmove(c->arena + base, c->arena + off, sz);
    c->out_tbl[i][0] = base;
    c->out_tbl[i][1] = sz;
    c->out_tbl[i][2] = c->out_tbl[n + i][2];
    c->out_tbl[i][3] = c->out_tbl[n + i][3];
    base += sz;
  }
  c->out_n = rem;
  c->arena_used = base;
}

}  // extern "C" (reopened below; internal helpers follow)

// -- internal: events / reasm -------------------------------------------------

static inline void ev_push(NetCtx *c, u64 type, u64 a, u64 b, u64 d) {
  if (c->ev_n >= EV_CAP) return;  // callers pre-check headroom
  u64 *row = c->ev[c->ev_n++];
  row[0] = type; row[1] = a; row[2] = b; row[3] = d;
}

static Slot *slot_find(NetCtx *c, i32 conn_idx, u8 gen, u64 sid) {
  for (i32 i = 0; i < c->depth; i++) {
    Slot *s = &c->slots[i];
    if (s->used && s->conn_idx == conn_idx && s->conn_gen == gen &&
        s->sid == sid)
      return s;
  }
  return NULL;
}

static Slot *slot_new(NetCtx *c, i32 conn_idx, u8 gen, u64 sid) {
  Slot *victim = NULL;
  for (i32 i = 0; i < c->depth; i++) {
    Slot *s = &c->slots[i];
    if (!s->used) { victim = s; goto init; }
    if (!victim || s->lru < victim->lru) victim = s;
  }
  c->counters[C_EVICTED]++;  // steal the least-recently-active slot
init:
  memset(victim, 0, offsetof(Slot, buf));
  victim->used = 1;
  victim->conn_idx = conn_idx;
  victim->conn_gen = gen;
  victim->sid = sid;
  return victim;
}

// merge [off, end) into the slot ranges; returns new contiguous-from-0
// extent.  Range overflow degrades to dropping the segment (the stream
// stalls and LRU reclaims it — same failure mode as an evicted slot).
static u64 slot_insert_range(Slot *s, u64 off, u64 end) {
  i32 i = 0;
  while (i < s->nrg && s->rg[i][1] < off) i++;
  if (i < s->nrg && s->rg[i][0] <= end) {  // overlaps/touches: merge
    if (off < s->rg[i][0]) s->rg[i][0] = off;
    if (end > s->rg[i][1]) s->rg[i][1] = end;
    while (i + 1 < s->nrg && s->rg[i + 1][0] <= s->rg[i][1]) {
      if (s->rg[i + 1][1] > s->rg[i][1]) s->rg[i][1] = s->rg[i + 1][1];
      memmove(&s->rg[i + 1], &s->rg[i + 2],
              (size_t)(s->nrg - i - 2) * sizeof(s->rg[0]));
      s->nrg--;
    }
  } else {
    if (s->nrg >= SLOT_MAX_RANGES) return s->delivered;
    memmove(&s->rg[i + 1], &s->rg[i],
            (size_t)(s->nrg - i) * sizeof(s->rg[0]));
    s->rg[i][0] = off; s->rg[i][1] = end;
    s->nrg++;
  }
  return (s->nrg && s->rg[0][0] == 0) ? s->rg[0][1] : 0;
}

// =============================================================================
// the datagram hot path
// =============================================================================

enum { RC_CONSUMED = 0, RC_PUNT = 1, RC_DROP = 2 };

// Frame classification for the PUNT contract.  CONSUME must be exactly
// the set waltz/quic.py handles-or-skips without control-plane effects.
enum { FR_CONSUME = 0, FR_PUNT = 1, FR_BAD = 2 };

struct FrameScan {
  // one ACK frame (range_cnt==0, no ECN) may be consumed natively
  int have_ack;
  u64 ack_largest, ack_first_len;
};

static int classify_frames(const u8 *p, size_t n, FrameScan *fs) {
  size_t off = 0;
  u64 v, sid, slen;
  fs->have_ack = 0;
  while (off < n) {
    u8 ft = p[off++];
    switch (ft) {
      case 0x00: break;                       // PADDING
      case 0x01: break;                       // PING (ack-eliciting only)
      case 0x02: case 0x03: {                 // ACK / ACK+ECN
        u64 largest, delay, range_cnt, first;
        if (vdec(p, n, &off, &largest) || vdec(p, n, &off, &delay) ||
            vdec(p, n, &off, &range_cnt) || vdec(p, n, &off, &first))
          return FR_BAD;
        if (range_cnt != 0 || ft == 0x03 || fs->have_ack)
          return FR_PUNT;  // multi-range/ECN/second ACK: control plane
        if (first > largest) return FR_BAD;   // range below zero
        fs->have_ack = 1;
        fs->ack_largest = largest;
        fs->ack_first_len = first;
        break;
      }
      case 0x06:                              // CRYPTO
      case 0x1A: case 0x1B:                   // PATH_CHALLENGE/RESPONSE
      case 0x1C: case 0x1D:                   // CONNECTION_CLOSE
      case 0x1E:                              // HANDSHAKE_DONE
        return FR_PUNT;
      case 0x04:                              // RESET_STREAM
        if (vdec(p, n, &off, &v) || vdec(p, n, &off, &v) ||
            vdec(p, n, &off, &v)) return FR_BAD;
        break;
      case 0x05:                              // STOP_SENDING
        if (vdec(p, n, &off, &v) || vdec(p, n, &off, &v)) return FR_BAD;
        break;
      case 0x08: case 0x09: case 0x0A: case 0x0B:
      case 0x0C: case 0x0D: case 0x0E: case 0x0F:   // STREAM
        if (vdec(p, n, &off, &sid)) return FR_BAD;
        if (ft & 0x04) { if (vdec(p, n, &off, &v)) return FR_BAD; }
        if (ft & 0x02) {
          if (vdec(p, n, &off, &slen) || off + slen > n) return FR_BAD;
          off += slen;
        } else {
          off = n;
        }
        break;
      case 0x10:                              // MAX_DATA
        if (vdec(p, n, &off, &v)) return FR_BAD;
        break;
      case 0x11:                              // MAX_STREAM_DATA
        if (vdec(p, n, &off, &v) || vdec(p, n, &off, &v)) return FR_BAD;
        break;
      case 0x12: case 0x13: case 0x14:
      case 0x16: case 0x17: case 0x19:        // MAX_STREAMS/BLOCKED/RETIRE
        if (vdec(p, n, &off, &v)) return FR_BAD;
        break;
      case 0x15:                              // STREAM_DATA_BLOCKED
        if (vdec(p, n, &off, &v) || vdec(p, n, &off, &v)) return FR_BAD;
        break;
      case 0x18: {                            // NEW_CONNECTION_ID
        if (vdec(p, n, &off, &v) || vdec(p, n, &off, &v)) return FR_BAD;
        if (off >= n) return FR_BAD;
        u8 cl = p[off];
        if (off + 1 + cl + 16 > n) return FR_BAD;
        off += 1 + (size_t)cl + 16;
        break;
      }
      default:
        return FR_BAD;                        // unhandled frame type
    }
  }
  return FR_CONSUME;
}

// apply the STREAM frames (classification already passed); returns
// RC_CONSUMED or RC_DROP (flow violation mid-apply, Python parity:
// earlier frames' effects persist, the rest of the packet dies)
static int apply_frames(NetCtx *c, i32 ci, const u8 *p, size_t n,
                        u64 *consumed_delta, u64 *total_delta,
                        int *ack_elicit) {
  NetConn *conn = &c->conns[ci];
  size_t off = 0;
  u64 v = 0, sid = 0, slen = 0;  // vdec rcs ignored: classified already
  while (off < n) {
    u8 ft = p[off++];
    // ack_pending parity: Python adds it only for frames parse_frames
    // YIELDS (ping/stream/max_data/max_stream_data here — the silently
    // skipped frame kinds and pure padding/ACK never trigger an ack)
    if (ft == 0x01 || (ft >= 0x08 && ft <= 0x11)) *ack_elicit = 1;
    if (ft == 0x00 || ft == 0x01) continue;
    if (ft == 0x02) {  // single-range ACK (classified consumable)
      u64 largest = 0, delay = 0, range_cnt = 0, first = 0;
      vdec(p, n, &off, &largest); vdec(p, n, &off, &delay);
      vdec(p, n, &off, &range_cnt); vdec(p, n, &off, &first);
      ev_push(c, EV_ACK, (u64)ci, largest, first);
      continue;
    }
    if (ft >= 0x08 && ft <= 0x0F) {  // STREAM
      vdec(p, n, &off, &sid);
      u64 soff = 0;
      if (ft & 0x04) { vdec(p, n, &off, &soff); }
      if (ft & 0x02) { vdec(p, n, &off, &slen); }
      else slen = n - off;
      const u8 *data = p + off;
      off += slen;
      int fin = ft & 0x01;
      u64 end = soff + slen;
      // flow control (quic.Connection._rx_flow_check)
      if (end > NET_STREAM_LIMIT) {
        c->counters[C_FLOW_VIOLATION]++;
        return RC_DROP;
      }
      // a finished stream's frame adds nothing: no flow (its high is its
      // final size), no slot, no txn
      if (stream_done(conn, sid)) continue;
      Slot *s = slot_find(c, ci, conn->gen, sid);
      u64 high = s ? s->high : 0;
      if (end > high) {
        conn->rx_data_total += end - high;
        *total_delta += end - high;
        if (conn->rx_data_total > conn->rx_max_data) {
          c->counters[C_FLOW_VIOLATION]++;
          return RC_DROP;
        }
      }
      if (!s) s = slot_new(c, ci, conn->gen, sid);
      s->lru = ++c->lru_tick;
      if (end > high) s->high = end;
      if (s->dead) {   // poisoned oversize stream: swallow until FIN
        if (fin) {
          s->used = 0;
          stream_mark_done(conn, sid);
        }
        continue;
      }
      if (fin) { s->fin = 1; s->fin_size = end; }
      if (end > NET_TXN_MTU) {  // oversize: tombstone (tpu_reasm rule)
        c->counters[C_OVERSZ]++;
        if (fin) {
          s->used = 0;
          stream_mark_done(conn, sid);
        } else {
          s->dead = 1;
        }
        continue;
      }
      if (slen) {
        memcpy(s->buf + soff, data, slen);
        u64 before = s->delivered;
        s->delivered = slot_insert_range(s, soff, end);
        if (s->delivered > before) *consumed_delta += s->delivered - before;
      } else if (fin && !s->nrg) {
        // zero-length FIN-only stream: delivers an empty txn
        s->delivered = 0;
      }
      if (s->fin && s->delivered >= s->fin_size) {
        // whole txn: copy into the out arena (credit-gated publish)
        if (c->out_n < OUT_CAP &&
            c->arena_used + s->fin_size <= OUT_ARENA_SZ) {
          u64 *row = c->out_tbl[c->out_n++];
          row[0] = c->arena_used;
          row[1] = s->fin_size;
          row[2] = 0;  // sig: stamped by the stage at publish
          row[3] = 0;  // tsorig: stamped by the stage at publish
          memcpy(c->arena + c->arena_used, s->buf, s->fin_size);
          c->arena_used += s->fin_size;
          c->counters[C_TXN]++;
        }
        s->used = 0;
        stream_mark_done(conn, sid);
      }
      continue;
    }
    // remaining consumable frames: skip exactly as classified
    switch (ft) {
      case 0x04: vdec(p, n, &off, &v); vdec(p, n, &off, &v);
                 vdec(p, n, &off, &v); break;
      case 0x05: case 0x11: case 0x15:
                 vdec(p, n, &off, &v); vdec(p, n, &off, &v); break;
      case 0x10: case 0x12: case 0x13: case 0x14:
      case 0x16: case 0x17: case 0x19: vdec(p, n, &off, &v); break;
      case 0x18: {
        vdec(p, n, &off, &v); vdec(p, n, &off, &v);
        u8 cl = p[off];
        off += 1 + (size_t)cl + 16;
        break;
      }
      default: break;  // unreachable post-classification
    }
  }
  return RC_CONSUMED;
}

extern "C" {

// One datagram, synchronously: 0 = consumed here (drain events/txns),
// 1 = PUNT (run the Python lane on these exact bytes, in order),
// 2 = dropped+counted here (dedup/bad packet — the Python lane would
//     have dropped it the same way).
static i32 fdn_datagram_inner(NetCtx *c, const u8 *data, i32 sz,
                              u32 addr_id) {
  c->counters[C_RX_DGRAM]++;
  if (sz <= 0) { c->counters[C_PUNT]++; return RC_PUNT; }
  if (data[0] & 0x80) {  // long header: handshake/control plane
    c->counters[C_PUNT]++;
    return RC_PUNT;
  }
  // headroom: a punt must be decidable BEFORE any effect lands
  if (c->ev_n + 8 > EV_CAP || c->out_n + 8 > OUT_CAP ||
      c->arena_used + 8 * NET_TXN_MTU > OUT_ARENA_SZ) {
    c->counters[C_PUNT]++;
    return RC_PUNT;
  }
  if (sz < 1 + NET_DCID_LEN) { c->counters[C_PUNT]++; return RC_PUNT; }
  u64 dcid;
  memcpy(&dcid, data + 1, 8);
  i32 ci = conn_find(c, dcid);
  if (ci < 0) {  // unknown CID: stateless-reset path is Python's
    c->counters[C_PUNT]++;
    return RC_PUNT;
  }
  NetConn *conn = &c->conns[ci];
  if (conn->addr_id != addr_id) {  // migration: path validation is Python's
    c->counters[C_PUNT]++;
    return RC_PUNT;
  }
  // short header: pn at 9, HP sample at pn_off+4 (quic.open_packet)
  size_t pn_off = 1 + NET_DCID_LEN;
  if (pn_off + 4 + 16 > (size_t)sz) {  // too short for the HP sample
    c->counters[C_BAD_PACKET]++;
    return RC_DROP;
  }
  u8 mask[16];
  aes_encrypt(&conn->hp, data + pn_off + 4, mask);
  u8 b0 = (u8)(data[0] ^ (mask[0] & 0x1F));
  u32 pn_len = (u32)(b0 & 0x03) + 1;
  u8 hdr[1 + NET_DCID_LEN + 4];
  hdr[0] = b0;
  memcpy(hdr + 1, data + 1, NET_DCID_LEN);
  u64 truncated = 0;
  for (u32 i = 0; i < pn_len; i++) {
    u8 pb = (u8)(data[pn_off + i] ^ mask[1 + i]);
    hdr[pn_off + i] = pb;
    truncated = (truncated << 8) | pb;
  }
  i64 pn = decode_pn(truncated, (int)(8 * pn_len), pn_largest(&conn->win));
  size_t hdr_len = pn_off + pn_len;
  size_t body_len = (size_t)sz - hdr_len;
  if (body_len < 16) { c->counters[C_BAD_PACKET]++; return RC_DROP; }
  size_t ct_len = body_len - 16;
  // nonce = iv XOR pn into the last 8 bytes (Keys.nonce)
  u8 nonce[12];
  memcpy(nonce, conn->iv, 12);
  for (int i = 0; i < 8; i++)
    nonce[11 - i] ^= (u8)(((u64)pn >> (8 * i)) & 0xFF);
  u8 *pt = c->scratch;
  if (ct_len > sizeof(c->scratch)) { c->counters[C_BAD_PACKET]++; return RC_DROP; }
  if (gcm_open_ks(&conn->pp, nonce, hdr, hdr_len,
                  data + hdr_len, ct_len, data + hdr_len + ct_len, pt) != 0) {
    c->counters[C_AUTH_FAIL]++;
    c->counters[C_BAD_PACKET]++;
    return RC_DROP;  // quic: "packet authentication failed" -> bad_packet
  }
  // duplicate AFTER decrypt (Python order): re-ack only
  if (pn_seen(&conn->win, pn)) {
    c->counters[C_DUP]++;
    c->counters[C_CONSUMED]++;
    ev_push(c, EV_PKT, (u64)ci, (u64)pn, 1);
    return RC_CONSUMED;
  }
  FrameScan fs;
  int cls = classify_frames(pt, ct_len, &fs);
  if (cls == FR_PUNT) { c->counters[C_PUNT]++; return RC_PUNT; }
  if (cls == FR_BAD) {
    // Python: tracker.add already ran when parse_frames raises
    pn_add(&conn->win, pn);
    ev_push(c, EV_PKT, (u64)ci, (u64)pn, 2);  // flag 2: seen, no ack-elicit
    c->counters[C_BAD_PACKET]++;
    return RC_DROP;
  }
  pn_add(&conn->win, pn);
  u64 consumed_delta = 0, total_delta = 0;
  int ack_elicit = 0;
  int rc = apply_frames(c, ci, pt, ct_len, &consumed_delta, &total_delta,
                        &ack_elicit);
  // flag 0 = seen + ack-eliciting, 3 = seen only (pure-ACK packet)
  ev_push(c, EV_PKT, (u64)ci, (u64)pn, ack_elicit ? 0 : 3);
  if (consumed_delta || total_delta)
    ev_push(c, EV_WIN, (u64)ci, consumed_delta, total_delta);
  if (rc == RC_DROP) { c->counters[C_BAD_PACKET]++; return RC_DROP; }
  c->counters[C_CONSUMED]++;
  return RC_CONSUMED;
}

// One datagram, synchronously — the metrics-armed wrapper: the
// decrypt+frame-apply span observes into the callback-phase histogram
// (one crossing per datagram; this path already pays a syscall per
// packet, so two clock reads are noise).
i32 fdn_datagram(void *ctx, const u8 *data, i32 sz, u32 addr_id) {
  NetCtx *c = (NetCtx *)ctx;
  fdm_plane *pl = c->mplane;
  if (!pl) return fdn_datagram_inner(c, data, sz, addr_id);
  u64 t0 = fdm_now_ns();
  i32 rc = fdn_datagram_inner(c, data, sz, addr_id);
  if (pl->flags & FDM_F_PH)
    fdm_hist_obs(pl->met, &pl->ph[FDM_PH_CB], (double)(fdm_now_ns() - t0));
  fdm_ctr_add(pl, pl->c_frags_off, 1);
  fdm_ctr_add(pl, pl->c_crossings_off, 1);
  if ((pl->crossings % FDM_FLIGHT_DECIMATE) == 0)
    fdm_flight(pl, FDM_EV_NSWEEP_DRAIN, 1);
  pl->crossings++;
  return rc;
}

// Arm/disarm the shm metrics plane (native/fd_metrics.h); NULL disarms.
void fdn_set_metrics(void *ctx, fdm_plane *plane) {
  ((NetCtx *)ctx)->mplane = plane;
}

// Real recvmmsg under the sweep: ONE syscall
// drains the UDP burst and the kernel scatters each datagram DIRECTLY
// into its out-arena slot — per-packet iovecs at NET_TXN_MTU stride, no
// intermediate buffer, no second copy.  Oversize datagrams truncate
// into their slot (MSG_TRUNC) and are dropped+counted without a row,
// matching the scalar fallback's drop; the slot gap is bounded by the
// same want*MTU reservation the credit gate already takes.  Returns
// datagrams taken (0 = socket dry).
i32 fdn_udp_sweep(void *ctx, i32 fd, i32 max_pkts) {
#if defined(__linux__)
  NetCtx *c = (NetCtx *)ctx;
  enum { BATCH = 64 };
  struct mmsghdr msgs[BATCH];
  struct iovec iovs[BATCH];
  u64 t0 = c->mplane ? fdm_now_ns() : 0;
  i32 total = 0;
  while (total < max_pkts) {
    i32 want = max_pkts - total;
    if (want > BATCH) want = BATCH;
    i32 room = OUT_CAP - c->out_n;
    if (room <= 0 ||
        c->arena_used + (u64)want * NET_TXN_MTU > OUT_ARENA_SZ)
      break;  // credit-gated: leave the rest on the socket
    if (want > room) want = room;
    memset(msgs, 0, sizeof(msgs[0]) * (size_t)want);
    for (i32 i = 0; i < want; i++) {
      iovs[i].iov_base = c->arena + c->arena_used + (u64)i * NET_TXN_MTU;
      iovs[i].iov_len = NET_TXN_MTU;
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    i32 got = (i32)recvmmsg(fd, msgs, (unsigned)want, MSG_DONTWAIT, NULL);
    if (got <= 0) break;
    for (i32 i = 0; i < got; i++) {
      c->counters[C_UDP_PKTS]++;
      if (msgs[i].msg_hdr.msg_flags & MSG_TRUNC) {
        c->counters[C_OVERSZ]++;  // > MTU: dropped, slot left as a gap
        continue;
      }
      u64 *row = c->out_tbl[c->out_n++];
      row[0] = c->arena_used + (u64)i * NET_TXN_MTU;
      row[1] = msgs[i].msg_len;
      row[2] = 0;
      row[3] = 0;
    }
    c->arena_used += (u64)got * NET_TXN_MTU;
    total += got;
    if (got < want) break;  // socket drained mid-batch
  }
  net_obs_drain(c, t0, total);
  return total;
#else
  (void)ctx; (void)fd; (void)max_pkts;
  return -1;
#endif
}

// Scalar fallback: one recvfrom per datagram into a bounce buffer, then
// a copy into the arena — the pre-recvmmsg shape, kept byte-identical
// (same rows, counters, and credit gate; only arena offsets may differ
// because good packets pack contiguously).  Portable: POSIX recv only.
// The tests drive both paths over the same socket load.
i32 fdn_udp_sweep_scalar(void *ctx, i32 fd, i32 max_pkts) {
#if !defined(__linux__)
  (void)ctx; (void)fd; (void)max_pkts;
  return -1;  // <sys/socket.h> is only pulled in under the Linux gate
#else
  NetCtx *c = (NetCtx *)ctx;
  u8 buf[2048];
  u64 t0 = c->mplane ? fdm_now_ns() : 0;
  i32 total = 0;
  while (total < max_pkts) {
    if (c->out_n >= OUT_CAP ||
        c->arena_used + NET_TXN_MTU > OUT_ARENA_SZ)
      break;  // credit-gated: leave the rest on the socket
    i64 got = (i64)recv(fd, buf, sizeof(buf), MSG_DONTWAIT);
    if (got < 0) break;
    total++;
    c->counters[C_UDP_PKTS]++;
    if ((u64)got > NET_TXN_MTU) { c->counters[C_OVERSZ]++; continue; }
    u64 *row = c->out_tbl[c->out_n++];
    row[0] = c->arena_used;
    row[1] = (u64)got;
    row[2] = 0;
    row[3] = 0;
    memcpy(c->arena + c->arena_used, buf, (size_t)got);
    c->arena_used += (u64)got;
  }
  net_obs_drain(c, t0, total);
  return total;
#endif
}

// =============================================================================
// standalone crypto exports (ops/aes.py acceleration + parity fuzzing)
// =============================================================================

// one-shot AES-ECB over nblocks 16-byte blocks; 0 ok / -1 bad key
i32 fdn_aes_ecb(const u8 *key, i32 keylen, const u8 *in, i32 nblocks,
                u8 *out) {
  simd_detect();
  AesKS ks;
  if (aes_expand(key, keylen, &ks) != 0) return -1;
  for (i32 i = 0; i < nblocks; i++)
    aes_encrypt(&ks, in + 16 * i, out + 16 * i);
  return 0;
}

i32 fdn_gcm_seal(const u8 *key, i32 keylen, const u8 *iv, const u8 *aad,
                 i32 aadlen, const u8 *pt, i32 ptlen, u8 *ct, u8 *tag) {
  simd_detect();
  GcmKS g;
  if (aes_expand(key, keylen, &g.aes) != 0) return -1;
  u8 z[16] = {0};
  aes_encrypt(&g.aes, z, g.hbe);
  g.h = be128_load(g.hbe);
  gcm_seal_ks(&g, iv, aad, (size_t)aadlen, pt, (size_t)ptlen, ct, tag);
  return 0;
}

// 0 ok (pt written) / -1 auth reject / -2 bad key
i32 fdn_gcm_open(const u8 *key, i32 keylen, const u8 *iv, const u8 *aad,
                 i32 aadlen, const u8 *ct, i32 ctlen, const u8 *tag,
                 u8 *pt) {
  simd_detect();
  GcmKS g;
  if (aes_expand(key, keylen, &g.aes) != 0) return -2;
  u8 z[16] = {0};
  aes_encrypt(&g.aes, z, g.hbe);
  g.h = be128_load(g.hbe);
  return gcm_open_ks(&g, iv, aad, (size_t)aadlen, ct, (size_t)ctlen,
                     tag, pt);
}

// simd feature report: bit0 = AESNI, bit1 = PCLMUL (bench/test introspection)
i32 fdn_simd_features(void) {
  simd_detect();
  return (g_aesni ? 1 : 0) | (g_pclmul ? 2 : 0);
}

// The scalar AES/GHASH path on request: fdn_simd_force(0) pins it for every
// later call in the process (the tests hold the two paths byte-equal this
// way), fdn_simd_force(1) goes back to the CPUID probe's choice.  A context
// made after the call reports the choice in its aesni/pclmul counters.
void fdn_simd_force(i32 on) {
  g_simd_init = 0;
  simd_detect();
  if (!on) { g_aesni = 0; g_pclmul = 0; }
}

}  // extern "C"
