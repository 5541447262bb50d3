// Native shredder: entry batch -> signed merkle FEC sets, one FFI crossing.
// The port's copy of the JAX package's native/fd_shred.cpp, with one change:
// the parity call.
//
// The compute half of the shred stage in C++: data-shred framing, GF(2^8)
// Reed-Solomon parity, the SHA-256 merkle tree over the shred set, and
// fixed-base-comb ed25519 signing of the untruncated 32-byte root.
// Behavioral parity with runtime/shredder.py (itself a port of the
// reference's fd_shredder.c) is BYTE parity: the differential suite
// (tests/test_torch_shred_native.py) asserts identical data+parity shreds,
// merkle roots and signatures across lanes and against the JAX package's
// native shredder.
//
// Parity goes through a function pointer, once a FEC set:
//   int encode(void* user, const u8* gen, const u8* data, u64 d, u64 p,
//              u64 sz, u8* out)
// gen is the p x d generator (parity rows) built here, data the d RS rows
// of sz bytes, out the p parity rows; a nonzero return is an error code.
// On the card the pointer is K5's host entry (csrc/gf256_apply.cu
// fd_gf256_encode_host: copy in, one launch, copy out, sync); on the CPU
// (tests only) a ctypes trampoline into ops/gf256.gf_apply_batch's plain
// version (runtime/shred_native.py).  A failed encode fails the batch with
// FDS_ERR_PARITY (distinct from the capacity -1): the sweep client counts
// it in no counter of its own and records the code in its fault word,
// which Python reads after the crossing and raises on.
//
// Layout constants mirror protocol/shred.py (the spec is fd_shred.h):
// 1203-byte merkle data shreds, 1228-byte coding shreds, 64-byte leader
// signature over the FEC set's merkle root, 20-byte tree nodes, proof at
// the tail.  The signing path replicates ops/ref/ed25519_ref.py's comb
// (64 windows x 16 entries over the fixed base) so signatures match the
// Python lane bit-for-bit; the expanded key (clamped scalar a, prefix,
// compressed pubkey) arrives from Python's key cache — the secret itself
// never crosses into this module.
//
// Two entry points:
//   - fds_shred_batch: one crossing shreds a whole entry batch (the
//     NativeShredder drop-in lane for runtime/shredder.Shredder);
//   - fds_stage_*: the sweep-harness client (runtime/stage.py's
//     fdr_sweep path) — entry frags append into a C-side batch buffer
//     and full batches shred + publish through the port's fd_ring
//     function pointers with zero Python per frag.
//
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "fd_metrics.h"

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace {

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef __uint128_t u128;
typedef int64_t i64;

// ---------------------------------------------------------------------------
// SHA-256 (merkle tree nodes) -- FIPS 180-4, constants generated from the
// frac(cbrt/sqrt(prime)) definition (cross-checked against hashlib).

static const uint32_t K256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u,
    0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u,
    0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};
static const uint32_t H256[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
};

static inline u32 rotr32(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

#if defined(__x86_64__)
// SHA-NI block compression (runtime-dispatched; the scalar path below
// is the portable ground truth and the differential tests cover both).
// The merkle tree is the shredder's hash-heaviest loop — ~2 sha256
// invocations per shred — so the hardware rounds are worth the dispatch.
__attribute__((target("sha,sse4.1")))
static void sha256_blocks_ni(u32 state[8], const u8* data) {
  __m128i STATE0, STATE1, MSG, TMP, ABEF_SAVE, CDGH_SAVE;
  __m128i W[4];
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  TMP = _mm_loadu_si128((const __m128i*)&state[0]);
  STATE1 = _mm_loadu_si128((const __m128i*)&state[4]);
  TMP = _mm_shuffle_epi32(TMP, 0xB1);           // CDAB
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);     // EFGH
  STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);     // ABEF
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);  // CDGH
  ABEF_SAVE = STATE0;
  CDGH_SAVE = STATE1;
  for (int i = 0; i < 16; i++) {
    int j = i & 3;
    if (i < 4) {
      W[j] = _mm_shuffle_epi8(
          _mm_loadu_si128((const __m128i*)(data + 16 * i)), MASK);
    } else {
      __m128i t = _mm_alignr_epi8(W[(j + 3) & 3], W[(j + 2) & 3], 4);
      W[j] = _mm_sha256msg1_epu32(W[j], W[(j + 1) & 3]);
      W[j] = _mm_add_epi32(W[j], t);
      W[j] = _mm_sha256msg2_epu32(W[j], W[(j + 3) & 3]);
    }
    MSG = _mm_add_epi32(
        W[j], _mm_set_epi32((int)K256[4 * i + 3], (int)K256[4 * i + 2],
                            (int)K256[4 * i + 1], (int)K256[4 * i]));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  }
  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
  TMP = _mm_shuffle_epi32(STATE0, 0x1B);        // FEBA
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);     // DCHG
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);  // DCBA
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);     // HGFE
  _mm_storeu_si128((__m128i*)&state[0], STATE0);
  _mm_storeu_si128((__m128i*)&state[4], STATE1);
}

static bool have_shani_probe() {
  // CPUID.(EAX=7,ECX=0):EBX bit 29 (this gcc's __builtin_cpu_supports
  // has no "sha" token)
  unsigned a, b, c, d;
  if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return false;
  return (b >> 29) & 1;
}

static bool have_shani() {
  static const bool ok = have_shani_probe();
  return ok;
}
#endif

struct Sha256 {
  u32 h[8];
  u8 buf[64];
  u64 len;
  Sha256() { reset(); }
  void reset() {
    std::memcpy(h, H256, sizeof(h));
    len = 0;
  }
  void block(const u8* p) {
#if defined(__x86_64__)
    if (have_shani()) {
      sha256_blocks_ni(h, p);
      return;
    }
#endif
    u32 w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (u32)p[4 * i] << 24 | (u32)p[4 * i + 1] << 16 |
             (u32)p[4 * i + 2] << 8 | (u32)p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
      u32 s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
      u32 s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u32 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
        hh = h[7];
    for (int i = 0; i < 64; i++) {
      u32 S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
      u32 ch = (e & f) ^ (~e & g);
      u32 t1 = hh + S1 + ch + K256[i] + w[i];
      u32 S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
      u32 maj = (a & b) ^ (a & c) ^ (b & c);
      u32 t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  void update(const u8* p, u64 n) {
    u64 have = len & 63;
    len += n;
    if (have) {
      u64 need = 64 - have;
      if (n < need) { std::memcpy(buf + have, p, n); return; }
      std::memcpy(buf + have, p, need);
      block(buf);
      p += need; n -= need;
    }
    while (n >= 64) { block(p); p += 64; n -= 64; }
    if (n) std::memcpy(buf, p, n);
  }
  void final(u8 out[32]) {
    u64 bits = len * 8;
    u8 pad = 0x80;
    update(&pad, 1);
    u8 z = 0;
    while ((len & 63) != 56) update(&z, 1);
    u8 lb[8];
    for (int i = 0; i < 8; i++) lb[i] = (u8)(bits >> (56 - 8 * i));
    update(lb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = (u8)(h[i] >> 24); out[4 * i + 1] = (u8)(h[i] >> 16);
      out[4 * i + 2] = (u8)(h[i] >> 8); out[4 * i + 3] = (u8)h[i];
    }
  }
};

// ---------------------------------------------------------------------------
// SHA-512 (ed25519 r/k derivation).

static const uint64_t K512[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};
static const uint64_t H512[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull,
};

static inline u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

struct Sha512 {
  u64 h[8];
  u8 buf[128];
  u64 len;
  Sha512() { std::memcpy(h, H512, sizeof(h)); len = 0; }
  void block(const u8* p) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
      u64 v = 0;
      for (int j = 0; j < 8; j++) v = (v << 8) | p[8 * i + j];
      w[i] = v;
    }
    for (int i = 16; i < 80; i++) {
      u64 s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
      u64 s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u64 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
        hh = h[7];
    for (int i = 0; i < 80; i++) {
      u64 S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      u64 ch = (e & f) ^ (~e & g);
      u64 t1 = hh + S1 + ch + K512[i] + w[i];
      u64 S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      u64 maj = (a & b) ^ (a & c) ^ (b & c);
      u64 t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  void update(const u8* p, u64 n) {
    u64 have = len & 127;
    len += n;
    if (have) {
      u64 need = 128 - have;
      if (n < need) { std::memcpy(buf + have, p, n); return; }
      std::memcpy(buf + have, p, need);
      block(buf);
      p += need; n -= need;
    }
    while (n >= 128) { block(p); p += 128; n -= 128; }
    if (n) std::memcpy(buf, p, n);
  }
  void final(u8 out[64]) {
    u64 bits = len * 8;  // < 2^64 for any input this module hashes
    u8 pad = 0x80;
    update(&pad, 1);
    u8 z = 0;
    while ((len & 127) != 112) update(&z, 1);
    u8 lb[16] = {0};
    for (int i = 0; i < 8; i++) lb[8 + i] = (u8)(bits >> (56 - 8 * i));
    update(lb, 16);
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        out[8 * i + j] = (u8)(h[i] >> (56 - 8 * j));
  }
};

// ---------------------------------------------------------------------------
// GF(2^8) tables (poly 0x11D, gf256_ref parity) + systematic generator
// construction: V (n x d) Vandermonde, G = V * inv(V[:d]) — the same
// math as gf256_ref.generator_matrix, so the submatrix handed to the
// parity call is byte-identical to the Python lane's.

constexpr unsigned GF_POLY = 0x11D;

struct GfTables {
  u8 exp[512];
  u8 log[256];
  GfTables() {
    unsigned x = 1;
    std::memset(log, 0, sizeof(log));
    for (unsigned i = 0; i < 255; i++) {
      exp[i] = (u8)x;
      log[x] = (u8)i;
      x <<= 1;
      if (x & 0x100) x ^= GF_POLY;
    }
    for (unsigned i = 255; i < 510; i++) exp[i] = exp[i - 255];
  }
  inline u8 mul(u8 a, u8 b) const {
    return (a && b) ? exp[log[a] + log[b]] : 0;
  }
  inline u8 inv(u8 a) const { return exp[255 - log[a]]; }
  inline u8 pow(u8 a, unsigned e) const {
    if (e == 0) return 1;
    if (a == 0) return 0;
    return exp[((unsigned)log[a] * e) % 255];
  }
};

static const GfTables GF;

// gen[p x d] = rows d..n-1 of the systematic generator (n = d + p).
// Gauss-Jordan inverse of the top d x d Vandermonde block, then the
// bottom rows times the inverse.  d, p <= 67.
static void build_generator(unsigned d, unsigned p, u8* gen) {
  enum { MAXD = 67 };
  static thread_local u8 a[MAXD][2 * MAXD];   // [V_top | I] augmented
  static thread_local u8 vb[2 * MAXD][MAXD];  // bottom rows of V
  unsigned n = d + p;
  for (unsigned i = 0; i < d; i++) {
    for (unsigned j = 0; j < d; j++) a[i][j] = GF.pow((u8)i, j);
    for (unsigned j = 0; j < d; j++) a[i][d + j] = (i == j);
  }
  for (unsigned i = d; i < n; i++)
    for (unsigned j = 0; j < d; j++) vb[i - d][j] = GF.pow((u8)i, j);
  // Gauss-Jordan over GF(256): the Vandermonde block is invertible
  // (distinct evaluation points), so a pivot always exists
  for (unsigned col = 0; col < d; col++) {
    unsigned piv = col;
    while (piv < d && a[piv][col] == 0) piv++;
    if (piv == d) return;  // unreachable; leaves gen zeroed on the row
    if (piv != col)
      for (unsigned j = 0; j < 2 * d; j++) {
        u8 t = a[col][j]; a[col][j] = a[piv][j]; a[piv][j] = t;
      }
    u8 pinv = GF.inv(a[col][col]);
    for (unsigned j = 0; j < 2 * d; j++) a[col][j] = GF.mul(a[col][j], pinv);
    for (unsigned r = 0; r < d; r++) {
      if (r == col || a[r][col] == 0) continue;
      u8 f = a[r][col];
      for (unsigned j = 0; j < 2 * d; j++)
        a[r][j] ^= GF.mul(f, a[col][j]);
    }
  }
  // gen = V_bottom * inv
  for (unsigned r = 0; r < p; r++)
    for (unsigned c = 0; c < d; c++) {
      u8 acc = 0;
      for (unsigned k = 0; k < d; k++)
        acc ^= GF.mul(vb[r][k], a[k][d + c]);
      gen[r * d + c] = acc;
    }
}

// ---------------------------------------------------------------------------
// ed25519 over GF(2^255 - 19): 4x64-limb field, extended-coordinate
// points, fixed-base comb — the exact construction of
// ops/ref/ed25519_ref.py so compressed outputs (and therefore
// signatures) are byte-identical.

struct Fe { u64 v[4]; };  // little-endian limbs, value < 2^256

static const Fe FE_P = {{0xffffffffffffffedull, 0xffffffffffffffffull,
                         0xffffffffffffffffull, 0x7fffffffffffffffull}};

static inline void fe_set(Fe& r, u64 x) {
  r.v[0] = x; r.v[1] = r.v[2] = r.v[3] = 0;
}

static inline int fe_cmp_p(const Fe& a) {  // a >= p ?
  for (int i = 3; i >= 0; i--) {
    if (a.v[i] > FE_P.v[i]) return 1;
    if (a.v[i] < FE_P.v[i]) return -1;
  }
  return 0;  // equal
}

static inline void fe_sub_p(Fe& a) {
  u128 bw = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a.v[i] - FE_P.v[i] - (u64)bw;
    a.v[i] = (u64)t;
    bw = (t >> 64) ? 1 : 0;
  }
}

static inline void fe_canon(Fe& a) {
  while (fe_cmp_p(a) >= 0) fe_sub_p(a);
}

static inline void fe_add(Fe& r, const Fe& a, const Fe& b) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)a.v[i] + b.v[i];
    r.v[i] = (u64)c;
    c >>= 64;
  }
  while (c) {  // 2^256 == 38 (mod p)
    u128 c2 = (u128)r.v[0] + (u64)(c * 38);
    r.v[0] = (u64)c2; c2 >>= 64;
    for (int i = 1; i < 4 && c2; i++) {
      c2 += r.v[i]; r.v[i] = (u64)c2; c2 >>= 64;
    }
    c = c2;
  }
}

static inline void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  u128 bw = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a.v[i] - b.v[i] - (u64)bw;
    r.v[i] = (u64)t;
    bw = (t >> 64) ? 1 : 0;
  }
  while (bw) {  // borrowed 2^256: subtract 38 to compensate mod p
    u128 t = (u128)r.v[0] - 38;
    r.v[0] = (u64)t;
    bw = (t >> 64) ? 1 : 0;
    for (int i = 1; i < 4 && bw; i++) {
      u128 t2 = (u128)r.v[i] - 1;
      r.v[i] = (u64)t2;
      bw = (t2 >> 64) ? 1 : 0;
    }
  }
}

static void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  u64 t[8] = {0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 cur = (u128)a.v[i] * b.v[j] + t[i + j] + carry;
      t[i + j] = (u64)cur;
      carry = cur >> 64;
    }
    t[i + 4] += (u64)carry;
  }
  // fold hi*38 into lo (2^256 == 38 mod p)
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)t[i] + (u128)t[i + 4] * 38;
    r.v[i] = (u64)c;
    c >>= 64;
  }
  while (c) {
    u128 c2 = (u128)r.v[0] + (u64)(c * 38);
    r.v[0] = (u64)c2; c2 >>= 64;
    for (int i = 1; i < 4 && c2; i++) {
      c2 += r.v[i]; r.v[i] = (u64)c2; c2 >>= 64;
    }
    c = c2;
  }
}

static inline void fe_sq(Fe& r, const Fe& a) { fe_mul(r, a, a); }

// r = a^e, e a 256-bit little-endian limb exponent
static void fe_pow(Fe& r, const Fe& a, const u64 e[4]) {
  Fe base = a, acc;
  fe_set(acc, 1);
  for (int i = 0; i < 256; i++) {
    if ((e[i / 64] >> (i % 64)) & 1) fe_mul(acc, acc, base);
    fe_sq(base, base);
  }
  r = acc;
}

static void fe_inv(Fe& r, const Fe& a) {
  static const u64 PM2[4] = {0xffffffffffffffebull, 0xffffffffffffffffull,
                             0xffffffffffffffffull, 0x7fffffffffffffffull};
  fe_pow(r, a, PM2);
}

static inline bool fe_eq(const Fe& a, const Fe& b) {
  Fe x = a, y = b;
  fe_canon(x); fe_canon(y);
  return !std::memcmp(x.v, y.v, sizeof(x.v));
}

static inline bool fe_is_zero(const Fe& a) {
  Fe x = a;
  fe_canon(x);
  return !(x.v[0] | x.v[1] | x.v[2] | x.v[3]);
}

struct Pt { Fe x, y, z, t; };  // extended coordinates

static Fe ED_D;       // -121665/121666
static Fe SQRT_M1;    // 2^((p-1)/4)
static Pt ED_BASE;
static Pt ED_IDENT;
static Pt ED_COMB[64][16];
static bool ed_ready = false;

// the complete extended-coordinates addition ed25519_ref.point_add uses
static void pt_add(Pt& r, const Pt& p, const Pt& q) {
  Fe a, b, c, d, e, f, g, h, t1, t2;
  fe_sub(t1, p.y, p.x);
  fe_sub(t2, q.y, q.x);
  fe_mul(a, t1, t2);
  fe_add(t1, p.y, p.x);
  fe_add(t2, q.y, q.x);
  fe_mul(b, t1, t2);
  fe_mul(t1, p.t, q.t);
  fe_mul(t2, t1, ED_D);
  fe_add(c, t2, t2);
  fe_mul(t1, p.z, q.z);
  fe_add(d, t1, t1);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.x, e, f);
  fe_mul(r.y, g, h);
  fe_mul(r.z, f, g);
  fe_mul(r.t, e, h);
}

static void pt_compress(u8 out[32], const Pt& p) {
  Fe zi, x, y;
  fe_inv(zi, p.z);
  fe_mul(x, p.x, zi);
  fe_mul(y, p.y, zi);
  fe_canon(x);
  fe_canon(y);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (u8)(y.v[i] >> (8 * j));
  out[31] |= (u8)((x.v[0] & 1) << 7);
}

// x from y per RFC 8032 5.1.3 (init-time only: recovers the base point)
static bool recover_x(Fe& x, const Fe& y, int sign) {
  static const u64 P38[4] = {0xfffffffffffffffeull, 0xffffffffffffffffull,
                             0xffffffffffffffffull, 0x0fffffffffffffffull};
  Fe y2, num, den, one, x2, chk;
  fe_set(one, 1);
  fe_mul(y2, y, y);
  fe_sub(num, y2, one);          // y^2 - 1
  Fe dy2, deni;
  fe_mul(dy2, ED_D, y2);
  fe_add(den, dy2, one);         // d*y^2 + 1
  fe_inv(deni, den);
  fe_mul(x2, num, deni);
  if (fe_is_zero(x2)) { fe_set(x, 0); return true; }
  fe_pow(x, x2, P38);            // x2^((p+3)/8)
  fe_mul(chk, x, x);
  if (!fe_eq(chk, x2)) {
    fe_mul(x, x, SQRT_M1);
    fe_mul(chk, x, x);
    if (!fe_eq(chk, x2)) return false;
  }
  fe_canon(x);
  if ((int)(x.v[0] & 1) != sign) fe_sub(x, FE_P, x);
  return true;
}

static void ed_init() {
  if (ed_ready) return;
  // d = -121665 * inv(121666)
  Fe n121665, n121666, inv121666;
  fe_set(n121665, 121665);
  fe_sub(n121665, FE_P, n121665);  // -121665 mod p
  fe_set(n121666, 121666);
  fe_inv(inv121666, n121666);
  fe_mul(ED_D, n121665, inv121666);
  // sqrt(-1) = 2^((p-1)/4)
  static const u64 PM14[4] = {0xfffffffffffffffbull, 0xffffffffffffffffull,
                              0xffffffffffffffffull, 0x1fffffffffffffffull};
  Fe two;
  fe_set(two, 2);
  fe_pow(SQRT_M1, two, PM14);
  // base point: y = 4/5, x recovered with sign 0
  Fe four, five, inv5, by, bx;
  fe_set(four, 4);
  fe_set(five, 5);
  fe_inv(inv5, five);
  fe_mul(by, four, inv5);
  fe_canon(by);
  recover_x(bx, by, 0);
  ED_BASE.x = bx; ED_BASE.y = by;
  fe_set(ED_BASE.z, 1);
  fe_mul(ED_BASE.t, bx, by);
  fe_set(ED_IDENT.x, 0);
  fe_set(ED_IDENT.y, 1);
  fe_set(ED_IDENT.z, 1);
  fe_set(ED_IDENT.t, 0);
  // fixed-base comb: 64 windows x 16 entries (ed25519_ref._base_comb)
  Pt wb = ED_BASE;
  for (int w = 0; w < 64; w++) {
    ED_COMB[w][0] = ED_IDENT;
    for (int j = 1; j < 16; j++) pt_add(ED_COMB[w][j], ED_COMB[w][j - 1], wb);
    for (int k = 0; k < 4; k++) pt_add(wb, wb, wb);
  }
  ed_ready = true;
}

// [s]B via the comb, s a 256-bit little-endian limb scalar
static void pt_mul_base(Pt& r, const u64 s[4]) {
  r = ED_IDENT;
  for (int i = 0; i < 64; i++) {
    unsigned nib = (unsigned)((s[i / 16] >> (4 * (i % 16))) & 15);
    if (nib) pt_add(r, r, ED_COMB[i][nib]);
  }
}

// -- scalar arithmetic mod L -------------------------------------------------

static const u64 SC_L[4] = {0x5812631a5cf5d3edull, 0x14def9dea2f79cd6ull,
                            0ull, 0x1000000000000000ull};

static inline int sc_ge_l(const u64 a[4]) {
  for (int i = 3; i >= 0; i--) {
    if (a[i] > SC_L[i]) return 1;
    if (a[i] < SC_L[i]) return 0;
  }
  return 1;
}

static inline void sc_sub_l(u64 a[4]) {
  u128 bw = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a[i] - SC_L[i] - (u64)bw;
    a[i] = (u64)t;
    bw = (t >> 64) ? 1 : 0;
  }
}

// r = x mod L for a 512-bit x (binary shift-reduce: performance is
// irrelevant at one signature per FEC set; simplicity is the point)
static void sc_mod_l(u64 r[4], const u64 x[8]) {
  r[0] = r[1] = r[2] = r[3] = 0;
  for (int i = 511; i >= 0; i--) {
    // r <<= 1
    for (int j = 3; j > 0; j--) r[j] = (r[j] << 1) | (r[j - 1] >> 63);
    r[0] <<= 1;
    r[0] |= (x[i / 64] >> (i % 64)) & 1;
    if (sc_ge_l(r)) sc_sub_l(r);
  }
}

static void sc_mul_mod_l(u64 r[4], const u64 a[4], const u64 b[4]) {
  u64 t[8] = {0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 cur = (u128)a[i] * b[j] + t[i + j] + carry;
      t[i + j] = (u64)cur;
      carry = cur >> 64;
    }
    t[i + 4] += (u64)carry;
  }
  sc_mod_l(r, t);
}

static void sc_add_mod_l(u64 r[4], const u64 a[4], const u64 b[4]) {
  u128 c = 0;
  u64 t[8] = {0};
  for (int i = 0; i < 4; i++) {
    c += (u128)a[i] + b[i];
    t[i] = (u64)c;
    c >>= 64;
  }
  t[4] = (u64)c;
  sc_mod_l(r, t);
}

static inline void sc_from_le64(u64 r[8], const u8 b[64]) {
  for (int i = 0; i < 8; i++) {
    u64 v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | b[8 * i + j];
    r[i] = v;
  }
}

static inline void sc_from_le32(u64 r[4], const u8 b[32]) {
  for (int i = 0; i < 4; i++) {
    u64 v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | b[8 * i + j];
    r[i] = v;
  }
}

struct Signer {
  u64 a[4];       // clamped secret scalar (little-endian limbs)
  u8 prefix[32];  // SHA512(secret)[32:]
  u8 apk[32];     // compressed public key
};

// RFC 8032 sign with a pre-expanded key — byte-identical to
// ed25519_ref.sign(secret, msg) for the same expansion.
static void ed_sign(u8 sig[64], const Signer& s, const u8* msg, u64 msg_len) {
  u8 h[64];
  u64 h8[8], r[4], k[4], ka[4], ss[4];
  Sha512 hr;
  hr.update(s.prefix, 32);
  hr.update(msg, msg_len);
  hr.final(h);
  sc_from_le64(h8, h);
  sc_mod_l(r, h8);
  Pt R;
  pt_mul_base(R, r);
  pt_compress(sig, R);  // sig[0:32] = R
  Sha512 hk;
  hk.update(sig, 32);
  hk.update(s.apk, 32);
  hk.update(msg, msg_len);
  hk.final(h);
  sc_from_le64(h8, h);
  sc_mod_l(k, h8);
  sc_mul_mod_l(ka, k, s.a);
  sc_add_mod_l(ss, r, ka);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) sig[32 + 8 * i + j] = (u8)(ss[i] >> (8 * j));
}

// ---------------------------------------------------------------------------
// Shredder — behavioral mirror of runtime/shredder.py (which mirrors
// fd_shredder.c).  All layout numbers are the protocol constants of
// protocol/shred.py.

enum {
  NORMAL_FEC_SET_PAYLOAD_SZ = 31840,
  NORMAL_DATA_CNT = 32,
  SHRED_MIN_SZ = 1203,   // merkle data shred wire size
  SHRED_MAX_SZ = 1228,   // merkle coding shred wire size
  SIGNATURE_SZ = 64,
  DATA_HEADER_SZ = 0x58,
  CODE_HEADER_SZ = 0x59,
  NODE_SZ = 20,
  DATA_FLAG_SLOT_COMPLETE = 0x80,
  DATA_FLAG_DATA_COMPLETE = 0x40,
  DATA_REF_TICK_MASK = 0x3F,
  MAX_D = 67,
};

static const u8 DATA_TO_PARITY[33] = {
    0,  17, 18, 19, 19, 20, 21, 21, 22, 23, 23, 24, 24, 25, 25, 26, 26,
    26, 27, 27, 28, 28, 29, 29, 29, 30, 30, 31, 31, 31, 32, 32, 32,
};

static inline unsigned parity_cnt_for(unsigned d) {
  return d <= 32 ? DATA_TO_PARITY[d] : d;
}

static inline unsigned odd_set_payload_per_shred(u64 remaining) {
  if (remaining <= 9135) return 1015;
  if (remaining <= 31840) return 995;
  if (remaining <= 62400) return 975;
  return 955;
}

static inline unsigned bm_depth(unsigned leaf_cnt) {
  if (leaf_cnt <= 1) return leaf_cnt;
  unsigned d = 1;
  while ((1u << (d - 1)) < leaf_cnt) d++;
  return d;
}

static const u8 LEAF_PREFIX[] = {0,   'S', 'O', 'L', 'A', 'N', 'A', '_', 'M',
                                 'E', 'R', 'K', 'L', 'E', '_', 'S', 'H', 'R',
                                 'E', 'D', 'S', '_', 'L', 'E', 'A', 'F'};
static const u8 NODE_PREFIX[] = {1,   'S', 'O', 'L', 'A', 'N', 'A', '_', 'M',
                                 'E', 'R', 'K', 'L', 'E', '_', 'S', 'H', 'R',
                                 'E', 'D', 'S', '_', 'N', 'O', 'D', 'E'};

static inline void put_le(u8* p, u64 v, int n) {
  for (int i = 0; i < n; i++) p[i] = (u8)(v >> (8 * i));
}

// the parity call (see the header): 0 = ok, else an error code
typedef int (*parity_encode_t)(void* user, const u8* gen, const u8* data,
                               u64 d, u64 p, u64 sz, u8* out);

// fds_shred_batch's parity failure (the capacity failure is -1)
constexpr i64 FDS_ERR_PARITY = -2;

struct ShredCtx {
  u16 version;       // shred_version in the common header
  Signer signer;
  parity_encode_t rs_encode;
  void* rs_user;     // the parity call's first argument
  int rs_err;        // the last parity call's nonzero code (0 = none)
  // generator submatrices, built lazily per d (gen[d] is p x d bytes)
  u8* gens[MAX_D + 1];
  // scratch: one FEC set's RS input/output matrices + merkle nodes
  // (all tree layers flattened: sum over ceil-halving layers of n<=134
  // leaves is bounded by 2n + log2(n) < 288 nodes)
  u8 rs_data[MAX_D * 1139];
  u8 rs_par[MAX_D * 1139];
  u8 nodes[288][NODE_SZ];
};

static const u8* ctx_gen(ShredCtx* c, unsigned d, unsigned p) {
  if (!c->gens[d]) {
    u8* g = (u8*)std::malloc(p * d);
    if (!g) return nullptr;
    build_generator(d, p, g);
    c->gens[d] = g;
  }
  return c->gens[d];
}

struct SetPlan {
  u64 offset, chunk;
  unsigned d, p, depth, region;
  u64 dbase, pbase;
};

// one FEC set: frame data shreds, RS parity, merkle, sign, proofs.
// Shreds are written wire-complete into `out` (d x 1203 then p x 1228).
// Returns bytes written (0 on a failed generator allocation or parity
// call: c->rs_err then holds the call's code), and the 32-byte root in
// root_out.
static u64 shred_one_set(ShredCtx* c, const u8* batch, u64 total,
                         const SetPlan& pl, u64 slot, unsigned parent_off,
                         unsigned ref_tick, int last_set, int block_complete,
                         u8* out, u8 root_out[32]) {
  unsigned d = pl.d, p = pl.p, depth = pl.depth;
  unsigned elt_sz = pl.region + (DATA_HEADER_SZ - 0x40);  // code_payload_sz
  u64 off = pl.offset;
  u64 end = pl.offset + pl.chunk;
  u8* dshred = out;
  // -- data shreds ----------------------------------------------------------
  for (unsigned i = 0; i < d; i++) {
    u8* buf = dshred + (u64)i * SHRED_MIN_SZ;
    std::memset(buf, 0, SHRED_MIN_SZ);
    u64 take = pl.region;
    if (off + take > end) take = end - off;
    unsigned flags = ref_tick & DATA_REF_TICK_MASK;
    if (last_set && i == d - 1) {
      flags |= DATA_FLAG_DATA_COMPLETE;
      if (block_complete) flags |= DATA_FLAG_SLOT_COMPLETE;
    }
    buf[64] = (u8)(0x80 | depth);              // variant
    put_le(buf + 65, slot, 8);
    put_le(buf + 73, pl.dbase + i, 4);         // idx
    put_le(buf + 77, c->version, 2);
    put_le(buf + 79, pl.dbase, 4);             // fec_set_idx
    put_le(buf + 83, parent_off, 2);
    buf[85] = (u8)flags;
    put_le(buf + 86, DATA_HEADER_SZ + take, 2);  // size
    std::memcpy(buf + DATA_HEADER_SZ, batch + off, take);
    off += take;
    // RS element: [64, 64+elt_sz) of the (zero-padded) shred
    std::memcpy(c->rs_data + (u64)i * elt_sz, buf + SIGNATURE_SZ, elt_sz);
  }
  (void)total;
  // -- parity ---------------------------------------------------------------
  const u8* gen = ctx_gen(c, d, p);
  if (!gen) return 0;
  int prc = c->rs_encode(c->rs_user, gen, c->rs_data, d, p, elt_sz, c->rs_par);
  if (prc) {
    c->rs_err = prc;
    return 0;
  }
  u8* cshred = dshred + (u64)d * SHRED_MIN_SZ;
  for (unsigned j = 0; j < p; j++) {
    u8* buf = cshred + (u64)j * SHRED_MAX_SZ;
    std::memset(buf, 0, SHRED_MAX_SZ);
    buf[64] = (u8)(0x40 | depth);
    put_le(buf + 65, slot, 8);
    put_le(buf + 73, pl.pbase + j, 4);
    put_le(buf + 77, c->version, 2);
    put_le(buf + 79, pl.dbase, 4);
    put_le(buf + 83, d, 2);
    put_le(buf + 85, p, 2);
    put_le(buf + 87, j, 2);
    std::memcpy(buf + CODE_HEADER_SZ, c->rs_par + (u64)j * elt_sz, elt_sz);
  }
  // -- merkle tree ----------------------------------------------------------
  unsigned n = d + p;
  unsigned data_moff = SHRED_MIN_SZ - depth * NODE_SZ;
  unsigned code_moff = SHRED_MAX_SZ - depth * NODE_SZ;
  // leaves: sha256(LEAF_PREFIX || shred[64:merkle_off]); keep the full
  // 32 bytes of leaf 0-only case aside — n >= 18 always here, so the
  // root is a node merge
  u8 (*layer)[NODE_SZ] = c->nodes;
  u8 full[32];
  for (unsigned i = 0; i < n; i++) {
    const u8* buf; unsigned moff;
    if (i < d) { buf = dshred + (u64)i * SHRED_MIN_SZ; moff = data_moff; }
    else { buf = cshred + (u64)(i - d) * SHRED_MAX_SZ; moff = code_moff; }
    Sha256 h;
    h.update(LEAF_PREFIX, sizeof(LEAF_PREFIX));
    h.update(buf + SIGNATURE_SZ, moff - SIGNATURE_SZ);
    h.final(full);
    std::memcpy(layer[i], full, NODE_SZ);
  }
  // layers bottom-up, 20-byte truncated nodes; record layer offsets so
  // proofs read directly from the flat node array
  unsigned layer_off[16];
  unsigned layer_len[16];
  unsigned n_layers = 0;
  unsigned cur_off = 0, cur_len = n;
  layer_off[0] = 0; layer_len[0] = n; n_layers = 1;
  while (cur_len > 1) {
    unsigned nxt_off = cur_off + cur_len;
    unsigned k = (cur_len + 1) / 2;
    for (unsigned i = 0; i < k; i++) {
      const u8* a = c->nodes[cur_off + 2 * i];
      const u8* b = (2 * i + 1 < cur_len) ? c->nodes[cur_off + 2 * i + 1] : a;
      Sha256 h;
      h.update(NODE_PREFIX, sizeof(NODE_PREFIX));
      h.update(a, NODE_SZ);
      h.update(b, NODE_SZ);
      h.final(full);
      std::memcpy(c->nodes[nxt_off + i], full, NODE_SZ);
      if (k == 1) std::memcpy(root_out, full, 32);  // untruncated root
    }
    cur_off = nxt_off;
    cur_len = k;
    layer_off[n_layers] = cur_off;
    layer_len[n_layers] = cur_len;
    n_layers++;
  }
  // -- sign + write signature & proofs into every shred ---------------------
  u8 sig[64];
  ed_sign(sig, c->signer, root_out, 32);
  for (unsigned i = 0; i < n; i++) {
    u8* buf; unsigned moff;
    if (i < d) { buf = dshred + (u64)i * SHRED_MIN_SZ; moff = data_moff; }
    else { buf = cshred + (u64)(i - d) * SHRED_MAX_SZ; moff = code_moff; }
    std::memcpy(buf, sig, 64);
    unsigned idx = i;
    for (unsigned lv = 0; lv + 1 < n_layers; lv++) {
      unsigned sib = idx ^ 1;
      const u8* node = (sib < layer_len[lv]) ? c->nodes[layer_off[lv] + sib]
                                             : c->nodes[layer_off[lv] + idx];
      std::memcpy(buf + moff + lv * NODE_SZ, node, NODE_SZ);
      idx >>= 1;
    }
  }
  return (u64)d * SHRED_MIN_SZ + (u64)p * SHRED_MAX_SZ;
}

// plan an entry batch into FEC sets (the reference chunking rule);
// returns set count (<= max_sets) or -1 if it would overflow
static i64 plan_batch(u64 total, i64 data_base, i64 parity_base, SetPlan* plans,
                      u64 max_sets) {
  u64 offset = 0;
  u64 nsets = 0;
  while (offset < total) {
    u64 remaining = total - offset;
    u64 chunk = (remaining >= 2ull * NORMAL_FEC_SET_PAYLOAD_SZ)
                    ? (u64)NORMAL_FEC_SET_PAYLOAD_SZ
                    : remaining;
    if (nsets >= max_sets) return -1;
    SetPlan& pl = plans[nsets];
    pl.offset = offset;
    pl.chunk = chunk;
    unsigned per = odd_set_payload_per_shred(chunk);
    unsigned d = (unsigned)((chunk + per - 1) / per);
    if (d < 1) d = 1;
    unsigned p = parity_cnt_for(d);
    pl.d = d;
    pl.p = p;
    pl.depth = bm_depth(d + p) - 1;
    pl.region = 1115 - NODE_SZ * pl.depth;
    pl.dbase = (u64)data_base;
    pl.pbase = (u64)parity_base;
    data_base += d;
    parity_base += p;
    offset += chunk;
    nsets++;
  }
  return (i64)nsets;
}

}  // namespace

extern "C" {

// ctx lifecycle: version + expanded signing key (a scalar LE32, prefix,
// compressed pubkey) + the parity function pointer and its user argument.
void* fds_ctx_new(unsigned version, const u8 a_le32[32], const u8 prefix[32],
                  const u8 apk[32], void* rs_encode_fn, void* rs_user) {
  if (!rs_encode_fn) return nullptr;
  ed_init();
  ShredCtx* c = (ShredCtx*)std::calloc(1, sizeof(ShredCtx));
  if (!c) return nullptr;
  c->version = (u16)version;
  sc_from_le32(c->signer.a, a_le32);
  std::memcpy(c->signer.prefix, prefix, 32);
  std::memcpy(c->signer.apk, apk, 32);
  c->rs_encode = (parity_encode_t)rs_encode_fn;
  c->rs_user = rs_user;
  return c;
}

void fds_ctx_delete(void* ctx) {
  ShredCtx* c = (ShredCtx*)ctx;
  if (!c) return;
  for (unsigned d = 0; d <= MAX_D; d++)
    if (c->gens[d]) std::free(c->gens[d]);
  std::free(c);
}

// Shred a whole entry batch in ONE crossing.  Outputs:
//   out:       wire-complete shreds, per set d x 1203 then p x 1228,
//              sets back to back;
//   set_meta:  per set 4 u64 rows (d, p, fec_set_idx, out byte offset);
//   roots:     32 bytes per set (untruncated signed merkle root);
//   idx_io:    [data_idx_offset, parity_idx_offset] — read AND advanced
//              (the Shredder's slot-scoped shred index state).
// Returns set count, -1 on insufficient capacity / empty batch, or
// FDS_ERR_PARITY (-2) when a parity call failed (fds_parity_error gives
// its code); on either failure idx_io is left as it was.
i64 fds_shred_batch(void* ctx, const u8* batch, u64 sz, u64 slot,
                    unsigned parent_off, unsigned ref_tick, int block_complete,
                    i64* idx_io, u8* out, u64 out_cap, u64* set_meta,
                    u64 max_sets, u8* roots) {
  ShredCtx* c = (ShredCtx*)ctx;
  if (!c || !sz) return -1;
  // plans live on the stack for the common case; a deferred-flush
  // mega-batch (max_sets tracks the caller's meta/roots capacity) heap
  // allocates rather than capping — the Python lane has no batch-size
  // ceiling, so this lane must not invent one
  SetPlan stack_plans[256];
  SetPlan* plans = stack_plans;
  if (max_sets > 256) {
    plans = (SetPlan*)std::malloc(max_sets * sizeof(SetPlan));
    if (!plans) return -1;
  }
  i64 rc = -1;
  c->rs_err = 0;
  i64 nsets = plan_batch(sz, idx_io[0], idx_io[1], plans, max_sets);
  if (nsets > 0) {
    u64 off = 0;
    i64 s = 0;
    for (; s < nsets; s++) {
      const SetPlan& pl = plans[s];
      u64 need = (u64)pl.d * SHRED_MIN_SZ + (u64)pl.p * SHRED_MAX_SZ;
      if (off + need > out_cap) break;
      u64 wrote = shred_one_set(c, batch, sz, pl, slot, parent_off, ref_tick,
                                s == nsets - 1, block_complete, out + off,
                                roots + 32 * s);
      if (!wrote) break;
      set_meta[4 * s + 0] = pl.d;
      set_meta[4 * s + 1] = pl.p;
      set_meta[4 * s + 2] = pl.dbase;
      set_meta[4 * s + 3] = off;
      off += wrote;
    }
    if (s == nsets) {
      idx_io[0] = (i64)(plans[nsets - 1].dbase + plans[nsets - 1].d);
      idx_io[1] = (i64)(plans[nsets - 1].pbase + plans[nsets - 1].p);
      rc = nsets;
    } else if (c->rs_err) {
      rc = FDS_ERR_PARITY;
    }
  }
  if (plans != stack_plans) std::free(plans);
  return rc;
}

// the code of the parity call that failed the last fds_shred_batch (0 =
// none failed)
int fds_parity_error(void* ctx) { return ((ShredCtx*)ctx)->rs_err; }

// ---------------------------------------------------------------------------
// Sweep-harness stage client (runtime/stage.py fdr_sweep): the whole
// shred stage hot path — entry accumulation, batch close, shred,
// publish — with zero Python per frag.  Ring operations go through
// the port's fd_ring function pointers (the fd_pack/fd_tcache precedent:
// the protocol logic stays in exactly one native module).

typedef int (*fdr_try_publish_t)(const void* link, void* prod,
                                 const u8* payload, u64 sz, u64 sig,
                                 u64 tsorig);
typedef u64 (*fdr_refresh_credits_t)(const void* link, void* prod);

struct ShredStageCtx {
  ShredCtx* sh;
  // out ring (opaque structs owned by tango/native.py's NativeProducer)
  const void* out_link;
  void* out_prod;
  fdr_try_publish_t publish;
  fdr_refresh_credits_t refresh;
  // stage parameters (mirrors runtime/shred_stage.ShredStage)
  u64 slot;
  unsigned parent_off;
  unsigned ref_tick;
  u64 batch_target;
  u64 min_credits;  // _room(): don't start shredding into a full ring
  // entry-batch accumulator
  u8* buf;
  u64 buf_sz, buf_cap;
  u64 tsorig_min;
  i64 idx[2];  // [data_idx_offset, parity_idx_offset]
  // shred output arena
  u8* arena;
  u64 arena_cap;
  u64 pending_bc;     // block_complete of a deferred flush (retry keeps it)
  // shm metrics plane (fds_stage_set_metrics; null = dark): the shred
  // burst and its publish loop attribute apply/publish phases into the
  // sweep crossing's decomposition
  fdm_plane* mplane;
  // flags + counters Python reads off the struct (no FFI)
  u64 pending_flush;  // batch closed for size but deferred for credits
  u64 entries_in, entry_batches, fec_sets;
  u64 data_out, parity_out, frags_out, backpressure;
  u64 batches_dropped;  // batch outgrew the 256-set plan bound (8MB+)
  // the code of a failed parity call (0 = none): the batch is lost and
  // counted nowhere else; Python raises once it reads this word
  u64 fault;
};

void* fds_stage_new(void* shred_ctx, const void* out_link, void* out_prod,
                    void* publish_fn, void* refresh_fn, u64 slot,
                    unsigned parent_off, unsigned ref_tick, u64 batch_target,
                    u64 min_credits) {
  ShredStageCtx* st = (ShredStageCtx*)std::calloc(1, sizeof(ShredStageCtx));
  if (!st) return nullptr;
  st->sh = (ShredCtx*)shred_ctx;
  st->out_link = out_link;
  st->out_prod = out_prod;
  st->publish = (fdr_try_publish_t)publish_fn;
  st->refresh = (fdr_refresh_credits_t)refresh_fn;
  st->slot = slot;
  st->parent_off = parent_off;
  st->ref_tick = ref_tick;
  st->batch_target = batch_target;
  st->min_credits = min_credits;
  st->buf_cap = 1 << 17;
  st->buf = (u8*)std::malloc(st->buf_cap);
  // an entry batch closes at batch_target but the last entry can
  // overshoot; 3 normal sets is a generous bound for the burst arena
  st->arena_cap = 4ull * (NORMAL_DATA_CNT * (SHRED_MIN_SZ + SHRED_MAX_SZ) + (MAX_D * (SHRED_MIN_SZ + SHRED_MAX_SZ)));
  st->arena = (u8*)std::malloc(st->arena_cap);
  if (!st->buf || !st->arena) {
    std::free(st->buf);
    std::free(st->arena);
    std::free(st);
    return nullptr;
  }
  return st;
}

// offsetof(pending_flush): Python reads the flag+counter tail of the
// struct through a zero-FFI memory view — this export pins the layout
// so the view can never silently drift from the C struct.
u64 fds_stage_flags_off(void) {
  return (u64)__builtin_offsetof(ShredStageCtx, pending_flush);
}

void fds_stage_delete(void* p) {
  ShredStageCtx* st = (ShredStageCtx*)p;
  if (!st) return;
  std::free(st->buf);
  std::free(st->arena);
  std::free(st);
}

// Arm/disarm the shm metrics plane: the SAME fdm_plane the stage's
// SweepDrainer passes fdr_sweep, so the apply/publish accums bracketed in
// stage_flush fold into that crossing's decomposition
// (runtime/shred_native.StageClient.set_metrics; null disarms).
void fds_stage_set_metrics(void* p, fdm_plane* plane) {
  ((ShredStageCtx*)p)->mplane = plane;
}

void fds_stage_set_slot(void* p, u64 slot) {
  ShredStageCtx* st = (ShredStageCtx*)p;
  if (st->slot != slot) {  // Shredder's slot-scoped index reset
    st->idx[0] = st->idx[1] = 0;
    st->slot = slot;
  }
}

// shred + publish the accumulated batch.  Returns 1 on success, 0 when
// deferred (credits below min_credits AND !force — pending_flush stays
// set and the stage retries from after_credit).  An EXPLICIT flush
// (ShredStage.flush, the slot-end path) forces: the Python lane's
// flush() never credit-defers, so buffered entries must not survive
// into the next slot's batch here either — frames past credit
// exhaustion count as backpressure and are DROPPED set-whole (the
// Python lane's publish_burst_out contract is per-frame; the _room()
// pre-gate makes the mid-set case rare, and shreds are erasure-coded
// by design).
static int stage_flush(ShredStageCtx* st, int block_complete, int force) {
  // block_complete < 0 = "retry a deferred flush with its original
  // flag" (the after_credit path must not downgrade a pending flush)
  if (block_complete < 0) block_complete = (int)st->pending_bc;
  if (!st->buf_sz) { st->pending_flush = 0; return 1; }
  u64 cr = st->refresh(st->out_link, st->out_prod);
  if (!force && cr < st->min_credits) {
    st->pending_flush = 1;
    st->pending_bc = (u64)block_complete;
    return 0;
  }
  // a deferred flush can accumulate multiple sets: size the arena to
  // the worst-case per-set wire footprint before shredding
  u64 nsets_bound = st->buf_sz / NORMAL_FEC_SET_PAYLOAD_SZ + 2;
  u64 need = nsets_bound * (u64)MAX_D * (SHRED_MIN_SZ + SHRED_MAX_SZ);
  if (need > st->arena_cap) {
    u8* na = (u8*)std::realloc(st->arena, need);
    if (na) {
      st->arena = na;
      st->arena_cap = need;
    }
  }
  u64 sm_stack[4 * 256];
  u8 sr_stack[32 * 256];
  u64* set_meta = sm_stack;
  u8* sroots = sr_stack;
  u8* heap_blk = nullptr;
  u64 max_sets = nsets_bound;
  if (max_sets > 256) {
    // deferred-flush mega-batch: size the meta/roots tables to the
    // bound instead of capping at 256 (which used to drop the batch)
    heap_blk = (u8*)std::malloc(max_sets * (4 * sizeof(u64) + 32));
    if (heap_blk) {
      set_meta = (u64*)heap_blk;
      sroots = heap_blk + max_sets * 4 * sizeof(u64);
    } else {
      max_sets = 256;  // OOM fallback: may drop, counted below
    }
  }
  u64 t_apply = st->mplane ? fdm_now_ns() : 0;
  i64 nsets = fds_shred_batch(st->sh, st->buf, st->buf_sz, st->slot,
                              st->parent_off, st->ref_tick, block_complete,
                              st->idx, st->arena, st->arena_cap, set_meta,
                              max_sets, sroots);
  // the shred/encode burst is the stage's apply phase; the wire loop
  // below is its publish phase (fdm_sweep_end nets both out of cb)
  if (st->mplane)
    fdm_accum(st->mplane, FDM_PH_APPLY, fdm_now_ns() - t_apply);
  u64 tsorig = st->tsorig_min;
  st->buf_sz = 0;
  st->tsorig_min = 0;
  st->pending_flush = 0;
  if (nsets == FDS_ERR_PARITY) {  // a failed parity call: a fault, not a drop
    st->fault = (u64)(unsigned)st->sh->rs_err;
    if (heap_blk) std::free(heap_blk);
    return 1;
  }
  if (nsets < 0) {  // arena bound / OOM fallback: dropped, counted
    st->batches_dropped++;
    if (heap_blk) std::free(heap_blk);
    return 1;
  }
  st->entry_batches++;
  u64 t_pub = st->mplane ? fdm_now_ns() : 0;
  for (i64 s = 0; s < nsets; s++) {
    u64 d = set_meta[4 * s + 0];
    u64 pcnt = set_meta[4 * s + 1];
    u64 fec_idx = set_meta[4 * s + 2];
    const u8* base = st->arena + set_meta[4 * s + 3];
    st->fec_sets++;
    u64 done = 0;
    for (u64 i = 0; i < d; i++)
      done += (u64)st->publish(st->out_link, st->out_prod,
                               base + i * SHRED_MIN_SZ, SHRED_MIN_SZ, fec_idx,
                               tsorig);
    const u8* cbase = base + d * SHRED_MIN_SZ;
    for (u64 j = 0; j < pcnt; j++)
      done += (u64)st->publish(st->out_link, st->out_prod,
                               cbase + j * SHRED_MAX_SZ, SHRED_MAX_SZ, fec_idx,
                               tsorig);
    st->data_out += d;
    st->parity_out += pcnt;
    st->frags_out += done;
    st->backpressure += (d + pcnt) - done;
  }
  if (st->mplane)
    fdm_accum(st->mplane, FDM_PH_PUBLISH, fdm_now_ns() - t_pub);
  if (heap_blk) std::free(heap_blk);
  return 1;
}

// append one entry frag (4-byte LE length framing, shred_stage parity)
static void stage_append(ShredStageCtx* st, const u8* payload, u64 sz,
                         u64 tsorig) {
  u64 need = st->buf_sz + 4 + sz;
  if (need > st->buf_cap) {
    u64 cap = st->buf_cap;
    while (cap < need) cap *= 2;
    u8* nb = (u8*)std::realloc(st->buf, cap);
    if (!nb) return;  // OOM: drop the entry (counts stay honest below)
    st->buf = nb;
    st->buf_cap = cap;
  }
  put_le(st->buf + st->buf_sz, sz, 4);
  std::memcpy(st->buf + st->buf_sz + 4, payload, sz);
  st->buf_sz += 4 + sz;
  if (tsorig && (!st->tsorig_min || tsorig < st->tsorig_min))
    st->tsorig_min = tsorig;
  st->entries_in++;
  // size-triggered close: credit-gated (deferral is harmless here), and
  // a flush already pending keeps ITS flag — a clobber to 0 would drop
  // a deferred slot-end's block_complete on the wire
  if (st->buf_sz >= st->batch_target)
    stage_flush(st, st->pending_flush ? -1 : 0, 0);
}

// the fdr_sweep frag callback (meta8 = one drain-table row: seq, sig,
// arena off, sz, ctl, tsorig, tspub, in_idx)
int fds_frag_cb(void* ctx, const u64* meta8, const u8* payload) {
  ShredStageCtx* st = (ShredStageCtx*)ctx;
  stage_append(st, payload, meta8[3], meta8[5]);
  return 0;
}

// per-frag fallback entry (mixed-lane/lossy path: Python's after_frag
// forwards into the SAME C-side buffer, so the two paths never diverge)
void fds_stage_append(void* ctx, const u8* payload, u64 sz, u64 tsorig) {
  stage_append((ShredStageCtx*)ctx, payload, sz, tsorig);
}

// flush entry point for Python (after_credit retry / slot-end flush)
int fds_stage_flush(void* ctx, int block_complete) {
  // bc >= 0 is an explicit ShredStage.flush: unconditional, Python-lane
  // parity (slot-end entries never linger into the next slot).  bc < 0
  // is the after_credit retry of a size-deferred close: stays gated.
  return stage_flush((ShredStageCtx*)ctx, block_complete,
                     block_complete >= 0);
}

}  // extern "C"
