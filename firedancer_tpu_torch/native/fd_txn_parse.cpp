// Native transaction parser: wire bytes -> packed descriptor.
//
// The verify stage parses EVERY ingress packet, making this the other
// per-frag host hot path next to the ring (the reference's fd_txn_parse
// is C for the same reason).  Validation rules mirror the port's
// protocol/txn.py (the python parser is the differential ground truth,
// tests/test_torch_txn_native.py), and the output is exactly txn_pack's
// packed layout — 17-byte header, 9 bytes per instruction, 10 bytes per
// lookup table — so python-side txn_unpack consumes it directly: one
// descriptor format across both runtimes.
//
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t TXN_MTU = 1232;
constexpr int SIG_SZ = 64;
constexpr int ACCT_SZ = 32;
constexpr int BLOCKHASH_SZ = 32;
constexpr int SIG_MAX = 127;
constexpr int ACCT_MAX = 128;
constexpr int LUT_MAX = 127;
constexpr int INSTR_MAX = 64;
constexpr uint8_t VLEGACY = 0xFF;

struct cursor {
  const uint8_t* p;
  uint64_t n;
  uint64_t i;
  bool left(uint64_t k) const { return i + k <= n; }
};

// compact-u16: minimal-encoding rule identical to compact_u16_decode
int cu16(cursor& c, uint32_t* out) {
  if (!c.left(1)) return -1;
  uint32_t b0 = c.p[c.i];
  if (b0 < 0x80) {
    c.i += 1;
    *out = b0;
    return 0;
  }
  if (!c.left(2)) return -1;
  uint32_t b1 = c.p[c.i + 1];
  if (b1 < 0x80) {
    if (b1 == 0) return -1;  // non-minimal
    c.i += 2;
    *out = (b0 & 0x7F) | (b1 << 7);
    return 0;
  }
  if (!c.left(3)) return -1;
  uint32_t b2 = c.p[c.i + 2];
  if (b2 == 0 || b2 > 0x03) return -1;  // non-minimal / >16 bits
  c.i += 3;
  *out = (b0 & 0x7F) | ((b1 & 0x7F) << 7) | (b2 << 14);
  return 0;
}

struct writer {
  uint8_t* p;
  uint64_t cap;
  uint64_t i;
  bool put8(uint32_t v) {
    if (i + 1 > cap) return false;
    p[i++] = (uint8_t)v;
    return true;
  }
  bool put16(uint32_t v) {
    if (i + 2 > cap) return false;
    p[i++] = (uint8_t)v;
    p[i++] = (uint8_t)(v >> 8);
    return true;
  }
};

}  // namespace

extern "C" {

// Parse `payload[0..sz)`; on success write the packed descriptor into
// out (capacity out_cap) and return its length.  Returns -1 on any
// malformed input, -2 if out_cap is too small.
int64_t fd_txn_parse(const uint8_t* payload, uint64_t sz, uint8_t* out,
                     uint64_t out_cap) {
  if (sz > TXN_MTU) return -1;
  cursor c{payload, sz, 0};

  if (!c.left(1)) return -1;
  uint32_t sig_cnt = c.p[c.i++];
  if (sig_cnt < 1 || sig_cnt > SIG_MAX) return -1;
  if (!c.left((uint64_t)SIG_SZ * sig_cnt)) return -1;
  uint64_t sig_off = c.i;
  c.i += (uint64_t)SIG_SZ * sig_cnt;

  uint64_t msg_off = c.i;
  if (!c.left(1)) return -1;
  uint32_t hdr0 = c.p[c.i++];
  uint32_t version;
  if (hdr0 & 0x80) {
    version = hdr0 & 0x7F;
    if (version != 0) return -1;  // only v0
    if (!c.left(1) || c.p[c.i] != sig_cnt) return -1;
    c.i += 1;
  } else {
    version = VLEGACY;
    if (sig_cnt != hdr0) return -1;
  }

  if (!c.left(2)) return -1;
  uint32_t ro_signed = c.p[c.i++];
  if (ro_signed >= sig_cnt) return -1;
  uint32_t ro_unsigned = c.p[c.i++];

  uint32_t acct_cnt;
  if (cu16(c, &acct_cnt)) return -1;
  if (acct_cnt < sig_cnt || acct_cnt > ACCT_MAX) return -1;
  if (sig_cnt + ro_unsigned > acct_cnt) return -1;
  if (!c.left((uint64_t)ACCT_SZ * acct_cnt)) return -1;
  uint64_t acct_off = c.i;
  c.i += (uint64_t)ACCT_SZ * acct_cnt;
  if (!c.left(BLOCKHASH_SZ)) return -1;
  uint64_t bh_off = c.i;
  c.i += BLOCKHASH_SZ;

  uint32_t instr_cnt;
  if (cu16(c, &instr_cnt)) return -1;
  if (instr_cnt > INSTR_MAX) return -1;
  if (!c.left(3ull * instr_cnt)) return -1;
  if (instr_cnt && acct_cnt <= 1) return -1;

  struct instr_rec {
    uint32_t prog, acct_cnt, data_sz, acct_off, data_off;
  } instrs[INSTR_MAX];
  uint32_t max_acct = 0;
  for (uint32_t k = 0; k < instr_cnt; k++) {
    if (!c.left(1)) return -1;
    uint32_t prog = c.p[c.i++];
    uint32_t icnt;
    if (cu16(c, &icnt)) return -1;
    if (!c.left(icnt)) return -1;
    uint32_t ioff = (uint32_t)c.i;
    for (uint32_t j = 0; j < icnt; j++)
      if (c.p[c.i + j] > max_acct) max_acct = c.p[c.i + j];
    c.i += icnt;
    uint32_t dsz;
    if (cu16(c, &dsz)) return -1;
    if (!c.left(dsz)) return -1;
    uint32_t doff = (uint32_t)c.i;
    c.i += dsz;
    if (!(prog > 0 && prog < acct_cnt)) return -1;
    instrs[k] = {prog, icnt, dsz, ioff, doff};
  }

  struct lut_rec {
    uint32_t addr_off, wcnt, rcnt, woff, roff;
  } luts[LUT_MAX];
  uint32_t lut_cnt = 0, adtl_w = 0, adtl = 0;
  if (version == 0) {
    if (cu16(c, &lut_cnt)) return -1;
    if (lut_cnt > LUT_MAX) return -1;
    if (!c.left(34ull * lut_cnt)) return -1;
    for (uint32_t k = 0; k < lut_cnt; k++) {
      if (!c.left(ACCT_SZ)) return -1;
      uint32_t aoff = (uint32_t)c.i;
      c.i += ACCT_SZ;
      uint32_t wcnt;
      if (cu16(c, &wcnt)) return -1;
      if (!c.left(wcnt)) return -1;
      uint32_t woff = (uint32_t)c.i;
      c.i += wcnt;
      uint32_t rcnt;
      if (cu16(c, &rcnt)) return -1;
      if (!c.left(rcnt)) return -1;
      uint32_t roff = (uint32_t)c.i;
      c.i += rcnt;
      if (wcnt > (uint32_t)(ACCT_MAX - acct_cnt)) return -1;
      if (rcnt > (uint32_t)(ACCT_MAX - acct_cnt)) return -1;
      if (wcnt + rcnt < 1) return -1;
      luts[k] = {aoff, wcnt, rcnt, woff, roff};
      adtl_w += wcnt;
      adtl += wcnt + rcnt;
    }
  }

  if (c.i != sz) return -1;  // no trailing bytes
  if (acct_cnt + adtl > ACCT_MAX) return -1;
  if (instr_cnt && max_acct >= acct_cnt + adtl) return -1;

  // emit the packed descriptor (protocol/txn.py txn_pack layout)
  writer w{out, out_cap, 0};
  bool ok = w.put8(version) && w.put8(sig_cnt) && w.put16((uint32_t)sig_off) &&
            w.put16((uint32_t)msg_off) && w.put8(ro_signed) &&
            w.put8(ro_unsigned) && w.put8(acct_cnt) &&
            w.put16((uint32_t)acct_off) && w.put16((uint32_t)bh_off) &&
            w.put8(lut_cnt) && w.put8(adtl_w) && w.put8(adtl) &&
            w.put8(instr_cnt);
  for (uint32_t k = 0; ok && k < instr_cnt; k++)
    ok = w.put8(instrs[k].prog) && w.put16(instrs[k].acct_cnt) &&
         w.put16(instrs[k].data_sz) && w.put16(instrs[k].acct_off) &&
         w.put16(instrs[k].data_off);
  for (uint32_t k = 0; ok && k < lut_cnt; k++)
    ok = w.put16(luts[k].addr_off) && w.put16(luts[k].wcnt) &&
         w.put16(luts[k].rcnt) && w.put16(luts[k].woff) &&
         w.put16(luts[k].roff);
  if (!ok) return -2;
  return (int64_t)w.i;
}

// Burst parse over a drained sweep (the verify stage's ring drain):
// rows are (byte offset, size) u64 pairs into `buf` — the drain table's
// chunk/sz columns verbatim — and every payload parses in ONE crossing.
// Per row, out_meta gets (offset into out, descriptor length); length 0
// means the payload was rejected.  Returns total bytes written, or -2
// when out ran out of capacity (caller grows and retries).
int64_t fd_txn_parse_burst(const uint8_t* buf, const uint64_t* rows,
                           uint64_t n, uint8_t* out, uint64_t out_cap,
                           uint64_t* out_meta) {
  uint64_t off = 0;
  for (uint64_t i = 0; i < n; i++) {
    int64_t r = fd_txn_parse(buf + rows[2 * i], rows[2 * i + 1], out + off,
                             out_cap - off);
    if (r == -2) return -2;
    if (r < 0) {
      out_meta[2 * i] = 0;
      out_meta[2 * i + 1] = 0;
    } else {
      out_meta[2 * i] = off;
      out_meta[2 * i + 1] = (uint64_t)r;
      off += (uint64_t)r;
    }
  }
  return (int64_t)off;
}

}  // extern "C"
