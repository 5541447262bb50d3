// Native executor fast lane: system + vote transactions, batched per
// microblock.
//
// Counterpart of the reference's hand-optimized bank-tile lanes
// (fd_system_program.c / fd_vote_program.c): the two dominant txn shapes
// execute entirely in C++ against account values in the funk wire format
// (flamenco/executor.py acct_encode/acct_decode: u64 lamports | 32B owner
// | u8 executable | data).  One fd_exec_batch2 call executes a whole
// microblock: the Python bank stage drains its burst, sends payloads +
// packed descriptors (fd_txn_parse's layout) + current account values in
// one request, and applies the returned record writes straight to funk —
// zero Account-object traffic on the hot path.
//
// Parity contract (differentially tested against the port's
// flamenco/runtime.py _execute_txn + programs.py/vote_program.py/nonce.py/
// stake.py, in tests/test_torch_exec_native.py):
// identical status codes, fees, and final account bytes.  Anything this
// lane is not SURE about — other programs, vote state versions !=
// current, lookup tables, arithmetic overflow that Python's big ints
// would survive — raises Punt: the batch stops BEFORE the txn mutates
// anything, the caller executes that txn through the Python lane, and
// resubmits the remainder.  Sequential semantics hold across the batch
// via an account overlay (a txn reads every earlier txn's committed
// writes).
//
// Status codes mirror flamenco/runtime.py:
//   0 success | -1 fee payer short (no fee) | -2 insufficient funds
//   -3 account error | -4 program error     (-2/-3/-4 still pay the fee)
//   -5 blockhash unknown/expired (no fee; the session gate's verdict
//      when the durable-nonce check fails)
//
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <cstdint>
#include <cstring>
#include <map>
#include <array>
#include <set>
#include <vector>

namespace {

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;
typedef unsigned __int128 u128;

typedef std::array<u8, 32> Key;

constexpr i64 TXN_SUCCESS = 0;
constexpr i64 ST_FEE = -1;
constexpr i64 ST_FUNDS = -2;
constexpr i64 ST_ACCT = -3;
constexpr i64 ST_PROG = -4;
constexpr i64 ST_BLOCKHASH = -5;  // TXN_ERR_BLOCKHASH (no fee)
constexpr i64 ST_ALREADY = -6;  // TXN_ERR_ALREADY_PROCESSED (no fee)

constexpr u64 MAX_PERMITTED_DATA_LENGTH = 10ull * 1024 * 1024;
constexpr u64 U64_MAX = ~0ull;

// VoteState machine constants (flamenco/vote_program.py)
constexpr unsigned MAX_LOCKOUT_HISTORY = 31;
constexpr unsigned VOTE_CREDITS_GRACE_SLOTS = 2;
constexpr unsigned VOTE_CREDITS_MAXIMUM_PER_SLOT = 16;
constexpr unsigned MAX_EPOCH_CREDITS_HISTORY = 64;

static const Key SYS_KEY = {};  // system program: 32 zero bytes
// "Vote111111111111111111111111111111111111111" (protocol/txn.py)
static const Key VOTE_KEY = {
    0x07, 0x61, 0x48, 0x1d, 0x35, 0x74, 0x74, 0xbb,
    0x7c, 0x4d, 0x76, 0x24, 0xeb, 0xd3, 0xbd, 0xb3,
    0xd8, 0x35, 0x5e, 0x73, 0xd1, 0x10, 0x43, 0xfc,
    0x0d, 0xa3, 0x53, 0x80, 0x00, 0x00, 0x00, 0x00,
};
// b"Stake11111" + 22 zero bytes (flamenco/stake.py STAKE_PROGRAM)
static const Key STAKE_KEY = {
    'S', 't', 'a', 'k', 'e', '1', '1', '1', '1', '1',
};

// typed failures: InstrError family mapped to the runtime's txn status
struct Err { i64 status; };
// this lane is not sure -> the caller runs the txn through Python
struct Punt {};

static inline u16 rd16(const u8* p) { return (u16)p[0] | ((u16)p[1] << 8); }
static inline u32 rd32(const u8* p) {
  return (u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) | ((u32)p[3] << 24);
}
static inline u64 rd64(const u8* p) {
  u64 v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}
static inline void wr32(u8* p, u32 v) {
  p[0] = (u8)v; p[1] = (u8)(v >> 8); p[2] = (u8)(v >> 16); p[3] = (u8)(v >> 24);
}
static inline void wr64(u8* p, u64 v) {
  for (int i = 0; i < 8; i++) { p[i] = (u8)v; v >>= 8; }
}

// -- account wire format (executor.acct_encode/acct_decode) ------------------

struct Acct {
  Key key;
  u64 lamports = 0;
  Key owner = {};
  bool exec = false;
  std::vector<u8> data;

  bool exists() const {
    return lamports > 0 || !data.empty() || owner != SYS_KEY;
  }
  bool same_state(const Acct& o) const {
    return lamports == o.lamports && owner == o.owner && exec == o.exec &&
           data == o.data;
  }
};

static void acct_decode(const u8* v, u64 n, Acct& a) {
  if (n == 0) {  // missing record: the zero system account
    a.lamports = 0; a.owner = SYS_KEY; a.exec = false; a.data.clear();
    return;
  }
  if (n < 41) {  // legacy u64||data records (short lamport reads allowed)
    u64 lam = 0;
    u64 k = n < 8 ? n : 8;
    for (u64 i = 0; i < k; i++) lam |= (u64)v[i] << (8 * i);
    a.lamports = lam;
    a.owner = SYS_KEY;
    a.exec = false;
    a.data.assign(n > 8 ? v + 8 : v, n > 8 ? v + n : v);
    if (n <= 8) a.data.clear();
    return;
  }
  a.lamports = rd64(v);
  std::memcpy(a.owner.data(), v + 8, 32);
  a.exec = v[40] != 0;
  a.data.assign(v + 41, v + n);
}

static void acct_encode(const Acct& a, std::vector<u8>& out) {
  out.resize(41 + a.data.size());
  wr64(out.data(), a.lamports);
  std::memcpy(out.data() + 8, a.owner.data(), 32);
  out[40] = a.exec ? 1 : 0;
  if (!a.data.empty())
    std::memcpy(out.data() + 41, a.data.data(), a.data.size());
}

// -- packed txn descriptor (protocol/txn.py txn_pack layout) -----------------

struct Instr {
  u8 prog;
  u16 acct_cnt, data_sz, acct_off, data_off;
};

struct Desc {
  u8 version, sig_cnt;
  u16 sig_off, msg_off;
  u8 ro_signed, ro_unsigned, acct_cnt;
  u16 acct_off, bh_off;
  u8 lut_cnt, adtl_w, adtl, instr_cnt;
  Instr instrs[64];
};

static void parse_desc(const u8* b, u64 n, Desc& d) {
  if (n < 17) throw Punt{};
  d.version = b[0]; d.sig_cnt = b[1];
  d.sig_off = rd16(b + 2); d.msg_off = rd16(b + 4);
  d.ro_signed = b[6]; d.ro_unsigned = b[7]; d.acct_cnt = b[8];
  d.acct_off = rd16(b + 9); d.bh_off = rd16(b + 11);
  d.lut_cnt = b[13]; d.adtl_w = b[14]; d.adtl = b[15]; d.instr_cnt = b[16];
  if (d.instr_cnt > 64) throw Punt{};
  if (n != 17ull + 9ull * d.instr_cnt + 10ull * d.lut_cnt) throw Punt{};
  const u8* p = b + 17;
  for (u32 k = 0; k < d.instr_cnt; k++, p += 9) {
    d.instrs[k].prog = p[0];
    d.instrs[k].acct_cnt = rd16(p + 1);
    d.instrs[k].data_sz = rd16(p + 3);
    d.instrs[k].acct_off = rd16(p + 5);
    d.instrs[k].data_off = rd16(p + 7);
  }
}

// Txn.is_writable (protocol/txn.py)
static bool is_writable(const Desc& d, u32 idx) {
  if (idx < d.acct_cnt) {
    if (idx < d.sig_cnt) return idx < (u32)(d.sig_cnt - d.ro_signed);
    return idx < (u32)(d.acct_cnt - d.ro_unsigned);
  }
  return idx < (u32)(d.acct_cnt + d.adtl_w);
}

// -- bincode cursor (flamenco/types.py semantics: short read = CodecError) ---

struct Rd {
  const u8* p;
  u64 n, i;
  void need(u64 k) { if (i + k > n) throw Err{ST_PROG}; }
  u8 get8() { need(1); return p[i++]; }
  u32 get32() { need(4); u32 v = rd32(p + i); i += 4; return v; }
  u64 get64() { need(8); u64 v = rd64(p + i); i += 8; return v; }
  i64 geti64() { u64 v = get64(); i64 s; std::memcpy(&s, &v, 8); return s; }
  void getkey(Key& k) { need(32); std::memcpy(k.data(), p + i, 32); i += 32; }
  bool getbool() {
    u8 b = get8();
    if (b > 1) throw Err{ST_PROG};
    return b == 1;
  }
};

// -- sha-256 (durable-nonce hash rotation; portable, nonce ops are rare) -----

static const u32 SHA_H0[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};
static const u32 SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

static inline u32 sha_rotr(u32 x, unsigned r) {
  return (x >> r) | (x << (32 - r));
}

struct Sha256 {
  u32 h[8];
  u8 buf[64];
  u64 len;
  Sha256() { std::memcpy(h, SHA_H0, sizeof(h)); len = 0; }
  void block(const u8* p) {
    u32 w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (u32)p[4 * i] << 24 | (u32)p[4 * i + 1] << 16 |
             (u32)p[4 * i + 2] << 8 | (u32)p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
      u32 s0 = sha_rotr(w[i - 15], 7) ^ sha_rotr(w[i - 15], 18) ^
               (w[i - 15] >> 3);
      u32 s1 = sha_rotr(w[i - 2], 17) ^ sha_rotr(w[i - 2], 19) ^
               (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u32 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
        hh = h[7];
    for (int i = 0; i < 64; i++) {
      u32 S1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
      u32 ch = (e & f) ^ (~e & g);
      u32 t1 = hh + S1 + ch + SHA_K[i] + w[i];
      u32 S0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
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

// -- slot hashes sysvar ------------------------------------------------------

struct SlotHashes {
  bool ok = true;          // blob well-formed (malformed -> -4 at use)
  std::vector<std::pair<u64, Key>> e;

  bool contains(u64 s) const {
    for (auto& kv : e) if (kv.first == s) return true;
    return false;
  }
  // dict(list) semantics: the LAST duplicate entry wins
  const Key* get(u64 s) const {
    const Key* hit = nullptr;
    for (auto& kv : e) if (kv.first == s) hit = &kv.second;
    return hit;
  }
};

static void parse_slot_hashes(const u8* p, u64 n, SlotHashes& sh) {
  sh.e.clear();
  sh.ok = false;
  if (n < 8) return;
  u64 cnt = rd64(p);
  if (cnt > 512) return;  // Vec max_len=512 -> CodecError in Python
  if (n != 8 + cnt * 40) return;  // loads() rejects trailing bytes
  const u8* q = p + 8;
  for (u64 k = 0; k < cnt; k++, q += 40) {
    Key h;
    std::memcpy(h.data(), q + 8, 32);
    sh.e.emplace_back(rd64(q), h);
  }
  sh.ok = true;
}

// -- vote state (flamenco/agave_state.py, current version only) --------------

struct Lk { u64 slot; u32 conf; };
struct LV { u8 latency; Lk lk; };

struct VoteSt {
  Key node = {}, withdrawer = {};
  u8 commission = 0;
  std::vector<LV> votes;
  bool has_root = false;
  u64 root = 0;
  std::map<u64, Key> auth;  // epoch -> authorized voter (BTreeMap)
  u8 prior_raw[1536];       // 32 x (pubkey, u64, u64): opaque passthrough
  u64 prior_idx = 31;
  bool prior_empty = true;
  std::vector<std::array<u64, 3>> credits;  // (epoch, credits, prev)
  u64 ts_slot = 0;
  i64 ts_ts = 0;
};

static void vote_state_decode(const u8* p, u64 n, VoteSt& vs) {
  Rd r{p, n, 0};
  u32 tag = r.get32();
  if (tag != 2) {
    if (tag <= 1) throw Punt{};  // old versions: the Python lane upgrades
    throw Err{ST_PROG};          // unknown version -> CodecError
  }
  r.getkey(vs.node);
  r.getkey(vs.withdrawer);
  vs.commission = r.get8();
  u64 nv = r.get64();
  if (nv > 64) throw Err{ST_PROG};  // Vec(LANDED_VOTE, max_len=64)
  vs.votes.clear();
  for (u64 k = 0; k < nv; k++) {
    LV lv;
    lv.latency = r.get8();
    lv.lk.slot = r.get64();
    lv.lk.conf = r.get32();
    vs.votes.push_back(lv);
  }
  u8 opt = r.get8();
  if (opt > 1) throw Err{ST_PROG};
  vs.has_root = opt == 1;
  vs.root = vs.has_root ? r.get64() : 0;
  u64 na = r.get64();
  if (na > 1024) throw Err{ST_PROG};
  vs.auth.clear();
  for (u64 k = 0; k < na; k++) {
    u64 epoch = r.get64();
    Key pk;
    r.getkey(pk);
    vs.auth[epoch] = pk;  // duplicate keys: later wins (dict semantics)
  }
  r.need(1536);
  std::memcpy(vs.prior_raw, r.p + r.i, 1536);
  r.i += 1536;
  vs.prior_idx = r.get64();
  vs.prior_empty = r.getbool();
  u64 nc = r.get64();
  if (nc > 4096) throw Err{ST_PROG};
  vs.credits.clear();
  for (u64 k = 0; k < nc; k++) {
    std::array<u64, 3> t;
    t[0] = r.get64(); t[1] = r.get64(); t[2] = r.get64();
    vs.credits.push_back(t);
  }
  vs.ts_slot = r.get64();
  vs.ts_ts = r.geti64();
  // trailing bytes (zero padding to the account size) are ignored, as
  // the Python decode (decode, not loads) does
}

static void vote_state_encode(const VoteSt& vs, std::vector<u8>& out) {
  out.clear();
  out.reserve(3762);
  auto put8 = [&](u8 v) { out.push_back(v); };
  auto put32 = [&](u32 v) {
    size_t o = out.size(); out.resize(o + 4); wr32(out.data() + o, v);
  };
  auto put64 = [&](u64 v) {
    size_t o = out.size(); out.resize(o + 8); wr64(out.data() + o, v);
  };
  auto putkey = [&](const Key& k) {
    out.insert(out.end(), k.begin(), k.end());
  };
  put32(2);  // VoteStateVersions::Current
  putkey(vs.node);
  putkey(vs.withdrawer);
  put8(vs.commission);
  put64(vs.votes.size());
  for (auto& lv : vs.votes) {
    put8(lv.latency);
    put64(lv.lk.slot);
    put32(lv.lk.conf);
  }
  if (vs.has_root) { put8(1); put64(vs.root); } else { put8(0); }
  put64(vs.auth.size());
  for (auto& kv : vs.auth) { put64(kv.first); putkey(kv.second); }
  out.insert(out.end(), vs.prior_raw, vs.prior_raw + 1536);
  put64(vs.prior_idx);
  put8(vs.prior_empty ? 1 : 0);
  put64(vs.credits.size());
  for (auto& t : vs.credits) { put64(t[0]); put64(t[1]); put64(t[2]); }
  put64(vs.ts_slot);
  u64 uts;
  std::memcpy(&uts, &vs.ts_ts, 8);
  put64(uts);
}

}  // namespace

namespace {

// -- vote state machine (flamenco/vote_program.py, line-for-line) ------------

static bool lockout_expired(const Lk& lk, u64 next_slot) {
  // slot + 2^conf < next_slot; conf >= 64 can never expire within u64
  if (lk.conf >= 64) return false;
  return (u128)lk.slot + ((u128)1 << lk.conf) < (u128)next_slot;
}

static u64 credits_for_latency(u32 latency) {
  if (latency == 0) return 1;  // legacy votes with no recorded latency
  if (latency <= VOTE_CREDITS_GRACE_SLOTS) return VOTE_CREDITS_MAXIMUM_PER_SLOT;
  u64 dec = latency - VOTE_CREDITS_GRACE_SLOTS;
  if (dec >= VOTE_CREDITS_MAXIMUM_PER_SLOT) return 1;
  u64 c = VOTE_CREDITS_MAXIMUM_PER_SLOT - dec;
  return c < 1 ? 1 : c;
}

static void increment_credits(VoteSt& vs, u64 epoch, u64 credits) {
  if (vs.credits.empty()) {
    vs.credits.push_back({epoch, 0, 0});
  } else if (epoch != vs.credits.back()[0]) {
    u64 c = vs.credits.back()[1], p = vs.credits.back()[2];
    if (c != p) {
      vs.credits.push_back({epoch, c, c});
    } else {
      vs.credits.back() = {epoch, c, c};
    }
    if (vs.credits.size() > MAX_EPOCH_CREDITS_HISTORY)
      vs.credits.erase(vs.credits.begin());
  }
  auto& last = vs.credits.back();
  if (last[1] > U64_MAX - credits) throw Err{ST_PROG};  // py: encode overflow
  last[1] += credits;
}

static void double_lockouts(VoteSt& vs) {
  u64 depth = vs.votes.size();
  for (u64 i = 0; i < depth; i++) {
    LV& lv = vs.votes[i];
    if (depth > i + (u64)lv.lk.conf) lv.lk.conf += 1;
  }
}

static void pop_expired_votes(VoteSt& vs, u64 next_slot) {
  while (!vs.votes.empty() && lockout_expired(vs.votes.back().lk, next_slot))
    vs.votes.pop_back();
}

static void process_next_vote_slot(VoteSt& vs, u64 next_slot, u64 epoch,
                                   u64 current_slot) {
  if (!vs.votes.empty() && vs.votes.back().lk.slot >= next_slot) return;
  pop_expired_votes(vs, next_slot);
  u64 latency = 0;
  if (current_slot != 0 && current_slot > next_slot)
    latency = current_slot - next_slot;
  LV lv;
  lv.latency = (u8)(latency > 255 ? 255 : latency);
  lv.lk = Lk{next_slot, 1};
  if (vs.votes.size() == MAX_LOCKOUT_HISTORY) {
    LV rooted = vs.votes.front();
    vs.votes.erase(vs.votes.begin());
    vs.has_root = true;
    vs.root = rooted.lk.slot;
    increment_credits(vs, epoch, credits_for_latency(rooted.latency));
  }
  vs.votes.push_back(lv);
  double_lockouts(vs);
}

// VoteError -> InstrError -> TXN_ERR_PROGRAM: every VoteError is ST_PROG
static void process_vote(VoteSt& vs, const std::vector<u64>& slots,
                         const Key& vote_hash, bool has_ts, i64 ts,
                         const SlotHashes& sh, u64 epoch, u64 current_slot);

static void check_and_set_timestamp(VoteSt& vs, u64 slot, i64 ts) {
  // process_timestamp: monotone; same slot may only re-assert the value
  if (slot < vs.ts_slot || ts < vs.ts_ts ||
      (slot == vs.ts_slot && ts != vs.ts_ts && vs.ts_slot != 0))
    throw Err{ST_PROG};  // TimestampTooOld
  vs.ts_slot = slot;
  vs.ts_ts = ts;
}

static void process_vote(VoteSt& vs, const std::vector<u64>& slots,
                         const Key& vote_hash, bool has_ts, i64 ts,
                         const SlotHashes& sh, u64 epoch, u64 current_slot) {
  if (slots.empty()) throw Err{ST_PROG};  // EmptySlots
  // check_slots_are_valid
  bool has_last = !vs.votes.empty();
  u64 last = has_last ? vs.votes.back().lk.slot : 0;
  std::vector<u64> accepted;
  for (u64 s : slots)
    if ((!has_last || s > last) && sh.contains(s)) accepted.push_back(s);
  if (accepted.empty()) throw Err{ST_PROG};  // VotesTooOldAllFiltered
  const Key* h = sh.get(accepted.back());
  if (h == nullptr || *h != vote_hash) throw Err{ST_PROG};  // SlotHashMismatch
  for (u64 s : accepted) process_next_vote_slot(vs, s, epoch, current_slot);
  if (has_ts) check_and_set_timestamp(vs, slots.back(), ts);
}

static void process_new_vote_state(VoteSt& vs, const std::vector<Lk>& nl,
                                   bool has_new_root, u64 new_root,
                                   const Key& vote_hash, const SlotHashes& sh,
                                   u64 epoch, u64 current_slot) {
  if (nl.empty()) throw Err{ST_PROG};                       // EmptySlots
  if (nl.size() > MAX_LOCKOUT_HISTORY) throw Err{ST_PROG};  // TooManyVotes
  if (!vs.votes.empty() && nl.back().slot <= vs.votes.back().lk.slot)
    throw Err{ST_PROG};  // VoteTooOld
  if (has_new_root && vs.has_root && new_root < vs.root)
    throw Err{ST_PROG};  // RootRollBack
  if (!has_new_root && vs.has_root) throw Err{ST_PROG};  // RootRollBack
  for (size_t i = 0; i < nl.size(); i++) {
    const Lk& lk = nl[i];
    if (lk.conf < 1 || lk.conf > MAX_LOCKOUT_HISTORY)
      throw Err{ST_PROG};  // ConfirmationOutOfBounds
    if (has_new_root && lk.slot <= new_root)
      throw Err{ST_PROG};  // SlotSmallerThanRoot
    if (i > 0) {
      if (lk.slot <= nl[i - 1].slot) throw Err{ST_PROG};  // SlotsNotOrdered
      if (lk.conf >= nl[i - 1].conf)
        throw Err{ST_PROG};  // ConfirmationsNotOrdered
    }
  }
  u64 last_slot = nl.back().slot;
  const Key* h = sh.contains(last_slot) ? sh.get(last_slot) : nullptr;
  if (h == nullptr) throw Err{ST_PROG};       // SlotsMismatch
  if (*h != vote_hash) throw Err{ST_PROG};    // SlotHashMismatch
  if (has_new_root) {
    // credits for old votes the new root newly covers
    bool has_old = vs.has_root;
    u64 old_root = vs.root;
    for (auto& lv : vs.votes) {
      bool above_old = !has_old || lv.lk.slot > old_root;
      if (above_old && lv.lk.slot <= new_root)
        increment_credits(vs, epoch, credits_for_latency(lv.latency));
    }
  }
  // carry landing latencies for surviving slots
  std::map<u64, u8> lat;
  for (auto& lv : vs.votes) lat[lv.lk.slot] = lv.latency;
  std::vector<LV> nv;
  for (auto& lk : nl) {
    LV lv;
    auto it = lat.find(lk.slot);
    if (it != lat.end()) {
      lv.latency = it->second;
    } else if (current_slot != 0) {
      u64 l = current_slot > lk.slot ? current_slot - lk.slot : 0;
      lv.latency = (u8)(l > 255 ? 255 : l);
    } else {
      lv.latency = 0;
    }
    lv.lk = lk;
    nv.push_back(lv);
  }
  vs.votes.swap(nv);
  vs.has_root = has_new_root;
  vs.root = new_root;
}

// authorized_voter_for: greatest epoch key <= epoch
static const Key* authorized_voter_for(const VoteSt& vs, u64 epoch) {
  const Key* best = nullptr;
  for (auto& kv : vs.auth) {
    if (kv.first <= epoch) best = &kv.second;
    else break;
  }
  return best;
}

// -- per-txn execution context -----------------------------------------------

struct IA {
  u8 idx;
  bool signer, writable;
};

struct TxnX {
  const u8* payload;
  u64 payload_sz;
  Desc desc;
  const u8* addrs;             // acct_cnt x 32B, inside the payload
  std::vector<Acct> accts;     // loaded, payer fee-debited
  std::vector<bool> signer, writable;

  const u8* addr(u32 i) const { return addrs + 32ull * i; }
};

struct VoteEnv {
  bool have_clock;
  u64 clock_slot, clock_epoch;
  bool sh_present;
  const SlotHashes* sh;
  // durable-nonce family (flamenco/nonce.py): the slot's blockhash view
  bool have_rbh = false;
  Key rbh = {};
  // rent sysvar (nonce partial withdraw's rent floor): 2 = the sysvar
  // blob was present but undecodable -> Punt at the point of use (the
  // Python lane owns whatever that decode raises)
  u8 rent_flag = 0;
  u64 rent_lpby = 3480;
  double rent_et = 2.0;
};

// next_nonce (flamenco/nonce.py): domain-separated over the blockhash
// and the account key
static void nonce_next(const Key& rbh, const Key& key, u8 out[32]) {
  static const char dom[] = "fdtpu:durable-nonce";
  Sha256 s;
  s.update((const u8*)dom, sizeof(dom) - 1);
  s.update(rbh.data(), 32);
  s.update(key.data(), 32);
  s.final(out);
}

constexpr u64 NONCE_DATA_LEN = 4 + 32 + 32;
constexpr u32 NONCE_UNINIT = 0;
constexpr u32 NONCE_INIT = 1;

// decode_state: short data reads as uninitialized (zeros)
static void nonce_decode(const std::vector<u8>& data, u32& state, Key& auth,
                         Key& nonce) {
  if (data.size() < NONCE_DATA_LEN) {
    state = NONCE_UNINIT;
    auth.fill(0);
    nonce.fill(0);
    return;
  }
  state = rd32(data.data());
  std::memcpy(auth.data(), data.data() + 4, 32);
  std::memcpy(nonce.data(), data.data() + 36, 32);
}

static void nonce_store(std::vector<u8>& data, u32 state, const Key& auth,
                        const Key& nonce) {
  wr32(data.data(), state);
  std::memcpy(data.data() + 4, auth.data(), 32);
  std::memcpy(data.data() + 36, nonce.data(), 32);
}

// -- system program (flamenco/programs.py system_program) --------------------

static Acct& sys_acct(TxnX& T, const std::vector<IA>& ia, u32 i) {
  if (i >= ia.size()) throw Err{ST_ACCT};  // "system instr needs account i"
  return T.accts[ia[i].idx];
}

static void sys_need_writable(const std::vector<IA>& ia, u32 i) {
  if (!ia[i].writable) throw Err{ST_ACCT};
}

static void sys_need_signer(const std::vector<IA>& ia, u32 i) {
  if (!ia[i].signer) throw Err{ST_ACCT};  // top level: no pda signers
}

// signed_by (nonce.py/stake.py): any instruction account that is this
// key and a txn-level signer (no pda signers at top level)
static bool instr_signed_by(const TxnX& T, const std::vector<IA>& ia,
                            const Key& key) {
  for (auto& a : ia)
    if (a.signer && T.accts[a.idx].key == key) return true;
  return false;
}

// -- durable-nonce family (flamenco/nonce.py handle, tags 4..7) --------------

static void nonce_instr(TxnX& T, const std::vector<IA>& ia, const u8* data,
                        u32 dlen, u32 tag, const VoteEnv& env) {
  // _recent_blockhash: fail CLOSED when the sysvar is absent
  auto rbh = [&]() -> const Key& {
    if (!env.have_rbh) throw Err{ST_ACCT};
    return env.rbh;
  };
  Acct& a = sys_acct(T, ia, 0);
  sys_need_writable(ia, 0);
  if (a.owner != SYS_KEY) throw Err{ST_ACCT};  // not system-owned
  u32 state;
  Key authority, nonce;
  nonce_decode(a.data, state, authority, nonce);

  if (tag == 6) {  // InitializeNonceAccount { authority 32 }
    if (dlen < 4 + 32) throw Err{ST_ACCT};
    if (state != NONCE_UNINIT) throw Err{ST_ACCT};
    if (a.data.size() < NONCE_DATA_LEN) throw Err{ST_ACCT};
    Key auth_new, nn;
    std::memcpy(auth_new.data(), data + 4, 32);
    nonce_next(rbh(), a.key, nn.data());
    nonce_store(a.data, NONCE_INIT, auth_new, nn);
  } else if (tag == 4) {  // AdvanceNonceAccount
    if (state != NONCE_INIT) throw Err{ST_ACCT};
    if (!instr_signed_by(T, ia, authority)) throw Err{ST_ACCT};
    Key nn;
    nonce_next(rbh(), a.key, nn.data());
    if (nn == nonce) throw Err{ST_ACCT};  // same-slot double advance
    nonce_store(a.data, NONCE_INIT, authority, nn);
  } else if (tag == 5) {  // WithdrawNonceAccount { lamports u64 }
    if (dlen < 12) throw Err{ST_ACCT};
    u64 lamports = rd64(data + 4);
    Acct& dest = sys_acct(T, ia, 1);
    sys_need_writable(ia, 1);
    const Key& who = state == NONCE_INIT ? authority : a.key;
    if (!instr_signed_by(T, ia, who)) throw Err{ST_ACCT};
    if (a.lamports < lamports) throw Err{ST_FUNDS};
    if (state == NONCE_INIT) {
      if (lamports == a.lamports) {
        // full drain: refuse while the stored nonce is still current,
        // and clear the state so the drained account stops satisfying
        // durable_nonce_ok
        Key nn;
        nonce_next(rbh(), a.key, nn.data());
        if (nn == nonce) throw Err{ST_ACCT};  // blockhash not expired
        Key z = {};
        nonce_store(a.data, NONCE_UNINIT, z, z);
      } else {
        // partial: the remainder must stay rent-exempt
        if (env.rent_flag == 2) throw Punt{};  // undecodable rent sysvar
        // int((data_len + 128) * lamports_per_byte_year
        //     * exemption_threshold), python float semantics
        u64 dl = (u64)a.data.size() + 128;
        if (env.rent_lpby != 0 && dl > U64_MAX / env.rent_lpby)
          throw Punt{};  // python bigint territory
        double f = (double)(dl * env.rent_lpby) * env.rent_et;
        if (!(f >= 0.0) || f >= 18446744073709551616.0)
          throw Punt{};  // NaN / negative / > u64: python lane decides
        u64 floor_ = (u64)f;
        if (a.lamports - lamports < floor_) throw Err{ST_FUNDS};
      }
    }
    if (a.key == dest.key) return;
    if (dest.lamports > U64_MAX - lamports) throw Punt{};  // py bigint
    a.lamports -= lamports;
    dest.lamports += lamports;
  } else if (tag == 7) {  // AuthorizeNonceAccount { authority 32 }
    if (dlen < 4 + 32) throw Err{ST_ACCT};
    if (state != NONCE_INIT) throw Err{ST_ACCT};
    if (!instr_signed_by(T, ia, authority)) throw Err{ST_ACCT};
    Key auth_new;
    std::memcpy(auth_new.data(), data + 4, 32);
    nonce_store(a.data, NONCE_INIT, auth_new, nonce);
  }
}

static void system_instr(TxnX& T, const std::vector<IA>& ia, const u8* data,
                         u32 dlen, const VoteEnv& env) {
  if (dlen < 4) return;  // garbage instruction: no-op (legacy parity)
  u32 tag = rd32(data);
  if (tag == 2) {  // Transfer { lamports }
    if (dlen < 12 || ia.size() < 2) return;  // no-op, mirrors python
    u64 lamports = rd64(data + 4);
    Acct& src = sys_acct(T, ia, 0);
    Acct& dst = sys_acct(T, ia, 1);
    sys_need_writable(ia, 0);
    sys_need_writable(ia, 1);
    sys_need_signer(ia, 0);
    if (src.owner != SYS_KEY) throw Err{ST_ACCT};
    if (!src.data.empty()) throw Err{ST_ACCT};  // source carries data
    if (src.lamports < lamports) throw Err{ST_FUNDS};
    if (src.key == dst.key) return;  // self-transfer: no-op, NOT a mint
    if (dst.lamports > U64_MAX - lamports) throw Punt{};  // py bigint path
    src.lamports -= lamports;
    dst.lamports += lamports;
  } else if (tag == 0) {  // CreateAccount { lamports, space, owner }
    if (dlen < 4 + 8 + 8 + 32 || ia.size() < 2) throw Err{ST_ACCT};
    u64 lamports = rd64(data + 4);
    u64 space = rd64(data + 12);
    Acct& src = sys_acct(T, ia, 0);
    Acct& nw = sys_acct(T, ia, 1);
    sys_need_writable(ia, 0);
    sys_need_writable(ia, 1);
    sys_need_signer(ia, 0);
    sys_need_signer(ia, 1);
    if (space > MAX_PERMITTED_DATA_LENGTH) throw Err{ST_ACCT};
    if (src.owner != SYS_KEY) throw Err{ST_ACCT};
    if (nw.exists()) throw Err{ST_ACCT};
    if (src.lamports < lamports) throw Err{ST_FUNDS};
    if (src.key != nw.key) {
      // nw.exists() false => nw.lamports == 0: the add cannot overflow
      src.lamports -= lamports;
      nw.lamports += lamports;
    }
    nw.data.assign(space, 0);
    std::memcpy(nw.owner.data(), data + 20, 32);
  } else if (tag == 1) {  // Assign { owner }
    if (dlen < 36 || ia.empty()) throw Err{ST_ACCT};
    Acct& a = sys_acct(T, ia, 0);
    sys_need_writable(ia, 0);
    sys_need_signer(ia, 0);
    if (a.owner != SYS_KEY) throw Err{ST_ACCT};
    std::memcpy(a.owner.data(), data + 4, 32);
  } else if (tag >= 4 && tag <= 7) {
    nonce_instr(T, ia, data, dlen, tag, env);  // durable-nonce family
  } else if (tag == 8) {  // Allocate { space }
    if (dlen < 12 || ia.empty()) throw Err{ST_ACCT};
    u64 space = rd64(data + 4);
    Acct& a = sys_acct(T, ia, 0);
    sys_need_writable(ia, 0);
    sys_need_signer(ia, 0);
    if (space > MAX_PERMITTED_DATA_LENGTH) throw Err{ST_ACCT};
    if (!a.data.empty() || a.owner != SYS_KEY) throw Err{ST_ACCT};
    a.data.assign(space, 0);
  }
  // other tags: no-op (unimplemented surface is inert, never fatal)
}

// -- stake program (flamenco/stake.py stake_program, tags 0..4) --------------

constexpr u64 STAKE_DATA_LEN = 4 + 32 * 3 + 8 * 3;  // 124
constexpr u32 STAKE_UNINIT = 0;
constexpr u32 STAKE_INIT = 1;
constexpr u32 STAKE_DELEGATED = 2;
constexpr u64 STAKE_WARMUP_DIV = 4;

struct StakeSt {
  u32 state = STAKE_UNINIT;
  Key staker = {}, withdrawer = {}, voter = {};
  u64 stake = 0;
  u64 activation_epoch = U64_MAX;
  u64 deactivation_epoch = U64_MAX;
};

// StakeState.decode: short data reads as the uninitialized default
static void stake_decode(const std::vector<u8>& data, StakeSt& st) {
  if (data.size() < STAKE_DATA_LEN) { st = StakeSt(); return; }
  const u8* p = data.data();
  st.state = rd32(p);
  std::memcpy(st.staker.data(), p + 4, 32);
  std::memcpy(st.withdrawer.data(), p + 36, 32);
  std::memcpy(st.voter.data(), p + 68, 32);
  st.stake = rd64(p + 100);
  st.activation_epoch = rd64(p + 108);
  st.deactivation_epoch = rd64(p + 116);
}

static void stake_store(std::vector<u8>& data, const StakeSt& st) {
  u8* p = data.data();
  wr32(p, st.state);
  std::memcpy(p + 4, st.staker.data(), 32);
  std::memcpy(p + 36, st.withdrawer.data(), 32);
  std::memcpy(p + 68, st.voter.data(), 32);
  wr64(p + 100, st.stake);
  wr64(p + 108, st.activation_epoch);
  wr64(p + 116, st.deactivation_epoch);
}

// locked_stake: the whole delegation while active/warming, ramping to
// zero through cooldown (a quarter releases per epoch boundary)
static u64 stake_locked(const StakeSt& st, u64 epoch) {
  if (st.state != STAKE_DELEGATED) return 0;
  if (st.deactivation_epoch == U64_MAX || epoch < st.deactivation_epoch)
    return st.stake;
  u64 d = epoch - st.deactivation_epoch;
  if (d >= STAKE_WARMUP_DIV) return 0;  // released >= stake
  u64 released = (u64)(((u128)st.stake * d) / STAKE_WARMUP_DIV);
  return st.stake - released;
}

static void stake_instr(TxnX& T, const std::vector<IA>& ia, const u8* data,
                        u32 dlen, const VoteEnv& env) {
  if (dlen < 4) return;  // garbage instruction: no-op
  u32 tag = rd32(data);
  // acct(i, owned=...): the owner-may-modify/debit rule
  auto acct = [&](u32 i, bool owned) -> Acct& {
    if (i >= ia.size()) throw Err{ST_ACCT};
    Acct& a = T.accts[ia[i].idx];
    if (owned && a.owner != STAKE_KEY) throw Err{ST_ACCT};
    return a;
  };
  // _clock_epoch fails CLOSED in python (AcctError when the sysvar is
  // missing); env.have_clock false also covers a MALFORMED clock blob
  // (the caller could not decode it) whose python-lane outcome differs,
  // so the safe translation is a punt, not a typed failure
  auto clock_epoch = [&]() -> u64 {
    if (!env.have_clock) throw Punt{};
    return env.clock_epoch;
  };

  if (tag == 0) {  // Initialize { staker 32 | withdrawer 32 }
    if (dlen < 4 + 64) throw Err{ST_ACCT};
    Acct& a = acct(0, true);
    sys_need_writable(ia, 0);
    StakeSt st;
    stake_decode(a.data, st);
    if (st.state != STAKE_UNINIT) throw Err{ST_ACCT};
    if (a.data.size() < STAKE_DATA_LEN) throw Err{ST_ACCT};
    st = StakeSt();
    st.state = STAKE_INIT;
    std::memcpy(st.staker.data(), data + 4, 32);
    std::memcpy(st.withdrawer.data(), data + 36, 32);
    stake_store(a.data, st);
  } else if (tag == 1) {  // Delegate; accounts [stake, vote]
    Acct& a = acct(0, true);
    Acct& vote = acct(1, false);
    sys_need_writable(ia, 0);
    StakeSt st;
    stake_decode(a.data, st);
    if (st.state == STAKE_UNINIT) throw Err{ST_ACCT};
    if (!instr_signed_by(T, ia, st.staker)) throw Err{ST_ACCT};
    u64 epoch = clock_epoch();
    st.state = STAKE_DELEGATED;
    st.voter = vote.key;
    st.stake = a.lamports;  // whole balance delegates
    st.activation_epoch = epoch;
    st.deactivation_epoch = U64_MAX;
    stake_store(a.data, st);
  } else if (tag == 2) {  // Deactivate
    Acct& a = acct(0, true);
    sys_need_writable(ia, 0);
    StakeSt st;
    stake_decode(a.data, st);
    if (st.state != STAKE_DELEGATED) throw Err{ST_ACCT};
    if (!instr_signed_by(T, ia, st.staker)) throw Err{ST_ACCT};
    st.deactivation_epoch = clock_epoch();
    stake_store(a.data, st);
  } else if (tag == 3) {  // Withdraw { lamports u64 }; [stake, dest]
    if (dlen < 12) throw Err{ST_ACCT};
    u64 lamports = rd64(data + 4);
    Acct& a = acct(0, true);
    Acct& dest = acct(1, false);
    sys_need_writable(ia, 0);
    sys_need_writable(ia, 1);
    StakeSt st;
    stake_decode(a.data, st);
    if (st.state == STAKE_UNINIT) {
      // an uninitialized stake account withdraws under its OWN key
      if (!instr_signed_by(T, ia, a.key)) throw Err{ST_ACCT};
    } else if (!instr_signed_by(T, ia, st.withdrawer)) {
      throw Err{ST_ACCT};
    }
    u64 locked =
        st.state == STAKE_DELEGATED ? stake_locked(st, clock_epoch()) : 0;
    // python signed arithmetic: lamports > balance - locked fails even
    // when locked exceeds the balance
    if ((__int128)a.lamports - (__int128)locked < (__int128)lamports)
      throw Err{ST_FUNDS};
    if (a.key == dest.key) return;
    if (dest.lamports > U64_MAX - lamports) throw Punt{};  // py bigint
    a.lamports -= lamports;
    dest.lamports += lamports;
  } else if (tag == 4) {  // Split { lamports u64 }; [stake, new_stake]
    if (dlen < 12) throw Err{ST_ACCT};
    u64 lamports = rd64(data + 4);
    Acct& a = acct(0, true);
    Acct& nw = acct(1, true);
    sys_need_writable(ia, 0);
    sys_need_writable(ia, 1);
    StakeSt st;
    stake_decode(a.data, st);
    if (st.state != STAKE_DELEGATED) throw Err{ST_ACCT};
    if (!instr_signed_by(T, ia, st.staker)) throw Err{ST_ACCT};
    if (lamports > st.stake || lamports > a.lamports) throw Err{ST_FUNDS};
    if (nw.data.size() < STAKE_DATA_LEN) throw Err{ST_ACCT};
    StakeSt nst;
    stake_decode(nw.data, nst);
    if (nst.state != STAKE_UNINIT) throw Err{ST_ACCT};
    if (nw.lamports > U64_MAX - lamports) throw Punt{};  // py bigint
    st.stake -= lamports;
    a.lamports -= lamports;
    stake_store(a.data, st);
    nw.lamports += lamports;
    nst = st;
    nst.state = STAKE_DELEGATED;
    nst.stake = lamports;
    stake_store(nw.data, nst);
  }
  // other tags: no-op
}

// -- vote program (flamenco/vote_program.py vote_program) --------------------

static bool vote_signed_by(const TxnX& T, const std::vector<IA>& ia,
                           const Key* pk) {
  if (pk == nullptr) return false;
  for (auto& a : ia)
    if (a.signer && T.accts[a.idx].key == *pk) return true;
  return false;
}

static void vote_instr(TxnX& T, const std::vector<IA>& ia, const u8* data,
                       u32 dlen, const VoteEnv& env) {
  if (dlen < 4) throw Err{ST_PROG};  // "vote: truncated instruction"
  u32 tag = rd32(data);
  if (ia.empty()) throw Err{ST_ACCT};  // missing vote account
  Acct& va = T.accts[ia[0].idx];
  if (va.owner != VOTE_KEY) throw Err{ST_ACCT};
  if (!ia[0].writable) throw Err{ST_ACCT};
  if (!env.have_clock) throw Err{ST_PROG};  // VoteError: clock unavailable
  if (tag == 0) throw Punt{};  // InitializeAccount: Python lane
  // _state_load: all-zero data = uninitialized
  bool all_zero = true;
  for (u8 b : va.data)
    if (b != 0) { all_zero = false; break; }
  if (all_zero) throw Err{ST_PROG};  // "vote account uninitialized"
  VoteSt vs;
  vote_state_decode(va.data.data(), va.data.size(), vs);
  u64 epoch = env.clock_epoch, cslot = env.clock_slot;

  if (tag == 2 || tag == 6) {  // Vote / VoteSwitch
    Rd r{data, dlen, 4};
    u64 ns = r.get64();
    if (ns > 64) throw Err{ST_PROG};  // Vec(U64, max_len=64)
    std::vector<u64> slots;
    for (u64 k = 0; k < ns; k++) slots.push_back(r.get64());
    Key h;
    r.getkey(h);
    u8 opt = r.get8();
    if (opt > 1) throw Err{ST_PROG};
    bool has_ts = opt == 1;
    i64 ts = has_ts ? r.geti64() : 0;
    // trailing bytes (VoteSwitch proof hash) are ignored, as Python
    if (!vote_signed_by(T, ia, authorized_voter_for(vs, epoch)))
      throw Err{ST_ACCT};
    if (!env.sh->ok) throw Err{ST_PROG};  // malformed SlotHashes sysvar
    process_vote(vs, slots, h, has_ts, ts, *env.sh, epoch, cslot);
  } else if (tag == 8 || tag == 9 || tag == 14 || tag == 15) {
    // UpdateVoteState(Switch) / TowerSync(Switch)
    Rd r{data, dlen, 4};
    u64 nlk = r.get64();
    if (nlk > 64) throw Err{ST_PROG};  // Vec(LOCKOUT, max_len=64)
    std::vector<Lk> nl;
    for (u64 k = 0; k < nlk; k++) {
      Lk lk;
      lk.slot = r.get64();
      lk.conf = r.get32();
      nl.push_back(lk);
    }
    u8 opt = r.get8();
    if (opt > 1) throw Err{ST_PROG};
    bool has_root = opt == 1;
    u64 root = has_root ? r.get64() : 0;
    Key h;
    r.getkey(h);
    opt = r.get8();
    if (opt > 1) throw Err{ST_PROG};
    bool has_ts = opt == 1;
    i64 ts = has_ts ? r.geti64() : 0;
    if (tag == 14 || tag == 15) {
      Key block_id;
      r.getkey(block_id);  // decoded (bounds-checked), unused as Python
    }
    if (!vote_signed_by(T, ia, authorized_voter_for(vs, epoch)))
      throw Err{ST_ACCT};
    if (!env.sh->ok) throw Err{ST_PROG};
    process_new_vote_state(vs, nl, has_root, root, h, *env.sh, epoch, cslot);
    if (has_ts && !nl.empty()) check_and_set_timestamp(vs, nl.back().slot, ts);
  } else if (tag == 1 || tag == 3 || tag == 4 || tag == 5 || tag == 7) {
    throw Punt{};  // authorize/withdraw/identity/commission: Python lane
  } else {
    throw Err{ST_PROG};  // "vote: unsupported instruction"
  }
  // _state_store: fixed account size, state may never grow past it
  std::vector<u8> blob;
  vote_state_encode(vs, blob);
  if (blob.size() > va.data.size()) throw Err{ST_PROG};
  std::memcpy(va.data.data(), blob.data(), blob.size());
  std::fill(va.data.begin() + blob.size(), va.data.end(), 0);
}

}  // namespace

namespace {

// -- response writer ---------------------------------------------------------

struct RespFull {};  // resp_cap too small: caller retries with a bigger buf

struct Wr {
  u8* p;
  u64 cap, i;
  void need(u64 k) { if (i + k > cap) throw RespFull{}; }
  void put8(u8 v) { need(1); p[i++] = v; }
  void put32(u32 v) { need(4); wr32(p + i, v); i += 4; }
  void put64(u64 v) { need(8); wr64(p + i, v); i += 8; }
  void bytes(const u8* b, u64 n) {
    need(n);
    if (n) std::memcpy(p + i, b, n);
    i += n;
  }
};

// -- one transaction (flamenco/runtime.py _execute_txn, native subset) -------

struct Write {
  u8 idx;
  std::vector<u8> val;
};

struct TxnResult {
  i64 status;
  u64 fee;
  std::vector<Write> writes;
  // instructions that charged their builtin cost before the txn ended:
  // the failing one included when it ran, all of them on success
  // (flamenco/executor.py charges up front), so Python's compute units
  // are the first n_ins instructions' BUILTIN_COST
  u8 n_ins = 0;
};

typedef std::map<Key, std::vector<u8>> Overlay;

struct TxnIn {
  const u8* payload;
  u64 payload_sz;
  const u8* desc_bytes;
  u64 desc_sz;
  u32 acct_cnt;
  // per-account supplied values (funk state at batch start)
  std::vector<std::pair<const u8*, u64>> vals;
  // session mode (fd_exec_batch2): every account value was pre-merged
  // into the session overlay; a miss is a protocol violation -> Punt
  bool ov_only = false;
};

static void load_acct(const Overlay& ov, const TxnIn& in, u32 i,
                      const Key& key, Acct& a) {
  auto it = ov.find(key);
  if (it != ov.end()) {
    acct_decode(it->second.data(), it->second.size(), a);
  } else if (in.ov_only) {
    throw Punt{};  // caller never shipped this account's value
  } else {
    acct_decode(in.vals[i].first, in.vals[i].second, a);
  }
  a.key = key;
}

static TxnResult execute_txn(const TxnIn& in, Overlay& ov, u64 lps,
                             const VoteEnv& env, bool durable = false) {
  TxnX T;
  T.payload = in.payload;
  T.payload_sz = in.payload_sz;
  parse_desc(in.desc_bytes, in.desc_sz, T.desc);
  Desc& d = T.desc;
  if (d.lut_cnt != 0 || d.adtl != 0) throw Punt{};  // ALT path: Python lane
  if (in.acct_cnt != d.acct_cnt) throw Punt{};
  if ((u64)d.acct_off + 32ull * d.acct_cnt > in.payload_sz) throw Punt{};
  if (d.acct_cnt == 0 || d.sig_cnt == 0) throw Punt{};
  T.addrs = in.payload + d.acct_off;

  // AccountLoadedTwice analog: duplicate addresses are a typed failure
  // BEFORE the fee is charged
  for (u32 i = 0; i < d.acct_cnt; i++)
    for (u32 j = i + 1; j < d.acct_cnt; j++)
      if (std::memcmp(T.addr(i), T.addr(j), 32) == 0)
        return TxnResult{ST_ACCT, 0, {}};

  u64 fee = lps * d.sig_cnt;
  Key payer_key;
  std::memcpy(payer_key.data(), T.addr(0), 32);
  Acct payer;
  load_acct(ov, in, 0, payer_key, payer);
  if (payer.lamports < fee) return TxnResult{ST_FEE, 0, {}};

  // load the account set; the payer loads with the fee already debited
  // (python writes the debit to funk before loading, so failure keeps it)
  T.accts.resize(d.acct_cnt);
  T.signer.resize(d.acct_cnt);
  T.writable.resize(d.acct_cnt);
  for (u32 i = 0; i < d.acct_cnt; i++) {
    Key k;
    std::memcpy(k.data(), T.addr(i), 32);
    load_acct(ov, in, i, k, T.accts[i]);
    T.signer[i] = i < d.sig_cnt;
    T.writable[i] = is_writable(d, i);
  }
  T.accts[0].lamports -= fee;
  std::vector<Acct> baseline = T.accts;

  auto fail = [&](i64 status, u32 n_ins) {
    TxnResult r{status, fee, {}, (u8)n_ins};
    Write w;
    w.idx = 0;
    acct_encode(baseline[0], w.val);  // fee-debited payer, no effects
    r.writes.push_back(std::move(w));
    // a FAILED durable-nonce txn still advances its nonce account
    // (runtime.py _advance_nonce_account): the rotated hash is part of
    // the txn's on-chain footprint, else the signed txn re-lands after
    // the status cache prunes its signature
    if (durable && d.instr_cnt > 0) {
      const Instr& ins0 = d.instrs[0];
      if ((u64)ins0.acct_off + ins0.acct_cnt <= in.payload_sz &&
          ins0.acct_cnt >= 1) {
        u8 nidx = in.payload[ins0.acct_off];
        if (nidx < d.acct_cnt && env.have_rbh) {
          // funk's post-fee-debit view IS the baseline (instruction
          // effects never landed); baseline[0] carries the debit, so a
          // payer-is-nonce txn rotates the already-debited account
          Acct na = baseline[nidx];
          u32 nstate;
          Key nauth, ncur;
          nonce_decode(na.data, nstate, nauth, ncur);
          if (nstate == NONCE_INIT) {
            Key nn;
            nonce_next(env.rbh, na.key, nn.data());
            nonce_store(na.data, NONCE_INIT, nauth, nn);
            Write nw;
            nw.idx = nidx;
            acct_encode(na, nw.val);
            if (nidx == 0) {
              r.writes[0] = std::move(nw);  // payer IS the nonce account
            } else {
              r.writes.push_back(std::move(nw));
            }
          }
        }
      }
    }
    return r;
  };

  for (u32 k = 0; k < d.instr_cnt; k++) {
    const Instr& ins = d.instrs[k];
    if (ins.prog >= d.acct_cnt) return fail(ST_ACCT, k);
    if ((u64)ins.data_off + ins.data_sz > in.payload_sz) throw Punt{};
    if ((u64)ins.acct_off + ins.acct_cnt > in.payload_sz) throw Punt{};
    const u8* idx = in.payload + ins.acct_off;
    bool bad_idx = false;
    for (u32 j = 0; j < ins.acct_cnt; j++)
      if (idx[j] >= d.acct_cnt) bad_idx = true;
    if (bad_idx) return fail(ST_ACCT, k);
    std::vector<IA> ia;
    ia.reserve(ins.acct_cnt);
    for (u32 j = 0; j < ins.acct_cnt; j++)
      ia.push_back(IA{idx[j], T.signer[idx[j]], T.writable[idx[j]]});
    const u8* data = in.payload + ins.data_off;
    const u8* progkey = T.addr(ins.prog);
    try {
      if (std::memcmp(progkey, SYS_KEY.data(), 32) == 0) {
        system_instr(T, ia, data, ins.data_sz, env);
      } else if (std::memcmp(progkey, VOTE_KEY.data(), 32) == 0) {
        vote_instr(T, ia, data, ins.data_sz, env);
      } else if (std::memcmp(progkey, STAKE_KEY.data(), 32) == 0) {
        stake_instr(T, ia, data, ins.data_sz, env);
      } else {
        throw Punt{};  // BPF / other builtins: Python lane
      }
    } catch (const Err& e) {
      return fail(e.status, k + 1);
    }
  }

  // commit: writes may only land on accounts the wave generator saw as
  // writable; validate everything before emitting anything
  TxnResult r{TXN_SUCCESS, fee, {}, (u8)d.instr_cnt};
  for (u32 i = 0; i < d.acct_cnt; i++) {
    bool changed = !T.accts[i].same_state(baseline[i]);
    if (changed && !T.writable[i]) return fail(ST_ACCT, d.instr_cnt);
    if (i == 0 || changed) {  // payer writes unconditionally (fee debit)
      Write w;
      w.idx = (u8)i;
      acct_encode(T.accts[i], w.val);
      r.writes.push_back(std::move(w));
    }
  }
  return r;
}

}  // namespace

// -- entry point --------------------------------------------------------------

extern "C" {

// -- slot session (the bank lane's residual Python gate, moved here) ---------
//
// A session persists across fd_exec_batch2 calls within one slot and owns
// what used to be ~5us/txn of Python work per microblock:
//
//   - the status-cache gate: valid recent blockhashes + the (blockhash,
//     signature) pairs already landed on this fork.  A duplicate gets
//     TXN_ERR_ALREADY_PROCESSED (fee 0, no mutation) in-line; a txn whose
//     blockhash is NOT in the valid set PUNTS (it may be a durable-nonce
//     candidate — only the Python lane can resolve that), exactly the
//     fallback the Python gate routed it to.
//   - the account-value overlay: funk values ship ONCE (first touch or
//     after a Python-lane write dirtied them); every later microblock
//     reads the session copy, which the session keeps coherent by
//     applying its own writes.  Python applies the returned writes to
//     funk, so funk and session stay in lock-step; Python-lane writes
//     are synced back via the request's refresh records.

struct Session {
  Overlay ov;
  std::set<std::array<u8, 96>> seen;  // blockhash || first signature
  std::set<Key> valid_bh;
};

// durable_nonce_ok (flamenco/nonce.py): may this stale-blockhash txn run
// as a durable-nonce txn?  First instruction system AdvanceNonceAccount,
// nonce account writable + initialized + stored hash == the txn's
// blockhash, authority among the signers.  Evaluated against the batch's
// working overlay first (earlier txns' writes), then the session's.
// Throws Punt when it cannot decide: malformed descriptor/offsets, or an
// account value that never reached the session (only funk can answer).
static bool durable_ok(const Session* S, const Overlay& work,
                       const TxnIn& in, const Key& bh) {
  Desc d;
  parse_desc(in.desc_bytes, in.desc_sz, d);  // malformed -> Punt
  if (d.instr_cnt == 0) return false;
  const Instr& ins = d.instrs[0];
  if (ins.prog >= d.acct_cnt) return false;
  if ((u64)d.acct_off + 32ull * d.acct_cnt > in.payload_sz) throw Punt{};
  const u8* addrs = in.payload + d.acct_off;
  if (std::memcmp(addrs + 32ull * ins.prog, SYS_KEY.data(), 32) != 0)
    return false;
  if ((u64)ins.data_off + ins.data_sz > in.payload_sz) throw Punt{};
  if (ins.data_sz < 4 || rd32(in.payload + ins.data_off) != 4 ||
      ins.acct_cnt < 1)
    return false;
  if ((u64)ins.acct_off + ins.acct_cnt > in.payload_sz) throw Punt{};
  u8 idx = in.payload[ins.acct_off];
  if (idx >= d.acct_cnt || !is_writable(d, idx)) return false;
  Key nkey;
  std::memcpy(nkey.data(), addrs + 32ull * idx, 32);
  const std::vector<u8>* val;
  auto itw = work.find(nkey);
  if (itw != work.end()) {
    val = &itw->second;
  } else {
    auto its = S->ov.find(nkey);
    if (its == S->ov.end()) throw Punt{};  // value never shipped
    val = &its->second;
  }
  Acct na;
  acct_decode(val->data(), val->size(), na);
  if (na.owner != SYS_KEY) return false;
  u32 state;
  Key auth, nonce;
  nonce_decode(na.data, state, auth, nonce);
  if (state != NONCE_INIT || nonce != bh) return false;
  u32 ns = d.sig_cnt < d.acct_cnt ? d.sig_cnt : d.acct_cnt;
  for (u32 i = 0; i < ns; i++)
    if (std::memcmp(addrs + 32ull * i, auth.data(), 32) == 0) return true;
  return false;
}

void* fd_exec_session_new() { return new (std::nothrow) Session(); }

void fd_exec_session_delete(void* h) { delete static_cast<Session*>(h); }

// Request ('FDX2'): u32 'FDX2' | u32 n_txn | the fixed header (u64
//   lamports_per_sig | u8 clock flag | u64 clock slot | u64 clock epoch |
//   u8 slot-hashes flag | u32 sz | slot-hashes bytes | u8 rbh flag | 32B
//   recent blockhash | u8 rent flag | u64 lamports_per_byte_year | f64
//   exemption threshold), then a gate section
//   u8 gate_on | u32 n_valid_bh | 32B* | u32 n_seen | (32B bh||64B sig)*
//   | u32 n_refresh | (32B key | u32 len | bytes)*
// then n_txn entries of
//   u16 payload_sz | u16 desc_sz | u8 acct_cnt | payload | desc
//   | per-acct: u8 have | [u32 len | bytes]     (have=0: session-known)
// Returns the response length, -1 on a malformed request, -2 when
// resp_cap is too small (the caller retries with a larger buffer).
// Response: u32 'FDXR' | u32 n_done | u8 punted | recs[n_done], each rec
//   i8 status | u64 fee | u8 n_ins | u8 n_w | (u8 acct_idx | u32 len | bytes)*
// (n_ins: TxnResult's count of instructions that charged their cost).
// Gated duplicates emit a record (ST_ALREADY, fee 0, no writes) and count
// as done.
int64_t fd_exec_batch2(void* sh, const uint8_t* req, uint64_t req_sz,
                       uint8_t* resp, uint64_t resp_cap) {
  Session* S = static_cast<Session*>(sh);
  if (!S) return -1;
  const u8* p = req;
  const u8* end = req + req_sz;
  auto have_b = [&](u64 k) { return (u64)(end - p) >= k; };
  if (!have_b(4 + 4 + 8 + 1 + 8 + 8 + 1 + 4)) return -1;
  if (rd32(p) != 0x32584446u) return -1;  // 'FDX2'
  p += 4;
  u32 n_txn = rd32(p); p += 4;
  u64 lps = rd64(p); p += 8;
  VoteEnv env;
  env.have_clock = *p++ != 0;
  env.clock_slot = rd64(p); p += 8;
  env.clock_epoch = rd64(p); p += 8;
  env.sh_present = *p++ != 0;
  u32 sh_sz = rd32(p); p += 4;
  if (!have_b(sh_sz)) return -1;
  SlotHashes slh;
  if (env.sh_present) parse_slot_hashes(p, sh_sz, slh);
  else slh.ok = true;
  p += sh_sz;
  env.sh = &slh;
  if (!have_b(1 + 32 + 1 + 8 + 8)) return -1;
  env.have_rbh = *p++ != 0;
  std::memcpy(env.rbh.data(), p, 32);
  p += 32;
  env.rent_flag = *p++;
  env.rent_lpby = rd64(p);
  p += 8;
  u64 et_bits = rd64(p);
  p += 8;
  std::memcpy(&env.rent_et, &et_bits, 8);

  if (!have_b(1 + 4)) return -1;
  // gate flag: 0 = off, 1 = on + REPLACE the valid-blockhash set from
  // this request, 2 = on + keep the session's current set (the caller
  // versions its blockhash registry and only re-ships on change)
  u8 gate_flag = *p++;
  bool gate_on = gate_flag != 0;
  u32 n_valid = rd32(p); p += 4;
  if (!have_b(32ull * n_valid + 4)) return -1;
  if (gate_flag != 2) S->valid_bh.clear();
  for (u32 k = 0; k < n_valid; k++, p += 32) {
    Key bh;
    std::memcpy(bh.data(), p, 32);
    S->valid_bh.insert(bh);
  }
  u32 n_seen = rd32(p); p += 4;
  if (!have_b(96ull * n_seen + 4)) return -1;
  for (u32 k = 0; k < n_seen; k++, p += 96) {
    std::array<u8, 96> e;
    std::memcpy(e.data(), p, 96);
    S->seen.insert(e);
  }
  u32 n_refresh = rd32(p); p += 4;
  for (u32 k = 0; k < n_refresh; k++) {
    if (!have_b(36)) return -1;
    Key key;
    std::memcpy(key.data(), p, 32);
    u32 vsz = rd32(p + 32);
    p += 36;
    if (!have_b(vsz)) return -1;
    S->ov[key].assign(p, p + vsz);
    p += vsz;
  }

  std::vector<TxnIn> txns;
  txns.reserve(n_txn);
  for (u32 t = 0; t < n_txn; t++) {
    if (!have_b(2 + 2 + 1)) return -1;
    TxnIn in;
    in.ov_only = true;
    in.payload_sz = rd16(p); p += 2;
    in.desc_sz = rd16(p); p += 2;
    in.acct_cnt = *p++;
    if (!have_b(in.payload_sz + in.desc_sz)) return -1;
    in.payload = p; p += in.payload_sz;
    in.desc_bytes = p; p += in.desc_sz;
    for (u32 i = 0; i < in.acct_cnt; i++) {
      if (!have_b(1)) return -1;
      u8 have_val = *p++;
      if (have_val) {
        if (!have_b(4)) return -1;
        u32 vs = rd32(p); p += 4;
        if (!have_b(vs)) return -1;
        // first-touch / dirtied value: merge into the session overlay
        // NOW (valid regardless of the txn's later outcome: this is the
        // current funk state, not a speculative write)
        if (in.desc_sz >= 17) {
          u32 aoff = rd16(in.desc_bytes + 9);
          if ((u64)aoff + 32ull * (i + 1) <= in.payload_sz) {
            Key key;
            std::memcpy(key.data(), in.payload + aoff + 32ull * i, 32);
            S->ov[key].assign(p, p + vs);
          }
        }
        p += vs;
      }
    }
    txns.push_back(std::move(in));
  }
  if (p != end) return -1;

  // Execute against a LOCAL working overlay (lazily seeded from the
  // session's) and commit to the session only after the response
  // serialized: a RespFull retry (-2) must see the pre-call state, or
  // the resent batch would double-apply every transfer.
  Overlay work;
  std::set<std::array<u8, 96>> landed;
  std::vector<TxnResult> recs;
  std::vector<const TxnIn*> rec_in;
  recs.reserve(n_txn);
  bool punted = false;
  for (u32 t = 0; t < n_txn && !punted; t++) {
    const TxnIn& in = txns[t];
    std::array<u8, 96> bhsig;
    bool have_key = false;
    bool durable = false;
    if (gate_on) {
      // slice blockhash + first signature straight from the payload
      // via the descriptor offsets; anything out of range punts to
      // the Python lane's structural checks
      if (in.desc_sz < 17) { punted = true; break; }
      u32 sig_off = rd16(in.desc_bytes + 2);
      u32 bh_off = rd16(in.desc_bytes + 11);
      if ((u64)sig_off + 64 > in.payload_sz ||
          (u64)bh_off + 32 > in.payload_sz) {
        punted = true;
        break;
      }
      std::memcpy(bhsig.data(), in.payload + bh_off, 32);
      std::memcpy(bhsig.data() + 32, in.payload + sig_off, 64);
      have_key = true;
      Key bh;
      std::memcpy(bh.data(), bhsig.data(), 32);
      if (!S->valid_bh.count(bh)) {
        // stale/unknown blockhash: run the durable-nonce gate in-line
        // (the check the Python gate used to own).  Not durable ->
        // TXN_ERR_BLOCKHASH, no fee, no footprint, batch continues;
        // undecidable here -> punt, the Python lane resolves it
        bool ok;
        try {
          ok = durable_ok(S, work, in, bh);
        } catch (const Punt&) {
          punted = true;
          break;
        }
        if (!ok) {
          recs.push_back(TxnResult{ST_BLOCKHASH, 0, {}});
          rec_in.push_back(&in);
          continue;
        }
        durable = true;
      }
      if (S->seen.count(bhsig) || landed.count(bhsig)) {
        recs.push_back(TxnResult{ST_ALREADY, 0, {}});
        rec_in.push_back(&in);
        continue;
      }
    }
    // seed the working overlay with the session's view of this txn's
    // accounts (copy-on-touch: only accounts the batch reaches copy)
    if (in.desc_sz >= 17) {
      u32 aoff = rd16(in.desc_bytes + 9);
      if ((u64)aoff + 32ull * in.acct_cnt <= in.payload_sz) {
        for (u32 i = 0; i < in.acct_cnt; i++) {
          Key k;
          std::memcpy(k.data(), in.payload + aoff + 32ull * i, 32);
          if (!work.count(k)) {
            auto it = S->ov.find(k);
            if (it != S->ov.end()) work[k] = it->second;
          }
        }
      }
    }
    TxnResult r;
    try {
      r = execute_txn(in, work, lps, env, durable);
    } catch (const Punt&) {
      punted = true;
      break;
    }
    if (gate_on && have_key && r.fee > 0) landed.insert(bhsig);
    // apply writes to the working overlay (later txns read them)
    const u8* addrs = in.payload + rd16(in.desc_bytes + 9);
    for (auto& wr_ : r.writes) {
      Key k;
      std::memcpy(k.data(), addrs + 32ull * wr_.idx, 32);
      work[k] = wr_.val;
    }
    recs.push_back(std::move(r));
    rec_in.push_back(&in);
  }

  Wr w{resp, resp_cap, 0};
  try {
    w.put32(0x52584446u);  // 'FDXR'
    w.put32((u32)recs.size());
    w.put8(punted ? 1 : 0);
    for (size_t t = 0; t < recs.size(); t++) {
      const TxnResult& r = recs[t];
      w.put8((u8)(int8_t)r.status);
      w.put64(r.fee);
      w.put8(r.n_ins);
      w.put8((u8)r.writes.size());
      for (auto& wr_ : r.writes) {
        w.put8(wr_.idx);
        w.put32((u32)wr_.val.size());
        w.bytes(wr_.val.data(), wr_.val.size());
      }
      (void)rec_in[t];
    }
  } catch (const RespFull&) {
    return -2;  // session untouched: the retry re-runs identically
  }
  // response fully serialized: commit the batch to the session
  for (auto& kv : work) S->ov[kv.first] = std::move(kv.second);
  for (auto& e : landed) S->seen.insert(e);
  return (int64_t)w.i;
}

}  // extern "C"
