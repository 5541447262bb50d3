// Native bank stage: microblock drain -> session exec -> entry publish in
// one crossing.  The port's copy of the JAX package's native/fd_bank.cpp,
// its native funk plane included (see "The native funk plane" below).
//
// The sweep-harness client for runtime/bank.BankStage: fdb_frag_cb
// consumes a pack microblock frame, builds an fd_exec_batch2 ('FDX2')
// request against the long-lived exec session owned by
// flamenco/runtime.SlotExecution, executes it through a function pointer
// into the port's fd_exec_native library (the runtime logic stays in one
// native module), and publishes the entry frame + per-microblock done
// frame through the port's fd_ring function pointers — zero Python per
// frag on the eligible path.
//
// The PUNT protocol is preserved byte-for-byte.  fd_exec_batch2 stops
// BEFORE mutating on anything it cannot replicate (unknown program, ALT
// descriptor, account value the session was never shipped, bigint
// arithmetic) and commits the batch's completed prefix; this client then
// STASHES the microblock — raw frame + the prefix's result records —
// into a result log that Python drains in arrival order from
// BankStage.before_credit.  The Python lane applies the prefix, resumes
// the tail through SlotExecution.execute_batch (which re-ships account
// values and re-arms the session), and publishes the entry itself.
// While a stash is pending every later frag is stashed too, so
// microblock order — and therefore PoH mixin order — is exactly the
// single-lane order.
//
// Requests are built with zero have-flags (gate_flag=2: keep the session
// valid set): the session's overlay is the ONLY account source, and an
// overlay miss is a Punt by construction (ov_only).  Cold accounts
// therefore punt exactly once — the Python resume ships their values —
// and the steady state is all-native.  Fully-native results still reach
// Python through the same log (published=1 groups) for result accounting.
//
// The native funk plane (fdb_stage_set_funk): when the slot's store is
// the shm record map (native/fd_funk.cpp), the committed records go
// straight into the slot's fork inside this crossing, through function
// pointers into the port's fd_funk library (ffk_txn_slot resolves the
// fork once a group, ffk_rec_insert_slot upserts a record), and the log
// carries payload-stripped records (n_w = 0).  A group whose insert fails
// (the fork frozen or unknown, the map full) logs its full records
// instead and counts in funk_falls: upserts are idempotent, so Python's
// re-apply overwrites a partial C write, and a record's compute units
// come from its n_ins, not from the state.  Unarmed, every record
// reaches funk through the log.
//
// Log group wire format (drained via fdb_log_ptr + the zero-FFI counter
// tail; see runtime/bank_native.py):
//   u64 mb_seq | u64 tsorig | u64 lat_ns | u32 n_done | u8 published |
//   u32 mb_sz | recs[n_done] | mb_raw[mb_sz]
// where each rec is the FDXR record verbatim:
//   i8 status | u64 fee | u8 n_ins | u8 n_w | (u8 acct_idx | u32 len | bytes)*
// published: 1 = entry+done frames already on the rings (Python applies
// state only); 2 = entry out but done deferred (Python publishes done);
// 0 = nothing published (Python resumes from txn n_done and publishes).
//
// The metrics plane (fdb_stage_set_metrics) brackets the apply and
// publish phases into the plane fdr_sweep carries, and observes each
// txn's commit latency into the stage's nbank_txn_lat_ns histogram.
//
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include "fd_metrics.h"

namespace {

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int8_t i8;
typedef int64_t i64;

// ---------------------------------------------------------------------------
// SHA-256 (PoH mixin = sha256 of the landed signatures) -- FIPS 180-4,
// scalar only: one short hash per microblock is nowhere near the merkle
// tree's budget, so no SHA-NI dispatch here.

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

struct Sha256 {
  u32 h[8];
  u8 buf[64];
  u64 len;
  Sha256() {
    std::memcpy(h, H256, sizeof(h));
    len = 0;
  }
  void block(const u8* p) {
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
// Cross-module function-pointer contracts (the port's fd_ring and
// fd_exec_native libraries).

typedef int (*fdr_try_publish_t)(const void* link, void* prod,
                                 const u8* payload, u64 sz, u64 sig,
                                 u64 tsorig);
typedef u64 (*fdr_refresh_credits_t)(const void* link, void* prod);
typedef i64 (*fd_exec_batch2_t)(void* sh, const u8* req, u64 req_sz,
                                u8* resp, u64 resp_cap);
// the port's fd_funk library: committed records go DIRECTLY into the shm
// record map inside this crossing — the txn index resolves once per group
// (the xid is the slot's funk fork), then each write is one slot-direct
// upsert
typedef int32_t (*ffk_txn_slot_t)(void* h, const u8* xid, int32_t xlen);
typedef int32_t (*ffk_rec_insert_slot_t)(void* h, int32_t ti, const u8* key,
                                         int32_t klen, const u8* val,
                                         int32_t vlen);
static inline u16 rd16(const u8* p) { return (u16)(p[0] | (p[1] << 8)); }
static inline u32 rd32(const u8* p) {
  return (u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) | ((u32)p[3] << 24);
}
static inline void wr16(u8* p, u16 v) { p[0] = (u8)v; p[1] = (u8)(v >> 8); }
static inline void wr32(u8* p, u32 v) {
  p[0] = (u8)v; p[1] = (u8)(v >> 8); p[2] = (u8)(v >> 16); p[3] = (u8)(v >> 24);
}
static inline void wr64(u8* p, u64 v) {
  for (int i = 0; i < 8; i++) p[i] = (u8)(v >> (8 * i));
}

static inline u64 now_ns(void) {
  // matches tango/shm.now_ns (time.monotonic_ns) for commit latency math
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (u64)ts.tv_sec * 1000000000ull + (u64)ts.tv_nsec;
}

static const u32 REQ2_MAGIC = 0x32584446u;   // 'FDX2'
static const u32 RESP_MAGIC = 0x52584446u;   // 'FDXR'

struct FragRef {  // one parsed microblock txn (borrowed from the frag payload)
  const u8* frag;
  u64 len;      // payload + desc + u16 trailer
  u64 psz;      // payload size (trailer value)
};

struct BankStageCtx {
  void* session;              // SlotExecution's fd_exec session (borrowed)
  fd_exec_batch2_t batch2;
  // out 0: entry frames -> poh; out 1: done frames -> pack (fd_ring
  // opaque structs owned by tango/native.py's NativeProducer)
  const void* ent_link;
  void* ent_prod;
  const void* done_link;
  void* done_prod;
  fdr_try_publish_t publish;
  fdr_refresh_credits_t refresh;
  u64 bank_idx;               // done-frame sig (mirrors BankStage.bank_idx)
  // fixed FDX2 prefix from Python: env blob (lps..rent) + the
  // steady-state gate section (gate_flag=2 keep / 0 off, zero counts)
  u8* hdr;
  u64 hdr_sz;
  u8* req;  u64 req_cap;
  u8* resp; u64 resp_cap;
  u8* ent;  u64 ent_cap;      // entry-frame build buffer
  FragRef* refs; u64 refs_cap;
  u8* log;  u64 log_cap;
  // shm metrics plane (fdb_stage_set_metrics; null = dark): the SAME
  // plane fdr_sweep carries, so apply/publish brackets here land in
  // that crossing's fdm_sweep_end phase decomposition
  fdm_plane* mplane;
  // native funk plane (fdb_stage_set_funk; null = disarmed): committed
  // records write straight into the shm map and the log carries
  // payload-stripped records
  void* funk;
  ffk_txn_slot_t funk_slot;
  ffk_rec_insert_slot_t funk_insert;
  u64 funk_xid_len;
  u8 funk_xid[128];           // FFK_XID_MAX
  u8* fkrecs; u64 fkrecs_cap; // stripped-record scratch
  // flags + counters Python reads off the struct (no FFI);
  // fdb_stage_flags_off pins this offset
  u64 log_sz;
  u64 stash_pending;  // a published<1 group awaits the Python drain
  u64 mb_seen, mb_native, mb_stashed, txn_native, credit_waits;
  u64 mb_dropped;  // log arena OOM before anything committed (never-path)
  u64 funk_writes;  // txns whose records went into the native map in-crossing
  u64 funk_falls;   // groups that fell back to full-value logging
};

static int ensure_cap(u8** buf, u64* cap, u64 need) {
  if (need <= *cap) return 1;
  u64 ncap = *cap ? *cap : 4096;
  while (ncap < need) ncap *= 2;
  u8* nb = (u8*)std::realloc(*buf, ncap);
  if (!nb) return 0;
  *buf = nb;
  *cap = ncap;
  return 1;
}

// Append one group to the result log.  recs/mb are copied.  Callers on
// the post-commit path pre-reserve capacity (the session commit is
// irreversible, so logging its records must not be able to fail); the
// pre-commit callers treat a 0 return as "stash the raw frame instead".
static int log_group(BankStageCtx* st, u64 mb_seq, u64 tsorig, u64 lat_ns,
                     u32 n_done, u8 published, const u8* recs, u64 recs_sz,
                     const u8* mb, u64 mb_sz) {
  u64 need = st->log_sz + 33 + recs_sz + mb_sz;
  if (!ensure_cap(&st->log, &st->log_cap, need)) return 0;
  u8* p = st->log + st->log_sz;
  wr64(p, mb_seq);
  wr64(p + 8, tsorig);
  wr64(p + 16, lat_ns);
  wr32(p + 24, n_done);
  p[28] = published;
  wr32(p + 29, (u32)mb_sz);
  if (recs_sz) std::memcpy(p + 33, recs, recs_sz);
  if (mb_sz) std::memcpy(p + 33 + recs_sz, mb, mb_sz);
  st->log_sz = need;
  // any not-fully-published group freezes the native path until Python
  // drains: entry AND done frames stay in single-lane ring order
  if (published != 1) st->stash_pending = 1;
  return 1;
}

static int stash_raw(BankStageCtx* st, u64 mb_seq, u64 tsorig, const u8* mb,
                     u64 mb_sz) {
  st->mb_stashed++;
  return log_group(st, mb_seq, tsorig, 0, 0, 0, nullptr, 0, mb, mb_sz);
}

}  // namespace

extern "C" {

void* fdb_stage_new(void* session, void* batch2_fn, const void* ent_link,
                    void* ent_prod, const void* done_link, void* done_prod,
                    void* publish_fn, void* refresh_fn, u64 bank_idx,
                    const u8* hdr, u64 hdr_sz) {
  BankStageCtx* st = (BankStageCtx*)std::calloc(1, sizeof(BankStageCtx));
  if (!st) return nullptr;
  st->session = session;
  st->batch2 = (fd_exec_batch2_t)batch2_fn;
  st->ent_link = ent_link;
  st->ent_prod = ent_prod;
  st->done_link = done_link;
  st->done_prod = done_prod;
  st->publish = (fdr_try_publish_t)publish_fn;
  st->refresh = (fdr_refresh_credits_t)refresh_fn;
  st->bank_idx = bank_idx;
  st->hdr = (u8*)std::malloc(hdr_sz ? hdr_sz : 1);
  if (!st->hdr) { std::free(st); return nullptr; }
  std::memcpy(st->hdr, hdr, hdr_sz);
  st->hdr_sz = hdr_sz;
  st->resp_cap = 1 << 16;
  st->resp = (u8*)std::malloc(st->resp_cap);
  if (!st->resp) { std::free(st->hdr); std::free(st); return nullptr; }
  return st;
}

// offsetof(log_sz): Python reads the flag+counter tail of the struct
// through a zero-FFI memory view — this export pins the layout so the
// view can never silently drift from the C struct.
u64 fdb_stage_flags_off(void) {
  return (u64)__builtin_offsetof(BankStageCtx, log_sz);
}

void fdb_stage_delete(void* p) {
  BankStageCtx* st = (BankStageCtx*)p;
  if (!st) return;
  std::free(st->hdr);
  std::free(st->req);
  std::free(st->resp);
  std::free(st->ent);
  std::free(st->refs);
  std::free(st->log);
  std::free(st->fkrecs);
  std::free(st);
}

// Arm/re-arm (or disarm: funk == NULL) the native funk plane.  Called at
// arm time and wherever the slot's xid or env header changes — the xid
// is the slot's funk fork.  The fn pointers come from the port's fd_funk
// library (cross-library linking by address, the fd_exec_batch2
// precedent).  Returns 0 on hard error (xid too long), 1 armed, 2 armed
// but the xid does not resolve yet (groups then log full records until
// it does).
int fdb_stage_set_funk(void* p, void* funk, void* slot_fn, void* insert_fn,
                       const u8* xid, u64 xid_len) {
  BankStageCtx* st = (BankStageCtx*)p;
  if (!funk || !xid_len) {
    st->funk = nullptr;
    st->funk_xid_len = 0;
    return 1;
  }
  if (xid_len > sizeof(st->funk_xid)) return 0;
  st->funk = funk;
  st->funk_slot = (ffk_txn_slot_t)slot_fn;
  st->funk_insert = (ffk_rec_insert_slot_t)insert_fn;
  std::memcpy(st->funk_xid, xid, xid_len);
  st->funk_xid_len = xid_len;
  return st->funk_slot(st->funk, st->funk_xid, (int32_t)xid_len) >= 0 ? 1 : 2;
}

// Arm/disarm the shm metrics plane.  The pointer is the
// stage's own fdm_plane — the one its SweepDrainer already passes to
// fdr_sweep — so the apply/publish accumulators bracketed below fold
// into the same crossing's phase histograms.
void fdb_stage_set_metrics(void* p, fdm_plane* plane) {
  ((BankStageCtx*)p)->mplane = plane;
}

// The env/gate prefix changes when Python re-arms the session (slot
// roll: new clock + recent blockhash).
int fdb_stage_set_hdr(void* p, const u8* hdr, u64 hdr_sz) {
  BankStageCtx* st = (BankStageCtx*)p;
  if (!ensure_cap(&st->hdr, &st->hdr_sz, hdr_sz)) return 0;
  std::memcpy(st->hdr, hdr, hdr_sz);
  st->hdr_sz = hdr_sz;
  return 1;
}

const u8* fdb_log_ptr(void* p) { return ((BankStageCtx*)p)->log; }

// Python calls this after a FULL drain (state applied, stashes resumed,
// session re-synced): un-stalls the native path.
void fdb_log_clear(void* p) {
  BankStageCtx* st = (BankStageCtx*)p;
  st->log_sz = 0;
  st->stash_pending = 0;
}

// The sweep-harness frag callback (resolved by ADDRESS for fdr_sweep —
// never called from Python).  meta8 row: seq, sig, off, sz, ctl,
// tsorig, tspub, in_idx.  Returns 0 to keep sweeping, -1 to stop the
// sweep after this frag (stash appended; Python drains before the next
// sweep touches the ring).
int fdb_frag_cb(void* vctx, const u64* meta8, const u8* payload) {
  BankStageCtx* st = (BankStageCtx*)vctx;
  u64 mb_seq = meta8[1];
  u64 sz = meta8[3];
  u64 tsorig = meta8[5];
  st->mb_seen++;

  // reserve stash room up front: past this point any bail-out can log
  // the raw frame, so a consumed frag is never lost
  if (!ensure_cap(&st->log, &st->log_cap, st->log_sz + 33 + sz)) {
    st->mb_dropped++;
    st->stash_pending = 1;  // freeze; Python sees the counter jump
    return -1;
  }

  // a pending stash freezes the native path: later microblocks queue
  // behind it in the log so PoH mixin order stays single-lane
  if (st->stash_pending) {
    stash_raw(st, mb_seq, tsorig, payload, sz);
    return -1;
  }
  // credit-gate BEFORE executing: the session commit is irreversible,
  // so never run a batch whose entry/done frames can't be published
  if (st->refresh(st->ent_link, st->ent_prod) < 1 ||
      st->refresh(st->done_link, st->done_prod) < 1) {
    st->credit_waits++;
    stash_raw(st, mb_seq, tsorig, payload, sz);
    return -1;
  }

  // parse the microblock frame: u32 seq | u16 cnt | (u16 len | frag)*
  // where frag = payload || packed desc || u16 payload_sz trailer
  if (sz < 6) { stash_raw(st, mb_seq, tsorig, payload, sz); return -1; }
  u32 cnt = rd16(payload + 4);
  if (!ensure_cap((u8**)&st->refs, &st->refs_cap,
                  (u64)(cnt ? cnt : 1) * sizeof(FragRef))) {
    stash_raw(st, mb_seq, tsorig, payload, sz);
    return -1;
  }
  u64 off = 6;
  u64 req_bound = 9 + st->hdr_sz;
  for (u32 i = 0; i < cnt; i++) {
    if (off + 2 > sz) { stash_raw(st, mb_seq, tsorig, payload, sz); return -1; }
    u64 flen = rd16(payload + off);
    off += 2;
    if (off + flen > sz || flen < 19) {
      stash_raw(st, mb_seq, tsorig, payload, sz);
      return -1;
    }
    const u8* frag = payload + off;
    u64 psz = rd16(frag + flen - 2);
    if (psz + 2 > flen || flen - 2 - psz < 17) {
      stash_raw(st, mb_seq, tsorig, payload, sz);
      return -1;
    }
    st->refs[i].frag = frag;
    st->refs[i].len = flen;
    st->refs[i].psz = psz;
    // 5-byte txn head + payload + desc + acct_cnt have-flags (all 0)
    req_bound += 5 + (flen - 2) + frag[psz + 8];
    off += flen;
  }
  if (cnt == 0 || off != sz) {
    // empty or trailing garbage: the Python lane raises/handles the
    // same frame identically, keeping the lanes behaviorally equal
    stash_raw(st, mb_seq, tsorig, payload, sz);
    return -1;
  }

  // build the FDX2 request: magic | n_txn | env+gate prefix | txns
  if (!ensure_cap(&st->req, &st->req_cap, req_bound)) {
    stash_raw(st, mb_seq, tsorig, payload, sz);
    return -1;
  }
  u8* q = st->req;
  wr32(q, REQ2_MAGIC);
  wr32(q + 4, cnt);
  std::memcpy(q + 8, st->hdr, st->hdr_sz);
  q += 8 + st->hdr_sz;
  for (u32 i = 0; i < cnt; i++) {
    const FragRef& r = st->refs[i];
    u64 dsz = r.len - 2 - r.psz;
    u8 acct_cnt = r.frag[r.psz + 8];
    wr16(q, (u16)r.psz);
    wr16(q + 2, (u16)dsz);
    q[4] = acct_cnt;
    std::memcpy(q + 5, r.frag, r.psz + dsz);  // payload then desc, contiguous
    q += 5 + r.psz + dsz;
    std::memset(q, 0, acct_cnt);  // have=0: session overlay only (ov_only)
    q += acct_cnt;
  }
  u64 req_sz = (u64)(q - st->req);

  // the session commit is irreversible: reserve log room for the worst
  // case (full response + raw frame) BEFORE executing, so the records
  // always reach Python.  rc == -2 leaves the session untouched, so the
  // grow loop can still bail to the raw-stash path safely.
  i64 rc;
  for (;;) {
    if (!ensure_cap(&st->log, &st->log_cap,
                    st->log_sz + 33 + st->resp_cap + sz)) {
      stash_raw(st, mb_seq, tsorig, payload, sz);
      return -1;
    }
    rc = st->batch2(st->session, st->req, req_sz, st->resp, st->resp_cap);
    if (rc != -2) break;
    if (st->resp_cap >= (1u << 28) ||
        !ensure_cap(&st->resp, &st->resp_cap, st->resp_cap * 4)) {
      stash_raw(st, mb_seq, tsorig, payload, sz);
      return -1;
    }
  }
  if (rc < 0) {
    // malformed request: nothing committed (batch2 parses everything
    // before executing) — the Python lane takes the whole microblock
    stash_raw(st, mb_seq, tsorig, payload, sz);
    return -1;
  }

  // parse the FDXR response; the session has already committed these
  // records, so from here every path MUST log them (capacity for
  // 33 + resp + frame is reserved above — log_group cannot fail)
  const u8* rp = st->resp;
  u64 rsz = (u64)rc;
  if (rsz > st->resp_cap) rsz = st->resp_cap;  // contract, belt anyway
  if (rsz < 9 || rd32(rp) != RESP_MAGIC) {
    stash_raw(st, mb_seq, tsorig, payload, sz);  // can't happen; stay safe
    return -1;
  }
  u32 n_done = rd32(rp + 4);
  u8 punted = rp[8];
  if (n_done > cnt) n_done = cnt;
  const u8* recs = rp + 9;
  u64 recs_sz = 0;
  u32 n_landed = 0;
  u64 ent_sz = 34;  // 32B mixin + u16 cnt
  {
    const u8* w = recs;
    for (u32 t = 0; t < n_done; t++) {
      if ((u64)(w - rp) + 11 > rsz) { n_done = t; break; }
      u64 fee = 0;
      for (int i = 0; i < 8; i++) fee |= (u64)w[1 + i] << (8 * i);
      u8 n_w = w[10];
      w += 11;
      for (u8 j = 0; j < n_w; j++) {
        if ((u64)(w - rp) + 5 > rsz) { n_w = 0; break; }
        w += 5 + rd32(w + 1);
      }
      if ((u64)(w - rp) > rsz) { n_done = t; break; }
      if (fee > 0) {
        n_landed++;
        ent_sz += 2 + st->refs[t].psz;
      }
    }
    recs_sz = (u64)(w - recs);
    if (recs_sz > rsz - 9) recs_sz = rsz - 9;
  }
  u64 lat_ns = now_ns() - tsorig;
  st->txn_native += n_done;
  // per-txn commit latency, stamped in-crossing: every txn in the
  // microblock commits atomically with it, so each gets the group's
  // latency — a per-txn-weighted distribution (nbank_txn_lat_ns)
  if (st->mplane && (st->mplane->flags & FDM_F_XLAT) && tsorig)
    for (u32 t = 0; t < n_done; t++)
      fdm_hist_obs(st->mplane->met, &st->mplane->xlat, (double)lat_ns);

  // native funk plane: the session has committed these records, so put
  // them straight into the shm map NOW (slot-direct upserts) and log a
  // payload-stripped record stream (n_w=0) — the Python drain shrinks
  // to result accounting.  Any insert failure falls back to the full
  // log for the whole group: upserts are idempotent, so a partial C
  // write is safely overwritten by the Python re-apply.
  const u8* lrecs = recs;
  u64 lrecs_sz = recs_sz;
  if (st->funk && n_done) {
    u64 t_apply = st->mplane ? fdm_now_ns() : 0;
    int32_t ti = st->funk_slot(st->funk, st->funk_xid,
                               (int32_t)st->funk_xid_len);
    int ok = ti >= 0 &&
             ensure_cap(&st->fkrecs, &st->fkrecs_cap, (u64)n_done * 11);
    if (ok) {
      u8* o = st->fkrecs;
      const u8* w = recs;
      for (u32 t = 0; t < n_done; t++) {
        u8 n_w = w[10];
        std::memcpy(o, w, 11);
        o[10] = 0;  // values live in the shm map, not the log
        o += 11;
        w += 11;
        const FragRef& r = st->refs[t];
        const u8* desc = r.frag + r.psz;
        u64 acct_off = rd16(desc + 9);  // in-bounds: batch2 gated the desc
        for (u8 j = 0; j < n_w; j++) {
          u32 vlen = rd32(w + 1);
          if (ok && st->funk_insert(st->funk, ti,
                                    r.frag + acct_off + 32u * (u64)w[0], 32,
                                    w + 5, (int32_t)vlen) != 0)
            ok = 0;  // keep walking: the stripped stream must stay aligned
          w += 5 + vlen;
        }
      }
    }
    if (ok) {
      lrecs = st->fkrecs;
      lrecs_sz = (u64)n_done * 11;
      st->funk_writes += n_done;
    } else {
      st->funk_falls++;
    }
    if (st->mplane)
      fdm_accum(st->mplane, FDM_PH_APPLY, fdm_now_ns() - t_apply);
  }

  if (punted || n_done < cnt) {
    // PUNT: the committed prefix rides in the log; Python applies it
    // and resumes the tail in order through SlotExecution.execute_batch
    st->mb_stashed++;
    log_group(st, mb_seq, tsorig, lat_ns, n_done, 0, lrecs, lrecs_sz,
              payload, sz);
    return -1;
  }

  // fully native: entry frame (landed txns only, PoH mixin = sha256 of
  // their signatures in order) + the always-published done frame —
  // byte-for-byte runtime/bank.BankStage.after_frag
  u8 published = 1;
  if (n_landed) {
    if (!ensure_cap(&st->ent, &st->ent_cap, ent_sz)) {
      st->mb_stashed++;
      log_group(st, mb_seq, tsorig, lat_ns, n_done, 0, lrecs, lrecs_sz,
                payload, sz);
      return -1;
    }
    Sha256 hx;
    u8* e = st->ent + 34;
    const u8* w = recs;
    for (u32 t = 0; t < n_done; t++) {
      u64 fee = 0;
      for (int i = 0; i < 8; i++) fee |= (u64)w[1 + i] << (8 * i);
      u8 n_w = w[10];
      w += 11;
      for (u8 j = 0; j < n_w; j++) w += 5 + rd32(w + 1);
      if (fee == 0) continue;
      const FragRef& r = st->refs[t];
      const u8* desc = r.frag + r.psz;
      u64 sig_off = rd16(desc + 2);
      hx.update(r.frag + sig_off, 64);  // in-bounds: batch2 gated sig_off
      wr16(e, (u16)r.psz);
      std::memcpy(e + 2, r.frag, r.psz);
      e += 2 + r.psz;
    }
    hx.final(st->ent);
    wr16(st->ent + 32, (u16)n_landed);
    u64 t_pub = st->mplane ? fdm_now_ns() : 0;
    int ent_ok = st->publish(st->ent_link, st->ent_prod, st->ent, ent_sz,
                             mb_seq, tsorig);
    if (st->mplane)
      fdm_accum(st->mplane, FDM_PH_PUBLISH, fdm_now_ns() - t_pub);
    if (!ent_ok) {
      // credits were pre-gated, so this is an out-mtu mismatch: fall
      // back to Python for the publish half (state is already committed
      // session-side; the n_done records carry it across)
      st->mb_stashed++;
      log_group(st, mb_seq, tsorig, lat_ns, n_done, 0, lrecs, lrecs_sz,
                payload, sz);
      return -1;
    }
  }
  static const u8 kEmpty = 0;  // 0-byte done frame: non-null for memcpy
  u64 t_done = st->mplane ? fdm_now_ns() : 0;
  int done_ok = st->publish(st->done_link, st->done_prod, &kEmpty, 0,
                            st->bank_idx, 0);
  if (st->mplane)
    fdm_accum(st->mplane, FDM_PH_PUBLISH, fdm_now_ns() - t_done);
  if (!done_ok) {
    published = 2;  // entry is out; Python publishes only the done frame
  }
  st->mb_native++;
  log_group(st, mb_seq, tsorig, lat_ns, n_done, published, lrecs, lrecs_sz,
            payload, sz);
  return published == 1 ? 0 : -1;
}

}  // extern "C"
