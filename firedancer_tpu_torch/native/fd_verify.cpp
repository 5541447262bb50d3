// Native verify-stage sweep client: the verify tile's HOST orchestration
// with zero Python per frag.  The port's copy of the JAX package's
// native/fd_verify.cpp, unchanged below this header.
//
// A client of the generic sweep harness (the port's fd_ring.cpp fdr_sweep;
// the shredder and the bank stage are the others): a registered verify
// stage's whole intake sweep — shard filter, txn parse (through a function
// pointer into the port's fd_txn_parse library: one parser
// implementation), the tiny per-stage tcache dedup guard, the msg-length /
// batch-fit guards, and fixed-shape batch assembly into reusable slot
// buffers — runs inside ONE FFI crossing.  Python's per-batch work shrinks
// to dispatching K1 over a sealed slot's numpy views and publishing the
// reaped frames (fdr_publish_burst straight out of the slot's
// preassembled frame arena: payload || packed-descriptor || u16 len, the
// verified-frag wire framing, built HERE so the emit path never touches
// frame bytes in Python).
//
// Slot ring = the async in-flight window: slots are acquired, sealed,
// dispatched and released in cyclic order, so batch submission and
// reaping stay in order by construction (the wiredancer discipline).
// When every slot is busy the intake stashes a bounded FIFO of frags
// and stops the sweep (cb < 0) — verify backpressures instead of
// dropping; only a dead/wedged consumer can overflow the stash, and
// those drops are counted.
//
// Semantics parity with runtime/verify.py's _guard/_accumulate is the
// contract (tests/test_torch_verify_native.py stream-diffs the lanes):
// guards run in the same order (parse -> tcache -> msg-len -> fit),
// the tcache matches tango/rings.TCache (depth-16 ring, tag 0 never
// dedups), a txn's elements always land in one batch, and a txn that
// does not fit the open batch seals it and opens the next.
//
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

typedef int64_t (*fdv_parse_fn)(const uint8_t*, uint64_t, uint8_t*, uint64_t);

constexpr uint64_t TXN_MTU = 1232;
constexpr uint64_t DESC_CAP = 2048;  // packed desc max is 1863 bytes
constexpr uint64_t FRAME_CAP = TXN_MTU + DESC_CAP + 2;
constexpr int TC_DEPTH = 16;  // runtime/verify.VERIFY_TCACHE_DEPTH
constexpr int STASH_CAP = 8;

enum { SLOT_FREE = 0, SLOT_OPEN = 1, SLOT_SEALED = 2, SLOT_INFLIGHT = 3 };

// one row per slot, viewed zero-FFI from Python (u64 x 4)
struct fdv_slot_meta {
  uint64_t state;
  uint64_t n_elems;
  uint64_t n_txn;
  uint64_t arena_off;
};

struct fdv_slot {
  uint8_t* msg;      // batch x mml, row-major (elem e at msg + e*mml)
  int32_t* ln;       // batch
  uint8_t* sig;      // batch x 64
  uint8_t* pk;       // batch x 32
  uint64_t* frames;  // batch x 4: (arena off, sz, sig_tag, tsorig) —
                     // fdr_publish_burst's frame-table format verbatim
  uint32_t* ranges;  // batch x 2: element [start, end) per txn
  uint8_t* arena;    // frame bytes (payload || packed || u16 payload_sz)
};

struct fdv_stash_ent {
  uint64_t sz;
  uint64_t tsorig;
  uint8_t buf[TXN_MTU];
};

struct fdv_stage {
  uint64_t shard_idx, shard_cnt, batch, mml, n_slots;
  fdv_parse_fn parse;
  uint64_t tc_ring[TC_DEPTH];
  uint64_t tc_oldest;
  fdv_slot* slots;
  fdv_slot_meta* meta;
  int64_t open;        // open slot index, -1 = none
  uint64_t next_open;  // cyclic acquire cursor (dispatch order)
  fdv_stash_ent stash[STASH_CAP];
  uint64_t stash_head, stash_n;
  uint8_t desc[DESC_CAP];
  // tail: flags + open_elems + counters, contiguous u64s for the
  // Python view — keep declaration order in sync with
  // runtime/verify_native._COUNTERS
  uint64_t flags;       // bit0: stash nonempty
  uint64_t open_elems;  // elements in the open slot (deadline probe:
                        // Python reads ONE word per loop iteration)
  uint64_t c_filtered, c_frags_in, c_parse_fail, c_dedup_dup,
      c_msg_too_long, c_too_many_sigs, c_txn_in, c_elems_in,
      c_intake_dropped, c_sealed_batches;
};

inline void set_flags(fdv_stage* s) {
  // bit0: stash nonempty; bit1: intake has room (the sweep gate Python
  // reads as ONE word instead of scanning the slot table per iteration)
  bool room = s->open >= 0 && s->meta[s->open].n_elems < s->batch;
  if (!room) {
    for (uint64_t i = 0; i < s->n_slots; i++) {
      if (s->meta[i].state == SLOT_FREE) {
        room = true;
        break;
      }
    }
  }
  s->flags = (s->stash_n ? 1u : 0u) | ((!s->stash_n && room) ? 2u : 0u);
  s->open_elems = s->open >= 0 ? s->meta[s->open].n_elems : 0;
}

bool acquire_open(fdv_stage* s) {
  fdv_slot_meta* m = &s->meta[s->next_open];
  if (m->state != SLOT_FREE) return false;
  m->state = SLOT_OPEN;
  m->n_elems = 0;
  m->n_txn = 0;
  m->arena_off = 0;
  s->open = (int64_t)s->next_open;
  s->next_open = (s->next_open + 1) % s->n_slots;
  return true;
}

void seal_open(fdv_stage* s) {
  if (s->open < 0) return;
  fdv_slot_meta* m = &s->meta[s->open];
  if (!m->n_txn) return;  // nothing accumulated: stay open
  m->state = SLOT_SEALED;
  s->open = -1;
  s->c_sealed_batches++;
}

// one txn through the guards + batch assembly; 0 = handled (accepted or
// counted drop), 1 = no slot room (caller stashes, order preserved)
int ingest(fdv_stage* s, const uint8_t* payload, uint64_t sz,
           uint64_t tsorig) {
  if (sz > TXN_MTU) {  // parser would reject; bound the stash/arena copy
    s->c_parse_fail++;
    return 0;
  }
  int64_t dn = s->parse(payload, sz, s->desc, DESC_CAP);
  if (dn < 0) {
    s->c_parse_fail++;
    return 0;
  }
  const uint8_t* d = s->desc;
  uint64_t sig_cnt = d[1];
  uint64_t sig_off = (uint64_t)d[2] | ((uint64_t)d[3] << 8);
  uint64_t msg_off = (uint64_t)d[4] | ((uint64_t)d[5] << 8);
  uint64_t acct_off = (uint64_t)d[9] | ((uint64_t)d[10] << 8);
  // room PROBE before any stateful guard: a no-room txn returns to the
  // stash untouched — if the tcache insert ran first, the retry would
  // see its own tag and self-deduplicate (a dropped txn, found by
  // test_stalled_consumer_backpressures_intake)
  bool need_new =
      s->open < 0 || s->meta[s->open].n_elems + sig_cnt > s->batch;
  if (need_new && s->meta[s->next_open].state != SLOT_FREE) return 1;
  // dedup tag: low 8 bytes of the first signature (sig_tag), BEFORE the
  // length/fit guards — the Python lane's guard order exactly
  uint64_t tag;
  std::memcpy(&tag, payload + sig_off, 8);
  if (!tag) tag = 1;
  for (int i = 0; i < TC_DEPTH; i++) {
    if (s->tc_ring[i] == tag) {
      s->c_dedup_dup++;
      return 0;
    }
  }
  s->tc_ring[s->tc_oldest] = tag;
  s->tc_oldest = (s->tc_oldest + 1) % TC_DEPTH;
  uint64_t msg_len = sz - msg_off;
  if (msg_len > s->mml) {
    s->c_msg_too_long++;
    return 0;
  }
  if (sig_cnt > s->batch) {
    s->c_too_many_sigs++;
    return 0;
  }
  if (s->open < 0) acquire_open(s);  // cannot fail: probed above
  fdv_slot_meta* m = &s->meta[s->open];
  if (m->n_elems + sig_cnt > s->batch) {
    seal_open(s);
    acquire_open(s);  // cannot fail: probed above
    m = &s->meta[s->open];
  }
  fdv_slot* sl = &s->slots[s->open];
  for (uint64_t i = 0; i < sig_cnt; i++) {
    uint64_t row = m->n_elems + i;
    std::memcpy(sl->msg + row * s->mml, payload + msg_off, msg_len);
    std::memset(sl->msg + row * s->mml + msg_len, 0, s->mml - msg_len);
    sl->ln[row] = (int32_t)msg_len;
    std::memcpy(sl->sig + row * 64, payload + sig_off + 64 * i, 64);
    std::memcpy(sl->pk + row * 32, payload + acct_off + 32 * i, 32);
  }
  sl->ranges[2 * m->n_txn] = (uint32_t)m->n_elems;
  sl->ranges[2 * m->n_txn + 1] = (uint32_t)(m->n_elems + sig_cnt);
  uint64_t off = m->arena_off;
  std::memcpy(sl->arena + off, payload, sz);
  std::memcpy(sl->arena + off + sz, s->desc, (uint64_t)dn);
  sl->arena[off + sz + dn] = (uint8_t)(sz & 0xFF);
  sl->arena[off + sz + dn + 1] = (uint8_t)(sz >> 8);
  uint64_t* fr = sl->frames + 4 * m->n_txn;
  fr[0] = off;
  fr[1] = sz + (uint64_t)dn + 2;
  fr[2] = tag;
  fr[3] = tsorig;
  m->arena_off += sz + (uint64_t)dn + 2;
  m->n_txn++;
  m->n_elems += sig_cnt;
  s->c_txn_in++;
  s->c_elems_in += sig_cnt;
  if (m->n_elems >= s->batch) seal_open(s);
  return 0;
}

void pump(fdv_stage* s) {
  while (s->stash_n) {
    fdv_stash_ent* e = &s->stash[s->stash_head];
    if (ingest(s, e->buf, e->sz, e->tsorig)) break;  // still no room
    s->stash_head = (s->stash_head + 1) % STASH_CAP;
    s->stash_n--;
  }
  set_flags(s);
}

void stash_push(fdv_stage* s, const uint8_t* payload, uint64_t sz,
                uint64_t tsorig) {
  if (s->stash_n >= STASH_CAP) {
    // every slot busy AND the stash full: only a dead/wedged consumer
    // gets here (the emit side frees slots as credits return) — count
    // the loss instead of growing without bound
    s->c_intake_dropped++;
    return;
  }
  fdv_stash_ent* e = &s->stash[(s->stash_head + s->stash_n) % STASH_CAP];
  e->sz = sz;
  e->tsorig = tsorig;
  std::memcpy(e->buf, payload, sz);
  s->stash_n++;
  set_flags(s);
}

int append_one(fdv_stage* s, const uint8_t* payload, uint64_t sz,
               uint64_t tsorig) {
  s->c_frags_in++;
  int r = 0;
  if (sz > TXN_MTU) {  // stash entries are TXN_MTU-bounded
    s->c_parse_fail++;
  } else {
    pump(s);
    if (s->stash_n) {  // order: queued frags go first
      stash_push(s, payload, sz, tsorig);
      r = -1;
    } else if (ingest(s, payload, sz, tsorig)) {
      stash_push(s, payload, sz, tsorig);
      r = -1;
    }
  }
  set_flags(s);
  return r;
}

}  // namespace

extern "C" {

void* fdv_stage_new(uint64_t shard_idx, uint64_t shard_cnt, uint64_t batch,
                    uint64_t max_msg_len, uint64_t n_slots, void* parse_fn) {
  if (!batch || !n_slots || !max_msg_len || !parse_fn) return nullptr;
  fdv_stage* s = (fdv_stage*)std::calloc(1, sizeof(fdv_stage));
  if (!s) return nullptr;
  s->shard_idx = shard_idx;
  s->shard_cnt = shard_cnt ? shard_cnt : 1;
  s->batch = batch;
  s->mml = max_msg_len;
  s->n_slots = n_slots;
  s->parse = (fdv_parse_fn)parse_fn;
  s->open = -1;
  s->slots = (fdv_slot*)std::calloc(n_slots, sizeof(fdv_slot));
  s->meta = (fdv_slot_meta*)std::calloc(n_slots, sizeof(fdv_slot_meta));
  if (!s->slots || !s->meta) return nullptr;
  for (uint64_t i = 0; i < n_slots; i++) {
    fdv_slot* sl = &s->slots[i];
    sl->msg = (uint8_t*)std::calloc(batch, max_msg_len);
    sl->ln = (int32_t*)std::calloc(batch, sizeof(int32_t));
    sl->sig = (uint8_t*)std::calloc(batch, 64);
    sl->pk = (uint8_t*)std::calloc(batch, 32);
    sl->frames = (uint64_t*)std::calloc(batch, 4 * sizeof(uint64_t));
    sl->ranges = (uint32_t*)std::calloc(batch, 2 * sizeof(uint32_t));
    sl->arena = (uint8_t*)std::malloc(batch * FRAME_CAP);
    if (!sl->msg || !sl->ln || !sl->sig || !sl->pk || !sl->frames ||
        !sl->ranges || !sl->arena)
      return nullptr;
  }
  set_flags(s);  // every slot is free: intake accepts from the start
  return s;
}

void fdv_stage_delete(void* ctx) {
  fdv_stage* s = (fdv_stage*)ctx;
  if (!s) return;
  for (uint64_t i = 0; i < s->n_slots; i++) {
    std::free(s->slots[i].msg);
    std::free(s->slots[i].ln);
    std::free(s->slots[i].sig);
    std::free(s->slots[i].pk);
    std::free(s->slots[i].frames);
    std::free(s->slots[i].ranges);
    std::free(s->slots[i].arena);
  }
  std::free(s->slots);
  std::free(s->meta);
  std::free(s);
}

// The fdr_sweep callback: resolved by ADDRESS from Python, called per
// frag inside the sweep crossing.  meta8 = (seq, sig, arena off, sz,
// ctl, tsorig, tspub, in_idx).  Returns -1 (stop the sweep) when the
// frag had to be stashed — the slot ring is full and intake must wait
// for the reap side to free a slot.
int fdv_frag_cb(void* ctx, const uint64_t* meta8, const uint8_t* payload) {
  fdv_stage* s = (fdv_stage*)ctx;
  if (s->shard_cnt > 1 && (meta8[0] % s->shard_cnt) != s->shard_idx) {
    s->c_filtered++;
    return 0;
  }
  return append_one(s, payload, meta8[3], meta8[5]);
}

// Per-frag fallback surface (mixed-lane / lossy-splice topologies): the
// Python after_frag forwards into the SAME state the sweep cb fills.
// The shard filter already ran in before_frag on that path.
int fdv_append(void* ctx, const uint8_t* payload, uint64_t sz,
               uint64_t tsorig) {
  return append_one((fdv_stage*)ctx, payload, sz, tsorig);
}

// Deadline close: seal the open slot (no-op when nothing accumulated).
void fdv_seal(void* ctx) {
  fdv_stage* s = (fdv_stage*)ctx;
  seal_open(s);
  set_flags(s);
}

// Retry stashed frags (the reap side calls this after releasing a slot).
void fdv_pump(void* ctx) { pump((fdv_stage*)ctx); }

// A dispatched+published slot returns to the ring.
void fdv_slot_release(void* ctx, uint64_t idx) {
  fdv_stage* s = (fdv_stage*)ctx;
  if (idx >= s->n_slots) return;
  s->meta[idx].state = SLOT_FREE;
  pump(s);
}

// zero-FFI view pointers (called once at construction from Python)
void* fdv_meta_ptr(void* ctx) { return ((fdv_stage*)ctx)->meta; }
void* fdv_counters_ptr(void* ctx) { return &((fdv_stage*)ctx)->flags; }
void* fdv_slot_msg(void* ctx, uint64_t i) {
  return ((fdv_stage*)ctx)->slots[i].msg;
}
void* fdv_slot_ln(void* ctx, uint64_t i) {
  return ((fdv_stage*)ctx)->slots[i].ln;
}
void* fdv_slot_sig(void* ctx, uint64_t i) {
  return ((fdv_stage*)ctx)->slots[i].sig;
}
void* fdv_slot_pk(void* ctx, uint64_t i) {
  return ((fdv_stage*)ctx)->slots[i].pk;
}
void* fdv_slot_frames(void* ctx, uint64_t i) {
  return ((fdv_stage*)ctx)->slots[i].frames;
}
void* fdv_slot_ranges(void* ctx, uint64_t i) {
  return ((fdv_stage*)ctx)->slots[i].ranges;
}
void* fdv_slot_arena(void* ctx, uint64_t i) {
  return ((fdv_stage*)ctx)->slots[i].arena;
}

}  // extern "C"
