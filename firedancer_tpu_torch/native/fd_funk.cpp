// fd_funk: the native shm storage plane, the port's copy of the JAX
// package's native/fd_funk.cpp (the same layout, seqlock and wire formats).
//
// A shared-memory-resident form of funk/funk.py: a flat key->value root
// store plus a tree of in-preparation transaction overlays, living
// entirely inside ONE shm mapping so that
//
//   - the bank sweep client (native/fd_bank.cpp) writes committed
//     records DIRECTLY into the map inside its fdr_sweep crossing (via
//     the ffk_txn_slot / ffk_rec_insert_slot function pointers handed
//     over at arm time) — no host-side re-apply per record;
//   - the Python lane (funk/funk_native.py) is a thin view over the
//     SAME map: zero-copy reads through the mapping base, batched
//     writes through one ffk_batch_apply crossing, and the seal's
//     before/after read-out in one ffk_txn_diff crossing;
//   - an uninvolved process can ffk_attach() the segment READ-ONLY and
//     observe a consistent store through the seqlock.
//
// Layout discipline: everything inside the mapping is OFFSET-based
// (no raw pointers), so the segment is position-independent across
// attaches.  The mapping is ftruncate'd to its max size up front and
// committed lazily by the kernel — "growable" without remap.  A bump
// allocator with power-of-2 freelists serves record nodes and value
// blocks; values are overwritten in place when the new length fits the
// block's capacity (the common bank case: fixed-width account values).
//
// Concurrency: single writer, many readers.  Every mutating entry
// point wraps itself in a seqlock (hdr->seq odd while writing, with
// release/acquire ordering); readers in other processes retry on a
// torn read.  Within the owning stage process the Python lane and the
// native bank lane share one thread (the stage loop), so they never
// interleave mid-operation.
//
// Error codes mirror funk/funk.py exactly (FunkError.code): the
// binding re-raises them 1:1 so both lanes agree on failure shapes.
//
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <stdint.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>

#if defined(__linux__) || defined(__APPLE__)
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#define FFK_HAVE_SHM 1
#else
#define FFK_HAVE_SHM 0
#endif

#if FFK_HAVE_SHM
// shm_open/shm_unlink live in librt on this glibc and the shared build
// links libc only — go through /dev/shm directly, which is exactly what
// glibc's shm_open does on Linux.
static void ffk_shm_path(char* out, size_t cap, const char* name) {
  snprintf(out, cap, "/dev/shm/%s", name[0] == '/' ? name + 1 : name);
}
static int ffk_shm_openx(const char* name, int oflag, int mode) {
  char path[160];
  ffk_shm_path(path, sizeof(path), name);
  return open(path, oflag | O_CLOEXEC, mode);
}
static void ffk_shm_unlinkx(const char* name) {
  char path[160];
  ffk_shm_path(path, sizeof(path), name);
  unlink(path);
}
#endif

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef int32_t i32;
typedef uint64_t u64;
typedef int64_t i64;

enum {
  FFK_ERR_TXN = -1,     // unknown / already-in-prep txn (funk.py ERR_TXN)
  FFK_ERR_FROZEN = -2,  // txn has children; records immutable
  FFK_ERR_KEY = -3,     // unknown key
  FFK_ERR_FULL = -4,    // txn table exhausted
  FFK_ERR_OOM = -5,     // arena exhausted
  FFK_ERR_RDONLY = -6,  // mutation through a read-only attach
  FFK_ERR_RANGE = -7,   // xid/key too long or output buffer too small
};

enum {
  FFK_XID_MAX = 128,    // funk_native.py mirrors this
  FFK_KEY_MAX = 1024,
  FFK_NCLASS = 40,      // freelist size classes: 16 << c
  FFK_MAGIC_LO = 0x6b6e75665f6466u,  // "fd_funk" LE
};

static const u64 FFK_MAGIC = ((u64)0x31 << 56) | (u64)FFK_MAGIC_LO;

// --------------------------------------------------------------------------
// in-segment structures (offset-based)
// --------------------------------------------------------------------------

struct ffk_hdr {
  u64 magic;
  u32 version;
  u32 txn_cap;
  u64 max_sz;        // whole mapping size
  u64 used;          // bump high-water, absolute offset
  u64 seq;           // seqlock: odd while a writer is inside
  u64 n_buckets;     // power of 2
  u64 buckets_off;   // u64[n_buckets] chain heads (0 = empty)
  u64 txns_off;      // ffk_txn[txn_cap]
  u64 arena_off;     // allocations start here
  u32 txn_cnt;
  u32 last_pub_len;  // 0 = never published
  u64 rec_cnt_root;
  u64 free_heads[FFK_NCLASS];
  u8 last_pub[FFK_XID_MAX];
};

struct ffk_txn {
  i32 state;    // 0 free, 1 live
  i32 parent;   // -1 = child of root, else live txn index
  u32 child_cnt;
  u32 xid_len;
  u64 rec_head; // offset of first ffk_rec on this txn's list (0 = none)
  u8 xid[FFK_XID_MAX];
};

// one record node; key bytes follow the struct inline
struct ffk_rec {
  u64 next;   // hash chain
  u64 tnext;  // per-txn list (root recs: unused, 0)
  i32 slot;   // 0 = root, else txn index + 1
  i32 vlen;   // -1 = tombstone
  u32 vcap;   // capacity of the block at voff
  u32 klen;
  u64 voff;   // value bytes, absolute offset (0 = none allocated)
};

// process-local handle
struct ffk_t {
  u8* base;
  u64 sz;
  int fd;
  int writable;
  int owner;      // unlinks the shm name on close
  char name[96];
};

static inline ffk_hdr* H(ffk_t* f) { return (ffk_hdr*)f->base; }
static inline u8* P(ffk_t* f, u64 off) { return f->base + off; }
static inline u64* buckets(ffk_t* f) { return (u64*)P(f, H(f)->buckets_off); }
static inline ffk_txn* txns(ffk_t* f) { return (ffk_txn*)P(f, H(f)->txns_off); }
static inline ffk_rec* rec_at(ffk_t* f, u64 off) { return (ffk_rec*)P(f, off); }
static inline u8* rec_key(ffk_rec* r) { return (u8*)(r + 1); }

// -- seqlock ----------------------------------------------------------------

static inline void wr_begin(ffk_t* f) {
  u64 s = __atomic_load_n(&H(f)->seq, __ATOMIC_RELAXED);
  __atomic_store_n(&H(f)->seq, s + 1, __ATOMIC_RELEASE);
  __atomic_thread_fence(__ATOMIC_ACQ_REL);
}

static inline void wr_end(ffk_t* f) {
  u64 s = __atomic_load_n(&H(f)->seq, __ATOMIC_RELAXED);
  __atomic_thread_fence(__ATOMIC_ACQ_REL);
  __atomic_store_n(&H(f)->seq, s + 1, __ATOMIC_RELEASE);
}

// -- allocator --------------------------------------------------------------

static int size_class(u64 n) {
  u64 c = 16;
  int k = 0;
  while (c < n && k < FFK_NCLASS - 1) { c <<= 1; k++; }
  return k;
}

static u64 class_bytes(int k) { return (u64)16 << k; }

// returns absolute offset or 0 on OOM
static u64 ffk_alloc(ffk_t* f, u64 n) {
  ffk_hdr* h = H(f);
  int k = size_class(n);
  u64 head = h->free_heads[k];
  if (head) {
    h->free_heads[k] = *(u64*)P(f, head);
    return head;
  }
  u64 need = class_bytes(k);
  u64 off = (h->used + 15) & ~(u64)15;
  if (off + need > h->max_sz) return 0;
  h->used = off + need;
  return off;
}

static void ffk_free(ffk_t* f, u64 off, u64 n) {
  if (!off) return;
  ffk_hdr* h = H(f);
  int k = size_class(n);
  *(u64*)P(f, off) = h->free_heads[k];
  h->free_heads[k] = off;
}

// -- hashing ---------------------------------------------------------------

static u64 ffk_hash(i32 slot, const u8* key, u32 klen) {
  u64 x = 0xcbf29ce484222325ULL;
  u32 s = (u32)slot;
  for (int i = 0; i < 4; i++) { x ^= (s >> (8 * i)) & 0xff; x *= 0x100000001b3ULL; }
  for (u32 i = 0; i < klen; i++) { x ^= key[i]; x *= 0x100000001b3ULL; }
  return x;
}

static u64* chain_head(ffk_t* f, i32 slot, const u8* key, u32 klen) {
  return &buckets(f)[ffk_hash(slot, key, klen) & (H(f)->n_buckets - 1)];
}

// find rec for (slot, key); prev_out (optional) gets &link pointing at it
static u64 rec_find(ffk_t* f, i32 slot, const u8* key, u32 klen,
                    u64** prev_out) {
  u64* link = chain_head(f, slot, key, klen);
  u64 off = *link;
  while (off) {
    ffk_rec* r = rec_at(f, off);
    if (r->slot == slot && r->klen == klen &&
        memcmp(rec_key(r), key, klen) == 0) {
      if (prev_out) *prev_out = link;
      return off;
    }
    link = &r->next;
    off = *link;
  }
  if (prev_out) *prev_out = 0;
  return 0;
}

// -- txn table --------------------------------------------------------------

static int txn_find(ffk_t* f, const u8* xid, int xlen) {
  if (xlen < 0 || xlen > FFK_XID_MAX) return -1;
  ffk_txn* t = txns(f);
  u32 cap = H(f)->txn_cap;
  u32 live = H(f)->txn_cnt;  // lowest-free allocation keeps indices
  u32 seen = 0;              // compact, so this scan is ~txn_cnt steps
  for (u32 i = 0; i < cap && seen < live; i++) {
    if (t[i].state != 1) continue;
    seen++;
    if (t[i].xid_len == (u32)xlen && memcmp(t[i].xid, xid, (size_t)xlen) == 0)
      return (int)i;
  }
  return -1;
}

// value upsert into (slot, key).  vlen -1 = tombstone (slot > 0) or
// delete (slot == 0, never errors on a missing key — _root_merge shape).
// A root tombstone is a delete.  Returns 0 / FFK_ERR_OOM.
static int rec_upsert(ffk_t* f, i32 slot, const u8* key, u32 klen,
                      const u8* val, i64 vlen, u64 tlist_txn_off) {
  ffk_hdr* h = H(f);
  u64* prev = 0;
  u64 off = rec_find(f, slot, key, klen, &prev);
  if (slot == 0 && vlen < 0) {  // root delete
    if (!off) return 0;
    ffk_rec* r = rec_at(f, off);
    *prev = r->next;
    ffk_free(f, r->voff, r->vcap);
    ffk_free(f, off, sizeof(ffk_rec) + r->klen);
    h->rec_cnt_root--;
    return 0;
  }
  if (off) {  // overwrite in place when it fits
    ffk_rec* r = rec_at(f, off);
    if (vlen < 0) {
      ffk_free(f, r->voff, r->vcap);
      r->voff = 0;
      r->vcap = 0;
      r->vlen = -1;
      return 0;
    }
    if ((u64)vlen > r->vcap) {
      u64 nv = ffk_alloc(f, (u64)vlen);
      if (!nv) return FFK_ERR_OOM;
      ffk_free(f, r->voff, r->vcap);
      r->voff = nv;
      r->vcap = (u32)class_bytes(size_class((u64)vlen));
    }
    if (vlen) memcpy(P(f, r->voff), val, (size_t)vlen);
    r->vlen = (i32)vlen;
    return 0;
  }
  // fresh node
  u64 noff = ffk_alloc(f, sizeof(ffk_rec) + klen);
  if (!noff) return FFK_ERR_OOM;
  ffk_rec* r = rec_at(f, noff);
  memset(r, 0, sizeof(*r));
  r->slot = slot;
  r->klen = klen;
  memcpy(rec_key(r), key, klen);
  if (vlen >= 0) {
    if (vlen) {
      r->voff = ffk_alloc(f, (u64)vlen);
      if (!r->voff) {
        ffk_free(f, noff, sizeof(ffk_rec) + klen);
        return FFK_ERR_OOM;
      }
      r->vcap = (u32)class_bytes(size_class((u64)vlen));
      memcpy(P(f, r->voff), val, (size_t)vlen);
    }
    r->vlen = (i32)vlen;
  } else {
    r->vlen = -1;
  }
  u64* head = chain_head(f, slot, key, klen);
  r->next = *head;
  *head = noff;
  if (slot == 0) {
    h->rec_cnt_root++;
  } else {
    ffk_txn* t = (ffk_txn*)P(f, tlist_txn_off);
    r->tnext = t->rec_head;
    t->rec_head = noff;
  }
  return 0;
}

// publish-time move of a txn rec's VALUE BLOCK into root (no memcpy):
// the root rec adopts voff/vcap/vlen; the donor rec is left to be freed
// node-only by the caller.
static int root_adopt(ffk_t* f, ffk_rec* src) {
  ffk_hdr* h = H(f);
  const u8* key = rec_key(src);
  u32 klen = src->klen;
  u64* prev = 0;
  u64 off = rec_find(f, 0, key, klen, &prev);
  if (src->vlen < 0) {  // tombstone publishes as a root delete
    if (off) {
      ffk_rec* r = rec_at(f, off);
      *prev = r->next;
      ffk_free(f, r->voff, r->vcap);
      ffk_free(f, off, sizeof(ffk_rec) + r->klen);
      h->rec_cnt_root--;
    }
    return 0;
  }
  if (off) {
    ffk_rec* r = rec_at(f, off);
    ffk_free(f, r->voff, r->vcap);
    r->voff = src->voff;
    r->vcap = src->vcap;
    r->vlen = src->vlen;
    src->voff = 0;
    src->vcap = 0;
    return 0;
  }
  u64 noff = ffk_alloc(f, sizeof(ffk_rec) + klen);
  if (!noff) return FFK_ERR_OOM;
  ffk_rec* r = rec_at(f, noff);
  memset(r, 0, sizeof(*r));
  r->slot = 0;
  r->klen = klen;
  memcpy(rec_key(r), key, klen);
  r->voff = src->voff;
  r->vcap = src->vcap;
  r->vlen = src->vlen;
  src->voff = 0;
  src->vcap = 0;
  u64* head = chain_head(f, 0, key, klen);
  r->next = *head;
  *head = noff;
  h->rec_cnt_root++;
  return 0;
}

// free every record of txn index ti (hash unlink + node/value free)
static void txn_free_recs(ffk_t* f, int ti) {
  ffk_txn* t = &txns(f)[ti];
  u64 off = t->rec_head;
  while (off) {
    ffk_rec* r = rec_at(f, off);
    u64 nxt = r->tnext;
    u64* prev = 0;
    u64 found = rec_find(f, ti + 1, rec_key(r), r->klen, &prev);
    if (found == off && prev) *prev = r->next;
    ffk_free(f, r->voff, r->vcap);
    ffk_free(f, off, sizeof(ffk_rec) + r->klen);
    off = nxt;
  }
  t->rec_head = 0;
}

// cancel txn ti and every descendant; returns count removed
static int txn_cancel_tree(ffk_t* f, int ti) {
  ffk_hdr* h = H(f);
  ffk_txn* t = txns(f);
  int n = 0;
  // children first (scan; txn counts are small — a handful of forks)
  for (u32 i = 0; i < h->txn_cap; i++) {
    if (t[i].state == 1 && t[i].parent == ti)
      n += txn_cancel_tree(f, (int)i);
  }
  if (t[ti].parent >= 0 && t[t[ti].parent].state == 1)
    t[t[ti].parent].child_cnt--;
  txn_free_recs(f, ti);
  t[ti].state = 0;
  t[ti].parent = -1;
  t[ti].child_cnt = 0;
  h->txn_cnt--;
  return n + 1;
}

// --------------------------------------------------------------------------
// exported surface
// --------------------------------------------------------------------------

extern "C" {

// create a fresh shm funk.  name: shm name ("/fdtpu_torch_funk_...") or NULL /
// "" for an auto-generated private name.  Returns handle or NULL.
void* ffk_create(const char* name, u64 max_sz, i32 txn_cap) {
#if !FFK_HAVE_SHM
  (void)name; (void)max_sz; (void)txn_cap;
  return 0;
#else
  if (max_sz < (u64)1 << 20) max_sz = (u64)1 << 20;
  if (txn_cap <= 0) txn_cap = 1024;
  ffk_t* f = (ffk_t*)calloc(1, sizeof(ffk_t));
  if (!f) return 0;
  static int ctr = 0;
  if (name && name[0]) {
    snprintf(f->name, sizeof(f->name), "%s", name);
  } else {
    snprintf(f->name, sizeof(f->name), "/fdtpu_torch_funk_%d_%d",
             (int)getpid(), ctr++);
  }
  ffk_shm_unlinkx(f->name);  // a stale segment from a crashed owner
  f->fd = ffk_shm_openx(f->name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (f->fd < 0) { free(f); return 0; }
  if (ftruncate(f->fd, (off_t)max_sz) != 0) {
    close(f->fd); ffk_shm_unlinkx(f->name); free(f); return 0;
  }
  f->base = (u8*)mmap(0, max_sz, PROT_READ | PROT_WRITE, MAP_SHARED,
                      f->fd, 0);
  if (f->base == MAP_FAILED) {
    close(f->fd); ffk_shm_unlinkx(f->name); free(f); return 0;
  }
  f->sz = max_sz;
  f->writable = 1;
  f->owner = 1;
  u64 n_buckets = 1u << 16;
  ffk_hdr* h = (ffk_hdr*)f->base;
  memset(h, 0, sizeof(*h));
  h->version = 1;
  h->txn_cap = (u32)txn_cap;
  h->max_sz = max_sz;
  h->n_buckets = n_buckets;
  h->buckets_off = (sizeof(ffk_hdr) + 63) & ~(u64)63;
  h->txns_off = h->buckets_off + n_buckets * 8;
  h->arena_off = (h->txns_off + (u64)txn_cap * sizeof(ffk_txn) + 63)
                 & ~(u64)63;
  h->used = h->arena_off;
  ffk_txn* t = (ffk_txn*)(f->base + h->txns_off);
  for (i32 i = 0; i < txn_cap; i++) { t[i].state = 0; t[i].parent = -1; }
  __atomic_store_n(&h->magic, FFK_MAGIC, __ATOMIC_RELEASE);
  return f;
#endif
}

// read-only attach to an existing segment (the read-replica seed)
void* ffk_attach(const char* name) {
#if !FFK_HAVE_SHM
  (void)name;
  return 0;
#else
  if (!name || !name[0]) return 0;
  int fd = ffk_shm_openx(name, O_RDONLY, 0);
  if (fd < 0) return 0;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(ffk_hdr)) {
    close(fd);
    return 0;
  }
  u8* base = (u8*)mmap(0, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return 0; }
  if (__atomic_load_n(&((ffk_hdr*)base)->magic, __ATOMIC_ACQUIRE)
      != FFK_MAGIC) {
    munmap(base, (size_t)st.st_size);
    close(fd);
    return 0;
  }
  ffk_t* f = (ffk_t*)calloc(1, sizeof(ffk_t));
  if (!f) { munmap(base, (size_t)st.st_size); close(fd); return 0; }
  f->base = base;
  f->sz = (u64)st.st_size;
  f->fd = fd;
  f->writable = 0;
  f->owner = 0;
  snprintf(f->name, sizeof(f->name), "%s", name);
  return f;
#endif
}

void ffk_close(void* h, i32 unlink_shm) {
#if FFK_HAVE_SHM
  ffk_t* f = (ffk_t*)h;
  if (!f) return;
  if (f->base) munmap(f->base, f->sz);
  if (f->fd >= 0) close(f->fd);
  if (unlink_shm && f->owner) ffk_shm_unlinkx(f->name);
  free(f);
#else
  (void)h; (void)unlink_shm;
#endif
}

const char* ffk_shm_name(void* h) { return ((ffk_t*)h)->name; }
u64 ffk_base(void* h) { return (u64)(uintptr_t)((ffk_t*)h)->base; }
u64 ffk_map_sz(void* h) { return ((ffk_t*)h)->sz; }
u64 ffk_seq(void* h) {
  return __atomic_load_n(&H((ffk_t*)h)->seq, __ATOMIC_ACQUIRE);
}
u64 ffk_arena_used(void* h) { return H((ffk_t*)h)->used; }

// -- fork tree --------------------------------------------------------------

// plen < 0: child of root.  0 ok, else FFK_ERR_*.
i32 ffk_txn_prepare(void* hh, const u8* pxid, i32 plen, const u8* xid,
                    i32 xlen) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  if (xlen <= 0 || xlen > FFK_XID_MAX) return FFK_ERR_RANGE;
  if (txn_find(f, xid, xlen) >= 0) return FFK_ERR_TXN;
  int pi = -1;
  if (plen >= 0) {
    pi = txn_find(f, pxid, plen);
    if (pi < 0) return FFK_ERR_TXN;
  }
  ffk_hdr* h = H(f);
  ffk_txn* t = txns(f);
  int slot = -1;
  for (u32 i = 0; i < h->txn_cap; i++) {
    if (t[i].state == 0) { slot = (int)i; break; }
  }
  if (slot < 0) return FFK_ERR_FULL;
  wr_begin(f);
  t[slot].state = 1;
  t[slot].parent = pi;
  t[slot].child_cnt = 0;
  t[slot].xid_len = (u32)xlen;
  memcpy(t[slot].xid, xid, (size_t)xlen);
  t[slot].rec_head = 0;
  if (pi >= 0) t[pi].child_cnt++;
  h->txn_cnt++;
  wr_end(f);
  return 0;
}

// 1 frozen, 0 not, FFK_ERR_TXN unknown
i32 ffk_txn_is_frozen(void* hh, const u8* xid, i32 xlen) {
  ffk_t* f = (ffk_t*)hh;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  return txns(f)[ti].child_cnt ? 1 : 0;
}

// 0 = live and writable (the bank sweep's arm-time check)
i32 ffk_txn_wcheck(void* hh, const u8* xid, i32 xlen) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  if (txns(f)[ti].child_cnt) return FFK_ERR_FROZEN;
  return 0;
}

i32 ffk_txn_cnt(void* hh) { return (i32)H((ffk_t*)hh)->txn_cnt; }

// serialized ancestry oldest..xid: (u16 len | xid bytes)*; returns bytes
// written, or the size needed when out == NULL, or FFK_ERR_*.
i64 ffk_txn_ancestry(void* hh, const u8* xid, i32 xlen, u8* out, i64 cap) {
  ffk_t* f = (ffk_t*)hh;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  ffk_txn* t = txns(f);
  int chain[4096];
  int n = 0;
  for (int cur = ti; cur >= 0; cur = t[cur].parent) {
    if (n >= (int)(sizeof(chain) / sizeof(chain[0]))) return FFK_ERR_RANGE;
    chain[n++] = cur;
  }
  i64 need = 0;
  for (int i = 0; i < n; i++) need += 2 + t[chain[i]].xid_len;
  if (!out) return need;
  if (cap < need) return FFK_ERR_RANGE;
  u8* p = out;
  for (int i = n - 1; i >= 0; i--) {  // oldest first
    u32 l = t[chain[i]].xid_len;
    p[0] = (u8)(l & 0xff);
    p[1] = (u8)(l >> 8);
    memcpy(p + 2, t[chain[i]].xid, l);
    p += 2 + l;
  }
  return need;
}

i32 ffk_txn_cancel(void* hh, const u8* xid, i32 xlen) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  wr_begin(f);
  int n = txn_cancel_tree(f, ti);
  wr_end(f);
  return n;
}

// merge xid's ancestor chain into root oldest-first, cancelling every
// competing sibling fork; returns #published or FFK_ERR_*.
i32 ffk_txn_publish(void* hh, const u8* xid, i32 xlen) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  ffk_hdr* h = H(f);
  ffk_txn* t = txns(f);
  int chain[4096];
  int n = 0;
  for (int cur = ti; cur >= 0; cur = t[cur].parent) {
    if (n >= (int)(sizeof(chain) / sizeof(chain[0]))) return FFK_ERR_RANGE;
    chain[n++] = cur;
  }
  wr_begin(f);
  int published = 0;
  for (int i = n - 1; i >= 0; i--) {  // oldest first
    int step = chain[i];
    int par = t[step].parent;
    // competing forks off the same parent lose
    for (u32 s = 0; s < h->txn_cap; s++) {
      if (t[s].state == 1 && (int)s != step && t[s].parent == par)
        txn_cancel_tree(f, (int)s);
    }
    // merge step's records into root (value blocks move, no memcpy)
    u64 off = t[step].rec_head;
    while (off) {
      ffk_rec* r = rec_at(f, off);
      u64 nxt = r->tnext;
      root_adopt(f, r);  // OOM cannot strand: adopt only moves blocks
      u64* prev = 0;
      u64 found = rec_find(f, step + 1, rec_key(r), r->klen, &prev);
      if (found == off && prev) *prev = r->next;
      ffk_free(f, off, sizeof(ffk_rec) + r->klen);
      off = nxt;
    }
    t[step].rec_head = 0;
    // step's children become children of root
    for (u32 c = 0; c < h->txn_cap; c++) {
      if (t[c].state == 1 && t[c].parent == step) t[c].parent = -1;
    }
    h->last_pub_len = t[step].xid_len;
    memcpy(h->last_pub, t[step].xid, t[step].xid_len);
    t[step].state = 0;
    t[step].parent = -1;
    t[step].child_cnt = 0;
    h->txn_cnt--;
    published++;
  }
  wr_end(f);
  return published;
}

// last published xid -> out; returns its length (0 = never published)
i32 ffk_last_publish(void* hh, u8* out, i32 cap) {
  ffk_hdr* h = H((ffk_t*)hh);
  if ((i32)h->last_pub_len > cap) return FFK_ERR_RANGE;
  memcpy(out, h->last_pub, h->last_pub_len);
  return (i32)h->last_pub_len;
}

// -- records ----------------------------------------------------------------

// xlen < 0: straight to root (the _root_merge funnel).  vlen < 0 is a
// tombstone (txn) / unconditional delete (root).  0 ok, else FFK_ERR_*.
// This is ALSO the function pointer fd_bank.cpp calls per committed
// record inside the sweep crossing.
i32 ffk_rec_insert(void* hh, const u8* xid, i32 xlen, const u8* key,
                   i32 klen, const u8* val, i32 vlen) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  if (klen < 0 || klen > FFK_KEY_MAX) return FFK_ERR_RANGE;
  i32 slot = 0;
  u64 toff = 0;
  if (xlen >= 0) {
    int ti = txn_find(f, xid, xlen);
    if (ti < 0) return FFK_ERR_TXN;
    if (txns(f)[ti].child_cnt) return FFK_ERR_FROZEN;
    slot = ti + 1;
    toff = H(f)->txns_off + (u64)ti * sizeof(ffk_txn);
  }
  wr_begin(f);
  i32 rc = rec_upsert(f, slot, key, (u32)klen, val, vlen, toff);
  wr_end(f);
  return rc;
}

// funk.py rec_remove: visibility check through the overlay chain, then
// tombstone (txn) or delete (root).  0 ok, else FFK_ERR_*.
i32 ffk_rec_remove(void* hh, const u8* xid, i32 xlen, const u8* key,
                   i32 klen) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  if (klen < 0 || klen > FFK_KEY_MAX) return FFK_ERR_RANGE;
  if (xlen < 0) {
    u64 off = rec_find(f, 0, key, (u32)klen, 0);
    if (!off) return FFK_ERR_KEY;
    wr_begin(f);
    i32 rc = rec_upsert(f, 0, key, (u32)klen, 0, -1, 0);
    wr_end(f);
    return rc;
  }
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  ffk_txn* t = txns(f);
  if (t[ti].child_cnt) return FFK_ERR_FROZEN;
  // visible from xid?
  int cur = ti;
  int found = 0;
  while (cur >= 0) {
    u64 off = rec_find(f, cur + 1, key, (u32)klen, 0);
    if (off) {
      found = rec_at(f, off)->vlen >= 0;
      break;
    }
    cur = t[cur].parent;
  }
  if (cur < 0) found = rec_find(f, 0, key, (u32)klen, 0) != 0;
  if (!found) return FFK_ERR_KEY;
  wr_begin(f);
  i32 rc = rec_upsert(f, ti + 1, key, (u32)klen, 0, -1,
                      H(f)->txns_off + (u64)ti * sizeof(ffk_txn));
  wr_end(f);
  return rc;
}

// nearest-overlay query.  Returns 1 found (voff/vlen set, voff relative
// to ffk_base), 0 not visible, FFK_ERR_TXN unknown txn.
i32 ffk_rec_query(void* hh, const u8* xid, i32 xlen, const u8* key,
                  i32 klen, u64* voff_out, i64* vlen_out) {
  ffk_t* f = (ffk_t*)hh;
  if (klen < 0 || klen > FFK_KEY_MAX) return FFK_ERR_RANGE;
  int cur = -1;
  if (xlen >= 0) {
    cur = txn_find(f, xid, xlen);
    if (cur < 0) return FFK_ERR_TXN;
  }
  ffk_txn* t = txns(f);
  while (cur >= 0) {
    u64 off = rec_find(f, cur + 1, key, (u32)klen, 0);
    if (off) {
      ffk_rec* r = rec_at(f, off);
      if (r->vlen < 0) return 0;  // tombstone hides ancestors
      *voff_out = r->voff;
      *vlen_out = r->vlen;
      return 1;
    }
    cur = t[cur].parent;
  }
  u64 off = rec_find(f, 0, key, (u32)klen, 0);
  if (!off) return 0;
  ffk_rec* r = rec_at(f, off);
  *voff_out = r->voff;
  *vlen_out = r->vlen;
  return 1;
}

i64 ffk_rec_cnt_root(void* hh) { return (i64)H((ffk_t*)hh)->rec_cnt_root; }

// every root key, serialized (u16 klen | key)*.  out == NULL: returns
// the byte size needed; else bytes written or FFK_ERR_RANGE.
i64 ffk_root_keys(void* hh, u8* out, i64 cap) {
  ffk_t* f = (ffk_t*)hh;
  ffk_hdr* h = H(f);
  i64 need = 0;
  u64 nb = h->n_buckets;
  u64* b = buckets(f);
  for (u64 i = 0; i < nb; i++) {
    for (u64 off = b[i]; off; off = rec_at(f, off)->next) {
      ffk_rec* r = rec_at(f, off);
      if (r->slot == 0) need += 2 + r->klen;
    }
  }
  if (!out) return need;
  if (cap < need) return FFK_ERR_RANGE;
  u8* p = out;
  for (u64 i = 0; i < nb; i++) {
    for (u64 off = b[i]; off; off = rec_at(f, off)->next) {
      ffk_rec* r = rec_at(f, off);
      if (r->slot != 0) continue;
      p[0] = (u8)(r->klen & 0xff);
      p[1] = (u8)(r->klen >> 8);
      memcpy(p + 2, rec_key(r), r->klen);
      p += 2 + r->klen;
    }
  }
  return need;
}

// one txn's OWN overlay, serialized (u16 klen | u8 tomb | key)* — the
// seal path's changed-accounts source.  out == NULL: size needed.
i64 ffk_txn_keys(void* hh, const u8* xid, i32 xlen, u8* out, i64 cap) {
  ffk_t* f = (ffk_t*)hh;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  ffk_txn* t = txns(f);
  i64 need = 0;
  for (u64 off = t[ti].rec_head; off; off = rec_at(f, off)->tnext)
    need += 3 + rec_at(f, off)->klen;
  if (!out) return need;
  if (cap < need) return FFK_ERR_RANGE;
  u8* p = out;
  for (u64 off = t[ti].rec_head; off; off = rec_at(f, off)->tnext) {
    ffk_rec* r = rec_at(f, off);
    p[0] = (u8)(r->klen & 0xff);
    p[1] = (u8)(r->klen >> 8);
    p[2] = r->vlen < 0 ? 1 : 0;
    memcpy(p + 3, rec_key(r), r->klen);
    p += 3 + r->klen;
  }
  return need;
}

// resolve xid -> txn table index for the slot-direct hot path (the bank
// sweep resolves once per frag callback, then inserts by index).
// Returns the index or FFK_ERR_TXN / FFK_ERR_FROZEN.
i32 ffk_txn_slot(void* hh, const u8* xid, i32 xlen) {
  ffk_t* f = (ffk_t*)hh;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  if (txns(f)[ti].child_cnt) return FFK_ERR_FROZEN;
  return ti;
}

// slot-direct insert-or-modify: the per-record entry the bank sweep
// calls through its function pointer — no xid scan, no frozen re-check
// (the caller resolved the slot this same crossing).
i32 ffk_rec_insert_slot(void* hh, i32 ti, const u8* key, i32 klen,
                        const u8* val, i32 vlen) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  if (ti < 0 || (u32)ti >= H(f)->txn_cap || txns(f)[ti].state != 1)
    return FFK_ERR_TXN;
  if (klen < 0 || klen > FFK_KEY_MAX) return FFK_ERR_RANGE;
  wr_begin(f);
  i32 rc = rec_upsert(f, ti + 1, key, (u32)klen, val, vlen,
                      H(f)->txns_off + (u64)ti * sizeof(ffk_txn));
  wr_end(f);
  return rc;
}

// the seal path's one-crossing read-out: for every key in xid's OWN
// overlay, serialize (u16 klen | i64 blen | i64 alen | key | before |
// after) where before = the value seen from xid's PARENT view (the
// start-of-slot value: parent overlays are frozen while xid is live)
// and after = the overlay's value; blen/alen -1 = absent/tombstone.
// out == NULL returns the byte size needed; else bytes written or
// FFK_ERR_*.
i64 ffk_txn_diff(void* hh, const u8* xid, i32 xlen, u8* out, i64 cap) {
  ffk_t* f = (ffk_t*)hh;
  int ti = txn_find(f, xid, xlen);
  if (ti < 0) return FFK_ERR_TXN;
  ffk_txn* t = txns(f);
  int parent = t[ti].parent;
  i64 need = 0;
  for (u64 off = t[ti].rec_head; off; off = rec_at(f, off)->tnext) {
    ffk_rec* r = rec_at(f, off);
    need += 2 + 8 + 8 + r->klen;
    if (r->vlen > 0) need += r->vlen;
    // before: walk parent chain then root
    int cur = parent;
    i64 blen = -1;
    int decided = 0;
    while (cur >= 0) {
      u64 po = rec_find(f, cur + 1, rec_key(r), r->klen, 0);
      if (po) {
        blen = rec_at(f, po)->vlen;
        decided = 1;
        break;
      }
      cur = t[cur].parent;
    }
    if (!decided) {
      u64 po = rec_find(f, 0, rec_key(r), r->klen, 0);
      if (po) blen = rec_at(f, po)->vlen;
    }
    if (blen > 0) need += blen;
  }
  if (!out) return need;
  if (cap < need) return FFK_ERR_RANGE;
  u8* p = out;
  for (u64 off = t[ti].rec_head; off; off = rec_at(f, off)->tnext) {
    ffk_rec* r = rec_at(f, off);
    // before lookup (same walk as the sizing pass)
    int cur = parent;
    u64 bvoff = 0;
    i64 blen = -1;
    int decided = 0;
    while (cur >= 0) {
      u64 po = rec_find(f, cur + 1, rec_key(r), r->klen, 0);
      if (po) {
        ffk_rec* pr = rec_at(f, po);
        blen = pr->vlen;
        bvoff = pr->voff;
        decided = 1;
        break;
      }
      cur = t[cur].parent;
    }
    if (!decided) {
      u64 po = rec_find(f, 0, rec_key(r), r->klen, 0);
      if (po) {
        ffk_rec* pr = rec_at(f, po);
        blen = pr->vlen;
        bvoff = pr->voff;
      }
    }
    i64 alen = r->vlen;
    p[0] = (u8)(r->klen & 0xff);
    p[1] = (u8)(r->klen >> 8);
    memcpy(p + 2, &blen, 8);
    memcpy(p + 10, &alen, 8);
    p += 18;
    memcpy(p, rec_key(r), r->klen);
    p += r->klen;
    if (blen > 0) { memcpy(p, P(f, bvoff), (size_t)blen); p += blen; }
    if (alen > 0) { memcpy(p, P(f, r->voff), (size_t)alen); p += alen; }
  }
  return need;
}

// one crossing for a batch of insert-or-modify writes: n records of
// (u16 klen | i32 vlen | key | val), vlen -1 = tombstone/delete.
// xlen < 0 targets root (the batched _root_merge).  0 ok or FFK_ERR_*;
// on error the batch may be partially applied (callers treat any
// nonzero rc as fatal for the store).
i32 ffk_batch_apply(void* hh, const u8* xid, i32 xlen, const u8* buf,
                    i64 len, i32 n) {
  ffk_t* f = (ffk_t*)hh;
  if (!f->writable) return FFK_ERR_RDONLY;
  i32 slot = 0;
  u64 toff = 0;
  if (xlen >= 0) {
    int ti = txn_find(f, xid, xlen);
    if (ti < 0) return FFK_ERR_TXN;
    if (txns(f)[ti].child_cnt) return FFK_ERR_FROZEN;
    slot = ti + 1;
    toff = H(f)->txns_off + (u64)ti * sizeof(ffk_txn);
  }
  wr_begin(f);
  const u8* p = buf;
  const u8* end = buf + len;
  i32 rc = 0;
  for (i32 i = 0; i < n && rc == 0; i++) {
    if (p + 6 > end) { rc = FFK_ERR_RANGE; break; }
    u32 klen = (u32)p[0] | ((u32)p[1] << 8);
    i32 vlen;
    memcpy(&vlen, p + 2, 4);
    p += 6;
    if (klen > FFK_KEY_MAX || p + klen > end) { rc = FFK_ERR_RANGE; break; }
    const u8* key = p;
    p += klen;
    const u8* val = p;
    if (vlen >= 0) {
      if (p + vlen > end) { rc = FFK_ERR_RANGE; break; }
      p += vlen;
    }
    rc = rec_upsert(f, slot, key, klen, val, vlen, toff);
  }
  wr_end(f);
  return rc;
}

}  // extern "C"
