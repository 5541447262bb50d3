// Native tcache: dedup cache of recently seen 64-bit tags (the port's copy
// of the repo's native/fd_tcache.cpp).
//
// The C++ half of the dedup hot path (the reference's fd_tcache.h is the
// same structure in C: a ring of the last `depth` tags + a hash map for
// O(1) membership, eviction strictly oldest-first).  Protocol parity
// with tango/rings.py TCache: tag 0 is the null tag and never dedups;
// insert returns 1 when the tag was already present.
//
// The map is open-addressed with linear probing over a power-of-2 table
// sized 2x the ring depth; deleted slots are re-linked by re-inserting
// the probe chain (standard robin-hood-free deletion by backward shift
// is overkill at 0.5 load factor — we instead mark with a tombstone-free
// rehash of the cluster).
//
// Build: utils/hostbuild.py (g++ -O2 -shared -fPIC into
// build/torch_native/); tango/tcache_native.py binds it.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Tcache {
  uint64_t depth;
  uint64_t oldest;
  uint64_t map_cap;  // power of 2, >= 2*depth
  uint64_t* ring;    // [depth]
  uint64_t* map;     // [map_cap], 0 = empty
};

inline uint64_t hash64(uint64_t x) {
  // splitmix64 finalizer: good avalanche for table indexing
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

inline uint64_t* probe(Tcache* t, uint64_t tag) {
  uint64_t mask = t->map_cap - 1;
  uint64_t i = hash64(tag) & mask;
  while (t->map[i] != 0 && t->map[i] != tag) i = (i + 1) & mask;
  return &t->map[i];
}

void map_erase(Tcache* t, uint64_t tag) {
  uint64_t mask = t->map_cap - 1;
  uint64_t i = hash64(tag) & mask;
  while (t->map[i] != tag) {
    if (t->map[i] == 0) return;  // not present
    i = (i + 1) & mask;
  }
  // delete + compact the probe cluster after i (linear-probing delete)
  t->map[i] = 0;
  uint64_t j = (i + 1) & mask;
  while (t->map[j] != 0) {
    uint64_t k = t->map[j];
    t->map[j] = 0;
    *probe(t, k) = k;  // re-insert shifts it to its proper slot
    j = (j + 1) & mask;
  }
}

}  // namespace

extern "C" {

void* tcache_new(uint64_t depth) {
  if (depth == 0) return nullptr;
  uint64_t cap = 1;
  while (cap < depth * 2) cap <<= 1;
  Tcache* t = static_cast<Tcache*>(std::malloc(sizeof(Tcache)));
  if (!t) return nullptr;
  t->depth = depth;
  t->oldest = 0;
  t->map_cap = cap;
  t->ring = static_cast<uint64_t*>(std::calloc(depth, 8));
  t->map = static_cast<uint64_t*>(std::calloc(cap, 8));
  if (!t->ring || !t->map) {
    std::free(t->ring);
    std::free(t->map);
    std::free(t);
    return nullptr;
  }
  return t;
}

void tcache_delete(void* h) {
  if (!h) return;
  Tcache* t = static_cast<Tcache*>(h);
  std::free(t->ring);
  std::free(t->map);
  std::free(t);
}

int tcache_query(void* h, uint64_t tag) {
  if (!h || tag == 0) return 0;
  Tcache* t = static_cast<Tcache*>(h);
  return *probe(t, tag) == tag;
}

// returns 1 = duplicate (already present), 0 = inserted fresh
int tcache_insert(void* h, uint64_t tag) {
  if (!h || tag == 0) return 0;
  Tcache* t = static_cast<Tcache*>(h);
  uint64_t* slot = probe(t, tag);
  if (*slot == tag) return 1;
  uint64_t old = t->ring[t->oldest];
  if (old != 0) map_erase(t, old);
  t->ring[t->oldest] = tag;
  t->oldest = (t->oldest + 1) % t->depth;
  // the erase may have moved entries; re-probe for the insert slot
  *probe(t, tag) = tag;
  return 0;
}

// bulk path: dedup `n` tags in one call; out_dup[i] = 1 if tags[i] was a
// duplicate at its position in the stream (per-frag ctypes crossings are
// the overhead the native path exists to amortize)
void tcache_insert_bulk(void* h, const uint64_t* tags, uint64_t n,
                        uint8_t* out_dup) {
  for (uint64_t i = 0; i < n; i++) {
    out_dup[i] = (uint8_t)tcache_insert(h, tags[i]);
  }
}

}  // extern "C"
