// Native tango ring plane: the link protocol in C++, the port's copy of
// the JAX package's native/fd_ring.cpp (its protocol half; see the end).
//
// Operates on the exact shared-memory layout tango/shm.py creates: the
// layout offsets arrive in the init struct from Python, so the format has
// one source of truth.  Protocol parity with tango/rings.py and
// tango/shm.py, held by tests/test_torch_native_ring.py against the
// Python lane and against the JAX package's lanes:
//
//   - mcache rows of 7 u64 (seq, sig, chunk, sz, ctl, tsorig, tspub);
//     BUSY bit (1<<63) set in the seq word while a row is mid-overwrite;
//     seq word written LAST on publish (release), checked before AND
//     after the payload copy on poll (the speculative-read discipline);
//   - compact dcache chunk allocation (64-byte granules, wrap at wmark);
//   - overrun detection by seq comparison in 64-bit wraparound space;
//   - credit flow control over the link's reliable fseqs
//     (shm.Producer.try_publish / rings.FlowControl.credits, exactly);
//   - lazy consumer progress publication to the fseq cell (the same
//     `lazy` cadence shm.Consumer keeps);
//   - tsorig pass-through + tspub stamping per hop (CLOCK_MONOTONIC —
//     the same clock Python's time.monotonic_ns() reads).
//
// The burst entry points are the point of the module: fdr_drain sweeps
// ALL of a stage's input links round-robin into a reusable arena and
// fdr_publish_burst pushes a frame list — one FFI crossing per run_once
// sweep instead of one per frag (runtime/stage.py's burst-drain path);
// fdr_sweep runs a stage's C callback per frag inside the same crossing
// (the bank stage's, native/fd_bank.cpp).
//
// fdr_sweep writes the stage's metrics plane when it is given one
// (runtime/native_metrics.NativePlane), and this library exports the
// plane's attach check and its test drivers (the end of this file).
// Left out of this copy, for want of a caller in the port: the
// plane-timed burst publish, the relay sweep client of the chaos harness,
// the synthetic-ingress pool publish and the bulk benchmark helpers.
//
// Build: utils/hostbuild.py (g++ -O2 -std=c++17 -shared -fPIC), on first use.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <unistd.h>

#include "fd_metrics.h"

namespace {

constexpr uint64_t BUSY = 1ull << 63;
constexpr uint64_t CHUNK_SZ = 64;
constexpr int NCOL = 7;
constexpr int DRAIN_NCOL = 8;  // 7 mcache cols (chunk -> arena offset) + in_idx

inline int64_t seq_diff(uint64_t a, uint64_t b) {
  return (int64_t)(a - b);
}

inline uint64_t now_ns() {
  // CLOCK_MONOTONIC: the exact clock behind time.monotonic_ns(), so a
  // C++-stamped tspub/tsorig compares against Python-side readings.
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

inline std::atomic<uint64_t>* row(uint8_t* base, uint64_t mcache_off,
                                  uint64_t depth, uint64_t seq) {
  uint64_t line = seq & (depth - 1);
  return reinterpret_cast<std::atomic<uint64_t>*>(base + mcache_off +
                                                  line * NCOL * 8);
}

}  // namespace

extern "C" {

enum { FDR_MAX_REL = 16 };  // reliable consumers per producer (fctl fan-in)

// Mirrors the python-side link geometry; filled by tango/native.py from
// shm._layout so C++ never re-derives the format.
struct fdr_link {
  uint8_t* base;
  uint64_t depth;
  uint64_t mtu;
  uint64_t mcache_off;
  uint64_t dcache_off;
  uint64_t dcache_sz;
  uint64_t fseq_off;
  uint64_t n_fseq;
};

struct fdr_producer {
  uint64_t seq;
  uint64_t chunk;     // compact dcache cursor (granules)
  uint64_t wmark;     // last chunk a max-size payload may start at
  uint64_t cr_avail;  // credits toward the slowest reliable consumer
  uint64_t cr_max;    // = depth (rings.FlowControl default)
  uint64_t n_rel;     // reliable fseq count (0 = free-running producer)
  uint64_t rel_idx[FDR_MAX_REL];
};

struct fdr_consumer {
  uint64_t seq;
  uint64_t ovrn_cnt;
  uint64_t fseq_idx;
  uint64_t lazy;  // publish progress every `lazy` frags (0 = every frag,
                  // shm.Consumer's `since_publish >= lazy` exactly)
  uint64_t since_publish;
};

static inline std::atomic<uint64_t>* fseq_cell(const fdr_link* l,
                                               uint64_t idx) {
  return reinterpret_cast<std::atomic<uint64_t>*>(l->base + l->fseq_off +
                                                  idx * 8);
}

void fdr_producer_init(const fdr_link* l, fdr_producer* p) {
  p->seq = 0;
  p->chunk = 0;
  uint64_t chunk_mtu = (l->mtu + CHUNK_SZ - 1) / CHUNK_SZ;
  p->wmark = l->dcache_sz / CHUNK_SZ - chunk_mtu;
  p->cr_avail = 0;  // shm.Producer boots with 0 and refreshes on demand
  p->cr_max = l->depth;
  p->n_rel = 0;  // caller fills rel_idx[] for credit-gated publishing
}

// cr_avail = max(cr_max - max(lag_i, 0), 0) over the reliable fseqs —
// rings.FlowControl.credits verbatim.  No reliable consumers = free run.
uint64_t fdr_refresh_credits(const fdr_link* l, fdr_producer* p) {
  if (!p->n_rel) {
    p->cr_avail = p->cr_max;
    return p->cr_avail;
  }
  int64_t lag = 0;
  for (uint64_t i = 0; i < p->n_rel; i++) {
    int64_t d = seq_diff(
        p->seq, fseq_cell(l, p->rel_idx[i])->load(std::memory_order_acquire));
    if (d > lag) lag = d;
  }
  int64_t cr = (int64_t)p->cr_max - lag;
  p->cr_avail = cr > 0 ? (uint64_t)cr : 0;
  return p->cr_avail;
}

// Publish one frag, no credit logic (the raw mcache.publish analog; the
// credit-gated entry points below call through here).
void fdr_publish(const fdr_link* l, fdr_producer* p, const uint8_t* payload,
                 uint64_t sz, uint64_t sig, uint64_t tsorig, uint64_t tspub) {
  uint64_t chunk = p->chunk;
  if (chunk > p->wmark) chunk = 0;
  p->chunk = chunk + (sz > 0 ? (sz + CHUNK_SZ - 1) / CHUNK_SZ : 1);

  std::memcpy(l->base + l->dcache_off + chunk * CHUNK_SZ, payload, sz);

  std::atomic<uint64_t>* r = row(l->base, l->mcache_off, l->depth, p->seq);
  r[0].store(BUSY | p->seq, std::memory_order_release);
  r[1].store(sig, std::memory_order_relaxed);
  r[2].store(chunk, std::memory_order_relaxed);
  r[3].store(sz, std::memory_order_relaxed);
  r[4].store(3 /* SOM|EOM */, std::memory_order_relaxed);
  r[5].store(tsorig, std::memory_order_relaxed);
  r[6].store(tspub, std::memory_order_relaxed);
  r[0].store(p->seq, std::memory_order_release);  // seq word LAST
  p->seq++;
}

// shm.Producer.try_publish: 1 = published, 0 = backpressured.  tsorig=0
// means "this stage is the origin" and stamps now; tspub stamps at every
// hop (fd_tango_base.h:48-60).
int fdr_try_publish(const fdr_link* l, fdr_producer* p, const uint8_t* payload,
                    uint64_t sz, uint64_t sig, uint64_t tsorig) {
  if (!p->cr_avail) {
    fdr_refresh_credits(l, p);
    if (!p->cr_avail) return 0;
  }
  uint64_t ts = now_ns();
  fdr_publish(l, p, payload, sz, sig, tsorig ? tsorig : ts, ts);
  p->cr_avail--;
  return 1;
}

// Burst publish: frame table rows of (byte offset into buf, sz, sig,
// tsorig).  Credit-gated per frame; returns frames published (stops at
// credit exhaustion — the caller keeps or drops the tail).
uint64_t fdr_publish_burst(const fdr_link* l, fdr_producer* p,
                           const uint8_t* buf, const uint64_t* tbl,
                           uint64_t n) {
  uint64_t done = 0;
  for (; done < n; done++) {
    const uint64_t* r = tbl + done * 4;
    if (!fdr_try_publish(l, p, buf + r[0], r[1], r[2], r[3])) break;
  }
  return done;
}

void fdr_publish_progress(const fdr_link* l, fdr_consumer* c) {
  fseq_cell(l, c->fseq_idx)->store(c->seq, std::memory_order_release);
  c->since_publish = 0;
}

// Poll one frag into `out` (>= mtu bytes) + meta_out[7]:
//    0 = frag copied out, -1 = not yet published, 1 = overrun (resynced).
// Consumed frags bump the lazy fseq-publication counter, same cadence as
// shm.Consumer (progress published once `since_publish >= lazy`, so
// lazy=0 publishes after every frag — the Python lane's semantics).
static int poll_step(const fdr_link* l, fdr_consumer* c, uint8_t* out,
                     uint64_t* meta_out) {
  std::atomic<uint64_t>* r = row(l->base, l->mcache_off, l->depth, c->seq);
  uint64_t mseq = r[0].load(std::memory_order_acquire);
  if (mseq & BUSY) {
    int64_t d = seq_diff(mseq & ~BUSY, c->seq);
    if (d > 0) {  // our frag is being overwritten: resync
      c->ovrn_cnt += (uint64_t)d;
      c->seq = mseq & ~BUSY;
      return 1;
    }
    return -1;  // our own frag mid-write: not ready
  }
  int64_t d = seq_diff(mseq, c->seq);
  if (d < 0) return -1;
  if (d > 0) {
    c->ovrn_cnt += (uint64_t)d;
    c->seq = mseq;
    return 1;
  }
  uint64_t sig = r[1].load(std::memory_order_relaxed);
  uint64_t chunk = r[2].load(std::memory_order_relaxed);
  uint64_t sz = r[3].load(std::memory_order_relaxed);
  uint64_t ctl = r[4].load(std::memory_order_relaxed);
  uint64_t tsorig = r[5].load(std::memory_order_relaxed);
  uint64_t tspub = r[6].load(std::memory_order_relaxed);
  if (sz > l->mtu) sz = l->mtu;  // torn row cannot overrun the out buffer
  std::memcpy(out, l->base + l->dcache_off + chunk * CHUNK_SZ, sz);
  // speculative-copy re-check: producer may have lapped us mid-copy
  if (r[0].load(std::memory_order_acquire) != c->seq) {
    c->ovrn_cnt += 1;
    return 1;
  }
  meta_out[0] = mseq;
  meta_out[1] = sig;
  meta_out[2] = chunk;
  meta_out[3] = sz;
  meta_out[4] = ctl;
  meta_out[5] = tsorig;
  meta_out[6] = tspub;
  c->seq++;
  c->since_publish++;
  if (c->since_publish >= c->lazy) fdr_publish_progress(l, c);
  return 0;
}

int fdr_poll(const fdr_link* l, fdr_consumer* c, uint8_t* out,
             uint64_t* meta_out) {
  return poll_step(l, c, out, meta_out);
}

// The stage-sweep crossing: poll all input links round-robin (starting
// at *rr_io, one frag per link per pass — runtime/stage.py's input
// fairness) into `arena`, metas into meta_out rows of 8 u64
// (seq, sig, ARENA BYTE OFFSET, sz, ctl, tsorig, tspub, in_idx — the
// first 7 columns index-compatible with an mcache row, chunk repurposed).
// Stops when max_frags frags landed or a full pass found every link
// empty.  Overruns resync + count skipped FRAGS into each consumer's
// ovrn_cnt (shm.Consumer.ovrn_cnt parity) and overrun EVENTS into
// *ovrn_out — the unit the stage-level `overrun` metric counts on the
// Python per-frag lane (one POLL_OVERRUN return per resync, however
// many frags the lap swallowed), so A/B artifacts stay commensurable.
// Returns frags delivered; *rr_io advances to the next round-robin
// cursor.
int64_t fdr_drain(fdr_link* const* links, fdr_consumer* const* cons,
                  uint64_t n_links, uint64_t* rr_io, uint64_t max_frags,
                  uint8_t* arena, uint64_t arena_sz, uint64_t* meta_out,
                  uint64_t* ovrn_out) {
  uint64_t got = 0, off = 0, rr = *rr_io, idle = 0, ovrn = 0;
  while (got < max_frags && idle < n_links) {
    uint64_t i = rr % n_links;
    const fdr_link* l = links[i];
    fdr_consumer* c = cons[i];
    rr = i + 1;
    if (off + l->mtu > arena_sz) break;  // arena full: deliver what we have
    uint64_t* m = meta_out + got * DRAIN_NCOL;
    int rc = poll_step(l, c, arena + off, m);
    if (rc == 0) {
      m[2] = off;  // chunk col -> arena byte offset (payload is a copy)
      m[7] = i;
      off += m[3];
      got++;
      idle = 0;
    } else if (rc == 1) {
      ovrn++;  // one EVENT, like one POLL_OVERRUN return per resync
      idle = 0;  // overrun: the consumer resynced — that is progress
    } else {
      idle++;
    }
  }
  *rr_io = rr % n_links;
  *ovrn_out = ovrn;
  return (int64_t)got;
}

// The generic native-stage sweep: fdr_drain's loop with a C
// stage callback invoked per frag — a registered stage's ENTIRE
// run_once sweep (drain -> stage compute -> publish, the publish side
// living behind function pointers handed to the stage module) executes
// in one FFI crossing with zero Python per frag, mirroring the
// reference's mux run loop.  The meta table still fills exactly like
// fdr_drain's so the Python side batch-observes frag latencies from the
// tsorig column without touching payloads.  The callback returns >= 0
// to continue, < 0 to stop the sweep after this (already consumed)
// frag — a stage must buffer internally rather than reject, the same
// contract its Python after_frag has.
typedef int (*fdr_sweep_cb)(void* ctx, const uint64_t* meta8,
                            const uint8_t* payload);

// The trailing `plane` is the in-crossing observability hook: when
// non-null, the sweep stamps CLOCK_MONOTONIC at every
// consumed-frag boundary (two reads per frag, none per idle poll pass
// beyond the crossing edges) and decomposes the crossing into
// drain / callback / apply / publish phase histograms — apply and
// publish arrive from the stage callback via the plane's accumulators
// (fdm_accum), callback time is reported net of them.  Per-frag
// tsorig latency observes into nsweep_lat_ns in the same breath, and
// fdm_sweep_end leaves decimated flight records straight in shm, so a
// SIGKILL mid-sweep still shows the crossing in the dump.
int64_t fdr_sweep(fdr_link* const* links, fdr_consumer* const* cons,
                  uint64_t n_links, uint64_t* rr_io, uint64_t max_frags,
                  uint8_t* arena, uint64_t arena_sz, uint64_t* meta_out,
                  uint64_t* ovrn_out, fdr_sweep_cb cb, void* cb_ctx,
                  fdm_plane* plane) {
  uint64_t got = 0, off = 0, rr = *rr_io, idle = 0, ovrn = 0;
  uint64_t drain_ns = 0, cb_ns = 0;
  uint64_t t_mark = plane ? fdm_now_ns() : 0;
  int stop = 0;
  while (!stop && got < max_frags && idle < n_links) {
    uint64_t i = rr % n_links;
    const fdr_link* l = links[i];
    fdr_consumer* c = cons[i];
    rr = i + 1;
    if (off + l->mtu > arena_sz) break;
    uint64_t* m = meta_out + got * DRAIN_NCOL;
    int rc = poll_step(l, c, arena + off, m);
    if (rc == 0) {
      m[2] = off;
      m[7] = i;
      if (plane) {
        uint64_t t1 = fdm_now_ns();
        drain_ns += t1 - t_mark;
        fdm_lat_obs(plane, t1, m[5]);
        if (cb(cb_ctx, m, arena + off) < 0) stop = 1;
        uint64_t t2 = fdm_now_ns();
        cb_ns += t2 - t1;
        t_mark = t2;
      } else {
        if (cb(cb_ctx, m, arena + off) < 0) stop = 1;
      }
      off += m[3];
      got++;
      idle = 0;
    } else if (rc == 1) {
      ovrn++;
      idle = 0;
    } else {
      idle++;
    }
  }
  if (plane) {
    drain_ns += fdm_now_ns() - t_mark;  // trailing idle passes drain out
    fdm_sweep_end(plane, got, drain_ns, cb_ns);
  }
  *rr_io = rr % n_links;
  *ovrn_out = ovrn;
  return (int64_t)got;
}


// -- the metrics plane's exported surface ------------------------------------
//
// The fdm_* inline writers live in fd_metrics.h (each client library
// carries its own copy); this library also exports the attach check and
// the test drivers, so the Python side proves the C writers word-equal
// to utils/metrics.py without a pipeline.

uint64_t fdm_abi_version(void) { return FDM_ABI_VERSION; }

// Check a plane against its raw shm segment: header magic, metric word
// count and recorder capacity must agree with what the Python binding
// derived (utils/metrics.py metrics_segment_* layout).  Returns 0 ok,
// negative = which check failed.
int fdm_plane_attach(fdm_plane* pl, const uint64_t* seg, uint64_t seg_words) {
  if (pl->version != FDM_ABI_VERSION) return -1;
  if (seg_words < FDM_SEG_HDR_WORDS) return -2;
  if (seg[0] != FDM_SEG_MAGIC) return -3;
  uint64_t n_met = seg[1];
  uint64_t rec_cap = seg[2];
  if (seg_words < FDM_SEG_HDR_WORDS + n_met + 1 + rec_cap * FDM_REC_WORDS)
    return -4;
  if (pl->met != seg + FDM_SEG_HDR_WORDS) return -5;
  if (pl->rec && pl->rec != seg + FDM_SEG_HDR_WORDS + n_met) return -6;
  if (pl->rec && pl->rec_cap != rec_cap) return -7;
  return 0;
}

// Test drivers: apply n observations/bumps through the C writers, so
// tests hold the resulting words against utils/metrics.py's
// MetricsRegistry/FlightRecorder doing the same operations.
void fdm_test_ctr(fdm_plane* pl, uint64_t off, uint64_t v) {
  fdm_ctr_add(pl, off, v);
}

void fdm_test_hist(fdm_plane* pl, const fdm_hist* h, const double* vals,
                   uint64_t n) {
  for (uint64_t i = 0; i < n; i++) fdm_hist_obs(pl->met, h, vals[i]);
}

void fdm_test_flight(fdm_plane* pl, uint64_t ev, uint64_t arg) {
  fdm_flight(pl, ev, arg);
}

void fdm_test_sweep_end(fdm_plane* pl, uint64_t got, uint64_t drain_ns,
                        uint64_t cb_ns, uint64_t apply_ns,
                        uint64_t pub_ns) {
  fdm_accum(pl, FDM_PH_APPLY, apply_ns);
  fdm_accum(pl, FDM_PH_PUBLISH, pub_ns);
  fdm_sweep_end(pl, got, drain_ns, cb_ns);
}

}  // extern "C"
