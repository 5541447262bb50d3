// fd_metrics.h — the in-crossing shm metrics writer: the port's copy of
// the JAX package's native/fd_metrics.h, unchanged below this comment.
//
// fd_ring.cpp's fdr_sweep writes the plane a stage hands it, and
// fd_bank.cpp (fdb_stage_set_metrics) and fd_shred.cpp (fds_stage_set_metrics)
// bracket their apply and publish phases into it; the Python half that
// fills fdm_plane is runtime/native_metrics.py, over utils/metrics.py's
// registry.  A null plane makes every writer here a no-op.
//
// Native twin of the shm metrics segment protocol: a sweep client bumps
// the uint64 words the Python registry lays out — relaxed-atomic counter
// adds, histogram observes with byte-identical bucket/sum semantics
// (first edge >= value; sum += trunc(value * FDM_SUM_SCALE + 0.5)
// clamped >= 0), and an in-line flight-ring writer so the record of a
// crossing survives the writing process being killed mid-sweep.  The
// layout authority stays in Python: it computes every histogram's word
// offset and bucket-edge table and hands them over in fdm_plane; this
// header only writes through the offsets it was given.
//
// Everything here is static inline: each .so carries its own copy, no
// cross-library linkage, no ODR hazard.

#pragma once

#include <cstdint>
#include <ctime>

// ABI + segment constants (mirrored by the Python side of the plane).
#define FDM_ABI_VERSION 1
#define FDM_SEG_MAGIC 0xFD7B0F17
#define FDM_SEG_HDR_WORDS 4
#define FDM_REC_WORDS 3
#define FDM_SUM_SCALE 1024
// flight events are decimated: one EV_NSWEEP_* pair every this many
// non-empty crossings (the FIRST crossing always records, so even a
// short-lived stage leaves evidence in the ring)
#define FDM_FLIGHT_DECIMATE 64

// flight event ids (EV_NSWEEP_DRAIN / EV_NSWEEP_PUBLISH)
#define FDM_EV_NSWEEP_DRAIN 18
#define FDM_EV_NSWEEP_PUBLISH 19

// sweep phases, in crossing order (NSWEEP_PHASES)
enum {
  FDM_PH_DRAIN = 0,    // poll_step spins + payload copy-in
  FDM_PH_CB = 1,       // stage callback minus attributed sub-phases
  FDM_PH_APPLY = 2,    // funk/store apply inside the callback
  FDM_PH_PUBLISH = 3,  // downstream publish inside the crossing
  FDM_NPH = 4
};

// feature flags: a zeroed flag makes the matching writer a no-op, so a
// partially-bound plane (e.g. no xlat histogram in this stage's
// schema) is safe to hand to any client
enum {
  FDM_F_CTR = 1,     // nsweep_frags / nsweep_crossings counters bound
  FDM_F_PH = 2,      // phase histograms bound
  FDM_F_FLIGHT = 4,  // flight ring bound
  FDM_F_LAT = 8,     // nsweep_lat_ns bound
  FDM_F_XLAT = 16    // stage-extra histogram bound (bank txn latency)
};

// One histogram's layout: `off` indexes the first bucket word inside
// met[] (words used: n buckets + overflow + scaled sum = n + 2); the
// edge table is Python-owned (kept alive by the binding for the
// plane's lifetime).
struct fdm_hist {
  uint64_t off;
  uint64_t n;
  const double* edges;
};

// The per-stage writer handle, filled by the Python side of the plane
// from the stage's MetricsRegistry/FlightRecorder views.  met/rec
// point INTO the shm segment; everything else is plain process-local
// state (the plane lives on the stage's own thread — accumulators are
// not shared).
struct fdm_plane {
  uint64_t version;          // = FDM_ABI_VERSION (checked at bind)
  uint64_t* met;             // metric words (registry base)
  uint64_t* rec;             // flight ring (count word first), or null
  uint64_t rec_cap;          // flight ring capacity (records)
  uint64_t flags;            // FDM_F_* capability bits
  uint64_t c_frags_off;      // nsweep_frags counter word
  uint64_t c_crossings_off;  // nsweep_crossings counter word
  fdm_hist ph[FDM_NPH];      // nsweep_{drain,callback,apply,publish}_ns
  fdm_hist lat;              // nsweep_lat_ns (tsorig -> consume, per frag)
  fdm_hist xlat;             // stage extra (bank: nbank_txn_lat_ns)
  uint64_t ph_accum[FDM_NPH];  // per-crossing ns accumulators
  uint64_t crossings;        // process-lifetime count (flight decimation)
};

static inline uint64_t fdm_now_ns(void) {
  // CLOCK_MONOTONIC == time.monotonic_ns(): native timestamps compare
  // against Python-side readings and Python-stamped tsorig columns
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// Relaxed-atomic counter bump: the monitor reads cross-process with no
// lock; word-sized relaxed adds are exactly the reference's discipline.
static inline void fdm_ctr_add(fdm_plane* pl, uint64_t off, uint64_t v) {
  if (!pl->met || !(pl->flags & FDM_F_CTR)) return;
  __atomic_fetch_add(pl->met + off, v, __ATOMIC_RELAXED);
}

// Histogram observe, byte-identical to MetricsRegistry.observe():
// count lands in the first bucket whose edge >= value (overflow word
// at index n), sum word adds trunc(value * FDM_SUM_SCALE + 0.5)
// clamped to >= 0 (the scaled-integer sum protocol).
static inline void fdm_hist_obs(uint64_t* met, const fdm_hist* h, double v) {
  uint64_t i = 0;
  while (i < h->n && h->edges[i] < v) i++;
  __atomic_fetch_add(met + h->off + i, 1ull, __ATOMIC_RELAXED);
  int64_t s = (int64_t)(v * (double)FDM_SUM_SCALE + 0.5);
  if (s > 0)
    __atomic_fetch_add(met + h->off + h->n + 1, (uint64_t)s,
                       __ATOMIC_RELAXED);
}

// In-line flight record (FlightRecorder.record's wire protocol): read
// the count word, write the (ts, event, arg) triple into the ring
// slot, release-store count+1 — straight to shm, so the record
// survives the writer dying on the very next instruction.
static inline void fdm_flight(fdm_plane* pl, uint64_t ev, uint64_t arg) {
  if (!pl->rec || !pl->rec_cap || !(pl->flags & FDM_F_FLIGHT)) return;
  uint64_t n = __atomic_load_n(pl->rec, __ATOMIC_RELAXED);
  uint64_t* r = pl->rec + 1 + (n % pl->rec_cap) * FDM_REC_WORDS;
  r[0] = fdm_now_ns();
  r[1] = ev;
  r[2] = arg;
  __atomic_store_n(pl->rec, n + 1, __ATOMIC_RELEASE);
}

// Per-frag tsorig->consume latency, stamped in-crossing (the native
// twin of the Python lane's frag_latency_ns batch observe).
static inline void fdm_lat_obs(fdm_plane* pl, uint64_t now,
                               uint64_t tsorig) {
  if (!(pl->flags & FDM_F_LAT) || !tsorig || now <= tsorig) return;
  fdm_hist_obs(pl->met, &pl->lat, (double)(now - tsorig));
}

// Sub-phase attribution from INSIDE a stage callback: the stage module
// brackets its funk-apply / publish sections with fdm_now_ns() reads
// and accumulates here; fdm_sweep_end folds the accumulators into the
// per-phase histograms once per crossing.
static inline void fdm_accum(fdm_plane* pl, int phase, uint64_t ns) {
  if (pl) pl->ph_accum[phase] += ns;
}

// Crossing epilogue (called by fdr_sweep): observe the phase
// decomposition for this crossing, bump the frag/crossing counters,
// and leave a decimated flight trail.  callback time is reported NET
// of the attributed apply/publish accumulators so the four phases sum
// to the crossing (up to clock-read cost).
static inline void fdm_sweep_end(fdm_plane* pl, uint64_t got,
                                 uint64_t drain_ns, uint64_t cb_ns) {
  if (!pl) return;
  uint64_t apply_ns = pl->ph_accum[FDM_PH_APPLY];
  uint64_t pub_ns = pl->ph_accum[FDM_PH_PUBLISH];
  pl->ph_accum[FDM_PH_APPLY] = 0;
  pl->ph_accum[FDM_PH_PUBLISH] = 0;
  if (!got) return;  // idle sweeps are not crossings
  uint64_t inner = apply_ns + pub_ns;
  if (inner > cb_ns) inner = cb_ns;  // clock skew guard: phases nest
  if (pl->flags & FDM_F_PH) {
    fdm_hist_obs(pl->met, &pl->ph[FDM_PH_DRAIN], (double)drain_ns);
    fdm_hist_obs(pl->met, &pl->ph[FDM_PH_CB], (double)(cb_ns - inner));
    if (apply_ns)
      fdm_hist_obs(pl->met, &pl->ph[FDM_PH_APPLY], (double)apply_ns);
    if (pub_ns)
      fdm_hist_obs(pl->met, &pl->ph[FDM_PH_PUBLISH], (double)pub_ns);
  }
  fdm_ctr_add(pl, pl->c_frags_off, got);
  fdm_ctr_add(pl, pl->c_crossings_off, 1);
  if ((pl->crossings % FDM_FLIGHT_DECIMATE) == 0) {
    fdm_flight(pl, FDM_EV_NSWEEP_DRAIN, got);
    if (pub_ns) fdm_flight(pl, FDM_EV_NSWEEP_PUBLISH, got);
  }
  pl->crossings++;
}

// Standalone publish-crossing observe: for clients whose publish burst
// happens OUTSIDE the sweep callback (verify's Python-side reap), the
// burst duration observes straight into the publish histogram with its
// own decimated flight record.
static inline void fdm_publish_obs(fdm_plane* pl, uint64_t ns,
                                   uint64_t frames) {
  if (!pl || !frames) return;
  if (pl->flags & FDM_F_PH)
    fdm_hist_obs(pl->met, &pl->ph[FDM_PH_PUBLISH], (double)ns);
  if ((pl->crossings % FDM_FLIGHT_DECIMATE) == 0)
    fdm_flight(pl, FDM_EV_NSWEEP_PUBLISH, frames);
  pl->crossings++;
}
