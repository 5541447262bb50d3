"""The stage run loop over shared-memory rings (the port's counterpart of
firedancer_tpu/runtime/stage.py).

A stage owns input links as consumers and output links as producers
(tango/shm.py: the Python lane, or tango/native.py: the native one, over
the same bytes).  A producer's credits come from its reliable consumers'
fseqs, which they publish lazily, every `lazy` frags and at each
housekeeping pass.  The loop is cooperative: `run_once` does one
iteration, so one process drives a whole pipeline.

The hooks keep the port's names and its frag view, `Frag(seq, sig,
tsorig)`, on every path (the meta row of the JAX package's hooks is not
used); the view is built here, in one place:

    during_housekeeping()  — lazy out-of-band work (every `lazy` iterations,
                             after the inputs publish their progress and
                             the outputs refresh their credits)
    before_credit()        — every iteration, before the credit check
    after_credit()         — when every output has credits (batch close, drain)
    before_frag(in_idx, seq, sig) -> bool   — cheap filter (False = skip)
    after_frag(in_idx, frag, payload)       — commit: process and publish
    sweep_frags(rows, buf) -> int           — optional: a whole drained
                             sweep in one call (see `_native_burst`)
    flush()                — drain everything (shutdown and tests)

Three input paths, picked per sweep:

  - every input a native consumer: ONE fdr_drain call pulls up to `burst`
    frags from all inputs round-robin (capped at the outputs' credits when
    `require_credit` is set), then the hooks run over the meta table;
  - a stage that registers a sweep client (`_sweep_client`, an object with
    `.cb`/`.cb_ctx`, the bank stage's runtime/bank_native.StageClient):
    ONE fdr_sweep call drains and runs the client's C callback per frag;
  - otherwise: a Python poll per frag.

`publish_burst_out` publishes a frame list in one fdr_publish_burst call
on a native producer.

Metrics (the JAX package's two tiers): the per-frag path counts in plain
dicts (`Metrics`), and `Metrics.flush`, from every housekeeping pass,
stores them into the stage's MetricsRegistry (utils/metrics.py: one flat
u64 array, shm-backable) once one is attached.  A stage with a sweep
client also has the shm metrics plane (runtime/native_metrics.NativePlane,
over a private registry when none is attached): fdr_sweep and the client's
C side write its native words from inside the crossing (nsweep_frags,
nsweep_crossings, the per-crossing drain / callback / apply / publish
histograms, the in-crossing tsorig latency), and flush never stores one.
Read them with `stage.metrics.registry.get(...)` / `.hist(...)`;
`sweep_frags` counts, on the Python side, the frags fdr_sweep returned.
Every path observes each consumed frag's now - tsorig into
`frag_latency_ns` (one clock read a sweep on the burst paths): the
monitor's latency columns and the slot report's end-to-end quantiles.

Supervision (the process runner, runtime/topo.py): every stage has a
command-and-control cell (`cnc`, tango/rings.Cnc; a local one unless the
runner hands in its shm cell).  Each housekeeping pass stamps the cnc's
heartbeat and stores the DIAG_* words; `run()` loops `run_once` until the
cnc signals HALT, napping after IDLE_SPINS sweeps that moved nothing
(each sweep that moved something adds its host time to `busy_ns`), and
`halt()` signals it.  `attach_observability` swaps in the runner's shm
registry and flight ring.  For an in-place restart, `arm_safe_progress`
makes fseq publication transactional (progress moves only after a sweep's
effects are published) and `resume_from_rings` reattaches to the live
rings: consumers at their published fseqs, producers at their recovered
frontiers, with a publish guard that swallows the replayed frags a
producer's ring already carries (`restart_dedup`).  The guard sees the
Python publish paths only, so a stage whose sweep client publishes from C
refuses arm_safe_progress, unless the client declares `honours_guard` and
takes the guard on its C side (the chaos relay's).
"""

from __future__ import annotations

import time
from bisect import bisect_left
from collections import Counter
from typing import NamedTuple

import numpy as np

from ..tango import shm
from ..tango.native import BurstDrainer, NativeConsumer, SweepDrainer
from ..tango.rings import CNC_SIG_HALT, CNC_SIG_RUN, Cnc
from ..utils import metrics as fm

now_ns = shm.now_ns

# Stage.run's nap: IDLE_SLEEP_S after IDLE_SPINS sweeps that moved nothing
IDLE_SPINS, IDLE_SLEEP_S = 256, 0.001


class Frag(NamedTuple):
    """Frag metadata: sequence number, 64-bit signature tag, origin time."""

    seq: int
    sig: int
    tsorig: int


# below this many values a Python pass beats numpy's per-call cost
_SHORT_BATCH = 32


class Metrics:
    """A stage's metrics over a declared schema (utils/metrics.py), in two
    tiers: the per-frag path updates plain dicts (a numpy u64 store costs
    ~20x a dict bump), and `flush()` stores them into the attached
    MetricsRegistry.  Counter names outside the schema stay local;
    `observe` needs a declared histogram (the schema's, or one added with
    `histogram`).  The schema's native words (a C sweep client's) get no
    local state and are never stored: read them off `registry`."""

    def __init__(self, schema: fm.MetricsSchema | None = None):
        self.schema = schema if schema is not None else fm.stage_schema()
        self.counters: Counter = Counter()
        self._hedges: dict[str, tuple] = {}
        self._hcounts: dict[str, list[int]] = {}
        self._hsums: dict[str, float] = {}
        for d in self.schema.defs:
            if d.kind == fm.HISTOGRAM and not d.native:
                self._declare(d.name, d.buckets)
        self.registry: fm.MetricsRegistry | None = None

    def inc(self, name: str, v: int = 1) -> None:
        self.counters[name] += v

    def get(self, name: str) -> int:
        return self.counters[name]

    def assign(self, values: dict) -> None:
        """Set counters to absolute values (a sweep client's running totals);
        Counter.update would add them."""
        for name, v in values.items():
            self.counters[name] = v

    def _declare(self, name: str, buckets: tuple) -> None:
        self._hedges[name] = tuple(buckets)
        self._hcounts[name] = [0] * (len(buckets) + 1)
        self._hsums[name] = 0.0

    def histogram(self, name: str, buckets: tuple) -> None:
        """Declare a histogram with these upper bucket edges (one overflow
        bucket past the last); it joins the schema, so a registry attached
        later lays it out."""
        self._declare(name, buckets)
        if self.registry is None and name not in self.schema.names():
            self.schema.histogram(name, buckets)

    def observe(self, name: str, value: float) -> None:
        c = self._hcounts[name]
        c[bisect_left(self._hedges[name], value)] += 1
        if value > 0:
            self._hsums[name] += value

    def observe_batch(self, name: str, values) -> None:
        """observe() over a sequence of values: one at a time for a short
        one, one numpy pass for a long one (a numpy pass costs ~15 us, a
        value ~0.5 us)."""
        if len(values) <= _SHORT_BATCH:
            c, edges, total = self._hcounts[name], self._hedges[name], 0
            for v in (values.tolist() if isinstance(values, np.ndarray) else values):
                c[bisect_left(edges, v)] += 1
                if v > 0:
                    total += v
            self._hsums[name] += total
            return
        v = np.asarray(values, dtype=np.float64)
        idx = np.searchsorted(self._hedges[name], v, side="left")
        c = self._hcounts[name]
        for i, k in enumerate(np.bincount(idx, minlength=len(c)).tolist()):
            if k:
                c[i] += k
        self._hsums[name] += float(v[v > 0].sum())

    def hist(self, name: str) -> dict:
        """{"buckets", "counts", "sum", "count"}; KeyError if undeclared."""
        return {
            "buckets": list(self._hedges[name]),
            "counts": list(self._hcounts[name]),
            "sum": self._hsums[name],
            "count": sum(self._hcounts[name]),
        }

    # -- the registry ---------------------------------------------------------

    def attach(self, registry: fm.MetricsRegistry) -> None:
        """Bind a registry laid out from this schema and store the local
        state into it at once."""
        self.registry = registry
        self.flush()

    def flush(self) -> None:
        """Store the local counters and histograms into the attached
        registry (no-op unattached); native words are left as C wrote them."""
        reg = self.registry
        if reg is None:
            return
        for name, (d, _off) in reg._off.items():
            if d.native:
                continue
            if d.kind == fm.HISTOGRAM:
                if name in self._hcounts:
                    reg.store_hist(name, self._hcounts[name], self._hsums[name])
            elif name in self.counters:
                reg.store(name, self.counters[name])


class Stage:
    # housekeeping cadence (iterations) and frags drained per iteration
    lazy = 64
    burst = 16
    # counters of this kind, published to its registry beside the shared
    # stage-loop block (extra_schema)
    counters: tuple = ()
    # drain-table batch hook: a stage may take a whole drained sweep, the
    # meta rows (as lists) and the joined payload bytes, in ONE call and
    # return how many frags it consumed (counted as frags_in), with the
    # per-frag path's counting rules for the rest.  None = the per-frag hooks.
    sweep_frags = None

    # a stage-extra native histogram the plane binds to its extra slot (the
    # bank's nbank_txn_lat_ns, written by its C side)
    native_xlat_metric: str | None = None

    # the cnc's diagnostic words, stored at every housekeeping pass
    DIAG_FRAGS_IN = 0
    DIAG_FRAGS_OUT = 1
    DIAG_OVERRUN = 2
    DIAG_BACKPRESSURE = 3
    DIAG_ITER = 4
    DIAG_RUN_AT = 5  # CLOCK_MONOTONIC ns at run()'s start

    def __init__(self, name: str, ins: list | None = None,
                 outs: list | None = None, *, cnc: Cnc | None = None):
        self.name = name
        self.ins = ins or []
        self.outs = outs or []
        self.cnc = cnc if cnc is not None else Cnc()
        self.metrics = Metrics(type(self).metrics_schema())
        # the flight ring (the metrics plane's C side records sweeps into
        # it too); attach_observability swaps in the runner's shm ring
        self.recorder = fm.FlightRecorder(fm.FLIGHT_DEPTH)
        self.recorder.record(fm.EV_BOOT)
        # in-place restart: out_idx -> the sigs its ring carried before the
        # crash (resume_from_rings); publish swallows those until the
        # replay passes the crash point
        self._resume_guards: dict[int, set[int]] = {}
        self._guard_max: dict[int, int] = {}  # each guard's largest sig
        # transactional progress (arm_safe_progress)
        self.safe_progress = False
        # the plane, cached with the registry it was built on
        self._nplane: tuple | None = None
        # stages that publish from after_frag set this so they never consume
        # a frag they could not forward
        self.require_credit = False
        # the sweep-harness client (see the module docstring)
        self._sweep_client = None
        # the cached drain plan: (inputs, drainer, client), rebuilt when the
        # input list or the client changes
        self._drainer: tuple | None = None
        self._iter = 0
        self._in_rr = 0

    # -- metrics ------------------------------------------------------------

    @classmethod
    def metrics_schema(cls) -> fm.MetricsSchema:
        """The stage kind's layout: the shared stage-loop block and whatever
        `extra_schema` adds."""
        s = fm.stage_schema()
        # the run loop's busy time (Stage.run): the port's, past the JAX
        # package's stage block
        s.counter("busy_ns", "host ns of run() sweeps that consumed or published")
        have = s.names()
        s.defs.extend(d for d in cls.extra_schema().defs if d.name not in have)
        return s

    @classmethod
    def extra_schema(cls) -> fm.MetricsSchema:
        s = fm.MetricsSchema()
        for name in dict.fromkeys(cls.counters):
            s.counter(name)
        return s

    # -- observability and supervision ---------------------------------------

    def trace(self, event: int, arg: int = 0) -> None:
        """Flight-recorder append (rare events only, never per frag)."""
        self.recorder.record(event, arg)

    def attach_observability(self, registry: fm.MetricsRegistry,
                             recorder: fm.FlightRecorder) -> None:
        """Bind the runner's shm registry and flight ring (a child's boot,
        after its builder ran).  The metrics plane and the drain plan that
        embeds it are rebuilt on the new registry at the next sweep; the
        sweep client's C side drops its pointer to the old plane now, so
        nothing writes into the old registry again."""
        self.metrics.attach(registry)
        self.recorder.replay_into(recorder)
        self.recorder = recorder
        self._nplane = None
        self._drainer = None
        client = self._sweep_client
        if client is not None and getattr(client, "_plane", None) is not None:
            client.set_metrics(None)

    def arm_safe_progress(self) -> None:
        """Make fseq publication transactional (a restartable stage's
        contract): consumers stop publishing progress mid-poll, and
        run_once publishes it only after a sweep's effects are out, so a
        SIGKILL leaves every fseq where everything before it is on the
        wire.  A stage with a sweep client raises, as its C side publishes
        without the replay guard resume_from_rings arms, unless the client
        declares `honours_guard` (it takes the guard itself: the relay's,
        tango/native.NativeRelayClient)."""
        client = self._sweep_client
        if client is not None and not getattr(client, "honours_guard", False):
            raise ValueError(f"stage '{self.name}': a sweep client publishes from C, past the"
                             f" in-place restart's publish guard; it cannot be restartable")
        self.safe_progress = True
        for c in self.ins:
            c.set_lazy(1 << 62)

    def _commit_progress(self) -> None:
        for c in self.ins:
            c.publish_progress()

    def resume_from_rings(self) -> None:
        """Reattach to the live rings after a respawn: every consumer at
        the progress it last published (frags consumed past it replay),
        every producer at the frontier recovered from its ring, with that
        ring's sigs arming the publish guard.  Exactly-once holds for
        stages whose output is a function of their input stream and whose
        sigs are unique within a ring depth; a source stage (no inputs)
        derives its own progress from its producers' seqs."""
        for c in self.ins:
            c.resume()
        self._resume_guards = {}
        self._guard_max = {}
        for i, p in enumerate(self.outs):
            sigs = p.resume()
            if sigs:
                self._resume_guards[i] = sigs
                self._guard_max[i] = max(sigs)
        self.trace(fm.EV_RESTART, self._iter)

    def _guarded(self, out_idx: int, sig: int) -> bool:
        """True when this publish replays a frag the ring already carries:
        swallow it.  The guard disarms at the first sig above every sig
        the ring carried (the replay passed the crash point); a sig below
        that the ring never carried (a frag dropped before the crash) goes
        out and leaves the guard armed."""
        g = self._resume_guards.get(out_idx)
        if g is None:
            return False
        if sig in g:
            g.discard(sig)
            self.metrics.inc("restart_dedup")
            return True
        if sig > self._guard_max[out_idx]:
            del self._resume_guards[out_idx]
            del self._guard_max[out_idx]
        return False

    def run(self) -> None:
        """The process runner's loop: run_once until the cnc signals HALT.
        A stage without a core of its own naps IDLE_SLEEP_S after
        IDLE_SPINS sweeps that consumed and published nothing, so it does
        not steal the CPU from busy siblings.  The host
        time of the sweeps that consumed or published adds up in the
        busy_ns counter (the process's CPU time also holds the idle ones)."""
        idle = 0
        busy = 0.0
        pc = time.perf_counter
        m = self.metrics.counters
        t = time.monotonic_ns()
        self.cnc.heartbeat(t)
        self.cnc.diag_set(self.DIAG_RUN_AT, t)
        self.cnc.signal = CNC_SIG_RUN
        self.trace(fm.EV_RUN)
        cells = self.cnc.cells
        while int(cells[0]) != CNC_SIG_HALT:
            out0 = m["frags_out"]
            t0 = pc()
            if self.run_once() or m["frags_out"] != out0:
                busy += pc() - t0
                m["busy_ns"] = int(busy * 1e9)
                idle = 0
            else:
                idle += 1
                if idle >= IDLE_SPINS:
                    time.sleep(IDLE_SLEEP_S)
        self.trace(fm.EV_HALT, self._iter)
        self.metrics.flush()

    def halt(self) -> None:
        self.cnc.signal = CNC_SIG_HALT

    def _native_plane(self):
        """The stage's metrics plane (runtime/native_metrics.NativePlane),
        built on the attached registry, or on a private one attached here
        when there is none.  A plane that cannot be built raises."""
        cached = self._nplane
        if cached is not None and cached[0] is self.metrics.registry:
            return cached[1]
        from .native_metrics import NativePlane

        if self.metrics.registry is None:
            self.metrics.attach(fm.MetricsRegistry(self.metrics.schema))
        plane = NativePlane(self.metrics.registry, self.recorder, xlat=self.native_xlat_metric)
        self._nplane = (self.metrics.registry, plane)
        return plane

    # -- hooks (override in subclasses) ------------------------------------

    def during_housekeeping(self) -> None: ...

    def before_credit(self) -> None: ...

    def after_credit(self) -> None: ...

    def before_frag(self, in_idx: int, seq: int, sig: int) -> bool:
        return True

    def after_frag(self, in_idx: int, frag: Frag, payload: bytes) -> None: ...

    def flush(self) -> None: ...

    # -- the loop ------------------------------------------------------------

    def _housekeeping(self) -> None:
        for c in self.ins:
            c.publish_progress()
        for p in self.outs:
            p.refresh_credits()
        self.during_housekeeping()
        m = self.metrics
        cnc = self.cnc
        cnc.heartbeat(time.monotonic_ns())
        cnc.diag_set(self.DIAG_FRAGS_IN, m.get("frags_in"))
        cnc.diag_set(self.DIAG_FRAGS_OUT, m.get("frags_out"))
        cnc.diag_set(self.DIAG_OVERRUN, m.get("overrun"))
        cnc.diag_set(self.DIAG_BACKPRESSURE, m.get("backpressure"))
        cnc.diag_set(self.DIAG_ITER, self._iter)
        m.flush()

    def _no_credit(self) -> bool:
        for p in self.outs:  # a loop, not any(): this runs thrice a sweep
            if p.cr_avail <= 0:
                return True
        return False

    def run_once(self) -> bool:
        """One loop iteration; True if any frag was consumed (or an overrun
        resynced an input)."""
        self._iter += 1
        if self._iter % self.lazy == 0:
            self._housekeeping()
        self.before_credit()
        stalled = self._no_credit()
        if stalled:
            for p in self.outs:  # stale credits: read the consumers' fseqs
                p.refresh_credits()
            stalled = self._no_credit()
        if stalled:
            self.metrics.inc("backpressure")
        else:
            self.after_credit()
            # after_credit may have spent the last credit
            stalled = self.require_credit and self._no_credit()
        if stalled and self.require_credit:
            self.metrics.inc("backpressure_stall")
            return False
        if not self.ins:
            return False
        drainer = self._native_drainer()
        if drainer is None:
            progressed = self._poll_burst()
        elif self._sweep_client is not None:
            progressed = self._native_sweep(drainer)
        else:
            progressed = self._native_burst(drainer)
        if progressed and self.safe_progress:
            self._commit_progress()  # the sweep's effects are out
        return progressed

    def _poll_burst(self) -> bool:
        """Up to `burst` frags by Python polls, round-robin over the inputs."""
        n_in = len(self.ins)
        m = self.metrics
        progressed = False
        for _ in range(self.burst):
            if progressed and self.require_credit and self._no_credit():
                break
            got = False
            for k in range(n_in):
                idx = (self._in_rr + k) % n_in
                res = self.ins[idx].poll()
                if res is shm.POLL_EMPTY:
                    continue
                got = progressed = True
                self._in_rr = (idx + 1) % n_in
                if res is shm.POLL_OVERRUN:
                    m.inc("overrun")
                    break
                meta, payload = res
                seq, sig, ts = int(meta[0]), int(meta[1]), int(meta[5])
                if not self.before_frag(idx, seq, sig):
                    m.inc("filtered")
                else:
                    self.after_frag(idx, Frag(seq, sig, ts), payload)
                    m.inc("frags_in")
                    if ts:
                        lat = shm.now_ns() - ts
                        if lat >= 0:
                            m.observe("frag_latency_ns", lat)
                break
            if not got:
                break
        return progressed

    def _native_drainer(self):
        """The cached drain plan when EVERY input is a native consumer, else
        None (the per-frag poll path)."""
        cached = self._drainer
        client = self._sweep_client
        if cached is not None and cached[0] == self.ins and cached[2] is client:
            return cached[1]
        drainer = None
        if all(type(c) is NativeConsumer for c in self.ins):
            if client is not None:
                plane = self._native_plane()
                drainer = SweepDrainer(self.ins, max(1, self.burst), client, plane)
                set_metrics = getattr(client, "set_metrics", None)
                if set_metrics is not None:
                    # the client's own C side brackets its apply and publish
                    # phases (and the bank its per-txn latency) into it too
                    set_metrics(plane)
            else:
                drainer = BurstDrainer(self.ins, max(1, self.burst))
        self._drainer = (list(self.ins), drainer, client)
        return drainer

    def _native_sweep(self, drainer: SweepDrainer) -> bool:
        """One fdr_sweep call: drain and the client's C callback per frag."""
        if not drainer.pending():
            return False
        n, self._in_rr, d_ovr = drainer.sweep(self._in_rr, max(1, self.burst))
        if d_ovr:
            self.metrics.inc("overrun", d_ovr)
        if n:
            self.metrics.inc("frags_in", n)
            self.metrics.inc("sweep_frags", n)
            self._observe_latency(drainer.meta[:n, 5])
        return n > 0 or d_ovr > 0

    def _observe_latency(self, ts_col) -> None:
        """frag_latency_ns (now - tsorig) over a sweep's tsorig column, one
        clock read for the sweep; frags without a tsorig are left out.  A
        short sweep (the common one) takes no numpy pass."""
        now = shm.now_ns()
        if len(ts_col) <= _SHORT_BATCH:
            tl = ts_col.tolist() if isinstance(ts_col, np.ndarray) else ts_col
            self.metrics.observe_batch("frag_latency_ns",
                                       [now - t for t in tl if t and now >= t])
            return
        ts = np.asarray(ts_col, dtype=np.int64)
        lat = now - ts
        ok = lat[(ts > 0) & (lat >= 0)]
        if ok.size:
            self.metrics.observe_batch("frag_latency_ns", ok)

    def _native_burst(self, drainer: BurstDrainer) -> bool:
        """One fdr_drain call, then the hooks over the meta table: each row
        is (seq, sig, arena offset, sz, ctl, tsorig, tspub, in_idx) and the
        payloads lie back to back in the arena."""
        max_frags = max(1, self.burst)
        if not drainer.pending():
            return False
        if self.require_credit and self.outs:
            # never pull a frag that may not be forwarded: each input frag
            # spends at most one credit of each output in every stage that
            # sets require_credit
            max_frags = min(max_frags, min(p.cr_avail for p in self.outs))
            if max_frags <= 0:
                return False
        m = self.metrics
        n, self._in_rr, d_ovr = drainer.drain(self._in_rr, max_frags)
        if d_ovr:
            m.inc("overrun", d_ovr)
        if n == 0:
            return d_ovr > 0
        rows = drainer.meta[:n].tolist()
        last = rows[-1]
        buf = drainer.arena[: last[2] + last[3]].tobytes()
        if self.sweep_frags is not None:
            m.inc("frags_in", self.sweep_frags(rows, buf))
            self._observe_latency(drainer.meta[:n, 5])
            return True
        before_frag, after_frag = self.before_frag, self.after_frag
        n_done = 0
        ts_done = []
        for seq, sig, off, sz, _ctl, tsorig, _tspub, idx in rows:
            if not before_frag(idx, seq, sig):
                m.inc("filtered")
                continue
            after_frag(idx, Frag(seq, sig, tsorig), buf[off : off + sz])
            n_done += 1
            ts_done.append(tsorig)
        if n_done:
            m.inc("frags_in", n_done)
            self._observe_latency(ts_done)
        return True

    def drop_native_views(self) -> None:
        """Terminal: release the drain plan, whose struct pointers reach into
        the inputs' mappings, so the links can close, and the metrics
        plane, whose pointer the sweep client's C side drops too.  The
        stage must not sweep again after this; its registry stays
        readable."""
        self._drainer = None
        self._nplane = None
        client = self._sweep_client
        if client is not None and getattr(client, "_plane", None) is not None:
            client.set_metrics(None)

    # -- helpers ------------------------------------------------------------

    def publish(self, out_idx: int, payload: bytes, sig: int = 0,
                tsorig: int = 0) -> bool:
        if self._resume_guards and self._guarded(out_idx, sig):
            return True  # a replay: on the wire before the crash
        ok = self.outs[out_idx].try_publish(payload, sig=sig, tsorig=tsorig)
        self.metrics.inc("frags_out" if ok else "backpressure")
        return ok

    def publish_burst_out(self, out_idx: int, items: list) -> int:
        """Publish (payload, sig, tsorig) items in order until credits run
        out (one fdr_publish_burst call on a native producer); the
        shortfall counts as backpressure and stays with the caller.
        Returns how many went out."""
        if not items:
            return 0
        if out_idx in self._resume_guards:
            # the replay window after a restart: frame by frame, so the
            # guard sees every sig (it disarms within one ring depth)
            n = 0
            for payload, sig, tsorig in items:
                if not self.publish(out_idx, payload, sig=sig, tsorig=tsorig):
                    break
                n += 1
            return n
        p = self.outs[out_idx]
        burst = getattr(p, "publish_burst", None)
        if burst is not None:
            n = burst(items)
        else:
            n = 0
            for payload, sig, tsorig in items:
                if not p.try_publish(payload, sig=sig, tsorig=tsorig):
                    break
                n += 1
        if n:
            self.metrics.inc("frags_out", n)
        if n < len(items):
            self.metrics.inc("backpressure", len(items) - n)
        return n
