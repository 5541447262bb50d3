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
on a native producer.  A dict of counters stands in for the JAX package's
shm metrics registry.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import Counter
from typing import NamedTuple

from ..tango import shm
from ..tango.native import BurstDrainer, NativeConsumer, SweepDrainer

now_ns = shm.now_ns


class Frag(NamedTuple):
    """Frag metadata: sequence number, 64-bit signature tag, origin time."""

    seq: int
    sig: int
    tsorig: int


class Metrics:
    """Counters by name and declared histograms (stand in for the JAX
    package's shm metrics; hist() returns its dict form)."""

    def __init__(self):
        self.counters: Counter = Counter()
        self._hedges: dict[str, tuple] = {}
        self._hcounts: dict[str, list[int]] = {}
        self._hsums: dict[str, float] = {}

    def inc(self, name: str, v: int = 1) -> None:
        self.counters[name] += v

    def get(self, name: str) -> int:
        return self.counters[name]

    def histogram(self, name: str, buckets: tuple) -> None:
        """Declare a histogram with these upper bucket edges (one overflow
        bucket past the last)."""
        self._hedges[name] = tuple(buckets)
        self._hcounts[name] = [0] * (len(buckets) + 1)
        self._hsums[name] = 0.0

    def observe(self, name: str, value: float) -> None:
        c = self._hcounts[name]
        c[bisect_left(self._hedges[name], value)] += 1
        if value > 0:
            self._hsums[name] += value

    def hist(self, name: str) -> dict:
        """{"buckets", "counts", "sum", "count"}; KeyError if undeclared."""
        return {
            "buckets": list(self._hedges[name]),
            "counts": list(self._hcounts[name]),
            "sum": self._hsums[name],
            "count": sum(self._hcounts[name]),
        }


class Stage:
    # housekeeping cadence (iterations) and frags drained per iteration
    lazy = 64
    burst = 16
    # drain-table batch hook: a stage may take a whole drained sweep, the
    # meta rows (as lists) and the joined payload bytes, in ONE call and
    # return how many frags it consumed (counted as frags_in), with the
    # per-frag path's counting rules for the rest.  None = the per-frag hooks.
    sweep_frags = None

    def __init__(self, name: str, ins: list | None = None,
                 outs: list | None = None):
        self.name = name
        self.ins = ins or []
        self.outs = outs or []
        self.metrics = Metrics()
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
        if drainer is not None:
            if self._sweep_client is not None:
                return self._native_sweep(drainer)
            return self._native_burst(drainer)
        return self._poll_burst()

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
                seq, sig = int(meta[0]), int(meta[1])
                if not self.before_frag(idx, seq, sig):
                    m.inc("filtered")
                else:
                    self.after_frag(idx, Frag(seq, sig, int(meta[5])), payload)
                    m.inc("frags_in")
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
                drainer = SweepDrainer(self.ins, max(1, self.burst), client)
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
        return n > 0 or d_ovr > 0

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
            return True
        before_frag, after_frag = self.before_frag, self.after_frag
        n_done = 0
        for seq, sig, off, sz, _ctl, tsorig, _tspub, idx in rows:
            if not before_frag(idx, seq, sig):
                m.inc("filtered")
                continue
            after_frag(idx, Frag(seq, sig, tsorig), buf[off : off + sz])
            n_done += 1
        if n_done:
            m.inc("frags_in", n_done)
        return True

    def drop_native_views(self) -> None:
        """Terminal: release the drain plan, whose struct pointers reach into
        the inputs' mappings, so the links can close.  The stage must not
        sweep again after this."""
        self._drainer = None

    # -- helpers ------------------------------------------------------------

    def publish(self, out_idx: int, payload: bytes, sig: int = 0,
                tsorig: int = 0) -> bool:
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
