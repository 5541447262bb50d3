"""A minimal in-process stage loop (the port's counterpart of
firedancer_tpu/runtime/stage.py, cut to what the in-process pipelines need).

Links are bounded deques of frags; a producer's credits are the free slots
of its link.  A dict of counters stands in for the shm metrics.  The hook
names are the JAX package's (the reference mux's callback set), so a later
slice can put shared-memory rings underneath without renaming anything:

    during_housekeeping()  — lazy out-of-band work (every `lazy` iterations)
    before_credit()        — every iteration, before the credit check
    after_credit()         — when every output has room (batch close, drain)
    before_frag(in_idx, seq, sig) -> bool   — cheap filter (False = skip)
    after_frag(in_idx, frag, payload)       — commit: process and publish
    flush()                — drain everything (shutdown and tests)
"""

from __future__ import annotations

import time
from bisect import bisect_left
from collections import Counter, deque
from typing import NamedTuple


class Frag(NamedTuple):
    """Frag metadata: sequence number, 64-bit signature tag, origin time."""

    seq: int
    sig: int
    tsorig: int


class Link:
    """A bounded in-process ring of (Frag, payload) entries."""

    def __init__(self, name: str, depth: int = 4096):
        self.name = name
        self.depth = depth
        self.q: deque = deque()
        self.seq = 0


class Producer:
    def __init__(self, link: Link):
        self.link = link

    @property
    def cr_avail(self) -> int:
        return self.link.depth - len(self.link.q)

    def try_publish(self, payload: bytes, sig: int = 0, tsorig: int = 0) -> bool:
        link = self.link
        if len(link.q) >= link.depth:
            return False
        link.q.append((Frag(link.seq, sig, tsorig), payload))
        link.seq += 1
        return True


class Consumer:
    def __init__(self, link: Link):
        self.link = link

    def poll(self):
        """(Frag, payload) or None when the link is empty."""
        q = self.link.q
        return q.popleft() if q else None

    def has_pending(self) -> bool:
        return bool(self.link.q)


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

    def __init__(self, name: str, ins: list | None = None,
                 outs: list | None = None):
        self.name = name
        self.ins = ins or []
        self.outs = outs or []
        self.metrics = Metrics()
        # stages that publish from after_frag set this so they never consume
        # a frag they could not forward
        self.require_credit = False
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

    def _no_credit(self) -> bool:
        return any(p.cr_avail <= 0 for p in self.outs)

    def run_once(self) -> bool:
        """One loop iteration; True if any frag was consumed."""
        self._iter += 1
        if self._iter % self.lazy == 0:
            self.during_housekeeping()
        self.before_credit()
        if self._no_credit():
            self.metrics.inc("backpressure")
        else:
            self.after_credit()
        if self.require_credit and self._no_credit():
            self.metrics.inc("backpressure_stall")
            return False
        n_in = len(self.ins)
        progressed = False
        for _ in range(self.burst):
            if progressed and self.require_credit and self._no_credit():
                break
            got = False
            for k in range(n_in):
                idx = (self._in_rr + k) % n_in
                res = self.ins[idx].poll()
                if res is None:
                    continue
                frag, payload = res
                got = progressed = True
                if not self.before_frag(idx, frag.seq, frag.sig):
                    self.metrics.inc("filtered")
                else:
                    self.after_frag(idx, frag, payload)
                    self.metrics.inc("frags_in")
                self._in_rr = (idx + 1) % n_in
                break
            if not got:
                break
        return progressed

    def publish(self, out_idx: int, payload: bytes, sig: int = 0,
                tsorig: int = 0) -> bool:
        ok = self.outs[out_idx].try_publish(payload, sig=sig, tsorig=tsorig)
        self.metrics.inc("frags_out" if ok else "backpressure")
        return ok

    def publish_burst_out(self, out_idx: int, items: list) -> int:
        """Publish (payload, sig, tsorig) items in order until credits run
        out; returns how many went out."""
        n = 0
        for payload, sig, tsorig in items:
            if not self.publish(out_idx, payload, sig, tsorig):
                break
            n += 1
        return n


def now_ns() -> int:
    return time.monotonic_ns()
