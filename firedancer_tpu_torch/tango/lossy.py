"""Lossy-link shim: deterministic frag-level network faults (the port's
copy of firedancer_tpu/tango/lossy.py).

The chaos harness's network-fault model at the tango layer: a
`LossyConsumer` wraps a real consumer and applies seeded drop / duplicate
/ reorder faults at frag granularity, driven from `utils/rng.Rng`, so
every fault sequence replays exactly from the run seed (the chaos
harness's core contract).

Liveness discipline (deliberate): the shim NEVER strands a frag.
POLL_EMPTY is returned only when the wrapped consumer is truly empty and
no shim-held frag remains, because the cooperative scheduler's drain
loops (`LeaderPipeline._sweep`) stop on a full no-progress sweep — a
frag parked behind a sleeping shim would deadlock the drain and read as
a (false) liveness violation.  Concretely:

  - drop: the frag is consumed and discarded (counted), and the shim
    polls again — a drop is invisible to the stage except as loss;
  - duplicate: the frag is delivered now AND queued for redelivery on
    the next poll (counted);
  - reorder: the frag swaps with its immediate successor when one is
    already available; with no successor the reorder degrades to
    in-order delivery (counted only when a swap happened).

Overruns pass through untouched: the shim models the NETWORK, not the
ring — an overrun is the ring's own loss signal and must stay visible.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..utils.rng import Rng

from . import shm


class LossyConsumer:
    """Wraps a `shm.Consumer` or a `native.NativeConsumer`; the same polling
    surface (`poll`, `has_pending`, `publish_progress`, attribute
    passthrough), so a Stage's input list takes it in place (both lanes
    return u64-ndarray metas, so sig values >= 2^63 survive the copy).
    Splicing the shim over a native input also drops that stage off the
    one-crossing burst-drain path (stage.py `_native_drainer` keys on the
    input objects' types), so every frag passes through the fault model.  Fault
    counters (`dropped`, `duplicated`, `reordered`) feed the chaos
    conservation invariants."""

    def __init__(self, inner: shm.Consumer, rng: Rng, *,
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 reorder_p: float = 0.0):
        self._inner = inner
        self._rng = rng
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.reorder_p = reorder_p
        self._ready: deque = deque()  # frags owed to the stage (copies)
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _take(self):
        """Next REAL frag off the inner consumer with drop applied;
        returns a (meta_copy, payload_bytes) tuple, POLL_EMPTY, or
        POLL_OVERRUN.  Meta is copied: the mcache row is a live view the
        producer may lap while the shim still holds the frag."""
        while True:
            r = self._inner.poll()
            if not isinstance(r, tuple):
                return r
            meta = np.array(r[0], copy=True)
            payload = bytes(r[1])
            if self.drop_p and self._rng.float01() < self.drop_p:
                self.dropped += 1
                continue  # eaten by the network; look at the next frag
            return meta, payload

    def poll(self):
        if self._ready:
            return self._ready.popleft()
        r = self._take()
        if not isinstance(r, tuple):
            return r
        meta, payload = r
        if self.dup_p and self._rng.float01() < self.dup_p:
            self.duplicated += 1
            self._ready.append((meta.copy(), payload))
        if self.reorder_p and self._rng.float01() < self.reorder_p:
            nxt = self._take()
            if isinstance(nxt, tuple):
                # successor first, this frag second: adjacent swap
                self.reordered += 1
                self._ready.append((meta, payload))
                return nxt
            if nxt == shm.POLL_OVERRUN:
                # the swap partner turned out to be an overrun signal:
                # deliver the held frag next, surface the overrun now
                self._ready.append((meta, payload))
                return nxt
            # nothing to swap with: in-order after all
        return meta, payload

    def has_pending(self) -> bool:
        # a shim-held frag (dup redelivery / reorder partner) IS pending
        # work even when the inner ring is empty — the adaptive
        # batch-close probe must not read backlog as idle ingress
        return bool(self._ready) or self._inner.has_pending()

    def publish_progress(self) -> None:
        self._inner.publish_progress()


def wrap_stage_input(stage, in_idx: int, rng: Rng, *, drop_p: float = 0.0,
                     dup_p: float = 0.0, reorder_p: float = 0.0
                     ) -> LossyConsumer:
    """Splice a LossyConsumer over one of `stage`'s inputs (cooperative
    pipelines; the process topology injects faults at the supervisor
    instead — chaos/faults.py)."""
    shim = LossyConsumer(stage.ins[in_idx], rng, drop_p=drop_p,
                         dup_p=dup_p, reorder_p=reorder_p)
    stage.ins[in_idx] = shim
    return shim
