"""PoH stage: the hash clock ticking between microblock mixins (the port's
counterpart of firedancer_tpu/runtime/poh_stage.py).

Hash continuously, mix in each executed microblock from the banks, emit
ticks on the tick cadence, and forward entries downstream to shred.
Generation is sequential host work by design (hashlib; the chain cannot
be parallelized forward); verification batches onto the card (K4).

Inputs:  ins[b] = bank b -> poh executed microblocks.
Outputs: outs[0] = poh -> shred entries.

Entry frame: u32 num_hashes | 32B poh_hash | u16 txn_cnt |
(u16 len || raw txn payload)*: the Solana entry triple (hashes since the
previous entry, the chain hash after this entry, the txns).  Ticks are
entries with txn_cnt = 0.

With a serving plane (parallel/serve.ServePlane), every full-tick
pure-append span is parked on the plane (`queue_poh_span`) and
re-verified by K4 on a later plane step.

With a slot clock (runtime/slot_clock.py) the wall clock, not the txn
stream, decides when ticks land and when a slot seals: tick k of a slot
may complete only once it is due, the slot seals at its deadline whatever
load is pending (`slots_sealed`, with the landing time past the deadline
in the `slot_seal_lag_ns` histogram), and a boundary that passes its
grace unsealed (a stalled loop, starved credits) becomes a counted miss
(`slot_missed`, `slot_skipped_ticks`): the stage skips to the slot the
clock says is current and keeps going.  After the leader window's last
slot `window_closed` is set and no tick lands again.  The port's stages
have no flight recorder: the counters carry every outcome.
"""

from __future__ import annotations

from ..utils import metrics as fm
from ..utils.metrics import exp_buckets
from .poh import PohChain
from .slot_clock import resolve_clock
from .stage import Stage

SEAL_LAG_BUCKETS = exp_buckets(1e4, 1e10, 19)  # ns past the slot deadline


def build_entry(num_hashes: int, poh_hash: bytes, txns: list[bytes]) -> bytes:
    out = bytearray()
    out += num_hashes.to_bytes(4, "little")
    out += poh_hash
    out += len(txns).to_bytes(2, "little")
    for p in txns:
        out += len(p).to_bytes(2, "little")
        out += p
    return bytes(out)


def parse_entry(frame: bytes) -> tuple[int, bytes, list[bytes]]:
    num_hashes = int.from_bytes(frame[:4], "little")
    poh_hash = frame[4:36]
    cnt = int.from_bytes(frame[36:38], "little")
    txns = []
    o = 38
    for _ in range(cnt):
        ln = int.from_bytes(frame[o : o + 2], "little")
        o += 2
        txns.append(frame[o : o + ln])
        o += ln
    return num_hashes, poh_hash, txns


class PohStage(Stage):
    counters = ("ticks", "mixins", "poh_spans_queued", "slots_sealed", "slot_missed",
                "slot_skipped_ticks")

    @classmethod
    def extra_schema(cls):
        return super().extra_schema().histogram("slot_seal_lag_ns", SEAL_LAG_BUCKETS)

    def __init__(
        self,
        *args,
        seed: bytes = b"\x00" * 32,
        hashes_per_tick: int = 64,
        ticks_per_slot: int = 8,
        hashes_per_iter: int = 16,
        plane=None,
        clock=None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.chain = PohChain(hash=seed)
        self.hashes_per_tick = hashes_per_tick
        self.ticks_per_slot = ticks_per_slot
        self.hashes_per_iter = hashes_per_iter
        self._hashes_since_entry = 0
        self._tick_cnt = 0
        self.entries_out = 0
        # the slot's final entry hash (the poh_hash the bank hash chains);
        # entries is an optional in-memory record for replay tests
        self.last_entry_hash = seed
        self.entries: list[tuple[int, bytes, list[bytes]]] | None = None
        # serving plane: full-tick pure-append spans are parked and
        # re-verified on the card by a later plane step.  Spans match the
        # plane's span length only when a whole tick passed without a
        # mixin (poh_iters == hashes_per_tick); others are skipped.
        self.plane = plane
        self._span_start = seed
        # final-tick landing time past the slot deadline (slot-clock mode)
        self.metrics.histogram("slot_seal_lag_ns", SEAL_LAG_BUCKETS)
        # slot-clock mode (module docstring)
        self._clock = resolve_clock(clock)
        if self._clock is not None:
            self.ticks_per_slot = self._clock.cfg.ticks_per_slot
            self.slot = self._clock.cfg.slot0
            self._slot_hash_base = 0
            self.window_closed = False

    # -- callbacks ----------------------------------------------------------

    def after_credit(self) -> None:
        """The clock: advance the chain a bounded amount per loop sweep so
        the cooperative scheduler stays fair.  In slot-clock mode the wall
        clock decides when ticks land and when the slot seals."""
        if self._clock is not None:
            self._clock_sweep(self._clock.now())
            return
        room = self.hashes_per_tick - (self.chain.hashcnt % self.hashes_per_tick)
        n = min(self.hashes_per_iter, room)
        if n <= 0:  # clock stopped (drain mode)
            return
        self.chain.append(n)
        self._hashes_since_entry += n
        if self.chain.hashcnt % self.hashes_per_tick == 0:
            self._emit_tick()

    # -- slot-clock mode -----------------------------------------------------

    def before_credit(self) -> None:
        """Miss detection must outrun backpressure: run_once skips
        after_credit while an output is starved, but a slot whose grace
        expired during the stall must still become a miss (the outcome is a
        value because it needs no credit to be declared).  before_credit
        runs every sweep."""
        if self._clock is None or self.window_closed:
            return
        now = self._clock.now()
        if self._clock.missed(self.slot, now):
            self._miss_slots(now)

    def _tick_progress(self) -> int:
        """Hashes into the current tick (slot-local; a mixin may overshoot a
        boundary, and the overshoot counts toward the next tick)."""
        return (self.chain.hashcnt - self._slot_hash_base
                - self._tick_cnt * self.hashes_per_tick)

    def _clock_sweep(self, now: int) -> None:
        clock = self._clock
        if self.window_closed:
            return
        if now >= clock.deadline_of(self.slot):
            # the boundary: seal now regardless of pending load, or, past
            # the grace, declare the slot missed and move on
            if clock.missed(self.slot, now):
                self._miss_slots(now)
            else:
                self._seal_rush()
            return  # pace the new slot from the next sweep on
        # paced hashing: tick k (1-based) may complete only once due;
        # catch-up after a stall is bounded per sweep (cooperative loop)
        for _ in range(4):
            if self._tick_cnt >= self.ticks_per_slot:
                return  # fully ticked; wait for the boundary roll
            k = self._tick_cnt + 1
            due = now >= clock.tick_deadline(self.slot, k)
            need = self.hashes_per_tick - self._tick_progress()
            if need > 0:
                cap = need if due else min(self.hashes_per_iter, need - 1)
                if cap > 0:
                    self.chain.append(cap)
                    self._hashes_since_entry += cap
            if not due or self._tick_progress() < self.hashes_per_tick:
                return
            if self.outs and self.outs[0].cr_avail <= 0:
                return  # starved: retry next sweep (the miss clock runs)
            self._emit_tick()

    def _seal_rush(self) -> None:
        """Deadline reached with the slot still open: land every remaining
        tick now (hashing is cheap; credits may not be) and roll to the next
        slot.  Called only inside the grace: past it the slot is a miss."""
        clock = self._clock
        while self._tick_cnt < self.ticks_per_slot:
            if self.outs and self.outs[0].cr_avail <= 0:
                return  # retry next sweep; grace expiry makes this a miss
            need = self.hashes_per_tick - self._tick_progress()
            if need > 0:
                self.chain.append(need)
                self._hashes_since_entry += need
            self._emit_tick()
        lag = clock.now() - clock.deadline_of(self.slot)
        self.metrics.inc("slots_sealed")
        self.metrics.observe("slot_seal_lag_ns", max(lag, 1))
        self.trace(fm.EV_SLOT_SEAL, self.slot)
        self._advance_slot(self.slot + 1)

    def _miss_slots(self, now: int) -> None:
        """The missed outcome: the boundary (plus grace) passed before the
        slot's final tick could land.  Count it, skip the unsealed ticks and
        continue at the slot the clock says is current."""
        target = self._clock.slot_at(now)
        missed = max(target - self.slot, 1)
        skipped = (missed * self.ticks_per_slot) - self._tick_cnt
        for s in range(self.slot, self.slot + missed):
            self.trace(fm.EV_SLOT_MISSED, s)
        self.metrics.inc("slot_missed", missed)
        self.metrics.inc("slot_skipped_ticks", max(skipped, 0))
        self._advance_slot(self.slot + missed)

    def _advance_slot(self, slot: int) -> None:
        self.slot = slot
        self._tick_cnt = 0
        self._slot_hash_base = self.chain.hashcnt
        if not self._clock.in_window(slot):
            # the leader window ended: the handoff fires on this schedule
            # (not on drain), and the clock stops sealing
            self.window_closed = True

    def slots_done(self) -> int:
        return (self.metrics.get("slots_sealed")
                + self.metrics.get("slot_missed"))

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        """A bank's executed microblock: mix its hash into the chain and
        emit the entry."""
        mixin = payload[:32]
        txn_cnt = int.from_bytes(payload[32:34], "little")
        txns = []
        o = 34
        for _ in range(txn_cnt):
            ln = int.from_bytes(payload[o : o + 2], "little")
            o += 2
            txns.append(payload[o : o + ln])
            o += ln
        self.chain.mixin(mixin)
        num_hashes = self._hashes_since_entry + 1  # the mixin counts as one
        self._hashes_since_entry = 0
        self._span_start = self.chain.hash  # a mixin breaks the append span
        self.metrics.inc("mixins")
        self.entries_out += 1
        self.last_entry_hash = self.chain.hash
        if self.entries is not None:
            self.entries.append((num_hashes, self.chain.hash, txns))
        self.publish(0, build_entry(num_hashes, self.chain.hash, txns),
                     sig=self.chain.hashcnt, tsorig=frag.tsorig)

    # -- internals ----------------------------------------------------------

    def _emit_tick(self) -> None:
        self.chain.tick()
        self._tick_cnt += 1
        num_hashes = self._hashes_since_entry
        self._hashes_since_entry = 0
        if (
            self.plane is not None
            and num_hashes == self.plane.cfg.poh_iters
            and self.plane.queue_poh_span(self._span_start, self.chain.hash)
        ):
            self.metrics.inc("poh_spans_queued")
        self._span_start = self.chain.hash
        self.metrics.inc("ticks")
        self.entries_out += 1
        self.last_entry_hash = self.chain.hash
        if self.entries is not None:
            self.entries.append((num_hashes, self.chain.hash, []))
        self.publish(0, build_entry(num_hashes, self.chain.hash, []),
                     sig=self.chain.hashcnt)

    def slot_complete(self) -> bool:
        return self._tick_cnt >= self.ticks_per_slot
