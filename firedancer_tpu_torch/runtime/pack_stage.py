"""Pack stage: the conflict-aware scheduler wired into the pipeline (the
port's counterpart of firedancer_tpu/runtime/pack_stage.py).

Verified txns arrive, conflict-free microblocks go out to B bank stages,
and each bank reports microblock completion back so its account locks
release.  The pipeline is always leader.  Two lanes, one policy:

  - `PackStage`, the Python lane over pack/scheduler.Pack, fed by the
    dedup stage (runtime/dedup.py);
  - `NativePackStage`, the C++ lane (native/fd_pack.cpp behind
    pack/scheduler_native.py) with dedup fused in: it consumes the verify
    stages' links directly, probes the native tcache inside each burst's
    `insert_burst` call, and gets each microblock's frame back from one
    `schedule` call, byte for byte the Python lane's.

Inputs:  ins[0..n_txn_ins) = txn links; ins[n_txn_ins+b] = bank b's done
feedback.  Outputs: outs[b] = pack->bank b microblock link.

Microblock frame: u32 mb_seq | u16 txn_cnt | (u16 len || verified-frag)*
where each verified-frag is payload||packed-desc||u16 (runtime/verify.py),
so banks never reparse.

Batching policy (both lanes): a microblock is scheduled for an idle bank when at least
`min_pending` txns are waiting, the oldest has waited `mb_deadline_s`, or
(the adaptive close) the txn inputs ran dry this iteration.

With a slot clock (runtime/slot_clock.py), the block closes at each
slot boundary (`Pack.end_block`; the unscheduled tail stays pooled for
the next slot, zero loss, counted in `blocks_closed`).  In a slot's last
`close_frac` the policy schedules without waiting for `min_pending`, and
with `shed_keep` set it sheds the lowest-priority pending regular txns
down to `shed_keep` (`txn_shed`; votes are never shed).  The port's
stages have no flight recorder: the counters carry every outcome.
"""

from __future__ import annotations

import time

from ..pack.scheduler import Pack
from ..utils import metrics as fm
from ..utils.metrics import exp_buckets
from .dedup import DEDUP_TCACHE_DEPTH
from .slot_clock import resolve_clock
from .stage import Stage
from .verify import decode_verified, encode_verified


class PackStage(Stage):
    counters = ("txn_in", "txn_dropped", "bad_frag", "dedup_dup", "microblocks",
                "microblock_done", "txn_scheduled", "cu_consumed", "blocks_closed", "txn_shed")

    def __init__(
        self,
        *args,
        bank_cnt: int = 2,
        depth: int = 4096,
        max_txn_per_microblock: int = 31,
        min_pending: int = 8,
        mb_deadline_s: float = 0.002,
        adaptive: bool = True,
        n_txn_ins: int = 1,
        clock=None,
        close_frac: float = 0.25,
        shed_keep: int | None = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if len(self.outs) != bank_cnt:
            raise ValueError("need one output link per bank")
        self.bank_cnt = bank_cnt
        self.n_txn_ins = n_txn_ins
        self.pack = self._make_pack(bank_cnt=bank_cnt, depth=depth,
                                    max_txn_per_microblock=max_txn_per_microblock)
        self.min_pending = min_pending
        self.mb_deadline_s = mb_deadline_s
        # adaptive close: schedule as soon as the txn inputs run dry;
        # accumulating toward min_pending only pays when a backlog exists
        self.adaptive = adaptive
        self.force_flush = False  # end of run: drain regardless of policy
        self._bank_busy = [False] * bank_cnt
        self._mb_seq = 0
        self._first_pending_at: float | None = None
        self._input_idle = False  # stamped in before_credit
        # first sig -> tsorig for latency attribution; bounded: entries of
        # txns evicted from the pool would otherwise leak
        self._tsorig_by_sig: dict[bytes, int] = {}
        self.metrics.histogram("mb_fill", exp_buckets(1, 64, 7))
        # slot-clock mode: the deadline-aware block close (module docstring)
        self._clock = resolve_clock(clock)
        self._close_ns = 0
        self._shed_keep = shed_keep
        self._deadline_near = False
        if self._clock is not None:
            self._clock_slot = self._clock.cfg.slot0
            self._close_ns = int(self._clock.slot_ns * close_frac)

    def _make_pack(self, **kw):
        return Pack(**kw)

    # -- callbacks ----------------------------------------------------------

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        if in_idx < self.n_txn_ins:
            try:
                p, desc = decode_verified(payload)
            except ValueError:
                self.metrics.inc("bad_frag")
                return
            if self.pack.insert(p, desc):
                self.metrics.inc("txn_in")
                if len(self._tsorig_by_sig) > 2 * self.pack.depth:
                    self._tsorig_by_sig.clear()
                self._tsorig_by_sig[desc.signatures(p)[0]] = frag.tsorig
            else:
                self.metrics.inc("txn_dropped")
        else:
            bank = in_idx - self.n_txn_ins
            self.pack.microblock_done(bank)
            self._bank_busy[bank] = False
            self.metrics.inc("microblock_done")

    def before_credit(self) -> None:
        # the mb_deadline_s clock starts here: before_credit runs every
        # iteration, even while a bank link is backpressured
        self._flush_intake()
        if self._clock is not None:
            self._clock_roll(self._clock.now())
        if self.adaptive:
            self._input_idle = not any(
                self.ins[i].has_pending() for i in range(self.n_txn_ins))
        if self._first_pending_at is None and self._pending_cnt():
            self._first_pending_at = time.monotonic()

    def after_credit(self) -> None:
        self._flush_intake()
        if not self._ready_to_schedule():
            return
        for bank in range(self.bank_cnt):
            if self._bank_busy[bank]:
                continue
            if self.outs[bank].cr_avail <= 0:
                continue
            if not self._try_emit(bank):
                break  # nothing schedulable right now (conflicts/empty)
        if self._pending_cnt() == 0:
            self._first_pending_at = None

    # -- internals ----------------------------------------------------------

    def _clock_roll(self, now: int) -> None:
        """One clock read a loop sweep: close the block at each slot
        boundary (in-flight microblocks finish through the normal done
        feedback, the unscheduled tail stays pooled for the next slot) and
        arm the deadline-close and load-shed posture for the slot's final
        stretch."""
        clock = self._clock
        slot = clock.slot_at(now)
        last = clock.last_slot()
        if last is not None:
            # the leader window bounds the boundaries this stage owns: one
            # final close after the last slot, then the clock is someone
            # else's (post-window accounting does not drift with wall time
            # while the pipeline drains)
            slot = min(slot, last + 1)
        if slot > self._clock_slot:
            self.pack.end_block()
            self.metrics.inc("blocks_closed", slot - self._clock_slot)
            self.trace(fm.EV_SLOT_ROLL, slot)
            self._clock_slot = slot
        self._deadline_near = clock.remaining_ns(slot, now) <= self._close_ns
        if self._deadline_near and self._shed_keep is not None:
            excess = self._pending_cnt() - self._shed_keep
            if excess > 0:
                shed = self._shed(excess)
                if shed:
                    self.metrics.inc("txn_shed", shed)
                    self.trace(fm.EV_SLOT_SHED, shed)

    def _shed(self, n: int) -> int:
        return self.pack.shed_lowest(n)

    def _flush_intake(self) -> None:
        """The native lane's hook: insert the frags gathered since the last
        call, in one call.  The Python lane inserts each frag at once."""

    def _pending_cnt(self) -> int:
        return self.pack.pending_cnt()

    def _ready_to_schedule(self) -> bool:
        n = self._pending_cnt()
        if n == 0:
            return False
        if self.force_flush or n >= self.min_pending:
            return True
        if self._deadline_near:
            # the slot's final stretch: accumulating toward min_pending
            # risks the block closing with schedulable work stranded
            return True
        if self.adaptive and self._input_idle:
            # inputs ran dry: nothing else is coming this instant
            return True
        return (self._first_pending_at is not None
                and time.monotonic() - self._first_pending_at >= self.mb_deadline_s)

    def _try_emit(self, bank: int) -> bool:
        chosen = self.pack.schedule_next_microblock(bank)
        if not chosen:
            chosen = self.pack.schedule_next_microblock(bank, votes=True)
        if not chosen:
            return False
        self._emit(bank, chosen)
        return True

    def _emit(self, bank: int, chosen) -> None:
        tsorig = 0
        cu = 0
        frame = bytearray()
        frame += self._mb_seq.to_bytes(4, "little")
        frame += len(chosen).to_bytes(2, "little")
        for o in chosen:
            frag = encode_verified(o.payload, o.desc)
            frame += len(frag).to_bytes(2, "little")
            frame += frag
            cu += o.cost.total
            ts = self._tsorig_by_sig.pop(o.first_sig(), 0)
            # the microblock inherits its OLDEST txn's origin stamp
            tsorig = min(tsorig, ts) if tsorig and ts else (tsorig or ts)
        self._publish_mb(bank, bytes(frame), len(chosen), cu, tsorig)

    def _publish_mb(self, bank: int, frame: bytes, txn_cnt: int, cu: int,
                    tsorig: int) -> None:
        self._mb_seq += 1
        self.publish(bank, frame, sig=self._mb_seq, tsorig=tsorig)
        self._bank_busy[bank] = True
        self.metrics.inc("microblocks")
        self.metrics.inc("txn_scheduled", txn_cnt)
        self.metrics.inc("cu_consumed", cu)
        self.metrics.observe("mb_fill", txn_cnt)
        self.trace(fm.EV_MICROBLOCK, txn_cnt)

    def stranded(self) -> bool:
        """True when pack holds txns of which none can ever be scheduled:
        it may schedule now, every bank is idle (so its last try scheduled
        nothing), and no further block will open (there is no slot clock,
        or its leader window has closed and the final block close is
        done).  Waiting on the batching policy, on a bank, or on a slot
        still to open is not this case."""
        if not self._pending_cnt() or any(self._bank_busy) or not self._ready_to_schedule():
            return False
        if self._clock is None:
            return True
        last = self._clock.last_slot()
        return last is not None and self._clock_slot > last

    def flush(self) -> None:
        """Force remaining txns out (end of run); banks must keep draining
        their done feedback for this to terminate."""
        self.force_flush = True
        self.after_credit()


class NativePackStage(PackStage):
    """The fused native lane: dedup and pack in one C++ structure
    (pack/scheduler_native.NativePack with a NativeTCache attached).

    It consumes the verify stages' links directly (no dedup stage):
    `after_frag` only gathers (frag, tag, tsorig), `before_credit` and
    `after_credit` insert the gathered burst in one call, which drops
    duplicates natively, and `schedule` hands back each microblock's frame.
    Every policy of the Python lane holds: the clock's block close,
    `close_frac`, `shed_keep` and `stranded()`."""

    # intake is an append a frag: drain deeper bursts a sweep, so the
    # loop's overhead and the insert call spread over more frags
    burst = 64

    def __init__(self, *args, **kwargs):
        self._burst: list = []
        super().__init__(*args, **kwargs)

    def _make_pack(self, **kw):
        from ..pack.scheduler_native import NativePack
        from ..tango.tcache_native import NativeTCache

        pack = NativePack(**kw)
        pack.attach_tcache(NativeTCache(DEDUP_TCACHE_DEPTH))
        return pack

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        if in_idx < self.n_txn_ins:
            self._burst.append((payload, frag.sig, frag.tsorig))
        else:
            bank = in_idx - self.n_txn_ins
            self.pack.microblock_done(bank)
            self._bank_busy[bank] = False
            self.metrics.inc("microblock_done")

    def _flush_intake(self) -> None:
        if not self._burst:
            return
        from ..pack import scheduler_native as sn

        codes = self.pack.insert_burst(self._burst)
        self._burst.clear()
        n_ok, n_dup, n_bad = (codes.count(c) for c in (sn.INS_OK, sn.INS_DUP, sn.INS_BAD_FRAG))
        m = self.metrics
        for name, n in (("txn_in", n_ok), ("dedup_dup", n_dup), ("bad_frag", n_bad),
                        ("txn_dropped", len(codes) - n_ok - n_dup - n_bad)):
            if n:
                m.inc(name, n)

    def _pending_cnt(self) -> int:
        # every insert, schedule and shed call reports the pool's size
        return self.pack.last_pending + len(self._burst)

    def _try_emit(self, bank: int) -> bool:
        # the regular pool, then the votes, in one call
        res = self.pack.schedule(bank, mb_seq=self._mb_seq, any_pool=True)
        if res is None:
            return False
        self._publish_mb(bank, *res)
        return True

    def flush(self) -> None:
        self._flush_intake()
        super().flush()
