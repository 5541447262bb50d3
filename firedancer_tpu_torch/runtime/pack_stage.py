"""Pack stage: the conflict-aware scheduler wired into the pipeline (the
port's counterpart of firedancer_tpu/runtime/pack_stage.py, its Python
lane `PackStage`).

Verified txns arrive from dedup, conflict-free microblocks go out to B
bank stages, and each bank reports microblock completion back so its
account locks release.  The pipeline is always leader.

Inputs:  ins[0..n_txn_ins) = txn links; ins[n_txn_ins+b] = bank b's done
feedback.  Outputs: outs[b] = pack->bank b microblock link.

Microblock frame: u32 mb_seq | u16 txn_cnt | (u16 len || verified-frag)*
where each verified-frag is payload||packed-desc||u16 (runtime/verify.py),
so banks never reparse.

Batching policy: a microblock is scheduled for an idle bank when at least
`min_pending` txns are waiting, the oldest has waited `mb_deadline_s`, or
(the adaptive close) the txn inputs ran dry this iteration.

Not ported: the fused native pack+dedup lane (NativePackStage) and the
slot clock (deadline close, load shedding).
"""

from __future__ import annotations

import time

from ..pack.scheduler import Pack
from ..utils.metrics import exp_buckets
from .stage import Stage
from .verify import decode_verified, encode_verified


class PackStage(Stage):
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
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if len(self.outs) != bank_cnt:
            raise ValueError("need one output link per bank")
        self.bank_cnt = bank_cnt
        self.n_txn_ins = n_txn_ins
        self.pack = Pack(bank_cnt=bank_cnt, depth=depth,
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
        if self.adaptive:
            self._input_idle = not any(
                self.ins[i].has_pending() for i in range(self.n_txn_ins))
        if self._first_pending_at is None and self.pack.pending_cnt():
            self._first_pending_at = time.monotonic()

    def after_credit(self) -> None:
        if not self._ready_to_schedule():
            return
        for bank in range(self.bank_cnt):
            if self._bank_busy[bank]:
                continue
            if self.outs[bank].cr_avail <= 0:
                continue
            if not self._try_emit(bank):
                break  # nothing schedulable right now (conflicts/empty)
        if self.pack.pending_cnt() == 0:
            self._first_pending_at = None

    # -- internals ----------------------------------------------------------

    def _ready_to_schedule(self) -> bool:
        n = self.pack.pending_cnt()
        if n == 0:
            return False
        if self.force_flush or n >= self.min_pending:
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
        self._mb_seq += 1
        self.publish(bank, bytes(frame), sig=self._mb_seq, tsorig=tsorig)
        self._bank_busy[bank] = True
        self.metrics.inc("microblocks")
        self.metrics.inc("txn_scheduled", len(chosen))
        self.metrics.inc("cu_consumed", cu)
        self.metrics.observe("mb_fill", len(chosen))

    def flush(self) -> None:
        """Force remaining txns out (end of run); banks must keep draining
        their done feedback for this to terminate."""
        self.force_flush = True
        self.after_credit()
