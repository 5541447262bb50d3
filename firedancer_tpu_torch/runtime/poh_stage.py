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
re-verified by K4 on a later plane step.  The slot clock (paced ticks,
slot seal and miss) is not ported.
"""

from __future__ import annotations

from .poh import PohChain
from .stage import Stage


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
    def __init__(
        self,
        *args,
        seed: bytes = b"\x00" * 32,
        hashes_per_tick: int = 64,
        ticks_per_slot: int = 8,
        hashes_per_iter: int = 16,
        plane=None,
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

    # -- callbacks ----------------------------------------------------------

    def after_credit(self) -> None:
        """The clock: advance the chain a bounded amount per loop sweep so
        the cooperative scheduler stays fair."""
        room = self.hashes_per_tick - (self.chain.hashcnt % self.hashes_per_tick)
        n = min(self.hashes_per_iter, room)
        if n <= 0:  # clock stopped (drain mode)
            return
        self.chain.append(n)
        self._hashes_since_entry += n
        if self.chain.hashcnt % self.hashes_per_tick == 0:
            self._emit_tick()

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
