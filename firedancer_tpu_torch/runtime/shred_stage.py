"""Shred stage: entries -> entry batches -> FEC sets -> wire shreds (the
port's counterpart of firedancer_tpu/runtime/shred_stage.py).

Accumulate poh entries into an entry batch, run the shredder (parity on
the card, merkle trees and the leader's signature on the host), and
publish every data and parity shred to the outgoing link (the turbine hop
in a full validator; the pipeline's store resolves them back).

Inputs:  ins[0] = poh -> shred entries.
Outputs: outs[0] = wire shreds (mtu >= 1228).

Entry batches close when the accumulated serialized entries reach
`batch_target_sz` or on flush at slot end.  With `idle_flush_s`, a batch
that has taken no entry for that long closes too (block_complete False):
a stage in its own process (runtime/topo.py) has no caller to flush it
when PoH stops at the end of the leader window.

Lanes, chosen at construction by the arguments:

  - `secret` given and no serving plane: the native shredder
    (runtime/shred_native.py, native/fd_shred.cpp; parity through K5's
    host entry on the card).  With a native out producer and no keep_sets
    the stage registers a shred_native.StageClient as its sweep client,
    and the WHOLE run_once sweep (drain entries -> accumulate -> batch
    close -> shred -> publish) is one fdr_sweep crossing with zero Python
    per frag; the callbacks below stay the per-frag surface (the fused
    stage, a mixed-lane splice) and forward into the SAME C-side buffer.
    Otherwise (keep_sets, Python rings) the stage shreds each batch
    through NativeShredder: one crossing a batch, the same bytes.
  - no secret, or a serving plane: the Python Shredder (a plane routes
    the parity through its encode_parity, as in the JAX package).

`FusedPohShredStage` is the fused poh+shred stage: one stage owns the
hash clock and the shredder, and each entry goes mixin -> entry batch ->
FEC set inside one sweep, with no poh->shred link.
"""

from __future__ import annotations

import time

from ..tango.native import NativeProducer
from ..utils import kbuild
from .poh_stage import PohStage
from .shred_native import NativeShredder, StageClient
from .shredder import EntryBatchMeta, FecSet, Shredder
from .stage import Frag, Stage


class ShredStage(Stage):
    counters = ("entries_in", "entry_batches", "fec_sets", "data_shreds_out",
                "parity_shreds_out", "batches_dropped", "k5_launches")

    def __init__(
        self,
        *args,
        signer,
        secret: bytes | None = None,
        slot: int = 1,
        shred_version: int = 1,
        batch_target_sz: int = 16384,
        keep_sets: bool = False,
        plane=None,
        device=None,
        idle_flush_s: float | None = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self._slot = slot
        self.idle_flush_s = idle_flush_s
        self._idle_entries = 0  # entries_in at the last change seen
        self._idle_since = time.monotonic()
        self.batch_target_sz = batch_target_sz
        self.keep_sets = keep_sets
        self.sets: list[FecSet] = []  # retained for tests/observers
        self._buf = bytearray()
        self._buf_tsorig = 0
        self.native_shred = secret is not None and plane is None
        if self.native_shred:
            self.shredder = NativeShredder(secret=secret, shred_version=shred_version,
                                           device=device)
            if not keep_sets and self.outs and isinstance(self.outs[0], NativeProducer):
                self._sweep_client = StageClient(self.shredder, self.outs[0], slot=slot,
                                                 batch_target=batch_target_sz)
        else:
            self.shredder = Shredder(signer=signer, shred_version=shred_version,
                                     plane=plane, device=device)

    # a property, so the sweep client's C-side slot (and its slot-scoped
    # shred index reset) follows a reassignment as the Shredders' per-batch
    # `if slot != self.slot` check does
    @property
    def slot(self) -> int:
        return self._slot

    @slot.setter
    def slot(self, v: int) -> None:
        self._slot = v
        if self._sweep_client is not None:
            self._sweep_client.set_slot(v)

    def _native_sweep(self, drainer) -> bool:
        progressed = super()._native_sweep(drainer)
        self._sweep_client.settle()  # K5's launches; raise on a failed parity call
        return progressed

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        c = self._sweep_client
        if c is not None:
            c.append(payload, frag.tsorig)
            return
        # entries are appended verbatim: the entry frame IS this build's
        # entry-batch serialization (the reference ships bincode entries)
        self._buf += len(payload).to_bytes(4, "little")
        self._buf += payload
        ts = frag.tsorig
        if ts and (self._buf_tsorig == 0 or ts < self._buf_tsorig):
            self._buf_tsorig = ts
        self.metrics.inc("entries_in")
        if len(self._buf) >= self.batch_target_sz and self._room():
            self._shred_batch(block_complete=False)

    def after_credit(self) -> None:
        c = self._sweep_client
        if c is not None:
            # a batch deferred for credits in C: retry with the flag the
            # deferred flush recorded (block_complete survives the wait)
            if c.pending_flush:
                c.retry_flush()
            return
        # batch closed for size but deferred for credits: retry here
        if len(self._buf) >= self.batch_target_sz and self._room():
            self._shred_batch(block_complete=False)

    def during_housekeeping(self) -> None:
        c = self._sweep_client
        if c is not None:
            # the C side's counters are the stage's in sweep mode: copied
            # at the lazy cadence every other stage metric has
            self.metrics.assign(c.counters())
        if self.native_shred:
            self.metrics.assign({"k5_launches": self.shredder.launches})
        if self.idle_flush_s is not None:
            self._idle_flush()

    def _idle_flush(self) -> None:
        """Close the open batch once no entry has come for idle_flush_s (a
        flush of an empty batch does nothing)."""
        n = self.metrics.get("entries_in")
        now = time.monotonic()
        if n != self._idle_entries:
            self._idle_entries, self._idle_since = n, now
        elif now - self._idle_since >= self.idle_flush_s:
            self.flush(block_complete=False)
            self._idle_since = now

    def _room(self) -> bool:
        """A batch bursts ~2 sets x ~65 shreds; don't start shredding unless
        the out ring can absorb it (dropping shreds mid-set wastes the set)."""
        return not self.outs or self.outs[0].cr_avail >= 256

    def flush(self, *, block_complete: bool = True) -> None:
        c = self._sweep_client
        if c is not None:
            c.flush(block_complete=block_complete)
            self.metrics.assign(c.counters())
            self.metrics.assign({"k5_launches": self.shredder.launches})
            return
        if self._buf:
            self._shred_batch(block_complete=block_complete)

    def drop_native_views(self) -> None:
        super().drop_native_views()
        c = self._sweep_client
        self._sweep_client = None
        if c is not None:
            c.close()

    def _shred_batch(self, *, block_complete: bool) -> None:
        batch = bytes(self._buf)
        self._buf = bytearray()
        tsorig = self._buf_tsorig
        self._buf_tsorig = 0
        k5 = kbuild.LAUNCHES["gf256_apply"]
        sets = self.shredder.entry_batch_to_fec_sets(
            batch, slot=self.slot,
            meta=EntryBatchMeta(block_complete=block_complete))
        if not self.native_shred:
            self.metrics.inc("k5_launches", kbuild.LAUNCHES["gf256_apply"] - k5)
        self.metrics.inc("entry_batches")
        for st in sets:
            self.metrics.inc("fec_sets")
            if self.keep_sets:
                self.sets.append(st)
            if self.outs:
                items = [(buf, st.fec_set_idx, tsorig) for buf in st.data_shreds]
                items += [(buf, st.fec_set_idx, tsorig) for buf in st.parity_shreds]
                self.publish_burst_out(0, items)
                self.metrics.inc("data_shreds_out", len(st.data_shreds))
                self.metrics.inc("parity_shreds_out", len(st.parity_shreds))


class FusedPohShredStage(PohStage):
    """The fused poh+shred stage: ONE stage owns both the hash clock and
    the shredder, collapsing the poh->shred link.  Each bank microblock's
    entry goes mixin -> entry batch -> FEC set inside a single run_once
    sweep, and ticks append to the same batch buffer.

    Composition, not reimplementation: the PoH half IS PohStage (every
    slot-clock seal and miss rule inherited as is); the shred half IS a
    ShredStage whose intake is called in process where the unfused
    pipeline would publish to the poh->shred link, so its entry bytes and
    FEC sets equal the unfused pipeline's.  With `secret` the half runs the
    native shredder; over a native out producer it takes the sweep
    client's per-frag surface (stage_append closes batches at the target
    size in C), so the fused lane keeps the zero-Python shred path.

    outs[0] is the wire-shred link (the unfused shred stage's output), so
    the PoH half's credit checks gate tick emission on the downstream the
    shreds land on: the backpressure the collapsed hop implies."""

    def __init__(self, *args, signer, secret: bytes | None = None, shred_slot: int = 1,
                 shred_version: int = 1, batch_target_sz: int = 16384,
                 keep_sets: bool = False, shred_plane=None, device=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.shred_half = ShredStage(
            f"{self.name}/shred", ins=[], outs=list(self.outs),
            signer=signer, secret=secret, slot=shred_slot, shred_version=shred_version,
            batch_target_sz=batch_target_sz, keep_sets=keep_sets,
            plane=shred_plane, device=device,
        )

    def publish(self, out_idx: int, payload: bytes, sig: int = 0,
                tsorig: int = 0) -> bool:
        """The collapsed hop: every entry the PoH half emits feeds the
        shredder in process instead of crossing a link."""
        self.shred_half.after_frag(0, Frag(0, sig, tsorig), payload)
        self.metrics.inc("frags_out")  # the unfused PoH stage's counter
        return True

    def after_credit(self) -> None:
        super().after_credit()  # the clock: ticks or the slot-clock sweep
        self.shred_half.after_credit()  # credit-deferred batch retry

    def during_housekeeping(self) -> None:
        self.shred_half.during_housekeeping()

    def flush(self, *, block_complete: bool = True) -> None:
        self.shred_half.flush(block_complete=block_complete)


def deshred_entry_batch(batch: bytes) -> list[bytes]:
    """Split a reassembled entry batch back into entry frames."""
    entries = []
    o = 0
    while o < len(batch):
        ln = int.from_bytes(batch[o : o + 4], "little")
        o += 4
        entries.append(batch[o : o + ln])
        o += ln
    return entries
