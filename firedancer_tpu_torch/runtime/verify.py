"""The verify stage: txn parse + dedup guard + batched sigverify on the card
(the port's counterpart of firedancer_tpu/runtime/verify.py, generic lane).

Semantics follow the reference's verify tile and the JAX package's stage:

  - parse the txn with the native parser (protocol/txn_native.py; drop on
    malformed) and read its signatures, message and signers straight off
    the packed descriptor: no Txn is built.  On native input rings a
    drained sweep is parsed in one fd_txn_parse_burst call
    (`sweep_frags`, the BurstParser);
  - a tiny per-stage tcache keyed on the first signature guards duplicate
    spam racing across round-robin peers (the real dedup is the downstream
    DedupStage's big tcache);
  - verify EVERY signature; a txn passes only if all its signatures pass;
  - publish payload + the parser's packed descriptor as it came, so
    downstream never reparses and nothing packs it again.

Txns accumulate into fixed-shape batches (a txn is never split across two);
a batch closes when full or when its deadline passes in after_credit; up to
`max_inflight` batches stay on the card while the host streams the next.
Reaping is strictly in submission order.  A dispatch is ONE kernel launch
on the "fused" and "baseline" lanes and four (K9-K12) on "split"
(ops/sigverify.py KERNEL_LADDER); its result is a small future: the mask and
count tensors on the device plus a CUDA event that `_result_ready` queries,
so the loop never blocks on a batch still running.  With a serving plane
(plane=...), generic batches go through the plane's step instead
(parallel/serve.py ServePlane.verify_batch).

The sweep client (runtime/verify_native.py over native/fd_verify.cpp): on
an exact VerifyStage whose every input is a native consumer and whose
output is a native producer of mtu >= verify_native.FRAME_MTU, with no
plane, no comb bank and no autotuner, the whole intake (parse, the guards,
batch assembly into C slot buffers) runs inside the fdr_sweep crossing
with no Python per frag.  Python then works a batch at a time: a sealed
slot's views become tensors on the stage's device for verify_dispatch
(K1 on the card), the reaped frames go out in one fdr_publish_burst call
straight from the slot's frame arena, and the slot returns to the intake
only after its frames are out.  native_client=None arms it where those
hold, True raises naming what blocks it, False never arms.

Autotuner (autotune_after > 0): the stage records its batch_fill, msg_len
and inflight_occupancy histograms; every autotune_after batches, at a
housekeeping call that finds the stage quiet (nothing accumulated, in
flight or sealed), it applies runtime/verify_tune.py's recommendation for
(batch, max_msg_len, comb split).  On the card that only changes the shape
of the next launch.

Repeated-signer lane (comb_slots > 0): real ingress repeats signers (one
vote key per validator, a vote per slot), so the stage keeps a comb bank on
the card.  A pubkey seen >= promote_threshold times is queued; at
housekeeping `_fill_bank` builds the queued combs (comb_fill, K7) and
installs the valid ones in free slots (bank_install, K8).  A txn whose
signers are ALL banked accumulates into a second batch, dispatched to
verify_cached (K6): 128 cached adds per signature, no doublings and no
decompression of A.  The policy is the JAX package's, line for line.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import sigverify as sv
from ..protocol import txn as ft
from ..protocol import txn_native
from ..tango.native import NativeConsumer, NativeProducer
from ..tango.rings import TCache
from ..utils import kbuild
from ..utils import metrics as fm
from ..utils.platform import resolve_device
from . import verify_native as vn
from . import verify_tune as vt
from .stage import Stage

VERIFY_TCACHE_DEPTH = 16  # tiny by design (fd_verify.h:6-7)
DEFAULT_MAX_INFLIGHT = 8
COMB_FILL_BATCH = 32  # pubkeys per comb_fill launch (the JAX jit shape's width)


def sig_tag(sig: bytes) -> int:
    """64-bit dedup tag: low 8 bytes of the (uniformly distributed) sig."""
    return int.from_bytes(sig[:8], "little") or 1


def _packed_fields(payload: bytes, packed: bytes):
    """(signatures, message, signers) read straight off the packed
    descriptor (txn_pack's layout)."""
    sig_cnt = packed[1]
    sig_off = packed[2] | (packed[3] << 8)
    msg_off = packed[4] | (packed[5] << 8)
    acct_off = packed[9] | (packed[10] << 8)
    sigs = [payload[sig_off + 64 * i : sig_off + 64 * (i + 1)] for i in range(sig_cnt)]
    signers = [payload[acct_off + 32 * i : acct_off + 32 * (i + 1)] for i in range(sig_cnt)]
    return sigs, payload[msg_off:], signers


def _packed_first_sig(payload: bytes, packed: bytes) -> bytes:
    sig_off = packed[2] | (packed[3] << 8)
    return payload[sig_off : sig_off + 64]


@dataclass
class _Acc:
    """One accumulating fixed-shape batch."""

    payloads: list = field(default_factory=list)
    descs: list = field(default_factory=list)  # packed descriptors
    elems: list = field(default_factory=list)  # [(msg, sig, pubkey)]
    ranges: list = field(default_factory=list)  # per txn (start, end)
    tsorigs: list = field(default_factory=list)
    slots: list = field(default_factory=list)  # cached lane: bank slot per element
    opened_at: float = 0.0


class _MaskOnly:
    """A plane step reaped by its mask alone, as the JAX stage reaps its
    plane route: the step counts every lane of the batch as real."""

    def __init__(self, pend):
        self.pend = pend

    def is_ready(self) -> bool:
        return self.pend.is_ready()

    def mask_host(self) -> np.ndarray:
        return self.pend.mask_host()

    def n_ok_host(self):
        return None


class _Result:
    """A dispatched batch's outputs: device tensors plus the event recorded
    after the launch (None on the CPU, where the plain version already ran)."""

    def __init__(self, mask: torch.Tensor, n_ok, event):
        self.mask = mask
        self.n_ok = n_ok
        self.event = event

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def mask_host(self) -> np.ndarray:
        return self.mask.cpu().numpy()

    def n_ok_host(self):
        return None if self.n_ok is None else int(self.n_ok)


@dataclass
class _Pending:
    acc: _Acc
    n_elems: int
    result: _Result


class VerifyStage(Stage):
    counters = ("txn_verified", "verify_fail", "parse_fail", "dedup_dup", "msg_too_long",
                "too_many_sigs", "batches", "batch_elems", "comb_batches", "comb_elems",
                "comb_fills", "comb_installs", "comb_filled", "emit_dropped",
                "submit_deferred", "retunes", "k1_launches", *vn.COUNTERS)

    def __init__(self, name: str, ins=None, outs=None, *, device=None,
                 batch: int = 1024, max_msg_len: int = 1232,
                 batch_deadline_s: float = 0.002,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 kernel: str = "fused", comb_slots: int = 0,
                 promote_threshold: int = 2, plane=None,
                 autotune_after: int = 0, native_client: bool | None = None,
                 precomputed_ok: bool = False, cnc=None):
        super().__init__(name, ins, outs, cnc=cnc)
        if kernel not in sv.KERNEL_LADDER:
            raise ValueError(f"unknown verify kernel {kernel!r}"
                             f" (ladder: {', '.join(sv.KERNEL_LADDER)})")
        # plane: a parallel/serve.ServePlane; generic batches go through its
        # step, so the stage's batch geometry must be the plane's shape
        self.plane = plane
        if plane is not None and (batch != plane.cfg.batch
                                  or max_msg_len != plane.cfg.max_msg_len):
            raise ValueError(
                f"verify stage (batch={batch}, max_msg_len={max_msg_len})"
                f" does not match the serving plane's shape"
                f" (batch={plane.cfg.batch}, max_msg_len={plane.cfg.max_msg_len})")
        self.device = (plane.device if plane is not None and device is None
                       else resolve_device(device))
        # precomputed_ok: a test and bench instrument, never the default: no
        # batch is dispatched (no kernel launch, no plain verify) and every
        # signature counts as valid, so the host machinery past verify is
        # measured net of the device (the JAX stage's instrument)
        self.precomputed_ok = precomputed_ok
        # the parser's library is built now, not mid-stream; the burst
        # parser serves sweep_frags
        self._burst_parser = txn_native.BurstParser(max(64, self.burst))
        self.kernel = kernel
        self.batch = batch
        self.max_msg_len = max_msg_len
        self.batch_deadline_s = batch_deadline_s
        self.max_inflight = max_inflight
        # autotune_after: re-derive (batch, max_msg_len, comb split) from
        # this stage's histograms every N batches (runtime/verify_tune.py);
        # 0 = off
        self.autotune_after = autotune_after
        self._last_tune_batches = 0
        self._comb_lane_on = True
        m = self.metrics
        m.histogram("batch_fill", fm.exp_buckets(1, 4096, 13))
        m.histogram("msg_len", fm.exp_buckets(32, 2048, 13))
        m.histogram("inflight_occupancy", tuple(float(i) for i in range(1, 17)))
        self.tcache = TCache(VERIFY_TCACHE_DEPTH)
        # comb bank (0 slots = the lane is off); the bank is allocated on
        # the first fill, comb_slots x 160 KB on the device
        self.comb_slots = comb_slots
        self.promote_threshold = promote_threshold
        self._bank = None
        self._slot_of: dict[bytes, int] = {}
        self._seen_cnt: dict[bytes, int] = {}
        self._fill_queue: list[bytes] = []
        self._free_slots: list[int] = list(range(comb_slots))
        # accumulating batches: generic and cached-signer lanes
        self._gen = _Acc()
        self._comb = _Acc()
        self._inflight: list[_Pending] = []
        # sealed batches waiting for a window slot (submit never blocks the
        # loop on the oldest batch just to close a new one)
        self._submit_queue: list[_Acc] = []
        self._submit_queue_max = 4
        # verified frames waiting for output credits: retried next credit
        # window, bounded so a dead consumer cannot grow it without limit
        self._emit_queue: list = []
        self._emit_queue_max = 8192
        # the sweep client's batches: (slot, n_elems, n_txn, result) in
        # flight, [slot, frame table, frames out] reaped and publishing
        self._nv_inflight: list = []
        self._nv_emit: list = []
        self._nv_opened_at = 0.0
        self._nv_stamp_sealed = 0  # the C side's seal count at the stamp
        self._nv_taken = 0  # sealed slots taken for dispatch
        want = native_client if native_client is not None else type(self) is VerifyStage
        if want:
            blocker = self._client_blocker()
            if blocker is None:
                self._sweep_client = vn.StageClient(
                    shard_idx=0, shard_cnt=1, batch=batch,
                    max_msg_len=max_msg_len, n_slots=max_inflight + 2)
            elif native_client:
                raise ValueError(f"native_client=True: the native sweep client cannot arm:"
                                 f" {blocker}")

    def _client_blocker(self) -> str | None:
        """What keeps the sweep client off this stage, or None."""
        if self.plane is not None:
            return "a serving plane routes the generic batches"
        if self.comb_slots:
            return "the comb bank needs Python signer tracking"
        if self.autotune_after:
            return "the autotuner retunes the batch geometry the C slots fix"
        if not self.ins or not self.outs:
            return "the stage has no rings"
        if not all(type(c) is NativeConsumer for c in self.ins):
            return "not every input is a native-ring consumer"
        if type(self.outs[0]) is not NativeProducer:
            return "the output is not a native-ring producer"
        if self.outs[0].link.mtu < vn.FRAME_MTU:
            return f"out link mtu {self.outs[0].link.mtu} < {vn.FRAME_MTU} (frame headroom)"
        return None

    def busy(self) -> bool:
        """Work accumulated, in flight or waiting for credits, on either
        intake lane."""
        if self._inflight or self._submit_queue or self._emit_queue:
            return True
        c = self._sweep_client
        return c is not None and bool(self._nv_inflight or self._nv_emit or c.stash_pending
                                      or c.open_elems() or c.sealed_waiting())

    # -- intake ----------------------------------------------------------------

    def _intake(self, payload: bytes):
        """Parse and guard one frag -> (sigs, msg, signers, packed
        descriptor) or None after counting the drop."""
        return self._guard(payload, txn_native.txn_parse_packed(payload))

    def _guard(self, payload: bytes, packed: bytes | None):
        """The intake's checks on a parsed frag (packed None = rejected)."""
        # the trailer must be exactly its declared fixed-layout length
        # (instruction and lookup counts at bytes 16 and 13)
        if packed is None or len(packed) != ft.txn_packed_sz(packed[16], packed[13]):
            self.metrics.inc("parse_fail")
            return None
        sigs, msg, signers = _packed_fields(payload, packed)
        if self.tcache.insert(sig_tag(sigs[0])):
            self.metrics.inc("dedup_dup")
            return None
        if len(msg) > self.max_msg_len:
            self.metrics.inc("msg_too_long")
            return None
        # a txn's elements must land in ONE batch (the all-sigs rule is
        # evaluated per batch): drop txns that can never fit
        if len(sigs) > self.batch:
            self.metrics.inc("too_many_sigs")
            return None
        return sigs, msg, signers, packed

    def _accumulate(self, got, payload: bytes, tsorig: int) -> None:
        sigs, msg, signers, packed = got
        self.metrics.observe("msg_len", len(msg))
        slots = self._signer_slots(signers)
        acc = self._comb if slots is not None else self._gen
        if acc.elems and len(acc.elems) + len(sigs) > self.batch:
            self._close_batch(acc)
            acc = self._comb if slots is not None else self._gen
        start = len(acc.elems)
        for s, pk in zip(sigs, signers):
            acc.elems.append((msg, s, pk))
        if slots is not None:
            acc.slots.extend(slots)
        acc.ranges.append((start, len(acc.elems)))
        acc.payloads.append(payload)
        acc.descs.append(packed)
        acc.tsorigs.append(tsorig)
        if len(acc.elems) >= self.batch:
            self._close_batch(acc)

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        c = self._sweep_client
        if c is not None:
            # the per-frag surface (a mixed-lane splice): into the SAME
            # C-side state the sweep callback fills
            c.append(payload, frag.tsorig)
            return
        got = self._intake(payload)
        if got is not None:
            self._accumulate(got, payload, frag.tsorig)

    def sweep_frags(self, rows, buf: bytes) -> int:
        """The drain-table intake (runtime/stage.py): a whole native-ring
        sweep in one call, its packets parsed in ONE fd_txn_parse_burst
        call over the table's (offset, size) columns, each then guarded and
        accumulated as after_frag does.  Every row counts as consumed, as
        every frag after_frag takes does (its drops are counted apart)."""
        for row, packed in zip(rows, self._burst_parser.parse(buf, rows)):
            off = row[2]
            payload = buf[off : off + row[3]]
            got = self._guard(payload, packed)
            if got is not None:
                self._accumulate(got, payload, row[5])
        return len(rows)

    # -- loop hooks ----------------------------------------------------------------

    def before_credit(self) -> None:
        # stamp the deadline clock once per newly opened batch
        c = self._sweep_client
        if c is not None:
            # the C side's open slot: its element count and the seal count
            # (a slot sealed full and a new one opened restarts the clock)
            if not c.open_elems():
                self._nv_opened_at = 0.0
            elif self._nv_opened_at == 0.0 or c.sealed_cnt() != self._nv_stamp_sealed:
                self._nv_opened_at = time.monotonic()
                self._nv_stamp_sealed = c.sealed_cnt()
            return
        for acc in (self._gen, self._comb):
            if acc.elems and acc.opened_at == 0.0:
                acc.opened_at = time.monotonic()

    def after_credit(self) -> None:
        c = self._sweep_client
        if c is not None:
            if self._nv_opened_at and \
                    time.monotonic() - self._nv_opened_at >= self.batch_deadline_s:
                c.seal()
                self._nv_opened_at = 0.0
            self._nv_pump()
            return
        if self._emit_queue:
            self._emit_burst([])
        now = time.monotonic()
        for acc in (self._gen, self._comb):
            if acc.elems and acc.opened_at \
                    and now - acc.opened_at >= self.batch_deadline_s:
                self._close_batch(acc)
        self._pump_submits()
        self._drain(block=False)

    def during_housekeeping(self) -> None:
        c = self._sweep_client
        if c is not None:
            self._nv_pump()
            # the C side's intake counters are the stage's on this lane
            self.metrics.assign(c.counters())
            return
        self._pump_submits()
        self._drain(block=False)
        self._fill_bank()
        self._maybe_retune()

    # -- the sweep client's batches --------------------------------------------

    def _native_sweep(self, drainer) -> bool:
        if not self._sweep_client.can_accept():
            # every slot busy: a sweep now would only stash, so reap and
            # publish first to reopen the intake
            self._nv_pump()
            return False
        return super()._native_sweep(drainer)

    def _nv_pump(self) -> None:
        """Submit sealed slots into the in-flight window (in seal order),
        reap completed heads (in order), publish the reaped frames."""
        c = self._sweep_client
        if not (self._nv_inflight or self._nv_emit) and c.sealed_cnt() == self._nv_taken:
            return  # idle: no slot sealed since the last take
        while len(self._nv_inflight) < self.max_inflight:
            got = c.take_sealed()
            if got is None:
                break
            self._nv_dispatch(*got)
        self._nv_drain(block=False)
        self._nv_publish()

    def _nv_dispatch(self, slot: int, n_elems: int, n_txn: int) -> None:
        """A sealed slot's views to the stage's device and verify_dispatch
        (K1 on the card).  The copies are synchronous (pageable host
        memory), so nothing reads the slot after this returns; the slot
        still stays the stage's until its frames are published."""
        views = self._sweep_client.slots[slot]
        self.metrics.observe_batch("msg_len", views.ln[views.ranges[:n_txn, 0]])
        if self.precomputed_ok:
            result = _Result(torch.ones((n_elems,), dtype=torch.bool), n_elems, None)
        else:
            result = self._nv_launch(views, n_elems)
        self._nv_inflight.append((slot, n_elems, n_txn, result))
        self.trace(fm.EV_BATCH_SUBMIT, n_elems)
        self._nv_taken += 1
        self.metrics.inc("batches")
        self.metrics.inc("batch_elems", n_elems)
        self.metrics.observe("batch_fill", n_elems)
        self.metrics.observe("inflight_occupancy", len(self._nv_inflight))

    def _nv_launch(self, views, n_elems: int) -> _Result:
        """The slot's views to the stage's device and verify_dispatch."""
        dev = self.device
        # the kernels' (len, B) layout: transposed on the device
        msg, sig, pk = (torch.from_numpy(a).to(dev).t().contiguous()
                        for a in (views.msg, views.sig, views.pk))
        ln = torch.from_numpy(views.ln).to(dev)
        if dev.type == "cpu":
            ln = ln.clone()  # the CPU tensor would alias the slot
        k1 = kbuild.LAUNCHES["verify_batch"]
        mask, n_ok = sv.verify_dispatch(self.kernel, msg, ln, sig, pk, n_elems,
                                        max_msg_len=self.max_msg_len)
        self.metrics.inc("k1_launches", kbuild.LAUNCHES["verify_batch"] - k1)
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return _Result(mask, n_ok, event)

    def _nv_drain(self, block: bool) -> None:
        """Reap in-flight slots in order: the txns whose every signature
        passed become the slot's frame table to publish; a slot with none
        goes straight back to the intake."""
        c = self._sweep_client
        while self._nv_inflight:
            slot, n_elems, n_txn, result = self._nv_inflight[0]
            if not block and not result.is_ready():
                return
            self._nv_inflight.pop(0)
            self.trace(fm.EV_BATCH_COMPLETE, n_elems)
            views = c.slots[slot]
            frames = views.frames[:n_txn]
            n_ok = result.n_ok_host()
            if n_ok is not None and n_ok == n_elems:
                tbl, kept = frames, n_txn
            else:
                mask = result.mask_host()[:n_elems].astype(np.uint8)
                ok_txn = np.minimum.reduceat(mask, views.ranges[:n_txn, 0].astype(np.int64))
                tbl = np.ascontiguousarray(frames[ok_txn.astype(bool)])
                kept = len(tbl)
                self.metrics.inc("verify_fail", n_txn - kept)
            if kept:
                self.metrics.inc("txn_verified", kept)
                self._nv_emit.append([slot, tbl, 0])
            else:
                c.release(slot)
            if block:
                break

    def _nv_publish(self) -> None:
        """Publish reaped frame tables head first (emit order is reap
        order), straight from the slot arenas: one fdr_publish_burst call a
        table, credit-gated, the tail retried next credit window.  A slot
        returns to the intake only once all its frames are out."""
        if not self._nv_emit or not self.outs:
            return
        c = self._sweep_client
        p = self.outs[0]
        while self._nv_emit:
            ent = self._nv_emit[0]
            slot, tbl, pos = ent
            sub = tbl[pos:]
            done = p.publish_burst_raw(c.slots[slot].arena_ptr, sub)
            if done:
                self.metrics.inc("frags_out", done)
            ent[2] = pos + done
            if ent[2] < len(tbl):
                self.metrics.inc("backpressure", len(sub) - done)
                break
            self._nv_emit.pop(0)
            c.release(slot)

    def drop_native_views(self) -> None:
        super().drop_native_views()
        c = self._sweep_client
        self._sweep_client = None
        if c is not None:
            self._nv_inflight, self._nv_emit = [], []
            c.close()

    # -- autotuner (runtime/verify_tune.py) ---------------------------------------

    def _maybe_retune(self) -> None:
        """Every autotune_after batches, apply the recommendation from this
        stage's own histograms, but only at a quiet point: nothing
        accumulated, nothing in flight, no sealed batch queued.  With a
        plane the batch shape is the plane's, so only the comb split moves."""
        if not self.autotune_after:
            return
        if self.metrics.get("batches") - self._last_tune_batches < self.autotune_after:
            return
        if self._inflight or self._submit_queue or self._gen.elems or self._comb.elems:
            return
        self._last_tune_batches = self.metrics.get("batches")
        rec = vt.recommend_for_stage(self)
        if self.plane is not None:
            rec = vt.Geometry(self.batch, self.max_msg_len, rec.comb_split)
        if (rec.batch, rec.max_msg_len, rec.comb_split) == \
                (self.batch, self.max_msg_len, self._comb_lane_on):
            return
        self.batch = rec.batch
        self.max_msg_len = rec.max_msg_len
        self._comb_lane_on = rec.comb_split
        self.metrics.inc("retunes")

    # -- comb bank ---------------------------------------------------------------------

    def _signer_slots(self, signers: list[bytes]) -> list[int] | None:
        """Bank slots if EVERY signer is banked, else None; counts sightings
        of the others and queues their promotion on the way."""
        if not self.comb_slots or self.precomputed_ok or not self._comb_lane_on:
            return None
        slots = []
        all_cached = True
        for pk in signers:
            slot = self._slot_of.get(pk)
            if slot is None:
                all_cached = False
                cnt = self._seen_cnt.get(pk, 0) + 1
                self._seen_cnt[pk] = cnt
                # >= not ==: a hot signer whose threshold crossing races a
                # full fill queue still promotes on a later sighting
                if (cnt >= self.promote_threshold and self._free_slots
                        and len(self._fill_queue) < self.comb_slots
                        and pk not in self._fill_queue):
                    self._fill_queue.append(pk)
                # spam guard: one-shot pubkeys must not grow the map unbounded
                if len(self._seen_cnt) > 16 * max(self.comb_slots, 256):
                    self._seen_cnt.clear()
            else:
                slots.append(slot)
        return slots if all_cached else None

    def _fill_bank(self) -> None:
        """Build and install the combs of up to COMB_FILL_BATCH queued
        pubkeys: ONE comb_fill launch over exactly the keys taken, then ONE
        bank_install of the columns whose key decompressed and is not of
        small order.  Slots are assigned in between, from the ok mask (the
        stage waits for it): the same slots, in the same order, as the JAX
        stage's.  Invalid pubkeys are not re-queued here."""
        if not self._fill_queue or not self._free_slots:
            return
        take = min(len(self._fill_queue), len(self._free_slots), COMB_FILL_BATCH)
        keys = self._fill_queue[:take]
        del self._fill_queue[:take]
        pk = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(take, 32).T.copy()
        tables, ok = sv.comb_fill(torch.from_numpy(pk).to(self.device))
        self.metrics.inc("comb_fills")
        ok = ok.cpu().numpy()
        if self._bank is None:
            self._bank = sv.bank_alloc(self.comb_slots, device=self.device)
        good = [i for i in range(take) if ok[i]]
        slots = [self._free_slots.pop() for _ in good]
        if good:
            if len(good) < take:
                tables = tables[torch.tensor(good, device=self.device)]
            sv.bank_install(self._bank, tables, slots)
            self.metrics.inc("comb_installs")
            for i, s in zip(good, slots):
                self._slot_of[keys[i]] = s
                self._seen_cnt.pop(keys[i], None)
            self.metrics.inc("comb_filled", len(good))

    # -- device batching -------------------------------------------------------------

    def _close_batch(self, acc: _Acc) -> None:
        if not acc.elems:
            return
        cached = acc is self._comb
        if cached:
            self._comb = _Acc()
        else:
            self._gen = _Acc()
        self._submit_queue.append((acc, cached))
        self._pump_submits()
        if self._submit_queue:
            self.metrics.inc("submit_deferred")
            if len(self._submit_queue) > self._submit_queue_max:
                # the memory bound: only a deep queue blocks on the oldest
                self._drain(block=True)
                self._pump_submits()

    def _pump_submits(self) -> None:
        q = self._submit_queue
        while q and len(self._inflight) < self.max_inflight:
            acc, cached = q.pop(0)
            n = len(acc.elems)
            k1 = kbuild.LAUNCHES["verify_batch"]
            self._inflight.append(_Pending(acc, n, self._dispatch(acc, cached)))
            self.trace(fm.EV_BATCH_SUBMIT, n)
            self.metrics.inc("k1_launches", kbuild.LAUNCHES["verify_batch"] - k1)
            self.metrics.inc("batches")
            self.metrics.inc("batch_elems", n)
            self.metrics.observe("batch_fill", n)
            self.metrics.observe("inflight_occupancy", len(self._inflight))
            if cached:
                self.metrics.inc("comb_batches")
                self.metrics.inc("comb_elems", n)

    def _assemble(self, acc: _Acc):
        """elems -> contiguous (len, B) byte rows, the kernels' layout: the
        batch is packed row-per-lane with one join per field, then
        transposed into a contiguous copy (a .T view is not contiguous)."""
        n = len(acc.elems)
        b = self.batch
        mm = self.max_msg_len
        msgs, sigs, pks = zip(*acc.elems)
        ln = np.zeros((b,), dtype=np.int32)
        ln[:n] = np.fromiter(map(len, msgs), dtype=np.int32, count=n)
        msg = np.zeros((b, mm), dtype=np.uint8)
        joined = b"".join(m.ljust(mm, b"\x00") for m in msgs)
        msg[:n] = np.frombuffer(joined, dtype=np.uint8).reshape(n, mm)
        sig = np.zeros((b, 64), dtype=np.uint8)
        sig[:n] = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
        pk = np.zeros((b, 32), dtype=np.uint8)
        pk[:n] = np.frombuffer(b"".join(pks), dtype=np.uint8).reshape(n, 32)
        return (np.ascontiguousarray(msg.T), ln, np.ascontiguousarray(sig.T),
                np.ascontiguousarray(pk.T))

    def _dispatch(self, acc: _Acc, cached: bool):
        dev = self.device
        n = len(acc.elems)
        if self.precomputed_ok:
            return _Result(torch.ones((n,), dtype=torch.bool), n, None)
        rows = self._assemble(acc)
        if self.plane is not None and not cached:
            # mesh route: the plane's step uploads each shard's lanes itself
            return _MaskOnly(self.plane.verify_batch(*rows))
        msg, ln, sig, pk = (torch.from_numpy(a).to(dev) for a in rows)
        if cached:
            slots = np.zeros((self.batch,), dtype=np.int32)
            slots[:n] = acc.slots
            mask, n_ok = sv.verify_cached(msg, ln, sig, pk, self._bank, slots, n,
                                          max_msg_len=self.max_msg_len)
        else:
            mask, n_ok = sv.verify_dispatch(self.kernel, msg, ln, sig, pk, n,
                                            max_msg_len=self.max_msg_len)
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return _Result(mask, n_ok, event)

    def _result_ready(self, head: _Pending) -> bool:
        return head.result.is_ready()

    def _result_mask(self, head: _Pending) -> np.ndarray:
        return head.result.mask_host()

    def _drain(self, block: bool) -> None:
        while self._inflight:
            head = self._inflight[0]
            if not block and not self._result_ready(head):
                return
            mask = self._result_mask(head)
            self._inflight.pop(0)
            self.trace(fm.EV_BATCH_COMPLETE, head.n_elems)
            self._pump_submits()
            # honest traffic passes whole batches: the on-card count decides
            # the common case without scanning the mask
            n_ok = head.result.n_ok_host()
            if n_ok is not None:
                all_ok = n_ok == head.n_elems
            else:
                all_ok = bool(mask[: head.n_elems].all())
            acc = head.acc
            emits = []
            for payload, packed, (a, b), tsorig in zip(acc.payloads, acc.descs,
                                                       acc.ranges, acc.tsorigs):
                if all_ok or bool(mask[a:b].all()):
                    emits.append(self._encode_emit(payload, packed, tsorig))
                else:
                    self.metrics.inc("verify_fail")
            self._emit_burst(emits)
            if block:
                break

    def _encode_emit(self, payload: bytes, packed: bytes, tsorig: int):
        frame = encode_verified_packed(payload, packed)
        # the first signature's tag rides in the frag sig for cheap dedup
        return frame, sig_tag(_packed_first_sig(payload, packed)), tsorig

    def _emit_burst(self, emits: list) -> None:
        if emits:
            self.metrics.inc("txn_verified", len(emits))
        if not self.outs:
            return
        q = self._emit_queue
        q.extend(emits)
        if not q:
            return
        n = self.publish_burst_out(0, q)
        del q[:n]
        if len(q) > self._emit_queue_max:
            drop = len(q) - self._emit_queue_max
            del q[:drop]
            self.metrics.inc("emit_dropped", drop)

    def flush(self) -> None:
        """Close and drain everything."""
        c = self._sweep_client
        if c is not None:
            # bounded: the emit side may be stuck on credits (the Python
            # lane's emit queue keeps the same posture at shutdown)
            for _ in range(4 * c.n_slots):
                c.pump()
                c.seal()
                self._nv_opened_at = 0.0
                self._nv_pump()
                if self._nv_inflight:
                    self._nv_drain(block=True)
                    self._nv_publish()
                if not self.busy():
                    break
            self.metrics.assign(c.counters())
            return
        self._fill_bank()
        for acc in (self._gen, self._comb):
            self._close_batch(acc)
        self._pump_submits()
        while self._inflight or self._submit_queue:
            self._drain(block=True)
            self._pump_submits()
        if self._emit_queue:
            self._emit_burst([])


def encode_verified_packed(payload: bytes, packed: bytes) -> bytes:
    """The verified-frag framing: payload || packed descriptor || u16
    payload_sz (byte-compatible with firedancer_tpu/runtime/verify.py)."""
    return payload + packed + len(payload).to_bytes(2, "little")


def encode_verified(payload: bytes, desc: ft.Txn) -> bytes:
    return encode_verified_packed(payload, ft.txn_pack(desc))


def decode_verified(frag: bytes) -> tuple[bytes, ft.Txn]:
    payload_sz = int.from_bytes(frag[-2:], "little")
    payload = frag[:payload_sz]
    desc, end = ft.txn_unpack(frag, payload_sz)
    if end != len(frag) - 2:
        raise ValueError("verified-frag trailer size mismatch")
    if not ft.txn_desc_valid(desc, payload_sz):
        raise ValueError("verified-frag descriptor fails validation")
    return payload, desc
