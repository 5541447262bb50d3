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
from ..tango.rings import TCache
from ..utils import metrics as fm
from ..utils.platform import resolve_device
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
    def __init__(self, name: str, ins=None, outs=None, *, device=None,
                 batch: int = 1024, max_msg_len: int = 1232,
                 batch_deadline_s: float = 0.002,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 kernel: str = "fused", comb_slots: int = 0,
                 promote_threshold: int = 2, plane=None,
                 autotune_after: int = 0, native_client: bool | None = None):
        super().__init__(name, ins, outs)
        if kernel not in sv.KERNEL_LADDER:
            raise ValueError(f"unknown verify kernel {kernel!r}"
                             f" (ladder: {', '.join(sv.KERNEL_LADDER)})")
        if native_client:
            raise ValueError(
                "native_client=True: the port has no native sweep client for the verify"
                " stage yet (the C++ intake sweep over the shm rings, native/fd_verify.cpp);"
                " ROADMAP item 5.5, the verify sweep client, brings it now that the rings"
                " are in")
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
        for acc in (self._gen, self._comb):
            if acc.elems and acc.opened_at == 0.0:
                acc.opened_at = time.monotonic()

    def after_credit(self) -> None:
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
        self._pump_submits()
        self._drain(block=False)
        self._fill_bank()
        self._maybe_retune()

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
        if not self.comb_slots or not self._comb_lane_on:
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
            self._inflight.append(_Pending(acc, n, self._dispatch(acc, cached)))
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
