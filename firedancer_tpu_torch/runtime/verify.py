"""The verify stage: txn parse + dedup guard + batched sigverify on the card
(the port's counterpart of firedancer_tpu/runtime/verify.py, generic lane).

Semantics follow the reference's verify tile and the JAX package's stage:

  - parse the txn (drop on malformed);
  - a tiny per-stage tcache keyed on the first signature guards duplicate
    spam racing across round-robin peers (the real dedup is the downstream
    DedupStage's big tcache);
  - verify EVERY signature; a txn passes only if all its signatures pass;
  - publish payload + packed descriptor, so downstream never reparses.

Txns accumulate into fixed-shape batches (a txn is never split across two);
a batch closes when full or when its deadline passes in after_credit; up to
`max_inflight` batches stay on the card while the host streams the next.
Reaping is strictly in submission order.  Each dispatch is ONE launch of
the verify kernel (ops/sigverify.py); its result is a small future: the
mask and count tensors on the device plus a CUDA event that `_result_ready`
queries, so the loop never blocks on a batch still running.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import sigverify as sv
from ..protocol import txn as ft
from ..tango.rings import TCache
from ..utils.platform import resolve_device
from .stage import Stage

VERIFY_TCACHE_DEPTH = 16  # tiny by design (fd_verify.h:6-7)
DEFAULT_MAX_INFLIGHT = 8


def sig_tag(sig: bytes) -> int:
    """64-bit dedup tag: low 8 bytes of the (uniformly distributed) sig."""
    return int.from_bytes(sig[:8], "little") or 1


@dataclass
class _Acc:
    """One accumulating fixed-shape batch."""

    payloads: list = field(default_factory=list)
    descs: list = field(default_factory=list)
    elems: list = field(default_factory=list)  # [(msg, sig, pubkey)]
    ranges: list = field(default_factory=list)  # per txn (start, end)
    tsorigs: list = field(default_factory=list)
    opened_at: float = 0.0


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
                 kernel: str = "fused"):
        super().__init__(name, ins, outs)
        if kernel not in sv.KERNEL_LADDER:
            raise ValueError(f"unknown verify kernel {kernel!r}"
                             f" (ladder: {', '.join(sv.KERNEL_LADDER)})")
        self.device = resolve_device(device)
        self.kernel = kernel
        self.batch = batch
        self.max_msg_len = max_msg_len
        self.batch_deadline_s = batch_deadline_s
        self.max_inflight = max_inflight
        self.tcache = TCache(VERIFY_TCACHE_DEPTH)
        self._gen = _Acc()
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
        """Parse and guard one frag -> (sigs, msg, signers, txn) or None
        after counting the drop."""
        t = ft.txn_parse(payload)
        if t is None:
            self.metrics.inc("parse_fail")
            return None
        sigs = t.signatures(payload)
        if self.tcache.insert(sig_tag(sigs[0])):
            self.metrics.inc("dedup_dup")
            return None
        msg = t.message(payload)
        if len(msg) > self.max_msg_len:
            self.metrics.inc("msg_too_long")
            return None
        # a txn's elements must land in ONE batch (the all-sigs rule is
        # evaluated per batch): drop txns that can never fit
        if len(sigs) > self.batch:
            self.metrics.inc("too_many_sigs")
            return None
        return sigs, msg, t.signers(payload), t

    def _accumulate(self, got, payload: bytes, tsorig: int) -> None:
        sigs, msg, signers, t = got
        acc = self._gen
        if acc.elems and len(acc.elems) + len(sigs) > self.batch:
            self._close_batch()
            acc = self._gen
        start = len(acc.elems)
        for s, pk in zip(sigs, signers):
            acc.elems.append((msg, s, pk))
        acc.ranges.append((start, len(acc.elems)))
        acc.payloads.append(payload)
        acc.descs.append(t)
        acc.tsorigs.append(tsorig)
        if len(acc.elems) >= self.batch:
            self._close_batch()

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        got = self._intake(payload)
        if got is not None:
            self._accumulate(got, payload, frag.tsorig)

    # -- loop hooks ----------------------------------------------------------------

    def before_credit(self) -> None:
        # stamp the deadline clock once per newly opened batch
        if self._gen.elems and self._gen.opened_at == 0.0:
            self._gen.opened_at = time.monotonic()

    def after_credit(self) -> None:
        if self._emit_queue:
            self._emit_burst([])
        acc = self._gen
        if acc.elems and acc.opened_at \
                and time.monotonic() - acc.opened_at >= self.batch_deadline_s:
            self._close_batch()
        self._pump_submits()
        self._drain(block=False)

    def during_housekeeping(self) -> None:
        self._pump_submits()
        self._drain(block=False)

    # -- device batching -------------------------------------------------------------

    def _close_batch(self) -> None:
        acc = self._gen
        if not acc.elems:
            return
        self._gen = _Acc()
        self._submit_queue.append(acc)
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
            acc = q.pop(0)
            n = len(acc.elems)
            self._inflight.append(_Pending(acc, n, self._dispatch(acc)))
            self.metrics.inc("batches")
            self.metrics.inc("batch_elems", n)

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

    def _dispatch(self, acc: _Acc) -> _Result:
        dev = self.device
        msg, ln, sig, pk = (torch.from_numpy(a).to(dev)
                            for a in self._assemble(acc))
        mask, n_ok = sv.verify_dispatch(self.kernel, msg, ln, sig, pk,
                                        len(acc.elems),
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
            for payload, t, (a, b), tsorig in zip(acc.payloads, acc.descs,
                                                  acc.ranges, acc.tsorigs):
                if all_ok or bool(mask[a:b].all()):
                    emits.append(self._encode_emit(payload, t, tsorig))
                else:
                    self.metrics.inc("verify_fail")
            self._emit_burst(emits)
            if block:
                break

    def _encode_emit(self, payload: bytes, t: ft.Txn, tsorig: int):
        frame = encode_verified(payload, t)
        # the first signature's tag rides in the frag sig for cheap dedup
        return frame, sig_tag(t.signatures(payload)[0]), tsorig

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
        self._close_batch()
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
