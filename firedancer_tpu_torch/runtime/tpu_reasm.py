"""TPU stream reassembly: stream fragments -> whole transactions (the port's
copy of firedancer_tpu/runtime/tpu_reasm.py, the fd_tpu_reasm slot table).

The buffer between a stream transport and the verify stage.  A fixed pool
of reassembly slots accumulates per-stream fragments; a stream's slot
publishes one whole txn when the stream FINishes, and the pool reclaims
the least-recently-active slot under pressure (peers that open streams
and stall must not pin memory).  A stream past TXN_MTU is cancelled and
its key tombstoned until FIN or reset, so its continuation frames cannot
churn fresh slots.

The transport (QUIC, or the stream framing of runtime/net.py) calls:
    append(stream_key, data, fin) -> None | completed txn bytes
"""

from __future__ import annotations

from collections import OrderedDict

from ..protocol.txn import TXN_MTU


class TpuReasm:
    _DEAD = None  # tombstone slot value: stream poisoned until FIN/reset

    def __init__(self, depth: int = 64, mtu: int = TXN_MTU):
        if depth <= 0:
            raise ValueError("depth must be positive")
        self.depth = depth
        self.mtu = mtu
        self._slots: OrderedDict[object, bytearray | None] = OrderedDict()
        self.metrics = {
            "published": 0,
            "oversz": 0,
            "evicted": 0,
            "cancelled": 0,
        }

    def append(self, key, data: bytes, fin: bool = False) -> bytes | None:
        """Accumulate stream bytes; returns the whole txn at FIN."""
        if key in self._slots:
            slot = self._slots[key]
            self._slots.move_to_end(key)
            if slot is self._DEAD:
                # poisoned (oversize) stream: swallow its continuation
                # frames so it can't churn fresh slots / evict honest
                # streams; the tombstone clears at FIN or reset
                if fin:
                    del self._slots[key]
                return None
        else:
            if len(self._slots) >= self.depth:
                # steal the least-recently-active slot (its stream stalls
                # out and will be dropped; QUIC-level retransmit recovers)
                self._slots.popitem(last=False)
                self.metrics["evicted"] += 1
            slot = bytearray()
            self._slots[key] = slot
        slot += data
        if len(slot) > self.mtu:
            self.metrics["oversz"] += 1
            if fin:  # stream ended at the crossing: nothing to poison
                del self._slots[key]
            else:  # poison the KEY so continuation frames can't churn
                # fresh slots and evict honest streams
                self._slots[key] = self._DEAD
            return None
        if not fin:
            return None
        del self._slots[key]
        self.metrics["published"] += 1
        return bytes(slot)

    def cancel(self, key) -> bool:
        """Transport-level stream reset: drop the slot (or tombstone)."""
        if key in self._slots:
            del self._slots[key]
            self.metrics["cancelled"] += 1
            return True
        return False

    def active(self) -> int:
        return len(self._slots)
