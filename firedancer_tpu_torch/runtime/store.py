"""Store stage: consumes wire shreds, resolves FEC sets, keeps the slot's
entry batches (the port's counterpart of firedancer_tpu/runtime/store.py).

The receive half of the FEC resolver: the pipeline publishes every shred
onto the wire link and this stage proves they reassemble, the same
component a non-leader validator runs on turbine ingress.  Recovery of
missing shreds runs K5 on `device` (default the card).

Inputs: ins[0] = shred -> store wire shreds.
State:  completed FEC sets per slot + reassembled entry-batch bytes.
The persistent blockstore hook is not ported.
"""

from __future__ import annotations

from ..protocol import shred as fs
from .fec_resolver import FecResolver
from .stage import Stage


class StoreStage(Stage):
    counters = ("shreds_in", "sets_stored")

    def __init__(self, *args, verify_sig=None, trust_membership: bool = False,
                 device=None, **kwargs):
        super().__init__(*args, **kwargs)
        # trust_membership: the leader's own store consuming its own shred
        # stream skips the per-shred merkle membership recompute; receive-
        # path stores keep full verification
        self.resolver = FecResolver(verify_sig=verify_sig, max_inflight=256,
                                    trust_membership=trust_membership,
                                    device=device)
        self.sets_by_slot: dict[int, list] = {}

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        out = self.resolver.add_shred(payload)
        self.metrics.inc("shreds_in")
        if out is not None:
            self.sets_by_slot.setdefault(out.slot, []).append(out)
            self.metrics.inc("sets_stored")

    def entry_batch_bytes(self, slot: int) -> bytes:
        """Reassembled data-shred payloads for `slot`, in fec_set order."""
        sets = sorted(self.sets_by_slot.get(slot, []), key=lambda s: s.fec_set_idx)
        out = bytearray()
        for st in sets:
            for buf in st.data_shreds:
                sh = fs.parse(buf)
                out += sh.payload(buf)
        return bytes(out)
