"""Dedup stage: the global signature dedup after verify (the reference's
fd_dedup tile; the port's counterpart of firedancer_tpu/runtime/dedup.py).

One big tcache keyed on the frag's signature tag (the first signature);
duplicates are dropped, everything else is forwarded unchanged.  The
tcache is the native one (tango/tcache_native.py), as in the JAX
DedupStage; its build failing raises.  On the default leader lane the
dedup is fused into pack instead (runtime/pack_stage.NativePackStage).
"""

from __future__ import annotations

from ..tango.tcache_native import NativeTCache
from .stage import Stage

DEDUP_TCACHE_DEPTH = 1 << 16


class DedupStage(Stage):
    def __init__(self, name: str = "dedup", ins=None, outs=None):
        super().__init__(name, ins, outs)
        # never consume a frag that cannot be forwarded: inserting into the
        # tcache and then dropping the publish would make an upstream
        # retransmit die here as a "duplicate" forever
        self.require_credit = True
        self.tcache = NativeTCache(DEDUP_TCACHE_DEPTH)

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        if self.tcache.insert(frag.sig):
            self.metrics.inc("dedup_dup")
            return
        if self.outs:
            self.publish(0, payload, sig=frag.sig, tsorig=frag.tsorig)
