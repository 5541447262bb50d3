"""TCache: the port's copy of the dedup tag cache (firedancer_tpu/tango/
rings.py TCache, the reference's fd_tcache).  Shared-memory rings and the
native ring lanes are a later slice; this slice's links are in-process
(runtime/stage.py)."""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


class TCache:
    """Dedup cache of recently seen 64-bit tags.

    Ring of the last `depth` tags + a set for O(1) membership; inserting a
    fresh tag evicts the oldest.  Tag 0 is reserved as null and never
    dedups.
    """

    def __init__(self, depth: int):
        self.depth = depth
        self.ring = np.zeros(depth, dtype=np.uint64)
        self.oldest = 0
        self.map: set[int] = set()

    def insert(self, tag: int) -> bool:
        """Insert tag; returns True if it was already present (duplicate)."""
        tag &= _MASK64
        if tag == 0:
            return False
        if tag in self.map:
            return True
        old = int(self.ring[self.oldest])
        if old:
            self.map.discard(old)
        self.ring[self.oldest] = tag
        self.oldest = (self.oldest + 1) % self.depth
        self.map.add(tag)
        return False
