"""ctypes binding for the native tcache, native/fd_tcache.cpp (the port's
counterpart of firedancer_tpu/tango/tcache_native.py).

The same semantics as tango/rings.py TCache: tag 0 is null and never
dedups, and inserting a fresh tag evicts the oldest.  The library is built
by utils/hostbuild.py on first use; a build failure raises.
"""

from __future__ import annotations

import ctypes

from ..utils import hostbuild

_MASK64 = (1 << 64) - 1


def _load() -> ctypes.CDLL:
    lib = hostbuild.load("fd_tcache")
    if not getattr(lib, "_bound", False):
        u64, vp = ctypes.c_uint64, ctypes.c_void_p
        lib.tcache_new.restype = vp
        lib.tcache_new.argtypes = [u64]
        lib.tcache_delete.argtypes = [vp]
        lib.tcache_query.restype = ctypes.c_int
        lib.tcache_query.argtypes = [vp, u64]
        lib.tcache_insert.restype = ctypes.c_int
        lib.tcache_insert.argtypes = [vp, u64]
        lib._bound = True
    return lib


class NativeTCache:
    def __init__(self, depth: int):
        self._lib = _load()
        self.depth = depth
        self._h = self._lib.tcache_new(depth)
        if not self._h:
            raise ValueError(f"tcache_new({depth}) failed")

    def query(self, tag: int) -> bool:
        return bool(self._lib.tcache_query(self._h, tag & _MASK64))

    def insert(self, tag: int) -> bool:
        """Insert tag; True if it was already present (a duplicate)."""
        return bool(self._lib.tcache_insert(self._h, tag & _MASK64))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tcache_delete(self._h)
            self._h = None

    def __del__(self):
        self.close()
