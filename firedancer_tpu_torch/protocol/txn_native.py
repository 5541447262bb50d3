"""ctypes binding for the native transaction parser, native/fd_txn_parse.cpp
(the port's counterpart of firedancer_tpu/protocol/txn_native.py).

fd_txn_parse.cpp applies protocol/txn.py's validation rules and emits the
packed descriptor (txn_pack's layout) directly, so the two parsers are
interchangeable: accept and reject alike, and the same descriptor bytes
(tests/test_torch_txn_native.py).  The verify stage parses every ingress
packet with `txn_parse_packed`.  The library is built by
utils/hostbuild.py on first use; a failed build raises HostBuildError.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..utils import hostbuild
from . import txn as ft

_OUT_CAP = 4096
_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the source each call
# the output buffer, one per thread: ctypes releases the GIL for the call,
# so a shared buffer could be written by two threads at once (the bytes
# are copied out before return)
_tls = threading.local()


def load() -> ctypes.CDLL:
    """The library, built by utils/hostbuild.py on first use."""
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_txn_parse")
        u64, vp, cp = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p
        lib.fd_txn_parse.argtypes = [cp, u64, cp, u64]
        lib.fd_txn_parse.restype = ctypes.c_int64
        lib.fd_txn_parse_burst.argtypes = [cp, vp, u64, cp, u64, vp]
        lib.fd_txn_parse_burst.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def txn_parse_packed(payload: bytes) -> bytes | None:
    """Native parse -> the packed descriptor's bytes (txn_pack's layout), or
    None for a malformed txn."""
    lib = _LIB or load()
    out = getattr(_tls, "out", None)
    if out is None:
        out = _tls.out = ctypes.create_string_buffer(_OUT_CAP)
    n = lib.fd_txn_parse(payload, len(payload), out, _OUT_CAP)
    if n < 0:
        return None
    return ctypes.string_at(out, n)


def txn_parse_native(payload: bytes) -> ft.Txn | None:
    """Native parse -> the Txn that protocol/txn.txn_parse builds, unpacked
    from the shared layout."""
    packed = txn_parse_packed(payload)
    if packed is None:
        return None
    desc, end = ft.txn_unpack(packed)
    if end != len(packed):
        return None
    return desc


class BurstParser:
    """Parses a drained burst in ONE fd_txn_parse_burst call, with the rows
    table, the descriptor arena and the per-row meta allocated once and
    reused.  One instance per stage, never shared across threads."""

    def __init__(self, max_rows: int = 64):
        self._lib = load()
        self._alloc(max_rows, max(_OUT_CAP, 512 * max_rows))

    def _alloc(self, max_rows: int, cap: int) -> None:
        self._max = max_rows
        self._rows = np.zeros((max_rows, 2), dtype=np.uint64)
        self._meta = np.zeros((max_rows, 2), dtype=np.uint64)
        self._cap = cap
        self._out = ctypes.create_string_buffer(cap)

    def parse(self, buf: bytes, rows) -> list[bytes | None]:
        """rows: drain-table rows (offset into `buf` at column 2, size at
        column 3).  One packed descriptor (None = rejected) per row, each
        equal to txn_parse_packed of that payload."""
        n = len(rows)
        if n == 0:
            return []
        if n > self._max:
            m = max(n, 2 * self._max)
            self._alloc(m, max(self._cap, 512 * m))
        rt = self._rows
        for i, row in enumerate(rows):
            rt[i, 0] = row[2]
            rt[i, 1] = row[3]
        while True:
            total = self._lib.fd_txn_parse_burst(buf, rt.ctypes.data, n, self._out,
                                                 self._cap, self._meta.ctypes.data)
            if total != -2:
                break
            # the arena ran out: grow it and parse the burst again
            self._cap *= 4
            self._out = ctypes.create_string_buffer(self._cap)
        raw = ctypes.string_at(self._out, total)
        meta = self._meta
        return [raw[int(meta[i, 0]) : int(meta[i, 0]) + int(meta[i, 1])] if meta[i, 1] else None
                for i in range(n)]
