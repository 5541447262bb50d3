"""ctypes binding for the native shm storage plane, native/fd_funk.cpp (the
port's counterpart of firedancer_tpu/funk/funk_native.py).

`NativeFunk` is funk/funk.py's API over ONE shared-memory record map:
the fork tree's prepare/publish/cancel with its frozen and ancestry
rules, overlay queries, tombstones and the FunkError codes -1/-2/-3.
native/fd_bank.cpp writes committed records into the same map from
inside its fdr_sweep crossing (runtime/bank_native.StageClient.set_funk).
Reads come back through a zero-copy memoryview over the mapping; batch
writes cross once a batch (`rec_insert_batch`, `_root_merge`), and the
seal's whole before/after read-out is one `txn_diff` crossing.

`make_funk()` (funk/__init__.py) returns one: it is the leader's store.
The dict-backed `Funk` stays for callers that pass it
(`BankCtx(funk=Funk())`) and under funk/persist.py's journal.  The
library is built by utils/hostbuild.py on first use; a failed build
raises HostBuildError, and a failed ffk_create or ffk_* call raises.

The segment is named `/fdtpu_torch_funk_<pid>_<n>` in /dev/shm (sparse:
256 MiB of address space, pages committed as written).  `close()` unmaps
it and unlinks the name this object created; the object is a context
manager, and one never closed unlinks at GC.  An uninvolved process can
`attach_readonly(shm_name)` and read a seqlock-consistent view.
"""

from __future__ import annotations

import atexit
import ctypes
import struct
import weakref

from ..utils import hostbuild
from .funk import ERR_FROZEN, ERR_KEY, ERR_TXN, FunkError

# error codes beyond the funk.py trio (fd_funk.cpp enum)
_ERR_FULL = -4
_ERR_OOM = -5
_ERR_RDONLY = -6
_ERR_RANGE = -7

_XID_MAX = 128  # FFK_XID_MAX

DEFAULT_SZ = 1 << 28  # 256 MiB of address space; pages commit lazily
DEFAULT_TXN_CAP = 1024

_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the sources each call
_LIVE: "weakref.WeakSet[NativeFunk]" = weakref.WeakSet()  # stores this process made


@atexit.register
def _close_live() -> None:
    """At exit, unlink every segment a store of this process still holds
    (one in a reference cycle may never reach __del__)."""
    for f in list(_LIVE):
        f.close()


def load() -> ctypes.CDLL:
    """The library, built by utils/hostbuild.py on first use."""
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_funk")
        u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
        vp, cp = ctypes.c_void_p, ctypes.c_char_p
        u64p, i64p = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)
        lib.ffk_create.argtypes = [cp, u64, i32]
        lib.ffk_create.restype = vp
        lib.ffk_attach.argtypes = [cp]
        lib.ffk_attach.restype = vp
        lib.ffk_close.argtypes = [vp, i32]
        lib.ffk_shm_name.argtypes = [vp]
        lib.ffk_shm_name.restype = cp
        for name in ("ffk_base", "ffk_map_sz", "ffk_seq", "ffk_arena_used"):
            getattr(lib, name).argtypes = [vp]
            getattr(lib, name).restype = u64
        lib.ffk_txn_prepare.argtypes = [vp, cp, i32, cp, i32]
        lib.ffk_txn_prepare.restype = i32
        for name in ("ffk_txn_is_frozen", "ffk_txn_wcheck", "ffk_txn_cancel",
                     "ffk_txn_publish", "ffk_txn_slot"):
            getattr(lib, name).argtypes = [vp, cp, i32]
            getattr(lib, name).restype = i32
        lib.ffk_txn_cnt.argtypes = [vp]
        lib.ffk_txn_cnt.restype = i32
        lib.ffk_txn_ancestry.argtypes = [vp, cp, i32, cp, i64]
        lib.ffk_txn_ancestry.restype = i64
        lib.ffk_last_publish.argtypes = [vp, cp, i32]
        lib.ffk_last_publish.restype = i32
        lib.ffk_rec_insert.argtypes = [vp, cp, i32, cp, i32, cp, i32]
        lib.ffk_rec_insert.restype = i32
        lib.ffk_rec_insert_slot.argtypes = [vp, i32, cp, i32, cp, i32]
        lib.ffk_rec_insert_slot.restype = i32
        lib.ffk_rec_remove.argtypes = [vp, cp, i32, cp, i32]
        lib.ffk_rec_remove.restype = i32
        lib.ffk_rec_query.argtypes = [vp, cp, i32, cp, i32, u64p, i64p]
        lib.ffk_rec_query.restype = i32
        lib.ffk_rec_cnt_root.argtypes = [vp]
        lib.ffk_rec_cnt_root.restype = i64
        lib.ffk_root_keys.argtypes = [vp, cp, i64]
        lib.ffk_root_keys.restype = i64
        lib.ffk_txn_keys.argtypes = [vp, cp, i32, cp, i64]
        lib.ffk_txn_keys.restype = i64
        lib.ffk_txn_diff.argtypes = [vp, cp, i32, cp, i64]
        lib.ffk_txn_diff.restype = i64
        lib.ffk_batch_apply.argtypes = [vp, cp, i32, cp, i64, i32]
        lib.ffk_batch_apply.restype = i32
        _LIB = lib
    return _LIB


class NativeFunkError(RuntimeError):
    pass


class _ClosedLib:
    """Stands in for the library on a closed store: every ffk_* call
    raises instead of handing C a dangling handle."""

    def __getattr__(self, name):
        raise NativeFunkError(f"{name} on a closed native funk")


_CLOSED = _ClosedLib()


def _raise(rc: int, what: str) -> None:
    if rc == ERR_TXN:
        raise FunkError(ERR_TXN, f"{what}: unknown/duplicate txn")
    if rc == ERR_FROZEN:
        raise FunkError(ERR_FROZEN, "txn has children; records frozen")
    if rc == ERR_KEY:
        raise FunkError(ERR_KEY, f"{what}: unknown key")
    if rc == _ERR_OOM:
        raise MemoryError(f"native funk arena exhausted ({what})")
    if rc == _ERR_FULL:
        raise NativeFunkError(f"native funk txn table full ({what})")
    raise NativeFunkError(f"native funk {what} failed: rc={rc}")


class _RecsProxy:
    """Write-through stand-in for `Funk.txn_recs_for_write`'s dict: the
    ancestry/frozen check ran once at acquisition; each __setitem__ is
    one insert into the shm overlay.  Batch writers should prefer
    NativeFunk.rec_insert_batch (one crossing for the whole batch)."""

    __slots__ = ("_f", "_slot")

    def __init__(self, f: "NativeFunk", slot: int):
        self._f = f
        self._slot = slot

    def __setitem__(self, key: bytes, val: bytes) -> None:
        rc = self._f._lib.ffk_rec_insert_slot(
            self._f._h, self._slot, bytes(key), len(key), bytes(val),
            len(val))
        if rc != 0:
            _raise(rc, "rec_insert")

    def update(self, items) -> None:
        for k, v in (items.items() if hasattr(items, "items") else items):
            self[k] = v


class NativeFunk:
    """The funk API over the native shm record map.  One authoritative
    store for both lanes: the bank sweep writes records in C inside its
    crossing; this class is the Python lane's batched-write and zero-copy
    read surface over the same segment."""

    def __init__(self, *, shm_name: str | None = None, max_sz: int = DEFAULT_SZ,
                 txn_cap: int = DEFAULT_TXN_CAP):
        lib = load()
        self._lib = lib
        self._h = lib.ffk_create(shm_name.encode() if shm_name else None, max_sz, txn_cap)
        if not self._h:
            raise NativeFunkError(f"ffk_create({shm_name!r}, {max_sz}, {txn_cap}) failed")
        self._owns = True
        self._init_views()
        _LIVE.add(self)

    def _init_views(self) -> None:
        base = int(self._lib.ffk_base(self._h))
        sz = int(self._lib.ffk_map_sz(self._h))
        self._map = memoryview((ctypes.c_uint8 * sz).from_address(base)).cast("B")
        # out-cells for rec_query, made once
        self._voff = ctypes.c_uint64(0)
        self._vlen = ctypes.c_int64(0)
        self._voff_ref = ctypes.byref(self._voff)
        self._vlen_ref = ctypes.byref(self._vlen)

    @classmethod
    def attach_readonly(cls, shm_name: str) -> "NativeFunk":
        """Read-only attach to a live store by its shm name (another
        process, or a reader beside the writer).  Mutating calls raise
        NativeFunkError; close() unmaps and unlinks nothing of the
        writer's."""
        lib = load()
        self = cls.__new__(cls)
        self._lib = lib
        self._h = lib.ffk_attach(shm_name.encode())
        if not self._h:
            raise NativeFunkError(f"ffk_attach({shm_name!r}) failed")
        self._owns = False
        self._init_views()
        return self

    # -- identity / shm surface ----------------------------------------------

    @property
    def shm_name(self) -> str:
        return self._lib.ffk_shm_name(self._h).decode()

    @property
    def handle(self) -> int:
        """The raw ffk handle fd_bank.cpp's fdb_stage_set_funk receives."""
        return int(self._h)

    def seq(self) -> int:
        return int(self._lib.ffk_seq(self._h))

    def arena_used(self) -> int:
        return int(self._lib.ffk_arena_used(self._h))

    # -- fork tree ------------------------------------------------------------

    def txn_prepare(self, parent: bytes | None, xid: bytes) -> bytes:
        if parent is None:
            rc = self._lib.ffk_txn_prepare(self._h, None, -1, bytes(xid),
                                           len(xid))
        else:
            rc = self._lib.ffk_txn_prepare(self._h, bytes(parent),
                                           len(parent), bytes(xid), len(xid))
        if rc != 0:
            _raise(rc, "txn_prepare")
        return xid

    def txn_is_frozen(self, xid: bytes) -> bool:
        rc = self._lib.ffk_txn_is_frozen(self._h, bytes(xid), len(xid))
        if rc < 0:
            _raise(rc, "txn_is_frozen")
        return bool(rc)

    def txn_cnt(self) -> int:
        return int(self._lib.ffk_txn_cnt(self._h))

    def txn_ancestry(self, xid: bytes) -> list[bytes]:
        lib = self._lib
        need = int(lib.ffk_txn_ancestry(self._h, bytes(xid), len(xid),
                                        None, 0))
        if need < 0:
            _raise(need, "txn_ancestry")
        buf = ctypes.create_string_buffer(need or 1)
        n = int(lib.ffk_txn_ancestry(self._h, bytes(xid), len(xid), buf,
                                     need))
        if n < 0:
            _raise(n, "txn_ancestry")
        out, p = [], 0
        raw = buf.raw[:n]
        while p < n:
            ln = raw[p] | (raw[p + 1] << 8)
            out.append(raw[p + 2: p + 2 + ln])
            p += 2 + ln
        return out

    def txn_cancel(self, xid: bytes) -> int:
        rc = self._lib.ffk_txn_cancel(self._h, bytes(xid), len(xid))
        if rc < 0:
            _raise(rc, "txn_cancel")
        return int(rc)

    def txn_publish(self, xid: bytes) -> int:
        rc = self._lib.ffk_txn_publish(self._h, bytes(xid), len(xid))
        if rc < 0:
            _raise(rc, "txn_publish")
        return int(rc)

    @property
    def last_publish(self) -> bytes | None:
        buf = ctypes.create_string_buffer(_XID_MAX)
        n = int(self._lib.ffk_last_publish(self._h, buf, _XID_MAX))
        if n <= 0:
            return None
        return buf.raw[:n]

    # -- records --------------------------------------------------------------

    def rec_insert(self, xid: bytes | None, key: bytes, val: bytes) -> None:
        if xid is None:
            rc = self._lib.ffk_rec_insert(self._h, None, -1, bytes(key),
                                          len(key), bytes(val), len(val))
        else:
            rc = self._lib.ffk_rec_insert(self._h, bytes(xid), len(xid),
                                          bytes(key), len(key), bytes(val),
                                          len(val))
        if rc != 0:
            _raise(rc, "rec_insert")

    def txn_recs_for_write(self, xid: bytes) -> _RecsProxy:
        slot = int(self._lib.ffk_txn_slot(self._h, bytes(xid), len(xid)))
        if slot < 0:
            _raise(slot, "txn_recs_for_write")
        return _RecsProxy(self, slot)

    def rec_insert_batch(self, xid: bytes | None, items) -> None:
        """One FFI crossing for a batch of (key, val-or-None) writes —
        the Python lane's hot write shape (None = tombstone/delete)."""
        parts = []
        n = 0
        for key, val in (items.items() if hasattr(items, "items")
                         else items):
            if val is None:
                parts.append(struct.pack("<Hi", len(key), -1))
                parts.append(bytes(key))
            else:
                parts.append(struct.pack("<Hi", len(key), len(val)))
                parts.append(bytes(key))
                parts.append(bytes(val))
            n += 1
        if not n:
            return
        blob = b"".join(parts)
        if xid is None:
            rc = self._lib.ffk_batch_apply(self._h, None, -1, blob,
                                           len(blob), n)
        else:
            rc = self._lib.ffk_batch_apply(self._h, bytes(xid), len(xid),
                                           blob, len(blob), n)
        if rc != 0:
            _raise(rc, "batch_apply")

    def rec_remove(self, xid: bytes | None, key: bytes) -> None:
        if xid is None:
            rc = self._lib.ffk_rec_remove(self._h, None, -1, bytes(key),
                                          len(key))
        else:
            rc = self._lib.ffk_rec_remove(self._h, bytes(xid), len(xid),
                                          bytes(key), len(key))
        if rc != 0:
            _raise(rc, "rec_remove")

    def rec_query(self, xid: bytes | None, key: bytes) -> bytes | None:
        rc = self._query(xid, key)
        if rc == 0:
            return None
        off = self._voff.value
        ln = self._vlen.value
        return bytes(self._map[off: off + ln]) if ln > 0 else b""

    def rec_query_view(self, xid: bytes | None,
                       key: bytes) -> memoryview | None:
        """Zero-copy read: a memoryview into the shm mapping.  Valid
        until the record is overwritten/published — consume before the
        next store mutation."""
        rc = self._query(xid, key)
        if rc == 0:
            return None
        off = self._voff.value
        ln = self._vlen.value
        return self._map[off: off + ln]

    def _query(self, xid: bytes | None, key: bytes) -> int:
        if xid is None:
            rc = self._lib.ffk_rec_query(self._h, None, -1, bytes(key),
                                         len(key), self._voff_ref,
                                         self._vlen_ref)
        else:
            rc = self._lib.ffk_rec_query(self._h, bytes(xid), len(xid),
                                         bytes(key), len(key),
                                         self._voff_ref, self._vlen_ref)
        if rc < 0:
            _raise(rc, "rec_query")
        return rc

    def rec_cnt_root(self) -> int:
        return int(self._lib.ffk_rec_cnt_root(self._h))

    def rec_keys(self, xid: bytes | None) -> list[bytes]:
        keys = set(self._root_keys())
        if xid is not None:
            for t_xid in self.txn_ancestry(xid):  # oldest -> newest
                for key, tomb in self._txn_keys(t_xid):
                    if tomb:
                        keys.discard(key)
                    else:
                        keys.add(key)
        return list(keys)

    def txn_diff(self, xid: bytes) -> list[tuple[bytes, bytes | None,
                                                 bytes | None]]:
        """The seal read-out in ONE crossing: [(key, before, after)] for
        every key in xid's own overlay, before = the parent view's value
        (start-of-slot), after = the overlay's (None = absent/tombstone)."""
        lib = self._lib
        bx = bytes(xid)
        need = int(lib.ffk_txn_diff(self._h, bx, len(bx), None, 0))
        if need < 0:
            _raise(need, "txn_diff")
        buf = ctypes.create_string_buffer(need or 1)
        n = int(lib.ffk_txn_diff(self._h, bx, len(bx), buf, need))
        if n < 0:
            _raise(n, "txn_diff")
        raw = buf.raw[:n]
        out = []
        p = 0
        while p < n:
            klen, blen, alen = struct.unpack_from("<Hqq", raw, p)
            p += 18
            key = raw[p: p + klen]
            p += klen
            before = None
            after = None
            if blen >= 0:
                before = raw[p: p + blen]
                p += blen
            if alen >= 0:
                after = raw[p: p + alen]
                p += alen
            out.append((key, before, after))
        return out

    # -- root iteration / merge funnel ----------------------------------------

    def _root_keys(self) -> list[bytes]:
        lib = self._lib
        need = int(lib.ffk_root_keys(self._h, None, 0))
        if need < 0:
            _raise(need, "root_keys")
        buf = ctypes.create_string_buffer(need or 1)
        n = int(lib.ffk_root_keys(self._h, buf, need))
        if n < 0:
            _raise(n, "root_keys")
        raw = buf.raw[:n]
        out, p = [], 0
        while p < n:
            ln = raw[p] | (raw[p + 1] << 8)
            out.append(raw[p + 2: p + 2 + ln])
            p += 2 + ln
        return out

    def _txn_keys(self, xid: bytes) -> list[tuple[bytes, bool]]:
        lib = self._lib
        bx = bytes(xid)
        need = int(lib.ffk_txn_keys(self._h, bx, len(bx), None, 0))
        if need < 0:
            _raise(need, "txn_keys")
        buf = ctypes.create_string_buffer(need or 1)
        n = int(lib.ffk_txn_keys(self._h, bx, len(bx), buf, need))
        if n < 0:
            _raise(n, "txn_keys")
        raw = buf.raw[:n]
        out, p = [], 0
        while p < n:
            ln = raw[p] | (raw[p + 1] << 8)
            tomb = bool(raw[p + 2])
            out.append((raw[p + 3: p + 3 + ln], tomb))
            p += 3 + ln
        return out

    @property
    def _root(self) -> dict[bytes, bytes]:
        """Dict view of the root store (the snapshot writer's iteration
        surface, utils/checkpt.funk_checkpt).  A COPY: cold-path only."""
        return {k: self.rec_query(None, k) for k in self._root_keys()}

    def _root_merge(self, items) -> None:
        """The single root-write funnel, one crossing per batch
        (None value = delete) — funk.py's contract, batched."""
        self.rec_insert_batch(None, items)

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Unmap the segment and unlink its name when this object made it.
        Idempotent; views from rec_query_view die with the mapping."""
        if getattr(self, "_h", None):
            self._map = None
            self._lib.ffk_close(self._h, 1 if self._owns else 0)
            self._h = None
            self._lib = _CLOSED

    def __enter__(self) -> "NativeFunk":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
