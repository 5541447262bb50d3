"""ctypes binding for the bank stage's sweep client, native/fd_bank.cpp (the
port's counterpart of firedancer_tpu/runtime/bank_native.py).

The bank sweep lane: fdb_frag_cb runs the whole per-microblock path (the
frame parse, the session's fd_exec_batch2 call, the PoH-mixin entry build
and the credit-gated entry and done publishes) inside one fdr_sweep call
(runtime/stage.py), with no Python per frag on the eligible path.  The C
side reaches the other native libraries through function pointers taken
from the port's own builds: fd_exec_batch2 from flamenco/exec_native.py's
library, fdr_try_publish and fdr_refresh_credits from tango/native.py's.

Python's half is the result log: every microblock the C side touches
appends a group, its committed records and, for a punt or a credit stall,
the raw frame to resume in order on the Python lane.
runtime/bank.BankStage drains it with `take_log`/`parse_log` and
un-freezes the C side with `clear_log`.

The native funk plane (`set_funk`): when the slot's store is the shm map
(funk/funk_native.NativeFunk), the C side writes the committed records
into the slot's fork inside the crossing, through the port's fd_funk
library's ffk_txn_slot / ffk_rec_insert_slot, and the log's records come
stripped of their writes, as the JAX package's do.
`bank_funk_writes` counts the txns so written, `bank_funk_falls` the
groups that logged full records instead (the slot's fork frozen or
unknown, the map full).  `set_metrics` arms the shm metrics plane
(runtime/native_metrics.NativePlane): the apply and publish brackets and
each txn's commit latency into `nbank_txn_lat_ns`.  The library is built
by utils/hostbuild.py on first use; a failed build raises HostBuildError.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from ..utils import hostbuild

_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the sources each call


def load() -> ctypes.CDLL:
    """The library, built by utils/hostbuild.py on first use."""
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_bank")
        u64, vp, cp = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p
        lib.fdb_stage_new.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, u64, cp, u64]
        lib.fdb_stage_new.restype = vp
        lib.fdb_stage_delete.argtypes = [vp]
        lib.fdb_stage_flags_off.restype = u64
        lib.fdb_stage_set_hdr.argtypes = [vp, cp, u64]
        lib.fdb_stage_set_hdr.restype = ctypes.c_int
        lib.fdb_stage_set_funk.argtypes = [vp, vp, vp, vp, cp, u64]
        lib.fdb_stage_set_funk.restype = ctypes.c_int
        lib.fdb_stage_set_metrics.argtypes = [vp, vp]
        lib.fdb_log_ptr.argtypes = [vp]
        lib.fdb_log_ptr.restype = vp
        lib.fdb_log_clear.argtypes = [vp]
        _LIB = lib
    return _LIB


class BankSweepError(RuntimeError):
    pass


def make_hdr(batch_ctx, *, gated: bool) -> bytes:
    """The FDX2 prefix the C side puts in every request: the BatchContext's
    fixed header (fee rate, clock, slot hashes, recent blockhash, rent) and
    a gate section with no records (flag 2 = the session keeps its valid
    set; the deltas and the refresh records ride SlotExecution.native_sync's
    crossings instead)."""
    return bytes(batch_ctx._fixed) + struct.pack("<BIII", 2 if gated else 0, 0, 0, 0)


# the C ctx's counters after log_sz and stash_pending, in declaration order;
# the offset comes from the C side (fdb_stage_flags_off)
COUNTERS = ("bank_mb_seen", "bank_mb_native", "bank_mb_stashed", "bank_txn_native",
            "bank_credit_waits", "bank_mb_dropped", "bank_funk_writes", "bank_funk_falls")

_GROUP_HEAD = struct.Struct("<QQQIBI")
_REC_HEAD = struct.Struct("<bQBB")  # status | fee | n_ins | n_writes


def parse_log(log: bytes) -> list:
    """A drained result log -> groups (mb_seq, tsorig, lat_ns, n_done,
    published, recs, mb_raw): recs = [(status, fee, n_ins, [(acct_idx,
    value)])], the fd_exec_batch2 records as they came (with no writes
    where the funk plane already put them in the map), and mb_raw the
    microblock frame (runtime/bank.parse_microblock's format)."""
    groups = []
    off = 0
    while off < len(log):
        mb_seq, tsorig, lat_ns, n_done, published, mb_sz = _GROUP_HEAD.unpack_from(log, off)
        off += _GROUP_HEAD.size
        recs = []
        for _ in range(n_done):
            status, fee, n_ins, n_w = _REC_HEAD.unpack_from(log, off)
            off += _REC_HEAD.size
            writes = []
            for _ in range(n_w):
                vlen = int.from_bytes(log[off + 1 : off + 5], "little")
                writes.append((log[off], log[off + 5 : off + 5 + vlen]))
                off += 5 + vlen
            recs.append((status, fee, n_ins, writes))
        groups.append((mb_seq, tsorig, lat_ns, n_done, published, recs, log[off : off + mb_sz]))
        off += mb_sz
    return groups


class StageClient:
    """The bank stage's sweep client: the fdr_sweep callback (`cb`,
    `cb_ctx`), the result log and the counters, read off the C ctx without
    a call.  `session` is the slot's exec_native.Session; the producers are
    the stage's two native outputs (entries to PoH, done frames to pack)."""

    def __init__(self, session, hdr: bytes, ent_producer, done_producer, *, bank_idx: int):
        from ..flamenco import exec_native
        from ..tango import native as tn

        lib = load()
        ring = tn.load()
        xlib = exec_native.load()
        self._lib = lib
        # kept alive as long as the C ctx points into them
        self._keep = (session, ent_producer, done_producer)
        self._funk = None  # set_funk's store, kept alive while armed
        self._plane = None  # set_metrics's plane, likewise
        vp = ctypes.c_void_p
        self._h = lib.fdb_stage_new(
            vp(session._h), ctypes.cast(xlib.fd_exec_batch2, vp),
            ctypes.cast(ent_producer._lsp, vp), ctypes.cast(ent_producer._pp, vp),
            ctypes.cast(done_producer._lsp, vp), ctypes.cast(done_producer._pp, vp),
            ctypes.cast(ring.fdr_try_publish, vp), ctypes.cast(ring.fdr_refresh_credits, vp),
            bank_idx, hdr, len(hdr))
        if not self._h:
            raise BankSweepError("fdb_stage_new failed")
        self.cb = ctypes.cast(lib.fdb_frag_cb, vp)
        self.cb_ctx = vp(self._h)
        n_tail = 2 + len(COUNTERS)
        self._tail = np.frombuffer(
            (ctypes.c_uint64 * n_tail).from_address(self._h + int(lib.fdb_stage_flags_off())),
            dtype=np.uint64)

    @property
    def log_sz(self) -> int:
        return int(self._tail[0])

    @property
    def stash_pending(self) -> bool:
        return bool(self._tail[1])

    def counters(self) -> dict[str, int]:
        return {name: int(self._tail[2 + i]) for i, name in enumerate(COUNTERS)}

    def set_hdr(self, hdr: bytes) -> None:
        """Put a new env/gate prefix in (the BatchContext was rebuilt)."""
        if not self._lib.fdb_stage_set_hdr(self._h, hdr, len(hdr)):
            raise BankSweepError("fdb_stage_set_hdr failed")

    def set_funk(self, funk, xid: bytes | None) -> None:
        """Arm (or disarm: funk or xid None) the native funk plane: the C
        side writes committed records into `funk`'s shm map, in the fork
        `xid`, and strips them from the log.  Called at arm time and
        wherever the slot's xid or env header changes.  `funk` (and so its
        library) is kept alive while the C side holds its pointers."""
        if funk is None or xid is None:
            rc = self._lib.fdb_stage_set_funk(self._h, None, None, None, None, 0)
            self._funk = None
        else:
            from ..funk import funk_native

            flib = funk_native.load()
            vp = ctypes.c_void_p
            rc = self._lib.fdb_stage_set_funk(
                self._h, vp(funk.handle), ctypes.cast(flib.ffk_txn_slot, vp),
                ctypes.cast(flib.ffk_rec_insert_slot, vp), xid, len(xid))
            self._funk = funk
        if rc == 0:
            raise BankSweepError(f"fdb_stage_set_funk failed (xid of {len(xid)} bytes)")

    def set_metrics(self, plane) -> None:
        """Arm (or disarm: None) the shm metrics plane: the apply and
        publish brackets inside fdb_frag_cb accumulate into the plane
        fdr_sweep is handed, and each txn's commit latency lands in the
        plane's extra histogram (`nbank_txn_lat_ns`).  The plane is kept
        alive while the C side holds its pointer."""
        self._plane = plane
        self._lib.fdb_stage_set_metrics(self._h, plane.ptr if plane is not None else None)

    def take_log(self) -> bytes:
        """A copy of the pending result log (b"" when idle).  Does not clear:
        clear_log once the drain is applied un-freezes the C side."""
        sz = int(self._tail[0])
        return ctypes.string_at(self._lib.fdb_log_ptr(self._h), sz) if sz else b""

    def clear_log(self) -> None:
        self._lib.fdb_log_clear(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._tail = None
            self._lib.fdb_stage_delete(self._h)
            self._h = None
            self._keep = self._funk = self._plane = None

    def __del__(self):
        self.close()
