"""ctypes binding for the verify stage's sweep client, native/fd_verify.cpp
(the port's counterpart of firedancer_tpu/runtime/verify_native.py).

The verify stage's host orchestration in one FFI crossing per sweep:
fdr_sweep drains the stage's input rings AND runs the C frag callback —
shard filter, fd_txn_parse (a function pointer into the port's parser
library, protocol/txn_native.py), tcache dedup, the msg-length / fit
guards, and fixed-shape batch assembly into a ring of reusable slot
buffers — with zero Python per frag.  Python touches the pipeline at BATCH
granularity only (runtime/verify.py): a sealed slot's numpy views go to K1
on the stage's device, and the reaped frames are published straight from
the slot's preassembled frame arena (one fdr_publish_burst crossing).

Lane parity with the Python intake is the contract
(tests/test_torch_verify_native.py).  The library is built by
utils/hostbuild.py on first use; a failed build raises HostBuildError.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..protocol import txn_native
from ..utils import hostbuild

# slot states (fd_verify.cpp enum)
SLOT_FREE = 0
SLOT_OPEN = 1
SLOT_SEALED = 2
SLOT_INFLIGHT = 3

# a frame is payload + packed descriptor + u16: the out link must carry
# fd_verify.cpp's FRAME_CAP
FRAME_MTU = 1232 + 2048 + 2

_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the source each call


def load() -> ctypes.CDLL:
    """The library, built by utils/hostbuild.py on first use."""
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_verify")
        u64, vp = ctypes.c_uint64, ctypes.c_void_p
        lib.fdv_stage_new.argtypes = [u64, u64, u64, u64, u64, vp]
        lib.fdv_stage_new.restype = vp
        lib.fdv_stage_delete.argtypes = [vp]
        lib.fdv_append.argtypes = [vp, ctypes.c_char_p, u64, u64]
        lib.fdv_append.restype = ctypes.c_int
        lib.fdv_seal.argtypes = [vp]
        lib.fdv_pump.argtypes = [vp]
        lib.fdv_slot_release.argtypes = [vp, u64]
        for name in ("fdv_meta_ptr", "fdv_counters_ptr"):
            getattr(lib, name).argtypes = [vp]
            getattr(lib, name).restype = vp
        for name in ("fdv_slot_msg", "fdv_slot_ln", "fdv_slot_sig", "fdv_slot_pk",
                     "fdv_slot_frames", "fdv_slot_ranges", "fdv_slot_arena"):
            getattr(lib, name).argtypes = [vp, u64]
            getattr(lib, name).restype = vp
        _LIB = lib
    return _LIB


class VerifyClientError(RuntimeError):
    pass


# the counter tail, in fd_verify.cpp declaration order after `flags` and
# `open_elems`; the names are the stage's metrics, so housekeeping copies
# them as they are
COUNTERS = ("filtered", "frags_in", "parse_fail", "dedup_dup", "msg_too_long",
            "too_many_sigs", "txn_in", "elems_in", "intake_dropped", "sealed_batches")
_TAIL_FLAGS = 0
_TAIL_OPEN_ELEMS = 1
_TAIL_COUNTERS = 2
_SEALED = COUNTERS.index("sealed_batches")

_META_NCOL = 4  # (state, n_elems, n_txn, arena_off) a slot


def _view(ptr: int, n: int, dtype) -> np.ndarray:
    ct = np.ctypeslib.as_ctypes_type(dtype) * n
    return np.frombuffer(ct.from_address(ptr), dtype=dtype)


class SlotViews:
    """Zero-copy numpy views over one slot's C buffers, built once: msg
    (batch, mml) row-major, ln, sig (batch, 64), pk (batch, 32), frames
    (batch, 4) = fdr_publish_burst's table (arena offset, size, sig tag,
    tsorig), ranges (batch, 2) = a txn's element [start, end)."""

    def __init__(self, lib, h, i: int, batch: int, mml: int):
        self.msg = _view(lib.fdv_slot_msg(h, i), batch * mml, np.uint8).reshape(batch, mml)
        self.ln = _view(lib.fdv_slot_ln(h, i), batch, np.int32)
        self.sig = _view(lib.fdv_slot_sig(h, i), batch * 64, np.uint8).reshape(batch, 64)
        self.pk = _view(lib.fdv_slot_pk(h, i), batch * 32, np.uint8).reshape(batch, 32)
        self.frames = _view(lib.fdv_slot_frames(h, i), batch * 4, np.uint64).reshape(batch, 4)
        self.ranges = _view(lib.fdv_slot_ranges(h, i), batch * 2, np.uint32).reshape(batch, 2)
        self.arena_ptr = int(lib.fdv_slot_arena(h, i))


class StageClient:
    """The verify stage's sweep client: C-side intake and batch assembly
    over a cyclic ring of `n_slots` slots.  Exposes the fdr_sweep callback
    (`cb`, `cb_ctx`), zero-FFI views of the slots and the counters, and the
    batch-granular control surface (seal, take_sealed, release)."""

    def __init__(self, *, shard_idx: int, shard_cnt: int, batch: int, max_msg_len: int,
                 n_slots: int):
        lib = load()
        parse = ctypes.cast(txn_native.load().fd_txn_parse, ctypes.c_void_p)
        self._lib = lib
        self.batch = batch
        self.max_msg_len = max_msg_len
        self.n_slots = n_slots
        self._h = lib.fdv_stage_new(shard_idx, shard_cnt, batch, max_msg_len, n_slots, parse)
        if not self._h:
            raise VerifyClientError("fdv_stage_new failed")
        self.cb = ctypes.cast(lib.fdv_frag_cb, ctypes.c_void_p)
        self.cb_ctx = ctypes.c_void_p(self._h)
        self.meta = _view(lib.fdv_meta_ptr(self._h), n_slots * _META_NCOL,
                          np.uint64).reshape(n_slots, _META_NCOL)
        self._tail = _view(lib.fdv_counters_ptr(self._h), _TAIL_COUNTERS + len(COUNTERS),
                           np.uint64)
        self.slots = [SlotViews(lib, self._h, i, batch, max_msg_len) for i in range(n_slots)]
        self._next_dispatch = 0  # cyclic = the C side's acquire order

    # -- intake ----------------------------------------------------------------

    @property
    def stash_pending(self) -> bool:
        return bool(self._tail[_TAIL_FLAGS] & 1)

    def can_accept(self) -> bool:
        """Room for one more txn without stashing (one u64 read; the C side
        keeps the bit): when False the stage reaps and publishes first
        instead of sweeping frags it would only stash."""
        return bool(self._tail[_TAIL_FLAGS] & 2)

    def append(self, payload: bytes, tsorig: int) -> bool:
        """Per-frag surface (a mixed-lane splice): forward into the SAME
        C-side state the sweep callback fills.  True = handled now
        (ingested, or dropped and counted by a guard); False = parked in
        the C-side stash (order kept, drained by pump).  Either way the C
        side accounts for the frag: the return is the backpressure signal."""
        return self._lib.fdv_append(self._h, payload, len(payload), tsorig) == 0

    def counters(self) -> dict[str, int]:
        return {name: int(self._tail[_TAIL_COUNTERS + i]) for i, name in enumerate(COUNTERS)}

    def sealed_cnt(self) -> int:
        """Slots sealed so far (full or at a deadline), one read."""
        return int(self._tail[_TAIL_COUNTERS + _SEALED])

    # -- batches -----------------------------------------------------------------

    def open_elems(self) -> int:
        """Elements in the open slot (0 = none): the deadline probe, one read."""
        return int(self._tail[_TAIL_OPEN_ELEMS])

    def seal(self) -> None:
        self._lib.fdv_seal(self._h)

    def pump(self) -> None:
        self._lib.fdv_pump(self._h)

    def sealed_waiting(self) -> bool:
        return bool((self.meta[:, 0] == SLOT_SEALED).any())

    def take_sealed(self) -> tuple[int, int, int] | None:
        """The next sealed slot in ring order as (slot, n_elems, n_txn),
        marked in flight (Python's until release); None when the next slot
        in order is not sealed, so dispatch keeps submission order."""
        i = self._next_dispatch
        if self.meta[i, 0] != SLOT_SEALED:
            return None
        self.meta[i, 0] = SLOT_INFLIGHT
        self._next_dispatch = (i + 1) % self.n_slots
        return i, int(self.meta[i, 1]), int(self.meta[i, 2])

    def release(self, slot: int) -> None:
        """The slot back to the intake (its frames are out and nothing reads
        its buffers any more)."""
        self._lib.fdv_slot_release(self._h, slot)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self.meta = self._tail = None
            self.slots = []
            self._lib.fdv_stage_delete(self._h)
            self._h = None

    def __del__(self):
        self.close()
