"""ctypes binding for the native executor lane, native/fd_exec_native.cpp
(the port's counterpart of firedancer_tpu/flamenco/exec_native.py).

The bank stage's per-microblock commit path: a run of eligible txns goes
through ONE fd_exec_batch2 call against the slot's Session, payloads and
packed descriptors (the verify stage's trailer) in, record writes and
per-txn (status, fee) out.  The session holds the status-cache gate and
an overlay of account values across calls, so each account's value
crosses once (first touch, or after a Python-lane write dirtied it).

  - `eligible_packed` is the routing classifier: a txn whose every
    instruction is system (the durable-nonce family included), stake, or
    vote with a tag in NATIVE_VOTE_TAGS may route native; lookup tables,
    BPF and every other program stay on the Python lane.
  - the C++ side may PUNT a txn it is not sure about (old vote state
    versions, arithmetic Python's big ints would survive, a stale
    blockhash that may be a durable nonce): the call stops before that
    txn mutates anything and the caller runs it on the Python lane, then
    resubmits the remainder.  That is the lane's own protocol.
  - a response that outgrows its buffer (rc -2) is retried with a buffer
    four times larger, up to 256 MB; any other negative return code, a
    bad response or a session that cannot be made raises NativeExecError.

The library is built by utils/hostbuild.py on first use; a failed build
raises HostBuildError.  Nothing switches the lane off: SlotExecution's
`native_exec` argument picks it.
"""

from __future__ import annotations

import ctypes
import struct
import weakref

from ..protocol.txn import _DESC_HDR, _DESC_INSTR, SYSTEM_PROGRAM, VOTE_PROGRAM
from ..utils import hostbuild
from .stake import STAKE_PROGRAM

_REQ_MAGIC = 0x42584446  # 'FDXB' (stateless)
_REQ2_MAGIC = 0x32584446  # 'FDX2' (session + native gate)
_RESP_MAGIC = 0x52584446  # 'FDXR'

_U32 = struct.Struct("<I")
_TXN_HEAD = struct.Struct("<HHB")
_REC_HEAD = struct.Struct("<bQBB")

RESP_CAP_MAX = 1 << 28  # the response buffer's growth stops at 256 MB


_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the source each call


class NativeExecError(RuntimeError):
    pass


def load() -> ctypes.CDLL:
    """The library, built by utils/hostbuild.py on first use."""
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_exec_native")
        u64, vp, cp = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p
        lib.fd_exec_batch.argtypes = [cp, u64, cp, u64]
        lib.fd_exec_batch.restype = ctypes.c_int64
        lib.fd_exec_session_new.restype = vp
        lib.fd_exec_session_new.argtypes = []
        lib.fd_exec_session_delete.argtypes = [vp]
        lib.fd_exec_batch2.argtypes = [vp, cp, u64, cp, u64]
        lib.fd_exec_batch2.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


class Session:
    """One slot's native session (fd_exec_native.cpp Session): the
    status-cache gate (valid blockhashes and the landed (blockhash,
    signature) pairs) and the account-value overlay live on the C++ side.
    Freed by close() or when the object is collected."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.fd_exec_session_new()
        if not self._h:
            raise NativeExecError("fd_exec_session_new failed")
        self._fin = weakref.finalize(self, self._lib.fd_exec_session_delete, self._h)

    def close(self) -> None:
        self._fin()
        self._h = None


# -- eligibility classifier ----------------------------------------------------

_HDR_SZ = _DESC_HDR.size  # 17
_INSTR_SZ = _DESC_INSTR.size  # 9

# VoteInstruction tags the native lane executes (Vote/VoteSwitch,
# UpdateVoteState(Switch), TowerSync(Switch))
NATIVE_VOTE_TAGS = frozenset((2, 6, 8, 9, 14, 15))


def eligible_packed(payload: bytes, desc_bytes: bytes) -> bool:
    """May this txn route native?  Read off the packed descriptor, so native
    traffic never unpacks a Txn.  Conservative by design: the C++ side
    re-checks and punts."""
    if len(desc_bytes) < _HDR_SZ or desc_bytes[13] != 0:  # lut_cnt
        return False
    acct_cnt = desc_bytes[8]
    acct_off = desc_bytes[9] | (desc_bytes[10] << 8)
    o = _HDR_SZ
    for _ in range(desc_bytes[16]):  # instr_cnt
        prog, _acnt, dsz, _aoff, doff = _DESC_INSTR.unpack_from(desc_bytes, o)
        o += _INSTR_SZ
        if prog >= acct_cnt:
            return False
        pa = acct_off + 32 * prog
        pk = payload[pa : pa + 32]
        if pk == SYSTEM_PROGRAM or pk == STAKE_PROGRAM:
            # the whole native surface, the durable-nonce family included
            # (the session's in-line durable gate owns the stale-blockhash
            # decision); stake tags 0..4 execute, others no-op
            pass
        elif pk == VOTE_PROGRAM:
            if dsz >= 4:
                tag = int.from_bytes(payload[doff : doff + 4], "little")
                if tag not in NATIVE_VOTE_TAGS:
                    return False
            # dsz < 4: both lanes fail the txn with the same status
        else:
            return False  # BPF, other builtins, unknown programs
    return True


# -- batch runner --------------------------------------------------------------


class BatchContext:
    """One slot's request context: the fixed header (fee rate, clock,
    slot-hashes sysvar, recent blockhash, rent) built once and reused for
    every call.  With a session, calls go through fd_exec_batch2 and a
    request arena reused across microblocks; without one, through the
    stateless fd_exec_batch."""

    def __init__(
        self,
        *,
        lamports_per_sig: int,
        clock_slot: int | None = None,
        clock_epoch: int | None = None,
        slot_hashes: bytes | None = None,
        session: Session | None = None,
        recent_blockhash: bytes | None = None,
        rent: tuple[int, int, float] | None = None,
    ):
        self._lib = load()
        self._session = session
        sh = bytes(slot_hashes or b"")
        rbh = bytes(recent_blockhash or b"")
        # (flag, lamports_per_byte_year, exemption_threshold); flag 2 = the
        # rent sysvar blob exists but does not decode: the C++ side punts
        # nonce partial withdraws instead of guessing a floor
        rent_flag, rent_lpby, rent_et = rent if rent is not None else (1, 3480, 2.0)
        self._fixed = (
            struct.pack(
                "<QBQQB",
                lamports_per_sig,
                1 if clock_slot is not None else 0,
                clock_slot or 0,
                clock_epoch or 0,
                1 if sh else 0,
            )
            + _U32.pack(len(sh))
            + sh
            + struct.pack("<B32sBQd", 1 if rbh else 0, rbh, rent_flag, rent_lpby, rent_et)
        )
        # the session path's request arena and response buffer, reused
        # across microblocks and grown on demand
        self._arena: bytearray | None = None
        self._arena_view = None
        self._resp_cap = 1 << 16
        self._resp = None

    def _ensure_arena(self, need: int) -> None:
        if self._arena is None or need > len(self._arena):
            cap = 1 << 16 if self._arena is None else len(self._arena)
            while cap < need:
                cap *= 2
            self._arena_view = None  # drop the old from_buffer pin first
            self._arena = bytearray(cap)
            self._arena_view = (ctypes.c_char * cap).from_buffer(self._arena)
        if self._resp is None:
            self._resp = ctypes.create_string_buffer(self._resp_cap)

    def run(self, entries, *, gate=None, refresh=None) -> tuple[int, bool, list]:
        """One fd_exec_batch(2) call.  entries: [payload, desc_bytes, addrs,
        vals, ...] lists; only the first four fields are read.  Returns
        (n_done, punted, [(status, fee, n_ins, [(idx, value)])]), n_ins the
        count of the txn's instructions that charged their builtin cost (the
        failing one included when it ran; all of them on success).

        Session mode: a vals entry may be None, meaning the session already
        holds that account's current value.  `gate` arms the native
        status-cache gate: (valid_blockhashes, or None for unchanged since
        the last call; seen_delta, the 96-byte blockhash || signature
        entries landed outside the session since the last call).  `refresh`
        (session mode): (key, value) records merged into the session's
        overlay before any txn runs, the bank sweep's resync of accounts the
        Python lane wrote (runtime/bank.py), which has no per-txn value to
        ride."""
        if self._session is not None:
            return self._run_session(entries, gate, refresh or ())
        parts = [struct.pack("<II", _REQ_MAGIC, len(entries)), self._fixed]
        req_sz = 0
        for e in entries:
            payload, desc_bytes, vals = e[0], e[1], e[3]
            parts.append(_TXN_HEAD.pack(len(payload), len(desc_bytes), len(vals)))
            parts.append(payload)
            parts.append(desc_bytes)
            for v in vals:
                v = v or b""
                parts.append(_U32.pack(len(v)))
                parts.append(v)
                req_sz += len(v)
            req_sz += len(payload) + 64
        req = b"".join(parts)
        cap = 4096 + 2 * req_sz
        while True:
            buf = ctypes.create_string_buffer(cap)
            rc = self._lib.fd_exec_batch(req, len(req), buf, cap)
            if rc == -2:
                # a CreateAccount/Allocate burst can outgrow the estimate;
                # the stateless call committed nothing, so retry bigger
                cap *= 4
                if cap > RESP_CAP_MAX:
                    raise NativeExecError("fd_exec_batch response > 256 MB")
                continue
            if rc < 0:
                raise NativeExecError(f"fd_exec_batch rc={rc}")
            return self._parse(buf.raw[:rc])

    def _run_session(self, entries, gate, refresh) -> tuple[int, bool, list]:
        """The session crossing through the reused request arena: one
        capacity pass, then pack_into and slice assignment, no per-txn
        bytes objects and no per-call join or response allocation."""
        fixed = self._fixed
        need = 8 + len(fixed) + 5 + 4 + 4  # headers, gate flag, counts
        if gate is not None:
            valid_bh, seen_delta = gate
            if valid_bh is not None:
                need += 32 * len(valid_bh)
            need += 96 * len(seen_delta)
        for _k, v in refresh:
            need += 36 + len(v)
        for e in entries:
            need += _TXN_HEAD.size + len(e[0]) + len(e[1])
            for v in e[3]:
                need += 1 if v is None else 5 + len(v)
        self._ensure_arena(need)
        a = self._arena
        struct.pack_into("<II", a, 0, _REQ2_MAGIC, len(entries))
        o = 8
        a[o : o + len(fixed)] = fixed
        o += len(fixed)
        if gate is not None:
            valid_bh, seen_delta = gate
            if valid_bh is None:
                # gate on, valid set unchanged (flag 2): the session keeps it
                a[o] = 2
                struct.pack_into("<I", a, o + 1, 0)
                o += 5
            else:
                a[o] = 1
                struct.pack_into("<I", a, o + 1, len(valid_bh))
                o += 5
                for bh in valid_bh:
                    a[o : o + 32] = bh
                    o += 32
            struct.pack_into("<I", a, o, len(seen_delta))
            o += 4
            for s in seen_delta:
                a[o : o + 96] = s
                o += 96
        else:
            a[o] = 0
            struct.pack_into("<II", a, o + 1, 0, 0)
            o += 9
        struct.pack_into("<I", a, o, len(refresh))
        o += 4
        for k, v in refresh:
            a[o : o + 32] = k
            struct.pack_into("<I", a, o + 32, len(v))
            o += 36
            a[o : o + len(v)] = v
            o += len(v)
        for e in entries:
            payload, desc_bytes, vals = e[0], e[1], e[3]
            _TXN_HEAD.pack_into(a, o, len(payload), len(desc_bytes), len(vals))
            o += _TXN_HEAD.size
            a[o : o + len(payload)] = payload
            o += len(payload)
            a[o : o + len(desc_bytes)] = desc_bytes
            o += len(desc_bytes)
            for v in vals:
                if v is None:  # session-known: nothing crosses
                    a[o] = 0
                    o += 1
                else:
                    a[o] = 1
                    struct.pack_into("<I", a, o + 1, len(v))
                    o += 5
                    a[o : o + len(v)] = v
                    o += len(v)
        while True:
            rc = self._lib.fd_exec_batch2(self._session._h, self._arena_view, o,
                                          self._resp, self._resp_cap)
            if rc == -2:
                # the session commits only after the response is written,
                # so a call that ran out of room changed nothing
                self._resp_cap *= 4
                if self._resp_cap > RESP_CAP_MAX:
                    raise NativeExecError("fd_exec_batch2 response > 256 MB")
                self._resp = ctypes.create_string_buffer(self._resp_cap)
                continue
            if rc < 0:
                raise NativeExecError(f"fd_exec_batch2 rc={rc}")
            return self._parse(ctypes.string_at(self._resp, rc))

    @staticmethod
    def _parse(buf: bytes) -> tuple[int, bool, list]:
        magic, n_done = struct.unpack_from("<II", buf, 0)
        if magic != _RESP_MAGIC:
            raise NativeExecError("fd_exec_batch bad response magic")
        punted = buf[8] != 0
        o = 9
        out = []
        for _ in range(n_done):
            status, fee, n_ins, n_w = _REC_HEAD.unpack_from(buf, o)
            o += _REC_HEAD.size
            writes = []
            for _ in range(n_w):
                idx = buf[o]
                (vlen,) = _U32.unpack_from(buf, o + 1)
                o += 5
                writes.append((idx, buf[o : o + vlen]))
                o += vlen
            out.append((status, fee, n_ins, writes))
        return n_done, punted, out
