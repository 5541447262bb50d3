"""ctypes facade for the native pack scheduler, native/fd_pack.cpp (the
port's counterpart of firedancer_tpu/pack/scheduler_native.py).

The pack stage's native lane: verified frags go into the pool through one
`fd_pack_insert_burst` call per drained burst, and each `fd_pack_schedule`
call returns a complete microblock frame, so Python never touches the
per-txn descriptors, the cost arithmetic or the conflict sets.

Fused dedup: `attach_tcache` wires a tango/tcache_native.NativeTCache
into the insert path, so a duplicate txn is dropped inside the same call.

Parity: byte-identical microblock frames, the same evictions and block
accounting as pack/scheduler.Pack, and the same drops as the dedup stage
in front of the Python lane (tests/test_torch_pack_native.py).  The
library is built by utils/hostbuild.py; a failed build or a bad return
code raises.
"""

from __future__ import annotations

import ctypes

from ..utils import hostbuild
from .scheduler import BlockLimits

# insert result codes (native/fd_pack.cpp INS_*)
INS_OK = 0        # accepted into the pool
INS_DUP = 1       # fused-dedup tcache hit
INS_REJECT = 2    # malformed compute-budget cost
INS_SIG_DUP = 3   # first signature already pooled
INS_BAD_FRAG = 4  # frag or descriptor fails validation
INS_FULL = 5      # pool full, the newcomer loses

_MASK64 = (1 << 64) - 1


class NativePackError(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    lib = hostbuild.load("fd_pack")
    if not getattr(lib, "_bound", False):
        u64, i64, vp = ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p
        lib.fd_pack_new.restype = vp
        lib.fd_pack_new.argtypes = [u64] * 8
        lib.fd_pack_delete.argtypes = [vp]
        lib.fd_pack_set_tcache.argtypes = [vp, vp, vp]
        lib.fd_pack_insert_burst.restype = i64
        lib.fd_pack_insert_burst.argtypes = [vp, ctypes.c_char_p, u64, u64, ctypes.c_char_p,
                                             ctypes.POINTER(u64)]
        lib.fd_pack_pending_cnt.restype = u64
        lib.fd_pack_pending_cnt.argtypes = [vp]
        lib.fd_pack_block_state.argtypes = [vp, ctypes.POINTER(u64)]
        lib.fd_pack_schedule.restype = i64
        lib.fd_pack_schedule.argtypes = [vp, u64, ctypes.c_int, ctypes.c_uint32,
                                         ctypes.c_char_p, u64, ctypes.POINTER(u64)]
        lib.fd_pack_microblock_done.argtypes = [vp, u64]
        lib.fd_pack_end_block.argtypes = [vp]
        lib.fd_pack_shed.restype = u64
        lib.fd_pack_shed.argtypes = [vp, u64, ctypes.POINTER(u64)]
        lib.fd_pack_cost_probe.restype = i64
        lib.fd_pack_cost_probe.argtypes = [ctypes.c_char_p, u64, ctypes.c_char_p, u64,
                                           ctypes.POINTER(u64)]
        lib._bound = True
    return lib


def cost_probe(payload: bytes, desc_bytes: bytes):
    """The native cost model on one (payload, packed descriptor): (0,
    (total, rewards), is_simple_vote), or (rc, None, None) when the native
    side refuses it (-1 the descriptor is invalid, -2 a malformed compute
    budget)."""
    out = (ctypes.c_uint64 * 4)()
    rc = _load().fd_pack_cost_probe(payload, len(payload), desc_bytes, len(desc_bytes), out)
    if rc != 0:
        return (int(rc), None, None)
    return (0, (int(out[0]), int(out[1]) | (int(out[2]) << 64)), bool(out[3]))


class NativePack:
    """One native pack pool with pack/scheduler.Pack's lifecycle (insert,
    schedule, microblock_done, end_block, shed_lowest) at burst
    granularity."""

    FRAME_CAP = 65536  # the pack->bank frame's largest size

    def __init__(self, *, bank_cnt: int = 4, depth: int = 4096,
                 max_txn_per_microblock: int = 31, max_schedule_search: int = 256,
                 limits: BlockLimits | None = None):
        self._lib = _load()
        self.limits = lim = limits or BlockLimits()
        self._h = self._lib.fd_pack_new(
            bank_cnt, depth, max_txn_per_microblock, max_schedule_search,
            lim.max_cost_per_block, lim.max_vote_cost_per_block,
            lim.max_write_cost_per_acct, lim.max_data_bytes_per_block)
        if not self._h:
            raise NativePackError(f"fd_pack_new(bank_cnt={bank_cnt}, depth={depth}) failed")
        self.bank_cnt = bank_cnt
        self.depth = depth
        self._frame_buf = ctypes.create_string_buffer(self.FRAME_CAP)
        self._meta = (ctypes.c_uint64 * 4)()
        self._pending_out = (ctypes.c_uint64 * 1)()
        # the pool's size after the last insert_burst, schedule or shed:
        # each call reports it, so the stage's policy needs no call of its own
        self.last_pending = 0
        # the native side holds the tcache's raw handle: keep it alive
        self._tcache = None

    def attach_tcache(self, tcache) -> None:
        """Fuse dedup into the insert call: `tcache` (a NativeTCache) is
        probed with each frag's tag before the frag is validated."""
        self._tcache = tcache
        insert_fn = ctypes.cast(tcache._lib.tcache_insert, ctypes.c_void_p)
        self._lib.fd_pack_set_tcache(self._h, ctypes.c_void_p(tcache._h), insert_fn)

    def insert_burst(self, entries) -> bytes:
        """Insert a burst of (frag, tag, tsorig) in one call, where frag is
        the verify stage's payload || packed descriptor || u16 layout and
        tag the frag's 64-bit signature tag; -> the INS_* code of each."""
        n = len(entries)
        parts = []
        for frag, tag, tsorig in entries:
            parts += [len(frag).to_bytes(2, "little"), (tag & _MASK64).to_bytes(8, "little"),
                      (tsorig & _MASK64).to_bytes(8, "little"), frag]
        buf = b"".join(parts)
        codes = ctypes.create_string_buffer(max(n, 1))
        rc = self._lib.fd_pack_insert_burst(self._h, buf, len(buf), n, codes, self._pending_out)
        if rc != n:
            raise NativePackError(f"fd_pack_insert_burst took {rc} of {n} frags")
        self.last_pending = int(self._pending_out[0])
        return codes.raw[:n]

    def schedule(self, bank: int, *, votes: bool = False, mb_seq: int = 0,
                 any_pool: bool = False):
        """-> (frame, txn_cnt, cu, tsorig), or None when nothing can be
        scheduled.  The frame is u32 mb_seq | u16 cnt | (u16 len || frag)*,
        byte for byte the Python lane's.  any_pool=True tries the regular
        pool, then the vote pool, in one call (the stage's order)."""
        rc = self._lib.fd_pack_schedule(self._h, bank, 2 if any_pool else int(votes),
                                        mb_seq & 0xFFFFFFFF, self._frame_buf,
                                        self.FRAME_CAP, self._meta)
        self.last_pending = int(self._meta[3])
        if rc == 0:
            return None
        if rc < 0:
            raise NativePackError(f"fd_pack_schedule rc={rc}")
        m = self._meta
        return self._frame_buf.raw[:rc], int(m[0]), int(m[1]), int(m[2])

    def microblock_done(self, bank: int) -> None:
        self._lib.fd_pack_microblock_done(self._h, bank)

    def end_block(self) -> None:
        self._lib.fd_pack_end_block(self._h)

    def shed_lowest(self, n: int) -> int:
        """Drop up to n of the lowest-priority pending regular txns (never
        votes); -> how many were shed."""
        shed = int(self._lib.fd_pack_shed(self._h, n, self._pending_out))
        self.last_pending = int(self._pending_out[0])
        return shed

    def pending_cnt(self) -> int:
        return int(self._lib.fd_pack_pending_cnt(self._h))

    def block_state(self) -> tuple[int, int, int]:
        """(cost_used, vote_cost_used, data_bytes_used) of the open block."""
        out = (ctypes.c_uint64 * 3)()
        self._lib.fd_pack_block_state(self._h, out)
        return int(out[0]), int(out[1]), int(out[2])

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.fd_pack_delete(self._h)
            self._h = None

    def __del__(self):
        self.close()
