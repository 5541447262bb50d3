"""ctypes binding for the native shredder, native/fd_shred.cpp (the port's
counterpart of firedancer_tpu/runtime/shred_native.py).

The shred stage's compute path in ONE FFI crossing per entry batch:
data-shred framing, GF(2^8) parity, the SHA-256 merkle tree, and
fixed-base-comb ed25519 signing of the untruncated root.  Byte parity with
runtime/shredder.Shredder is the contract (tests/test_torch_shred_native.py).

Parity stays on the card: the C side calls a parity function once a FEC
set through a pointer, and on a CUDA device that pointer is K5's host entry
(csrc/gf256_apply.cu fd_gf256_encode_host: the set's RS rows and generator
copied into device scratch that `_CardParity` allocates as torch tensors
and keeps alive, one launch on the device's current stream, the parity
copied back).  The entry counts its launches in its own word, which
`_CardParity.fold` adds to kbuild.LAUNCHES["gf256_apply"] after every
shred call and every sweep.  On the CPU (tests only) the pointer is a
ctypes trampoline into ops/gf256.gf_apply_batch's plain version.  The
device decides, once, at construction: a CUDA shredder never runs the
plain version.  A failed parity call raises `ShredError` after the
crossing returns; a failed build raises HostBuildError.

Two surfaces:

  - `NativeShredder`: a drop-in for Shredder — same
    `entry_batch_to_fec_sets` signature and FecSet results;
  - `StageClient`: the sweep-harness client (runtime/stage.py fdr_sweep)
    — owns the C-side entry accumulator and publish path, so a whole shred
    stage sweep runs with zero Python per frag.

The signer's expanded key (clamped scalar, prefix, compressed pubkey)
comes from ed25519_ref's key cache; the raw secret never crosses the FFI.
`StageClient.set_metrics` arms the shm metrics plane
(runtime/native_metrics.NativePlane): the shred and publish brackets
inside the crossing land in the plane fdr_sweep is handed.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import gf256 as g2
from ..ops.ref import ed25519_ref as ref
from ..utils import hostbuild, kbuild
from ..utils.platform import resolve_device
from .shredder import EntryBatchMeta, FecSet, count_fec_sets

_MIN_SZ = 1203
_MAX_SZ = 1228
_MAX_D = 67
_MAX_ELT = 1139  # the largest RS row: a depth-0 set's code_payload_sz
ERR_PARITY = -2  # fds_shred_batch: a parity call failed (-1: capacity)

# int encode(void* user, const u8* gen, const u8* data, u64 d, u64 p,
#            u64 sz, u8* out)
ENCODE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                             ctypes.c_uint64, ctypes.c_void_p)

_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the sources each call


def load() -> ctypes.CDLL:
    """The library, built by utils/hostbuild.py on first use."""
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_shred")
        u64, vp, cp = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p
        lib.fds_ctx_new.argtypes = [ctypes.c_uint, cp, cp, cp, vp, vp]
        lib.fds_ctx_new.restype = vp
        lib.fds_ctx_delete.argtypes = [vp]
        lib.fds_shred_batch.argtypes = [
            vp, cp, u64, u64, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), vp, u64, ctypes.POINTER(u64), u64, vp]
        lib.fds_shred_batch.restype = ctypes.c_int64
        lib.fds_parity_error.argtypes = [vp]
        lib.fds_parity_error.restype = ctypes.c_int
        lib.fds_stage_new.argtypes = [vp, vp, vp, vp, vp, u64, ctypes.c_uint, ctypes.c_uint,
                                      u64, u64]
        lib.fds_stage_new.restype = vp
        lib.fds_stage_delete.argtypes = [vp]
        lib.fds_stage_flags_off.argtypes = []
        lib.fds_stage_flags_off.restype = u64
        lib.fds_stage_set_slot.argtypes = [vp, u64]
        lib.fds_stage_append.argtypes = [vp, cp, u64, u64]
        lib.fds_stage_flush.argtypes = [vp, ctypes.c_int]
        lib.fds_stage_flush.restype = ctypes.c_int
        lib.fds_stage_set_metrics.argtypes = [vp, vp]
        _LIB = lib
    return _LIB


class ShredError(RuntimeError):
    pass


class _HostUser(ctypes.Structure):
    """fd_gf256_host_user (csrc/gf256_apply.cu)."""

    _fields_ = [("device", ctypes.c_int64), ("stream", ctypes.c_void_p),
                ("gen", ctypes.c_void_p), ("data", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("launches", ctypes.c_uint64)]


class _CardParity:
    """K5's host entry as the parity call, with its device scratch (torch
    tensors, alive as long as this object) and the device's current stream
    at construction."""

    def __init__(self, dev: torch.device):
        self._kernel = kbuild.load("gf256_apply")
        self.fn = ctypes.cast(self._kernel.fd_gf256_encode_host, ctypes.c_void_p)
        self._scratch = [torch.empty(n, dtype=torch.uint8, device=dev)
                         for n in (_MAX_D * _MAX_D, _MAX_D * _MAX_ELT, _MAX_D * _MAX_ELT)]
        gen, data, out = (t.data_ptr() for t in self._scratch)
        self._user = _HostUser(device=dev.index or 0,
                               stream=torch.cuda.current_stream(dev).cuda_stream,
                               gen=gen, data=data, out=out, launches=0)
        self.user = ctypes.addressof(self._user)
        self._folded = 0
        self.exc = None  # the CPU lane's; the card's errors are codes

    @property
    def launches(self) -> int:
        """K5 launches the host entry has started for this context."""
        return self._user.launches

    def fold(self) -> None:
        """Add the entry's launches since the last fold to kbuild.LAUNCHES."""
        n = self._user.launches
        if n != self._folded:
            kbuild.LAUNCHES["gf256_apply"] += n - self._folded
            self._folded = n

    def describe(self, code: int) -> str:
        msg = self._kernel.fd_cuda_error_string(code).decode()
        return f"K5 host entry: CUDA error {code} ({msg})"


class _CpuParity:
    """The plain version as the parity call: a ctypes trampoline into
    gf_apply_batch on CPU tensors (the tests' lane).  An exception inside
    the call returns -1 to C and is chained to the ShredError raised
    after the crossing."""

    def __init__(self):
        self._cb = ENCODE_FN(self._encode)
        self.fn = ctypes.cast(self._cb, ctypes.c_void_p)
        self.user = None
        self.exc: BaseException | None = None
        self.launches = 0  # the plain version launches nothing

    def _encode(self, user, gen, data, d, p, sz, out) -> int:
        try:
            mat = np.ctypeslib.as_array((ctypes.c_uint8 * (p * d)).from_address(gen))
            rows = np.ctypeslib.as_array((ctypes.c_uint8 * (d * sz)).from_address(data))
            par = g2.gf_apply_batch(torch.from_numpy(mat.reshape(1, p, d).copy()),
                                    torch.from_numpy(rows.reshape(1, d, sz).copy()))
            ctypes.memmove(out, par.numpy().tobytes(), p * sz)
            return 0
        except BaseException as e:  # nothing may cross the C frame: re-raised after it
            self.exc = e
            return -1

    def fold(self) -> None:
        pass  # the plain version counts no launch

    def describe(self, code: int) -> str:
        return f"plain parity call returned {code}"


class _Ctx:
    """One signer's native shredder context (comb key, generator cache and
    the parity call of `device`)."""

    def __init__(self, secret: bytes, shred_version: int, device):
        dev = resolve_device(device)
        self.device = dev
        self.parity = _CardParity(dev) if dev.type == "cuda" else _CpuParity()
        lib = load()
        a, prefix, apk = ref._expanded(secret)
        self._lib = lib
        self._h = lib.fds_ctx_new(shred_version, a.to_bytes(32, "little"), prefix, apk,
                                  self.parity.fn, self.parity.user)
        if not self._h:
            raise ShredError("fds_ctx_new failed")

    def raise_parity(self, code: int) -> None:
        exc, self.parity.exc = self.parity.exc, None
        if exc is not None and not isinstance(exc, Exception):
            raise exc  # an interrupt or exit inside the parity call
        raise ShredError(f"native shredder: parity call failed"
                         f" ({self.parity.describe(code)})") from exc

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.fds_ctx_delete(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeShredder:
    """Drop-in for runtime/shredder.Shredder: one FFI crossing shreds a
    whole entry batch into wire-complete signed FEC sets, parity on
    `device` (default the card; "cpu" runs the plain version).  Construct
    with the SECRET (not a signer callable): the comb signing path needs
    the expanded key on the C++ side."""

    def __init__(self, *, secret: bytes, shred_version: int = 0, device=None):
        self._ctx = _Ctx(secret, shred_version, device)
        self.device = self._ctx.device
        self.shred_version = shred_version
        self.slot = -1
        self.data_idx_offset = 0
        self.parity_idx_offset = 0
        self._idx = (ctypes.c_int64 * 2)()
        # reusable out arena + per-set meta/roots, grown on demand
        self._cap = 1 << 20
        self._out = ctypes.create_string_buffer(self._cap)
        self._meta = np.zeros((256, 4), dtype=np.uint64)
        self._roots = ctypes.create_string_buffer(32 * 256)

    def entry_batch_to_fec_sets(self, entry_batch: bytes, *, slot: int,
                                meta: EntryBatchMeta | None = None) -> list[FecSet]:
        if not entry_batch:
            raise ValueError("empty entry batch")
        meta = meta or EntryBatchMeta()
        if slot != self.slot:
            self.data_idx_offset = 0
            self.parity_idx_offset = 0
            self.slot = slot
        n_sets = count_fec_sets(len(entry_batch)) + 1
        need = n_sets * _MAX_D * (_MIN_SZ + _MAX_SZ)
        if need > self._cap:
            self._cap = need
            self._out = ctypes.create_string_buffer(self._cap)
        if n_sets > self._meta.shape[0]:
            # no batch-size ceiling: the Python lane shreds any batch, so
            # the meta/roots tables grow with the plan bound
            self._meta = np.zeros((n_sets, 4), dtype=np.uint64)
            self._roots = ctypes.create_string_buffer(32 * n_sets)
        self._idx[0] = self.data_idx_offset
        self._idx[1] = self.parity_idx_offset
        ctx = self._ctx
        n = ctx._lib.fds_shred_batch(
            ctx._h, entry_batch, len(entry_batch), slot, meta.parent_offset,
            meta.reference_tick, 1 if meta.block_complete else 0, self._idx,
            ctypes.cast(self._out, ctypes.c_void_p), self._cap,
            self._meta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), self._meta.shape[0],
            ctypes.cast(self._roots, ctypes.c_void_p))
        ctx.parity.fold()
        if n == ERR_PARITY:
            ctx.raise_parity(ctx._lib.fds_parity_error(ctx._h))
        if n < 0:
            raise ShredError("fds_shred_batch failed (capacity)")
        self.data_idx_offset = int(self._idx[0])
        self.parity_idx_offset = int(self._idx[1])
        if n:
            # copy only the produced bytes (.raw would copy the whole arena)
            d_l, p_l, _, off_l = (int(x) for x in self._meta[n - 1])
            raw = ctypes.string_at(self._out, off_l + d_l * _MIN_SZ + p_l * _MAX_SZ)
        else:
            raw = b""
        roots = ctypes.string_at(self._roots, 32 * n)
        sets: list[FecSet] = []
        for s in range(n):
            d, p, fec_idx, off = (int(x) for x in self._meta[s])
            cbase = off + d * _MIN_SZ
            sets.append(FecSet(
                data_shreds=[raw[off + i * _MIN_SZ: off + (i + 1) * _MIN_SZ] for i in range(d)],
                parity_shreds=[raw[cbase + j * _MAX_SZ: cbase + (j + 1) * _MAX_SZ]
                               for j in range(p)],
                merkle_root=roots[32 * s: 32 * s + 32],
                slot=slot,
                fec_set_idx=fec_idx,
            ))
        return sets

    @property
    def launches(self) -> int:
        """K5 launches this shredder's parity call started (0 on the CPU)."""
        return self._ctx.parity.launches

    def close(self) -> None:
        self._ctx.close()


# ShredStageCtx's tail after pending_flush, in declaration order (the
# flag's byte offset comes from the C side, fds_stage_flags_off, so the
# view cannot drift from the struct layout); `fault` last
COUNTERS = ("entries_in", "entry_batches", "fec_sets", "data_shreds_out",
            "parity_shreds_out", "frags_out", "backpressure", "batches_dropped")


class StageClient:
    """The shred stage's sweep-harness client: a C-side entry accumulator,
    batch close, shred and publish path over `shredder`'s context and the
    stage's native out producer.  Exposes the fdr_sweep callback (`cb`,
    `cb_ctx`) and cheap struct reads of the deferred-flush flag, the
    counters and the fault word."""

    def __init__(self, shredder: NativeShredder, out_producer, *, slot: int,
                 parent_off: int = 1, ref_tick: int = 0, batch_target: int = 16384,
                 min_credits: int = 256):
        from ..tango import native as tn

        lib = load()
        ring = tn.load()
        vp = ctypes.c_void_p
        self._lib = lib
        self._ctx = shredder._ctx
        self._prod = out_producer  # the C ctx points into its structs
        self._plane = None  # set_metrics's plane, likewise
        self._h = lib.fds_stage_new(
            self._ctx._h, ctypes.cast(out_producer._lsp, vp), ctypes.cast(out_producer._pp, vp),
            ctypes.cast(ring.fdr_try_publish, vp), ctypes.cast(ring.fdr_refresh_credits, vp),
            slot, parent_off, ref_tick, batch_target, min_credits)
        if not self._h:
            raise ShredError("fds_stage_new failed")
        self.cb = ctypes.cast(lib.fds_frag_cb, vp)
        self.cb_ctx = vp(self._h)
        n_tail = 2 + len(COUNTERS)
        self._tail = np.frombuffer(
            (ctypes.c_uint64 * n_tail).from_address(self._h + int(lib.fds_stage_flags_off())),
            dtype=np.uint64)

    @property
    def pending_flush(self) -> bool:
        return bool(self._tail[0])

    def counters(self) -> dict[str, int]:
        return {name: int(self._tail[1 + i]) for i, name in enumerate(COUNTERS)}

    def settle(self) -> None:
        """After every crossing: fold K5's launches into kbuild.LAUNCHES and
        raise if a parity call failed."""
        self._ctx.parity.fold()
        fault = int(self._tail[1 + len(COUNTERS)])
        if fault:
            self._tail[1 + len(COUNTERS)] = 0
            self._ctx.raise_parity(fault)

    def append(self, payload: bytes, tsorig: int) -> None:
        """Per-frag fallback (the fused stage, a mixed-lane splice): forward
        into the SAME C-side buffer the sweep callback fills."""
        self._lib.fds_stage_append(self._h, payload, len(payload), tsorig)
        self.settle()

    def flush(self, *, block_complete: bool) -> bool:
        done = bool(self._lib.fds_stage_flush(self._h, 1 if block_complete else 0))
        self.settle()
        return done

    def retry_flush(self) -> bool:
        """Retry a credit-deferred flush with its ORIGINAL block_complete
        flag (the C side recorded it)."""
        done = bool(self._lib.fds_stage_flush(self._h, -1))
        self.settle()
        return done

    def set_slot(self, slot: int) -> None:
        self._lib.fds_stage_set_slot(self._h, slot)

    def set_metrics(self, plane) -> None:
        """Arm (or disarm: None) the shm metrics plane: the shred and
        publish brackets inside the crossing accumulate into the plane
        fdr_sweep is handed.  The plane is kept alive while the C side
        holds its pointer."""
        self._plane = plane
        self._lib.fds_stage_set_metrics(self._h, plane.ptr if plane is not None else None)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._tail = None
            self._lib.fds_stage_delete(self._h)
            self._h = None
            self._prod = self._plane = None

    def __del__(self):
        self.close()
