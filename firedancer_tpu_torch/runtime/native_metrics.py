"""The native metrics plane binding (the port's counterpart of
firedancer_tpu/runtime/native_metrics.py).

Builds the `fdm_plane` handle the native sweep clients write the shm
metrics plane through: Python computes every layout fact (histogram word
offsets, bucket-edge tables, counter words, the flight ring's base) from
the stage's MetricsRegistry and FlightRecorder (utils/metrics.py is the
one source of the segment format) and hands them to C in one struct.
The C side (native/fd_metrics.h, carried by every client library) only
writes THROUGH the offsets it was given: relaxed-atomic counter bumps,
histogram observes equal to MetricsRegistry.observe's, and in-line flight
records.

A stage with a native sweep client always has a plane (runtime/stage.py
`Stage._native_plane`): there is no switch.  The attach check and the
test drivers are exports of native/fd_ring.cpp (tango/native.py's
library); an ABI mismatch or a segment whose layout disagrees raises
`PlaneError`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import metrics as fm

# constants mirrored from native/fd_metrics.h
FDM_ABI_VERSION = 1
FDM_SEG_MAGIC = 0xFD7B0F17
FDM_SEG_HDR_WORDS = 4
FDM_REC_WORDS = 3
FDM_SUM_SCALE = 1024
FDM_FLIGHT_DECIMATE = 64
FDM_NPH = 4
FDM_F_CTR = 1
FDM_F_PH = 2
FDM_F_FLIGHT = 4
FDM_F_LAT = 8
FDM_F_XLAT = 16

_PU64 = ctypes.POINTER(ctypes.c_uint64)
_PF64 = ctypes.POINTER(ctypes.c_double)


class _Hist(ctypes.Structure):
    _fields_ = [
        ("off", ctypes.c_uint64),
        ("n", ctypes.c_uint64),
        ("edges", _PF64),
    ]


class _Plane(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_uint64),
        ("met", _PU64),
        ("rec", _PU64),
        ("rec_cap", ctypes.c_uint64),
        ("flags", ctypes.c_uint64),
        ("c_frags_off", ctypes.c_uint64),
        ("c_crossings_off", ctypes.c_uint64),
        ("ph", _Hist * FDM_NPH),
        ("lat", _Hist),
        ("xlat", _Hist),
        ("ph_accum", ctypes.c_uint64 * FDM_NPH),
        ("crossings", ctypes.c_uint64),
    ]


class PlaneError(RuntimeError):
    pass


_LIB: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """tango/native.py's fd_ring library with the fdm_* surface declared."""
    global _LIB
    if _LIB is None:
        from ..tango import native as tn

        lib = tn.load()
        u64, PP, PH = ctypes.c_uint64, ctypes.POINTER(_Plane), ctypes.POINTER(_Hist)
        lib.fdm_abi_version.argtypes = []
        lib.fdm_abi_version.restype = u64
        lib.fdm_plane_attach.argtypes = [PP, _PU64, u64]
        lib.fdm_plane_attach.restype = ctypes.c_int
        lib.fdm_test_ctr.argtypes = [PP, u64, u64]
        lib.fdm_test_hist.argtypes = [PP, PH, _PF64, u64]
        lib.fdm_test_flight.argtypes = [PP, u64, u64]
        lib.fdm_test_sweep_end.argtypes = [PP, u64, u64, u64, u64, u64]
        got = int(lib.fdm_abi_version())
        if got != FDM_ABI_VERSION:
            raise PlaneError(f"fd_metrics ABI {got} != {FDM_ABI_VERSION}")
        _LIB = lib
    return _LIB


class NativePlane:
    """One stage's fdm_plane, built from its registry (and flight recorder)
    and handed to SweepDrainer and the sweep clients as `.ptr`.

    C holds raw pointers into the registry's words, the recorder's words
    and the bucket-edge arrays: this object keeps them alive, and the
    drainer and clients keep this object alive.  `xlat` names a stage-extra
    native histogram bound to the plane's extra slot (the bank's
    nbank_txn_lat_ns)."""

    def __init__(self, registry: fm.MetricsRegistry,
                 recorder: fm.FlightRecorder | None = None, *, xlat: str | None = None):
        lib = load()
        self.registry = registry
        self.recorder = recorder
        self._edges: list[np.ndarray] = []
        p = _Plane()
        p.version = FDM_ABI_VERSION
        p.met = ctypes.cast(int(registry.words.ctypes.data), _PU64)
        flags = 0
        off = registry._off
        if "nsweep_frags" in off and "nsweep_crossings" in off:
            p.c_frags_off = off["nsweep_frags"][1]
            p.c_crossings_off = off["nsweep_crossings"][1]
            flags |= FDM_F_CTR
        if all([self._bind_hist(p.ph[i], f"nsweep_{ph}_ns")
                for i, ph in enumerate(fm.NSWEEP_PHASES)]):
            flags |= FDM_F_PH
        if self._bind_hist(p.lat, "nsweep_lat_ns"):
            flags |= FDM_F_LAT
        if xlat and self._bind_hist(p.xlat, xlat):
            flags |= FDM_F_XLAT
        if recorder is not None:
            p.rec = ctypes.cast(int(recorder.words.ctypes.data), _PU64)
            p.rec_cap = recorder.capacity
            flags |= FDM_F_FLIGHT
        p.flags = flags
        self._p = p
        self.flags = flags
        self.ptr = ctypes.cast(ctypes.pointer(p), ctypes.c_void_p)  # made once
        self._lib = lib
        # a segment-backed registry carries the whole segment: C checks the
        # header and the bases against what was just computed
        seg = getattr(registry, "_seg", None)
        if seg is not None:
            rc = int(lib.fdm_plane_attach(ctypes.byref(p),
                                          ctypes.cast(int(seg.ctypes.data), _PU64), len(seg)))
            if rc != 0:
                raise PlaneError(f"fdm_plane_attach failed ({rc}): the segment's layout"
                                 " disagrees with the plane's")

    def _bind_hist(self, slot: _Hist, name: str) -> bool:
        got = self.registry._off.get(name)
        if got is None or got[0].kind != fm.HISTOGRAM:
            return False
        d, off = got
        edges = self.registry._edges[name]  # float64, made at layout
        self._edges.append(edges)
        slot.off = off
        slot.n = len(d.buckets)
        slot.edges = ctypes.cast(int(edges.ctypes.data), _PF64)
        return True

    # -- test drivers (the C writers, held against utils/metrics.py) -----------

    def test_ctr(self, name: str, v: int) -> None:
        self._lib.fdm_test_ctr(ctypes.byref(self._p), self.registry._off[name][1], v)

    def test_hist(self, name: str, values) -> None:
        vals = np.ascontiguousarray(values, dtype=np.float64)
        slot = _Hist()
        if not self._bind_hist(slot, name):
            raise KeyError(name)
        self._lib.fdm_test_hist(ctypes.byref(self._p), ctypes.byref(slot),
                                ctypes.cast(int(vals.ctypes.data), _PF64), len(vals))

    def test_flight(self, event: int, arg: int) -> None:
        self._lib.fdm_test_flight(ctypes.byref(self._p), event, arg)

    def test_sweep_end(self, got: int, drain_ns: int, cb_ns: int, apply_ns: int = 0,
                       pub_ns: int = 0) -> None:
        self._lib.fdm_test_sweep_end(ctypes.byref(self._p), got, drain_ns, cb_ns, apply_ns,
                                     pub_ns)
