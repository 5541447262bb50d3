"""ctypes binding for the native net client, native/fd_net.cpp (the port's
counterpart of firedancer_tpu/runtime/net_native.py).

Two surfaces over one library, built by utils/hostbuild.py on first use (a
failed build raises HostBuildError; nothing falls back to another lane):

  - `NetClient`: one ingress stage's native state.  The QUIC short-header
    steady state in one FFI crossing a datagram (DCID -> connection lookup,
    header-protection unmask, AES-128-GCM open, packet-number dedup, the
    STREAM frame walk and fd_tpu_reasm-style reassembly), and the plain-UDP
    sweep (`udp_sweep`: one recvmmsg crossing a burst, straight into the out
    arena).  Whole txns land in the out arena with an (off, sz, sig,
    tsorig) table shaped for fdr_publish_burst; the credit-gated publish
    retires only the published prefix (`out_pop`), the unpublished tail
    stays queued in C, never dropped.  Everything the C side cannot own
    PUNTs back to the Python connection (waltz/quic.py) in arrival order;
    consumed packets surface as events (pn sync, single-range acks,
    flow-window deltas) the stage replays into the Python connection after
    every crossing.
  - `aes_ecb_blocks`, `gcm_seal`, `gcm_open`: ops/aes.py's default route.

The AES-NI/PCLMUL choice is the C side's CPUID probe (`simd_features`).
The scalar AES/GHASH path (`simd_force(False)`) and the per-datagram
`NetClient.udp_sweep_scalar` are reachable only by those explicit calls:
the tests hold them byte-equal to the SIMD path and the recvmmsg sweep, and
nothing on the main path calls them.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import hostbuild

# fdn_datagram return codes (fd_net.cpp enum)
RC_CONSUMED = 0
RC_PUNT = 1
RC_DROP = 2

# event rows (type, conn_idx, a, b)
EV_PKT = 1   # a = pn, b = flag (0 ack-eliciting, 1 dup, 2 bad-frame, 3 pure-ack)
EV_ACK = 2   # a = largest, b = first_range_len
EV_WIN = 3   # a = rx_consumed delta, b = rx_data_total delta

_EV_CAP = 4096
_OUT_CAP = 1024
_ARENA_SZ = _OUT_CAP * (1232 + 48)

_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the sources each call


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_net")
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64, i64, i32, u32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32
        vp, cp = ctypes.c_void_p, ctypes.c_char_p
        lib.fdn_new.argtypes = [i32, i32]
        lib.fdn_new.restype = vp
        lib.fdn_delete.argtypes = [vp]
        lib.fdn_conn_add.argtypes = [vp, cp, u32, cp, cp, cp, i64p, i32, u64, u64]
        lib.fdn_conn_add.restype = i32
        lib.fdn_conn_remove.argtypes = [vp, i32]
        lib.fdn_conn_set_addr.argtypes = [vp, i32, u32]
        lib.fdn_conn_window.argtypes = [vp, i32, u64, u64]
        lib.fdn_conn_pn_add.argtypes = [vp, i32, i64]
        lib.fdn_conn_stream_is_done.argtypes = [vp, i32, u64]
        lib.fdn_conn_stream_is_done.restype = i32
        lib.fdn_conn_stream_done.argtypes = [vp, i32, u64]
        lib.fdn_datagram.argtypes = [vp, cp, i32, u32]
        lib.fdn_datagram.restype = i32
        lib.fdn_udp_sweep.argtypes = [vp, i32, i32]
        lib.fdn_udp_sweep.restype = i32
        lib.fdn_udp_sweep_scalar.argtypes = [vp, i32, i32]
        lib.fdn_udp_sweep_scalar.restype = i32
        lib.fdn_set_metrics.argtypes = [vp, vp]
        for name in ("fdn_counters_ptr", "fdn_events_ptr", "fdn_out_tbl_ptr",
                     "fdn_out_arena_ptr"):
            getattr(lib, name).argtypes = [vp]
            getattr(lib, name).restype = vp
        for name in ("fdn_counters_len", "fdn_events_count", "fdn_out_count"):
            getattr(lib, name).argtypes = [vp]
            getattr(lib, name).restype = i32
        lib.fdn_events_clear.argtypes = [vp]
        lib.fdn_out_pop.argtypes = [vp, i32]
        lib.fdn_aes_ecb.argtypes = [cp, i32, cp, i32, cp]
        lib.fdn_aes_ecb.restype = i32
        lib.fdn_gcm_seal.argtypes = [cp, i32, cp, cp, i32, cp, i32, cp, cp]
        lib.fdn_gcm_seal.restype = i32
        lib.fdn_gcm_open.argtypes = [cp, i32, cp, cp, i32, cp, i32, cp, cp]
        lib.fdn_gcm_open.restype = i32
        lib.fdn_simd_features.argtypes = []
        lib.fdn_simd_features.restype = i32
        lib.fdn_simd_force.argtypes = [i32]
        lib.fdn_simd_force.restype = None
        _LIB = lib
    return _LIB


# counter tail, in fd_net.cpp declaration order
_COUNTERS = ("rx_dgram", "consumed", "punt", "dup", "bad_packet", "txn",
             "oversz", "evicted", "flow_violation", "auth_fail",
             "udp_pkts", "aesni", "pclmul", "tail_retained")
COUNTER_IDX = {name: i for i, name in enumerate(_COUNTERS)}


class NetClient:
    """One ingress stage's native state: the interned connection table,
    the per-datagram fast path, the UDP sweep, and the zero-FFI
    event/out/counter views the stage drains after every crossing."""

    def __init__(self, *, max_conns: int, reasm_depth: int):
        lib = _load()
        self._lib = lib
        self._plane = None  # set_metrics's plane: C holds its raw pointer
        self._h = lib.fdn_new(max_conns, reasm_depth)
        if not self._h:
            raise MemoryError("fdn_new failed")

        def view(ptr, n, dt):
            ct = (ctypes.c_uint64 * n) if dt == np.uint64 else (ctypes.c_uint8 * n)
            return np.frombuffer(ct.from_address(ptr), dtype=dt)

        ncnt = int(lib.fdn_counters_len(self._h))
        self.counters_view = view(int(lib.fdn_counters_ptr(self._h)), ncnt, np.uint64)
        self.events = view(int(lib.fdn_events_ptr(self._h)),
                           _EV_CAP * 4, np.uint64).reshape(_EV_CAP, 4)
        self.out_tbl = view(int(lib.fdn_out_tbl_ptr(self._h)),
                            _OUT_CAP * 4, np.uint64).reshape(_OUT_CAP, 4)
        self.arena = view(int(lib.fdn_out_arena_ptr(self._h)), _ARENA_SZ, np.uint8)

    # -- connection table -----------------------------------------------------

    def conn_add(self, dcid: bytes, addr_id: int, key: bytes, iv: bytes,
                 hp: bytes, ranges: list[tuple[int, int]],
                 rx_max_data: int, rx_data_total: int) -> int:
        """Install an ESTABLISHED connection's rx side; `ranges` seed the pn
        dedup window from the Python tracker.  -1 = table full (the
        connection stays on the Python lane)."""
        flat = (ctypes.c_int64 * (2 * len(ranges)))()
        for i, (lo, hi) in enumerate(ranges):
            flat[2 * i] = lo
            flat[2 * i + 1] = hi
        return int(self._lib.fdn_conn_add(
            self._h, bytes(dcid), addr_id, bytes(key), bytes(iv), bytes(hp), flat,
            len(ranges), rx_max_data, rx_data_total))

    def conn_remove(self, idx: int) -> None:
        self._lib.fdn_conn_remove(self._h, idx)

    def conn_set_addr(self, idx: int, addr_id: int) -> None:
        self._lib.fdn_conn_set_addr(self._h, idx, addr_id)

    def conn_window(self, idx: int, rx_max_data: int, rx_data_total: int) -> None:
        self._lib.fdn_conn_window(self._h, idx, rx_max_data, rx_data_total)

    def conn_pn_add(self, idx: int, pn: int) -> None:
        self._lib.fdn_conn_pn_add(self._h, idx, pn)

    def conn_stream_is_done(self, idx: int, sid: int) -> bool:
        return bool(self._lib.fdn_conn_stream_is_done(self._h, idx, sid))

    def conn_stream_done(self, idx: int, sid: int) -> None:
        self._lib.fdn_conn_stream_done(self._h, idx, sid)

    # -- the hot path -----------------------------------------------------------

    def datagram(self, data: bytes, addr_id: int) -> int:
        """One datagram through the C fast path: RC_CONSUMED, RC_PUNT (run
        the Python connection on these bytes) or RC_DROP."""
        return int(self._lib.fdn_datagram(self._h, data, len(data), addr_id))

    def set_metrics(self, plane) -> None:
        """Arm the shm metrics plane (runtime/native_metrics.NativePlane):
        a socket sweep observes the drain phase, a datagram its decrypt and
        apply as the callback phase, from C.  None disarms."""
        self._plane = plane
        self._lib.fdn_set_metrics(self._h, plane.ptr if plane is not None else None)

    def udp_sweep(self, fd: int, max_pkts: int) -> int:
        """One recvmmsg syscall a burst, the kernel scattering each datagram
        straight into its out-arena slot; datagrams taken."""
        return int(self._lib.fdn_udp_sweep(self._h, fd, max_pkts))

    def udp_sweep_scalar(self, fd: int, max_pkts: int) -> int:
        """One recv a datagram through a bounce buffer: the same rows and
        counters as udp_sweep, reached only by this explicit call."""
        return int(self._lib.fdn_udp_sweep_scalar(self._h, fd, max_pkts))

    # -- drain surface ------------------------------------------------------------

    def event_count(self) -> int:
        return int(self._lib.fdn_events_count(self._h))

    def events_clear(self) -> None:
        self._lib.fdn_events_clear(self._h)

    def out_count(self) -> int:
        return int(self._lib.fdn_out_count(self._h))

    def out_pop(self, n: int) -> None:
        self._lib.fdn_out_pop(self._h, n)

    def out_txn(self, row: int) -> bytes:
        off = int(self.out_tbl[row, 0])
        sz = int(self.out_tbl[row, 1])
        return bytes(self.arena[off:off + sz])

    def counters(self) -> dict[str, int]:
        return {name: int(self.counters_view[i]) for i, name in enumerate(_COUNTERS)}

    def close(self) -> None:
        if self._h:
            self.counters_view = self.events = self.out_tbl = self.arena = None
            self._lib.fdn_delete(self._h)
            self._h = None
            self._plane = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


# -- the AES-GCM surface (ops/aes.py's default route) ----------------------------


def aes_ecb_blocks(key: bytes, data: bytes) -> bytes:
    """AES-ECB over len(data) // 16 blocks (callers validate lengths)."""
    lib = _load()
    n = len(data) // 16
    out = ctypes.create_string_buffer(16 * n)
    if lib.fdn_aes_ecb(key, len(key), data, n, out) != 0:
        raise ValueError("AES-128 or AES-256 keys only")
    return out.raw


def gcm_seal(key: bytes, iv: bytes, plaintext: bytes, aad: bytes) -> tuple[bytes, bytes]:
    lib = _load()
    ct = ctypes.create_string_buffer(max(len(plaintext), 1))
    tag = ctypes.create_string_buffer(16)
    if lib.fdn_gcm_seal(key, len(key), iv, aad, len(aad), plaintext, len(plaintext),
                        ct, tag) != 0:
        raise ValueError("AES-128 or AES-256 keys only")
    return ct.raw[:len(plaintext)], tag.raw[:16]


def gcm_open(key: bytes, iv: bytes, ciphertext: bytes, tag: bytes,
             aad: bytes) -> bytes | None:
    lib = _load()
    pt = ctypes.create_string_buffer(max(len(ciphertext), 1))
    rc = lib.fdn_gcm_open(key, len(key), iv, aad, len(aad), ciphertext, len(ciphertext),
                          tag, pt)
    if rc == -2:
        raise ValueError("AES-128 or AES-256 keys only")
    if rc != 0:
        return None
    return pt.raw[:len(ciphertext)]


def simd_features() -> int:
    """bit0 = AES-NI, bit1 = PCLMUL: the paths the C side takes now."""
    return int(_load().fdn_simd_features())


def simd_force(on: bool) -> None:
    """False pins the scalar AES/GHASH path for every later call in the
    process; True returns to the CPUID probe's choice."""
    _load().fdn_simd_force(1 if on else 0)
