"""ctypes binding for the native ring lane, native/fd_ring.cpp (the port's
counterpart of firedancer_tpu/tango/native.py).

native/fd_ring.cpp speaks the whole link protocol of tango/shm.py over the
same shared-memory bytes (credit-gated publish over the reliable fseqs,
lazy progress publication, overrun resync and counting, tsorig pass-through
and tspub stamping), so a native producer feeds a Python consumer and the
other way round.  The layout offsets are computed once, in Python
(shm._layout), and handed to C++ in the link struct.

  - `NativeProducer` / `NativeConsumer` have the Python endpoints' surface
    (try_publish, poll, has_pending, publish_progress, cr_avail,
    refresh_credits), one call per operation;
  - `BurstDrainer` drains all of a stage's native inputs in ONE fdr_drain
    call into an arena with a meta table, and
    `NativeProducer.publish_burst` publishes a frame list in one
    fdr_publish_burst call: runtime/stage.py's burst path
    (`publish_burst_raw`: frames already in native memory, the verify
    sweep client's);
  - `SweepDrainer` is fdr_sweep: the drain plus a stage's C callback per
    frag in the same call (the bank, shred and verify stages' clients:
    runtime/bank_native.py, shred_native.py, verify_native.py);
  - `NativeRelayClient` is the chaos harness's relay as a sweep client
    (fdr_relay_*), the one client that honours the in-place restart's
    publish guard.

Every endpoint pins the link's buffer through a ctypes view, so it
registers with its ShmLink, whose close() detaches it first.  The library
is built by utils/hostbuild.py on first use; a failed build raises
HostBuildError.
"""

from __future__ import annotations

import array
import ctypes

import numpy as np

from ..utils import hostbuild
from . import shm

_MASK64 = (1 << 64) - 1
_SEQ = (1 << 63) - 1  # a seq word without the BUSY bit
FDR_MAX_REL = 16  # the C++ side's reliable fseqs per producer
DRAIN_NCOL = 8  # 7 mcache-compatible columns (chunk -> arena offset) + in_idx


class _Link(ctypes.Structure):
    _fields_ = [
        ("base", ctypes.c_void_p),
        ("depth", ctypes.c_uint64),
        ("mtu", ctypes.c_uint64),
        ("mcache_off", ctypes.c_uint64),
        ("dcache_off", ctypes.c_uint64),
        ("dcache_sz", ctypes.c_uint64),
        ("fseq_off", ctypes.c_uint64),
        ("n_fseq", ctypes.c_uint64),
    ]


class _Producer(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.c_uint64),
        ("chunk", ctypes.c_uint64),
        ("wmark", ctypes.c_uint64),
        ("cr_avail", ctypes.c_uint64),
        ("cr_max", ctypes.c_uint64),
        ("n_rel", ctypes.c_uint64),
        ("rel_idx", ctypes.c_uint64 * FDR_MAX_REL),
    ]


class _Consumer(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.c_uint64),
        ("ovrn_cnt", ctypes.c_uint64),
        ("fseq_idx", ctypes.c_uint64),
        ("lazy", ctypes.c_uint64),
        ("since_publish", ctypes.c_uint64),
    ]


_LIB: ctypes.CDLL | None = None  # bound once: hostbuild.load hashes the sources each call


def load() -> ctypes.CDLL:
    """The library, built by utils/hostbuild.py on first use."""
    global _LIB
    if _LIB is None:
        lib = hostbuild.load("fd_ring")
        PL, PP, PC = (ctypes.POINTER(t) for t in (_Link, _Producer, _Consumer))
        u64, vp, cp = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p
        lib.fdr_producer_init.argtypes = [PL, PP]
        lib.fdr_refresh_credits.argtypes = [PL, PP]
        lib.fdr_refresh_credits.restype = u64
        lib.fdr_try_publish.argtypes = [PL, PP, cp, u64, u64, u64]
        lib.fdr_try_publish.restype = ctypes.c_int
        lib.fdr_publish_burst.argtypes = [PL, PP, cp, vp, u64]
        lib.fdr_publish_burst.restype = u64
        lib.fdr_publish_progress.argtypes = [PL, PC]
        lib.fdr_poll.argtypes = [PL, PC, cp, ctypes.POINTER(u64)]
        lib.fdr_poll.restype = ctypes.c_int
        drain = [ctypes.POINTER(PL), ctypes.POINTER(PC), u64, ctypes.POINTER(u64), u64, vp,
                 u64, vp, ctypes.POINTER(u64)]
        lib.fdr_drain.argtypes = drain
        lib.fdr_drain.restype = ctypes.c_int64
        lib.fdr_sweep.argtypes = drain + [vp, vp, vp]
        lib.fdr_sweep.restype = ctypes.c_int64
        # the relay sweep client (the chaos harness's)
        lib.fdr_relay_new.argtypes = [PL, u64, u64]
        lib.fdr_relay_new.restype = vp
        lib.fdr_relay_set_metrics.argtypes = [vp, vp]
        lib.fdr_relay_seq_sync.argtypes = [vp, u64, u64]
        lib.fdr_relay_guard.argtypes = [vp, vp, u64]
        lib.fdr_relay_counts.argtypes = [vp] + [ctypes.POINTER(u64)] * 3
        lib.fdr_relay_free.argtypes = [vp]
        _LIB = lib
    return _LIB


def _link_struct(link: shm.ShmLink) -> tuple[_Link, object]:
    """The C view of a link, and the buffer view that must outlive it."""
    a, b, c, _d, _e = shm._layout(link.depth, link.mtu, link.n_fseq, link.dcache_sz)
    buf = (ctypes.c_char * link._shm.size).from_buffer(link._shm.buf)
    ls = _Link(base=ctypes.addressof(buf), depth=link.depth, mtu=link.mtu, mcache_off=a,
               dcache_off=b, dcache_sz=link.dcache_sz, fseq_off=c, n_fseq=link.n_fseq)
    return ls, buf


def _detached() -> RuntimeError:
    return RuntimeError("detached native endpoint (link closed)")


class NativeProducer:
    """shm.Producer's surface on the native lane.  reliable_fseq_idx: None =
    every fseq of the link is a reliable consumer; [] = free-running."""

    def __init__(self, link: shm.ShmLink, reliable_fseq_idx: list[int] | None = None):
        idxs = reliable_fseq_idx if reliable_fseq_idx is not None else list(range(link.n_fseq))
        if len(idxs) > FDR_MAX_REL:
            raise ValueError(f"more than {FDR_MAX_REL} reliable fseqs")
        for i in idxs:
            if not 0 <= i < link.n_fseq:
                # link.fseqs[i] raises on the Python lane; unchecked here it
                # would read the words past the fseqs
                raise IndexError(f"reliable fseq idx {i} out of range (n_fseq={link.n_fseq})")
        self._lib = load()
        self._ls, self._keep = _link_struct(link)
        self._p = _Producer()
        self._lib.fdr_producer_init(ctypes.byref(self._ls), ctypes.byref(self._p))
        self._p.n_rel = len(idxs)
        for k, i in enumerate(idxs):
            self._p.rel_idx[k] = i
        self._lsp = ctypes.byref(self._ls)
        self._pp = ctypes.byref(self._p)
        self.link = link
        link.register(self)

    @property
    def seq(self) -> int:
        return self._p.seq

    @property
    def chunk(self) -> int:
        """The dcache cursor (64-byte granules) the next publish starts at."""
        return self._p.chunk

    @property
    def cr_avail(self) -> int:
        return self._p.cr_avail

    def refresh_credits(self) -> None:
        if self._lsp is None:
            raise _detached()
        self._lib.fdr_refresh_credits(self._lsp, self._pp)

    def try_publish(self, payload: bytes, sig: int = 0, tsorig: int = 0) -> bool:
        """shm.Producer.try_publish: False = backpressured."""
        if self._lsp is None:
            raise _detached()
        if len(payload) > self.link.mtu:
            raise ValueError("payload exceeds mtu")
        return bool(self._lib.fdr_try_publish(self._lsp, self._pp, payload, len(payload),
                                              sig & _MASK64, tsorig))

    def publish_burst(self, items) -> int:
        """Publish [(payload, sig, tsorig), ...] in ONE call, credit-gated
        frame by frame; returns the frames published (the tail past the
        credits stays with the caller).  The frame table is built for the
        creditable prefix only."""
        n = len(items)
        if not n:
            return 0
        if self._lsp is None:
            raise _detached()
        if self._p.cr_avail < n:
            self.refresh_credits()
        n = min(n, self._p.cr_avail)
        if not n:
            return 0
        mtu = self.link.mtu
        rows = []  # (offset into buf, sz, sig, tsorig) a frame
        off = 0
        for k in range(n):
            payload, sig, tsorig = items[k]
            sz = len(payload)
            if sz > mtu:
                raise ValueError("payload exceeds mtu")
            rows += (off, sz, sig & _MASK64, tsorig)
            off += sz
        tbl = array.array("Q", rows)
        buf = b"".join(items[k][0] for k in range(n))
        return int(self._lib.fdr_publish_burst(self._lsp, self._pp, buf, tbl.buffer_info()[0],
                                               n))

    def resume(self) -> set[int]:
        """shm.Producer.resume on this lane: the cursors recovered from the
        live ring (one Python pass over the mcache at restart) are set in
        the C producer struct, which every publish reads."""
        if self._lsp is None:
            raise _detached()
        frontier, next_chunk, sigs = self.link.mcache.recover()
        self._p.seq = frontier
        self._p.chunk = next_chunk
        self.refresh_credits()
        return sigs

    def publish_burst_raw(self, buf_ptr: int, tbl: np.ndarray) -> int:
        """fdr_publish_burst over frames that already lie in native memory
        (the verify sweep client's slot arenas): buf_ptr is the arena's
        base, tbl a contiguous (n, 4) u64 table of (offset, size, sig,
        tsorig) rows.  Credit-gated frame by frame; returns the frames
        published (the tail stays with the caller).  The frame assembler
        bounds every size by the link mtu (the verify stage arms only over
        an out link that carries its largest frame), and the C side trusts
        the rows."""
        n = len(tbl)
        if not n:
            return 0
        if self._lsp is None:
            raise _detached()
        return int(self._lib.fdr_publish_burst(self._lsp, self._pp,
                                               ctypes.cast(buf_ptr, ctypes.c_char_p),
                                               tbl.ctypes.data, n))

    def detach(self) -> None:
        """Drop the buffer pin (ShmLink.close); the producer is unusable after."""
        self._lsp = self._pp = None
        self._ls = self._p = self._keep = None
        self.link = None


class NativeConsumer:
    """shm.Consumer's surface on the native lane."""

    def __init__(self, link: shm.ShmLink, fseq_idx: int = 0, lazy: int = 64):
        if not 0 <= fseq_idx < link.n_fseq:
            raise IndexError(f"fseq idx {fseq_idx} out of range (n_fseq={link.n_fseq})")
        self._lib = load()
        self._ls, self._keep = _link_struct(link)
        self._c = _Consumer(fseq_idx=fseq_idx, lazy=lazy)
        self.lazy = lazy
        self._out = ctypes.create_string_buffer(link.mtu)
        self._meta = (ctypes.c_uint64 * 7)()
        self._meta_np = np.frombuffer(self._meta, dtype=np.uint64)
        # the mcache's seq words, for has_pending's probe without a call
        self._seqs = np.frombuffer(self._keep, dtype=np.uint64, count=link.depth * 7,
                                   offset=self._ls.mcache_off)[::7]
        self._mask = link.depth - 1
        self._lsp = ctypes.byref(self._ls)
        self._cp = ctypes.byref(self._c)
        self.link = link
        link.register(self)

    @property
    def seq(self) -> int:
        return self._c.seq

    @property
    def ovrn_cnt(self) -> int:
        return self._c.ovrn_cnt

    def poll(self):
        """(meta u64 row copy, payload) | POLL_EMPTY | POLL_OVERRUN, as
        shm.Consumer.poll."""
        if self._lsp is None:
            raise _detached()
        rc = self._lib.fdr_poll(self._lsp, self._cp, self._out, self._meta)
        if rc == -1:
            return shm.POLL_EMPTY
        if rc == 1:
            return shm.POLL_OVERRUN
        return self._meta_np.copy(), self._out.raw[: int(self._meta[3])]

    def has_pending(self) -> bool:
        """A frag (or an overrun) is ready at the cursor: fdr_has_pending's
        test, read here off the seq word (an idle stage probes its inputs
        every sweep, and a call costs more than the read)."""
        if self._lsp is None:
            raise _detached()
        s = self._c.seq
        w = int(self._seqs[s & self._mask])
        # published at our seq, or (busy or not) a later frag's: an overrun
        return w == s or w & _SEQ > s

    def publish_progress(self) -> None:
        if self._lsp is None:
            raise _detached()
        self._lib.fdr_publish_progress(self._lsp, self._cp)

    def set_lazy(self, lazy: int) -> None:
        """shm.Consumer.set_lazy on this lane: the C struct's field is the
        one fdr_poll, fdr_drain and fdr_sweep read."""
        self.lazy = lazy
        self._c.lazy = lazy

    def resume(self) -> int:
        """shm.Consumer.resume on this lane: the C cursor is set to the
        progress last published to this consumer's fseq."""
        if self._lsp is None:
            raise _detached()
        self._c.seq = self.link.fseqs[int(self._c.fseq_idx)].query()
        self._c.since_publish = 0
        return int(self._c.seq)

    def detach(self) -> None:
        self._lsp = self._cp = None
        self._ls = self._c = self._keep = self._seqs = None
        self.link = None


class BurstDrainer:
    """One fdr_drain call a sweep over a stage's native inputs: a reusable
    payload arena and an (max_frags, 8) u64 meta table (columns 0-6 as an
    mcache row with the chunk column holding the arena byte offset, column
    7 the input index)."""

    def __init__(self, consumers: list[NativeConsumer], max_frags: int):
        if not consumers:
            raise ValueError("a drainer needs at least one consumer")
        self._lib = load()
        self.consumers = list(consumers)
        n = len(self.consumers)
        self.max_frags = max_frags
        mtu = max(c.link.mtu for c in self.consumers)
        self.arena = np.zeros(max_frags * mtu, dtype=np.uint8)
        self.meta = np.zeros((max_frags, DRAIN_NCOL), dtype=np.uint64)
        self._links = (ctypes.POINTER(_Link) * n)(*[ctypes.pointer(c._ls) for c in self.consumers])
        self._cons = (ctypes.POINTER(_Consumer) * n)(*[ctypes.pointer(c._c) for c in self.consumers])
        self._n = n
        self._rr = ctypes.c_uint64(0)
        self._ovrn = ctypes.c_uint64(0)
        self._args = (self._links, self._cons, n, ctypes.byref(self._rr))
        self._tail = (self.arena.ctypes.data, self.arena.size, self.meta.ctypes.data,
                      ctypes.byref(self._ovrn))

    def _check(self) -> None:
        # the struct pointers outlive a detach, but their base would point
        # into an unmapped buffer: refuse instead
        for c in self.consumers:
            if c._lsp is None:
                raise _detached()

    def pending(self) -> bool:
        """Any input has a frag (or an overrun) ready: when none has, a
        sweep is skipped without a call."""
        for c in self.consumers:
            if c.has_pending():
                return True
        return False

    def drain(self, rr: int, max_frags: int) -> tuple[int, int, int]:
        """Up to max_frags frags round-robin from input rr on: (frags
        delivered, next rr, overrun events).  Payloads land in the arena at
        the meta rows' byte offsets."""
        self._check()
        self._rr.value = rr % self._n
        n = self._lib.fdr_drain(*self._args, min(max_frags, self.max_frags), *self._tail)
        return int(n), int(self._rr.value), int(self._ovrn.value)


class SweepDrainer(BurstDrainer):
    """fdr_sweep: the drain and the stage client's C callback per frag in
    the same call.  `client` exposes `.cb` (the address of its callback)
    and `.cb_ctx` (its context pointer).  The meta table fills as
    fdr_drain's.  `plane` (runtime/native_metrics.NativePlane, kept alive
    here) is the stage's metrics plane the sweep writes: crossings, frags,
    the drain / callback / apply / publish phase histograms and the
    in-crossing latency; None writes nothing."""

    def __init__(self, consumers: list[NativeConsumer], max_frags: int, client, plane=None):
        super().__init__(consumers, max_frags)
        self.client = client
        self.plane = plane
        self._cb = (client.cb, client.cb_ctx, plane.ptr if plane is not None else None)

    def sweep(self, rr: int, max_frags: int) -> tuple[int, int, int]:
        """(frags processed, next rr, overrun events)."""
        self._check()
        self._rr.value = rr % self._n
        n = self._lib.fdr_sweep(*self._args, min(max_frags, self.max_frags), *self._tail,
                                *self._cb)
        return int(n), int(self._rr.value), int(self._ovrn.value)


class NativeRelayClient:
    """The relay sweep client (fd_ring.cpp fdr_relay_*): every frag the
    sweep drains is forwarded onto one output link, lossy under
    backpressure (a frag without credit is dropped and counted), the chaos
    harness's relay with no Python per frag, so its crash scenarios cross a
    native crossing whose flight events must survive SIGKILL.  `crash_at`
    non-zero makes the C side _exit(42) once it has handled a frag with
    sig >= crash_at, after flushing the crossing's flight records.

    It honours the in-place restart's publish guard (`honours_guard`):
    `resume(producer, sigs)` puts its producer at the cursors the stage's
    producer recovered from the ring and swallows the replayed frags whose
    sigs that ring already carries, so runtime/topo.py lets a stage built
    over it be restartable."""

    honours_guard = True

    def __init__(self, out_link: shm.ShmLink, fseq_idx: int = 0, crash_at: int = 0):
        self._lib = load()
        self._ls, self._keep = _link_struct(out_link)
        self._h = self._lib.fdr_relay_new(ctypes.byref(self._ls), fseq_idx, crash_at)
        self.cb = ctypes.cast(self._lib.fdr_relay_cb, ctypes.c_void_p)
        self.cb_ctx = ctypes.c_void_p(self._h)
        self._plane = None
        self.link = out_link
        out_link.register(self)

    def _ctx(self):
        if self._h is None:
            raise _detached()
        return self._h

    def set_metrics(self, plane) -> None:
        """Arm the in-crossing metrics plane (a NativePlane: the publish
        phase and the crash path's flight flush); None disarms."""
        self._plane = plane  # the C side holds a raw pointer
        self._lib.fdr_relay_set_metrics(self._ctx(), plane.ptr if plane is not None else None)

    def seq_sync(self, seq: int, chunk: int) -> None:
        """Put the relay's producer at a ring's recovered cursors."""
        self._lib.fdr_relay_seq_sync(self._ctx(), seq, chunk)

    def resume(self, producer, sigs) -> None:
        """The restart path: the producer's cursors (just recovered from
        the live ring by its resume()) and the guard over `sigs`, the sigs
        that ring carries."""
        self.seq_sync(producer.seq, producer.chunk)
        arr = np.fromiter((s & _MASK64 for s in sigs), dtype=np.uint64)
        self._lib.fdr_relay_guard(self._ctx(), arr.ctypes.data, len(arr))

    def counts(self) -> tuple[int, int, int]:
        """(forwarded, dropped, swallowed by the guard) since this client
        was made."""
        vals = [ctypes.c_uint64(0) for _ in range(3)]
        self._lib.fdr_relay_counts(self._ctx(), *(ctypes.byref(v) for v in vals))
        return tuple(int(v.value) for v in vals)

    def detach(self) -> None:
        """Free the C side and drop the buffer pin (ShmLink.close)."""
        if self._h is not None:
            self._lib.fdr_relay_free(self._h)
        self._h = None
        self.cb = self.cb_ctx = None
        self._ls = self._keep = None
        self.link = None
