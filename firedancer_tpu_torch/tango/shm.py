"""Shared-memory links: mcache + dcache + fseqs in one mappable block (the
port's copy of firedancer_tpu/tango/shm.py, byte-compatible with it: a
link either package creates, the other attaches by name).

Layout (8-byte aligned):
  [0, 32)         header: depth, mtu, n_fseq, dcache_sz (0 = the footprint)
  [32, a)         mcache table   (depth * 7 u64)
  [a, b)          dcache data    (dcache_sz bytes)
  [b, c)          fseq cells     (n_fseq u64)
  [c, c + 64)     a command-and-control cell's words (rings.Cnc), kept
                  for the JAX package's layout; the process runner gives
                  each stage a cnc segment of its own (runtime/topo.py)

Two lanes speak the protocol over the same bytes: the Python `Producer`
and `Consumer` here (the spec the native lane is held against) and the
native endpoints of tango/native.py over native/fd_ring.cpp.
`make_producer` and `make_consumer` pick the lane by argument; nothing
reads the environment, and a failed g++ build of the native lane raises.
"""

from __future__ import annotations

import gc
import os
import time
import weakref
from multiprocessing import shared_memory

import numpy as np

from . import rings

_HDR = 4 * 8
CNC_SZ = rings.Cnc.footprint()  # the command-and-control words

_uid_seq = iter(range(1 << 62))


def fresh_uid(namespace: str | None = None) -> str:
    """A /dev/shm-unique run id, `[namespace_]pid_counter`: the pid keeps
    processes apart (test workers, pipelines side by side) and the counter
    keeps one process's successive pipelines apart; `namespace` scopes a
    run's segments (a topology's, say) under a prefix of its own.  Names
    are made in the parent: children of a topology get them ready-made."""
    tag = f"{os.getpid()}_{next(_uid_seq)}"
    return f"{namespace}_{tag}" if namespace else tag


def now_ns() -> int:
    """The frag-timestamp clock (tsorig, tspub): CLOCK_MONOTONIC, the one
    the native lane stamps with too."""
    return time.monotonic_ns()


def _layout(depth: int, mtu: int, n_fseq: int, dcache_sz: int | None = None):
    a = _HDR
    b = a + rings.MCache.footprint(depth)
    c = b + (dcache_sz or rings.DCache.footprint(mtu, depth))
    d = c + n_fseq * 8
    return a, b, c, d, d + CNC_SZ


class _SharedMemory(shared_memory.SharedMemory):
    def __del__(self):
        # collected with views of it still alive (a link never closed, in
        # one garbage cycle with its endpoints): the mapping then lives
        # until the last view goes, with nothing to report
        try:
            self.close()
        except BufferError:
            pass


class ShmLink:
    """One producer -> consumers link over a named shared-memory block."""

    def __init__(self, shm, depth: int, mtu: int, n_fseq: int, owner: bool,
                 dcache_sz: int | None = None):
        self._shm = shm
        self.name = shm.name.lstrip("/")
        self.depth = depth
        self.mtu = mtu
        self.n_fseq = n_fseq
        self.dcache_sz = dcache_sz or rings.DCache.footprint(mtu, depth)
        # every endpoint (either lane) registers here, and close() detaches
        # them first: their numpy and ctypes views pin the mapping
        self._endpoints: list = []
        a, b, c, _d, _e = _layout(depth, mtu, n_fseq, dcache_sz)
        buf = shm.buf
        self.mcache = rings.MCache(
            depth, np.frombuffer(buf, dtype=rings.U64, offset=a,
                                 count=depth * rings.MCache.NCOL), init=owner)
        self.dcache = rings.DCache(mtu, depth, buf=np.frombuffer(
            buf, dtype=np.uint8, offset=b, count=self.dcache_sz))
        self.fseqs = [rings.Fseq(np.frombuffer(buf, dtype=rings.U64, offset=c + 8 * i, count=1))
                      for i in range(n_fseq)]

    @classmethod
    def create(cls, name: str, depth: int, mtu: int, n_fseq: int = 1,
               dcache_sz: int | None = None) -> "ShmLink":
        """dcache_sz may oversize the data region past the footprint; a
        smaller one would let in-flight frags be overwritten, and one that
        is not a whole number of chunks would misalign the u64 cells after
        it, so both raise."""
        if dcache_sz is not None:
            if dcache_sz < rings.DCache.footprint(mtu, depth):
                raise ValueError(f"dcache_sz {dcache_sz} < DCache.footprint({mtu}, {depth})"
                                 f" = {rings.DCache.footprint(mtu, depth)}")
            if dcache_sz % rings.DCache.CHUNK_SZ:
                raise ValueError(f"dcache_sz {dcache_sz} is not a multiple of the"
                                 f" {rings.DCache.CHUNK_SZ}-byte chunk")
        size = _layout(depth, mtu, n_fseq, dcache_sz)[-1]
        shm = _SharedMemory(name=name, create=True, size=size)
        hdr = np.frombuffer(shm.buf, dtype=np.int64, count=4)
        hdr[:] = (depth, mtu, n_fseq, dcache_sz or 0)
        del hdr
        return cls(shm, depth, mtu, n_fseq, owner=True, dcache_sz=dcache_sz)

    @classmethod
    def attach(cls, name: str) -> "ShmLink":
        """Map an existing link by name; its geometry comes from the header."""
        shm = _SharedMemory(name=name)
        depth, mtu, n_fseq, dcache_sz = (int(v) for v in np.frombuffer(shm.buf, np.int64, 4))
        return cls(shm, depth, mtu, n_fseq, owner=False, dcache_sz=dcache_sz or None)

    def close(self) -> None:
        """Drop this object's views and the mapping.  The registered
        endpoints are detached first; a view some other object still holds
        (an endpoint of the JAX package, say) raises BufferError from the
        mapping's close."""
        for ref in self._endpoints:
            obj = ref()
            if obj is not None:
                obj.detach()
        self._endpoints = []
        self.mcache = self.dcache = self.fseqs = None
        gc.collect()
        self._shm.close()

    def unlink(self) -> None:
        self._shm.unlink()

    def register(self, endpoint) -> None:
        """close() detaches `endpoint` (held weakly) before unmapping."""
        self._endpoints.append(weakref.ref(endpoint))


POLL_EMPTY = "empty"
POLL_OVERRUN = "overrun"


class Producer:
    """The Python publish side of a link, credit-gated over the reliable
    fseqs (None = all of the link's; [] = free-running)."""

    def __init__(self, link: ShmLink, reliable_fseq_idx: list[int] | None = None):
        self.link = link
        self.seq = 0
        idxs = reliable_fseq_idx if reliable_fseq_idx is not None else list(range(link.n_fseq))
        self.fctl = rings.FlowControl(link.depth, [link.fseqs[i] for i in idxs])
        self.cr_avail = 0
        link.register(self)

    def refresh_credits(self) -> None:
        self.cr_avail = self.fctl.credits(self.seq)

    def resume(self) -> set[int]:
        """In-place restart: the publish cursor recovered from the live
        ring (a fresh endpoint at seq 0 would lap every consumer and
        overwrite payloads in flight).  Returns the ring's published sigs,
        the caller's replay-dedup window (Stage.resume_from_rings)."""
        frontier, next_chunk, sigs = self.link.mcache.recover()
        self.seq = frontier
        self.link.dcache._chunk = next_chunk
        self.refresh_credits()
        return sigs

    def try_publish(self, payload: bytes, sig: int = 0, tsorig: int = 0) -> bool:
        """Publish if credits allow (False = backpressured).  tspub is
        stamped here; tsorig=0 means this stage is the origin and stamps
        now too."""
        if self.cr_avail <= 0:
            self.refresh_credits()
            if self.cr_avail <= 0:
                return False
        ts = now_ns()
        dc = self.link.dcache
        chunk = dc.alloc(len(payload))
        dc.write(chunk, payload)
        self.link.mcache.publish(self.seq, sig=sig, chunk=chunk, sz=len(payload),
                                 tsorig=tsorig or ts, tspub=ts)
        self.seq += 1
        self.cr_avail -= 1
        return True

    def detach(self) -> None:
        self.link = self.fctl = None


class Consumer:
    """The Python receive side of a link: polls in sequence, resyncs on an
    overrun and publishes its progress to its fseq every `lazy` frags."""

    def __init__(self, link: ShmLink, fseq_idx: int = 0, lazy: int = 64):
        self.link = link
        self.seq = 0
        self.fseq = link.fseqs[fseq_idx]
        self.lazy = lazy
        self._since_publish = 0
        self.ovrn_cnt = 0
        link.register(self)

    def poll(self):
        """(meta row, payload), POLL_EMPTY or POLL_OVERRUN (the consumer has
        skipped ahead to the frag that overwrote its own)."""
        mc = self.link.mcache
        status, meta = mc.query(self.seq)
        if status < 0:
            return POLL_EMPTY
        if status > 0:
            line_seq = int(mc.table[mc.line(self.seq), rings.MCache.COL_SEQ]) & ~rings.MCache.BUSY
            self.ovrn_cnt += max(rings.seq_diff(line_seq, self.seq), 1)
            self.seq = line_seq
            return POLL_OVERRUN
        payload = self.link.dcache.read(int(meta[rings.MCache.COL_CHUNK]),
                                        int(meta[rings.MCache.COL_SZ]))
        # the producer may have lapped us during the copy: the bytes are torn
        if mc.query(self.seq)[0] != 0:
            self.ovrn_cnt += 1
            return POLL_OVERRUN
        self.seq += 1
        self._since_publish += 1
        if self._since_publish >= self.lazy:
            self.publish_progress()
        return meta, payload

    def has_pending(self) -> bool:
        """A frag (or an overrun) is ready at this consumer's cursor."""
        return self.link.mcache.query(self.seq)[0] >= 0

    def publish_progress(self) -> None:
        self.fseq.publish(self.seq)
        self._since_publish = 0

    def resume(self) -> int:
        """In-place restart: resume at the progress this consumer last
        published to its fseq.  Frags consumed past it before the crash
        are polled again; the restarted stage's publish guard keeps the
        wire exactly-once."""
        self.seq = self.fseq.query()
        self._since_publish = 0
        return self.seq

    def set_lazy(self, lazy: int) -> None:
        """Retune the progress publication interval
        (Stage.arm_safe_progress puts it out of reach)."""
        self.lazy = lazy

    def detach(self) -> None:
        self.link = self.fseq = None


def make_producer(link: ShmLink, reliable_fseq_idx: list[int] | None = None, *,
                  native: bool = True):
    """A publish endpoint: the native lane (tango/native.py) or the Python one."""
    if native:
        from . import native as tn

        return tn.NativeProducer(link, reliable_fseq_idx)
    return Producer(link, reliable_fseq_idx)


def make_consumer(link: ShmLink, fseq_idx: int = 0, lazy: int = 64, *, native: bool = True):
    """A receive endpoint: the native lane (tango/native.py) or the Python one."""
    if native:
        from . import native as tn

        return tn.NativeConsumer(link, fseq_idx, lazy)
    return Consumer(link, fseq_idx, lazy)
