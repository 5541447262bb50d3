"""Single-producer message rings (the tango layer): the port's copy of
firedancer_tpu/tango/rings.py, byte for byte in its layouts.

  - 64-bit global fragment sequence numbers compared with signed
    wraparound (`seq_diff`), so rings run forever;
  - MCache: a power-of-2 ring of frag metadata rows of 7 u64 (seq, sig,
    chunk, sz, ctl, tsorig, tspub); one producer, many consumers; a slow
    consumer is never waited on: it sees the sequence gap (overrun) and
    resynchronizes.  A row being overwritten holds its new seq with the
    BUSY bit (1 << 63) set, and the seq word is written last;
  - DCache: payload bytes in 64-byte chunks, allocated compactly and
    wrapping to chunk 0 past the watermark;
  - Fseq: a consumer's published progress, read by the producer's
    FlowControl for its credits toward reliable consumers;
  - TCache: the dedup tag cache;
  - Cnc: a stage's command-and-control cell (signal, heartbeat and
    diagnostic words), which the process runner (runtime/topo.py) reads.

State lives in numpy arrays over an optional buffer, so the same code runs
over plain memory (tests) or over a shared-memory block (tango/shm.py).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
_MASK64 = (1 << 64) - 1


def seq_diff(a: int, b: int) -> int:
    """Signed distance a - b in 64-bit sequence space."""
    d = (int(a) - int(b)) & _MASK64
    return d - (1 << 64) if d >= (1 << 63) else d


# control bits in a frag's meta row (start and end of message)
CTL_SOM = 1 << 0
CTL_EOM = 1 << 1


class MCache:
    """Metadata ring: depth rows of (seq, sig, chunk, sz, ctl, tsorig, tspub)
    as a (depth, 7) uint64 array; the seq word (column 0) is written last
    on publish and checked before and after a read."""

    NCOL = 7
    COL_SEQ, COL_SIG, COL_CHUNK, COL_SZ, COL_CTL, COL_TSORIG, COL_TSPUB = range(7)

    # a row being overwritten: no consumer polls a seq with this bit set,
    # so the previous lap's frag at this line can never be read torn
    BUSY = 1 << 63

    def __init__(self, depth: int, buf: np.ndarray | None = None, *, init: bool = True):
        if depth & (depth - 1) or depth <= 0:
            raise ValueError("depth must be a power of 2")
        self.depth = depth
        if buf is None:
            buf = np.zeros(depth * self.NCOL, dtype=U64)
        self.table = buf.reshape(depth, self.NCOL)
        if not self.table.flags.writeable:
            raise ValueError("mcache buffer must be writable")
        if init:
            # each line starts busy at its own first seq: a consumer
            # polling seq k of any lap sees "not yet published"
            self.table[:, self.COL_SEQ] = np.uint64(self.BUSY) | np.arange(depth, dtype=U64)

    @classmethod
    def footprint(cls, depth: int) -> int:
        return depth * cls.NCOL * 8

    def line(self, seq: int) -> int:
        return int(seq) & (self.depth - 1)

    def publish(self, seq: int, sig: int = 0, chunk: int = 0, sz: int = 0,
                ctl: int = CTL_SOM | CTL_EOM, tsorig: int = 0, tspub: int = 0) -> None:
        row = self.table[self.line(seq)]
        row[self.COL_SEQ] = self.BUSY | (int(seq) & _MASK64)
        row[self.COL_SIG] = int(sig) & _MASK64
        row[self.COL_CHUNK] = int(chunk) & _MASK64
        row[self.COL_SZ] = int(sz) & _MASK64
        row[self.COL_CTL] = int(ctl) & _MASK64
        row[self.COL_TSORIG] = int(tsorig) & _MASK64
        row[self.COL_TSPUB] = int(tspub) & _MASK64
        row[self.COL_SEQ] = int(seq) & _MASK64  # publish: the seq word last

    def query(self, seq: int):
        """Poll for frag `seq`: (0, row copy) when available, (-1, None) when
        not yet published, (+1, None) when overrun."""
        row = self.table[self.line(seq)]
        mseq = int(row[self.COL_SEQ])
        if mseq & self.BUSY:
            # mid-overwrite with frag mseq & ~BUSY: newer than ours means
            # ours is gone; otherwise it is ours, still being written
            d = seq_diff(mseq & ~self.BUSY, seq)
            return (1, None) if d > 0 else (-1, None)
        d = seq_diff(mseq, seq)
        if d == 0:
            meta = row.copy()
            # the producer may have started overwriting during the copy
            if int(row[self.COL_SEQ]) != int(seq) & _MASK64:
                return 1, None
            return 0, meta
        return (-1, None) if d < 0 else (1, None)

    def recover(self) -> tuple[int, int, set[int]]:
        """The producer's cursors rebuilt from the ring alone, for a
        respawned producer that reattaches to its live ring:
        (frontier_seq, next_chunk, published_sigs).  The newest row
        without the BUSY bit is the last completed publish, so the
        frontier is the seq after it (0 on a ring never published); a
        row caught mid-overwrite was never visible and is published
        again.  next_chunk is the dcache cursor after the frontier frag's
        payload, so a resumed producer overwrites no frag in flight; the
        sigs are every completed row's, the replay-dedup window."""
        best = None  # (seq, chunk, sz)
        sigs: set[int] = set()
        for line in range(self.depth):
            row = self.table[line]
            mseq = int(row[self.COL_SEQ])
            if mseq & self.BUSY:
                continue  # initial, or mid-overwrite (never published)
            sigs.add(int(row[self.COL_SIG]))
            if best is None or seq_diff(mseq, best[0]) > 0:
                best = (mseq, int(row[self.COL_CHUNK]), int(row[self.COL_SZ]))
        if best is None:
            return 0, 0, sigs
        frontier = (best[0] + 1) & _MASK64
        next_chunk = best[1] + (-(-max(best[2], 1) // DCache.CHUNK_SZ))
        return frontier, next_chunk, sigs


class DCache:
    """Compact payload ring paired with an mcache: chunk indices in 64-byte
    granules; `alloc` gives the chunk for the next payload of at most mtu
    bytes and wraps to 0 once the cursor passes the watermark."""

    CHUNK_SZ = 64

    def __init__(self, mtu: int, depth: int, buf: np.ndarray | None = None):
        self.mtu = mtu
        chunk_mtu = -(-mtu // self.CHUNK_SZ)
        if buf is None:
            buf = np.zeros(self.footprint(mtu, depth), dtype=np.uint8)
        self.data = buf
        self.wmark = (len(self.data) - chunk_mtu * self.CHUNK_SZ) // self.CHUNK_SZ
        self._chunk = 0

    @classmethod
    def footprint(cls, mtu: int, depth: int) -> int:
        chunk_mtu = -(-mtu // cls.CHUNK_SZ)
        return (depth + 2) * chunk_mtu * cls.CHUNK_SZ * 2

    def alloc(self, sz: int) -> int:
        if sz > self.mtu:
            raise ValueError("payload exceeds mtu")
        chunk = self._chunk
        if chunk > self.wmark:
            chunk = 0
        self._chunk = chunk + (-(-max(sz, 1) // self.CHUNK_SZ))
        return chunk

    def write(self, chunk: int, payload: bytes) -> None:
        o = chunk * self.CHUNK_SZ
        self.data[o : o + len(payload)] = np.frombuffer(payload, dtype=np.uint8)

    def read(self, chunk: int, sz: int) -> bytes:
        o = chunk * self.CHUNK_SZ
        return self.data[o : o + sz].tobytes()


class Fseq:
    """A consumer's published progress sequence (one u64 cell)."""

    def __init__(self, buf: np.ndarray | None = None):
        self.cell = buf if buf is not None else np.zeros(1, dtype=U64)

    def publish(self, seq: int) -> None:
        self.cell[0] = int(seq) & _MASK64

    def query(self) -> int:
        return int(self.cell[0])


class FlowControl:
    """Producer credits over the reliable consumers' fseqs:
    cr_avail = max(cr_max - max(seq - fseq_i), 0).  Consumers left out
    take overruns instead of exerting backpressure."""

    def __init__(self, depth: int, fseqs: list[Fseq], cr_max: int | None = None):
        self.cr_max = cr_max if cr_max is not None else depth
        self.fseqs = fseqs

    def credits(self, seq: int) -> int:
        if not self.fseqs:
            return self.cr_max
        lag = max(seq_diff(seq, f.query()) for f in self.fseqs)
        return max(self.cr_max - max(lag, 0), 0)


class TCache:
    """Dedup cache of recently seen 64-bit tags.

    Ring of the last `depth` tags + a set for O(1) membership; inserting a
    fresh tag evicts the oldest.  Tag 0 is reserved as null and never
    dedups.
    """

    def __init__(self, depth: int):
        self.depth = depth
        self.ring = np.zeros(depth, dtype=np.uint64)
        self.oldest = 0
        self.map: set[int] = set()

    def insert(self, tag: int) -> bool:
        """Insert tag; returns True if it was already present (duplicate)."""
        tag &= _MASK64
        if tag == 0:
            return False
        if tag in self.map:
            return True
        old = int(self.ring[self.oldest])
        if old:
            self.map.discard(old)
        self.ring[self.oldest] = tag
        self.oldest = (self.oldest + 1) % self.depth
        self.map.add(tag)
        return False


# Cnc signal values (the fd_cnc state machine)
CNC_SIG_BOOT = 0
CNC_SIG_RUN = 1
CNC_SIG_HALT = 2
CNC_SIG_FAIL = 3


class Cnc:
    """Command-and-control cell: signal, heartbeat, then NDIAG diagnostic
    words, one u64 each (the JAX package's layout, word for word, so
    either package's view of one buffer reads the other's writes)."""

    NDIAG = 6

    def __init__(self, buf: np.ndarray | None = None):
        self.cells = buf if buf is not None else np.zeros(2 + self.NDIAG, dtype=U64)

    @classmethod
    def footprint(cls) -> int:
        return (2 + cls.NDIAG) * 8

    @property
    def signal(self) -> int:
        return int(self.cells[0])

    @signal.setter
    def signal(self, v: int) -> None:
        self.cells[0] = v

    def heartbeat(self, now: int) -> None:
        self.cells[1] = int(now) & _MASK64

    @property
    def last_heartbeat(self) -> int:
        return int(self.cells[1])

    def diag(self, idx: int) -> int:
        return int(self.cells[2 + idx])

    def diag_set(self, idx: int, v: int) -> None:
        self.cells[2 + idx] = int(v) & _MASK64
