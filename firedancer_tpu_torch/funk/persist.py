"""Durable funk: write-ahead journal + snapshot compaction (the port's copy
of firedancer_tpu/funk/persist.py; its journal and snapshot files are
byte-identical to the JAX package's).

Durability is a file-system protocol over the dict-backed store:

  - every ROOT mutation batch (a publish step's record set, or a direct
    root insert/remove) is appended to a write-ahead journal as one
    CRC-framed record before it is applied: a crash never splits a
    publish in half;
  - recovery = load the latest snapshot, then replay the journal,
    truncating at the first torn/corrupt frame (frames before it are
    intact by construction);
  - when the journal outgrows the live root, compaction writes a fresh
    snapshot (utils/checkpt.py, framed and compressed) and resets the
    journal.  Rename-into-place keeps a crash during compaction
    recoverable from the previous snapshot and journal.

In-preparation fork-tree txns are NOT journaled: they are speculative
and a restarted validator rebuilds them from replay; only published
state must survive.

Not ported: `funk_from_config`, the boot-time factory over the node's
config file, which waits for the port's utils/config.py.
"""

from __future__ import annotations

import os
import struct
import zlib

from ..utils import checkpt as cp
from .funk import Funk

_MAGIC = b"FDTPUWAL"
_FRAME_HDR = struct.Struct("<II")  # payload_len, crc32(payload)


def _enc_batch(items: list[tuple[bytes, bytes | None]]) -> bytes:
    out = [struct.pack("<I", len(items))]
    for key, val in items:
        if val is None:
            out.append(struct.pack("<Hi", len(key), -1))
            out.append(key)
        else:
            out.append(struct.pack("<Hi", len(key), len(val)))
            out.append(key)
            out.append(val)
    return b"".join(out)


def _dec_batch(payload: bytes) -> list[tuple[bytes, bytes | None]]:
    (n,) = struct.unpack_from("<I", payload, 0)
    off = 4
    items = []
    for _ in range(n):
        klen, vlen = struct.unpack_from("<Hi", payload, off)
        off += 6
        key = payload[off : off + klen]
        off += klen
        if vlen < 0:
            items.append((key, None))
        else:
            items.append((key, payload[off : off + vlen]))
            off += vlen
    return items


class PersistentFunk(Funk):
    """Funk whose published root survives process restarts.

    `PersistentFunk(dir)` recovers snapshot+journal from `dir` if
    present, else starts empty.  `compact_ratio` bounds journal growth:
    when journal bytes exceed max(min_compact_bytes, ratio x approximate
    live-root bytes) the store compacts.  `sync` fsyncs every journal
    append (durable against power loss, slower); sync=False leaves
    flushing to the OS (durable against process crash, the default).
    """

    def __init__(self, dirpath: str, *, compact_ratio: int = 4,
                 min_compact_bytes: int = 1 << 20, sync: bool = False):
        super().__init__()
        self.dir = dirpath
        self.compact_ratio = compact_ratio
        self.min_compact_bytes = min_compact_bytes
        self.sync = sync
        os.makedirs(dirpath, exist_ok=True)
        self._snap_path = os.path.join(dirpath, "funk.snap")
        self._wal_path = os.path.join(dirpath, "funk.wal")
        self._root_bytes = 0  # approximate live size for compaction
        self._recover()
        self._wal = open(self._wal_path, "ab")
        if self._wal.tell() == 0:
            self._wal.write(_MAGIC)
            self._wal.flush()

    # -- recovery -----------------------------------------------------------

    def _recover(self) -> None:
        if os.path.exists(self._snap_path):
            restored = cp.funk_restore(self._snap_path, Funk)
            self._root = restored._root
        replayed, valid_end = 0, len(_MAGIC)
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                blob = f.read()
            if blob[: len(_MAGIC)] != _MAGIC:
                # torn/garbage header: the whole journal is untrusted.
                # Truncate to ZERO (not just skip) — __init__ reopens in
                # append mode and only writes the magic at tell()==0, so
                # leaving the garbage in place would append frames after
                # it and every later recovery would drop them all.
                blob = b""
                valid_end = 0
            off = len(_MAGIC)
            while off + _FRAME_HDR.size <= len(blob):
                ln, crc = _FRAME_HDR.unpack_from(blob, off)
                payload = blob[off + _FRAME_HDR.size : off + _FRAME_HDR.size + ln]
                if len(payload) != ln or zlib.crc32(payload) != crc:
                    break  # torn tail: everything before it is intact
                for key, val in _dec_batch(payload):
                    if val is None:
                        self._root.pop(key, None)
                    else:
                        self._root[key] = val
                off += _FRAME_HDR.size + ln
                valid_end = off
                replayed += 1
            if valid_end < os.path.getsize(self._wal_path):
                with open(self._wal_path, "r+b") as f:
                    f.truncate(valid_end)
        self._root_bytes = sum(
            len(k) + len(v) for k, v in self._root.items()
        )
        self.recovered_frames = replayed

    # -- journaled root writes ---------------------------------------------

    def _root_merge(self, items) -> None:
        payload = _enc_batch(items)
        self._wal.write(_FRAME_HDR.pack(len(payload), zlib.crc32(payload)))
        self._wal.write(payload)
        self._wal.flush()
        if self.sync:
            os.fsync(self._wal.fileno())
        for key, val in items:
            old = self._root.get(key)
            if old is not None:
                self._root_bytes -= len(key) + len(old)
            if val is not None:
                self._root_bytes += len(key) + len(val)
        super()._root_merge(items)
        limit = max(self.min_compact_bytes,
                    self.compact_ratio * max(self._root_bytes, 1))
        if self._wal.tell() > limit:
            self.compact()

    # -- compaction ---------------------------------------------------------

    def compact(self) -> None:
        """Snapshot the live root and reset the journal.  Crash-safe:
        the snapshot lands via rename; the journal is truncated only
        after the snapshot is durable."""
        tmp = self._snap_path + ".tmp"
        cp.funk_checkpt(tmp, self)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        self._wal.close()
        self._wal = open(self._wal_path, "wb")
        self._wal.write(_MAGIC)
        self._wal.flush()
        if self.sync:
            os.fsync(self._wal.fileno())

    def close(self) -> None:
        self._wal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
