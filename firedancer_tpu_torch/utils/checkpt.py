"""Framed compressed checkpoint/restore, and the funk snapshot on it (the
port's copy of firedancer_tpu/utils/checkpt.py, its framing and funk half;
the files are byte-identical to the JAX package's).

A checkpoint is a sequence of independent *frames*, each holding a
sequence of variable-size data buffers, stored RAW or zlib-compressed;
frames are independent, so they can be restored selectively.

File layout (little-endian):
    magic "FDTPUCKP" | u32 version | u32 frame_cnt
    per frame: u8 style | u32 name_len | name | u64 payload_sz | payload
    payload (after decompression for ZLIB style):
        u32 buf_cnt | (u64 len | bytes)*

`funk_checkpt`/`funk_restore` snapshot a funk's published root on it
(funk/persist.py's compaction).  The PoH half is not ported.
"""

from __future__ import annotations

import struct
import zlib

MAGIC = b"FDTPUCKP"
VERSION = 1

STYLE_RAW = 0
STYLE_ZLIB = 1


def _encode_frame(bufs: list[bytes]) -> bytes:
    out = bytearray(struct.pack("<I", len(bufs)))
    for b in bufs:
        out += struct.pack("<Q", len(b))
        out += b
    return bytes(out)


def _decode_frame(payload: bytes) -> list[bytes]:
    (cnt,) = struct.unpack_from("<I", payload, 0)
    off = 4
    bufs = []
    for _ in range(cnt):
        (ln,) = struct.unpack_from("<Q", payload, off)
        off += 8
        bufs.append(payload[off : off + ln])
        off += ln
    if off != len(payload):
        raise ValueError("trailing bytes in checkpoint frame")
    return bufs


def checkpt(
    path: str, frames: dict[str, list[bytes]], *, style: int = STYLE_ZLIB
) -> int:
    """Write named frames; returns bytes written."""
    out = bytearray(MAGIC)
    out += struct.pack("<II", VERSION, len(frames))
    for name, bufs in frames.items():
        nb = name.encode()
        payload = _encode_frame(bufs)
        if style == STYLE_ZLIB:
            payload = zlib.compress(payload, 6)
        out += struct.pack("<BI", style, len(nb))
        out += nb
        out += struct.pack("<Q", len(payload))
        out += payload
    with open(path, "wb") as f:
        f.write(out)
    return len(out)


def restore(path: str, *, only: set[str] | None = None) -> dict[str, list[bytes]]:
    """Read frames back (optionally a subset — frames are independent)."""
    data = open(path, "rb").read()
    if data[:8] != MAGIC:
        raise ValueError("bad checkpoint magic")
    version, cnt = struct.unpack_from("<II", data, 8)
    if version != VERSION:
        raise ValueError(f"unsupported checkpoint version {version}")
    off = 16
    out: dict[str, list[bytes]] = {}
    for _ in range(cnt):
        style, name_len = struct.unpack_from("<BI", data, off)
        off += 5
        name = data[off : off + name_len].decode()
        off += name_len
        (sz,) = struct.unpack_from("<Q", data, off)
        off += 8
        payload = data[off : off + sz]
        off += sz
        if only is not None and name not in only:
            continue
        if style == STYLE_ZLIB:
            payload = zlib.decompress(payload)
        elif style != STYLE_RAW:
            raise ValueError(f"unknown frame style {style}")
        out[name] = _decode_frame(payload)
    return out


# -- the funk snapshot ----------------------------------------------------------


def funk_checkpt(path: str, funk) -> int:
    """Snapshot a funk's ROOT store (published state: in-prep forks are
    speculative and not checkpointed), keys sorted."""
    bufs = []
    for key, val in sorted(funk._root.items()):
        bufs.append(key)
        bufs.append(val)
    return checkpt(path, {"funk_root": bufs})


def funk_restore(path: str, funk_cls):
    """A new `funk_cls()` with the snapshot's root records inserted."""
    f = funk_cls()
    bufs = restore(path, only={"funk_root"})["funk_root"]
    if len(bufs) % 2:
        raise ValueError("funk frame must hold key/value pairs")
    for i in range(0, len(bufs), 2):
        f.rec_insert(None, bufs[i], bufs[i + 1])
    return f
