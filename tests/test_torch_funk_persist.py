"""The port's durable funk (funk/persist.py over utils/checkpt.py) against
the JAX package's PersistentFunk.

  - seeded op streams (test_torch_funk.py's, roots and publishes
    journaled) through both packages' PersistentFunk, each in its own
    directory: the journal and the snapshot files byte-equal after every
    stream, compaction included, and the recovered roots equal;
  - recovery from a torn tail, a corrupt frame and a garbage header, as
    the JAX package's tests/test_funk_persist.py;
  - a JAX snapshot and journal restore in the port, and the reverse.

Tolerance: exact equality, byte for byte.
"""

from __future__ import annotations

import os
import zlib

import pytest

from firedancer_tpu.funk import persist as jp
from firedancer_tpu.utils import checkpt as jcp
from firedancer_tpu_torch.funk import persist as tp
from firedancer_tpu_torch.utils import checkpt as tcp
from tests.test_torch_funk import SEEDS, apply_op, op_stream, root_state

FILES = ("funk.wal", "funk.snap")


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in FILES if os.path.exists(os.path.join(d, n))}


@pytest.mark.parametrize("seed", SEEDS)
def test_journal_and_snapshot_bytes_equal_jax(seed, tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(min_compact_bytes=2048, compact_ratio=2)
    with jp.PersistentFunk(jd, **kw) as j, tp.PersistentFunk(td, **kw) as t:
        for op, a in op_stream(seed):
            assert apply_op(j, op, a) == apply_op(t, op, a)
        assert root_state(j) == root_state(t)
        j.compact()
        t.compact()
        for i in range(40):  # past the compaction: a fresh journal
            for f in (j, t):
                f.rec_insert(None, b"late%d" % (i % 7), b"v%d.%d" % (seed, i))
    jf, tf = _files(jd), _files(td)
    assert sorted(tf) == sorted(FILES) and jf == tf
    with tp.PersistentFunk(td) as t, jp.PersistentFunk(jd) as j:
        assert t.recovered_frames == j.recovered_frames > 0
        assert root_state(t) == root_state(j)


def test_compaction_writes_equal_files(tmp_path):
    """Compaction on its own trigger (the journal past its bound) lands at
    the same write in both packages, with equal files."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    with jp.PersistentFunk(jd, min_compact_bytes=2048) as j, \
            tp.PersistentFunk(td, min_compact_bytes=2048) as t:
        for i in range(200):
            v = bytes([i]) * 64
            j.rec_insert(None, b"key%03d" % (i % 10), v)
            t.rec_insert(None, b"key%03d" % (i % 10), v)
            assert _files(jd) == _files(td)
    assert os.path.getsize(os.path.join(td, "funk.wal")) < 64 * 200


def test_checkpt_frames_equal_jax(tmp_path):
    frames = {"a": [b"", b"x" * 100, os.urandom(33)], "b": [], "c": [b"k", b"v"]}
    for style in (tcp.STYLE_RAW, tcp.STYLE_ZLIB):
        pj, pt = str(tmp_path / f"j{style}"), str(tmp_path / f"t{style}")
        assert jcp.checkpt(pj, frames, style=style) == tcp.checkpt(pt, frames, style=style)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        assert tcp.restore(pj) == frames == jcp.restore(pt)
        assert tcp.restore(pj, only={"c"}) == {"c": [b"k", b"v"]}


def test_torn_tail_truncated(tmp_path):
    d = str(tmp_path / "db")
    with tp.PersistentFunk(d) as f:
        f.rec_insert(None, b"good", b"yes")
    wal = os.path.join(d, "funk.wal")
    with open(wal, "ab") as fh:
        fh.write(tp._FRAME_HDR.pack(100, zlib.crc32(b"x")))  # a frame cut short
        fh.write(b"partial")
    with tp.PersistentFunk(d) as f:
        assert f.rec_query(None, b"good") == b"yes" and f.recovered_frames == 1
    with tp.PersistentFunk(d) as f:  # the tail went: the journal ends at the good frame
        assert f.recovered_frames == 1
    size = os.path.getsize(wal)
    jd = str(tmp_path / "jdb")
    with jp.PersistentFunk(jd) as f:
        f.rec_insert(None, b"good", b"yes")
    assert os.path.getsize(os.path.join(jd, "funk.wal")) == size


def test_corrupt_frame_stops_replay(tmp_path):
    d = str(tmp_path / "db")
    with tp.PersistentFunk(d) as f:
        f.rec_insert(None, b"k1", b"v1")
        f.rec_insert(None, b"k2", b"v2")
    wal = os.path.join(d, "funk.wal")
    blob = bytearray(open(wal, "rb").read())
    blob[-1] ^= 0xFF  # the last frame's payload
    open(wal, "wb").write(bytes(blob))
    with tp.PersistentFunk(d) as f:
        assert f.rec_query(None, b"k1") == b"v1" and f.rec_query(None, b"k2") is None


def test_garbage_header_starts_a_fresh_journal(tmp_path):
    """A journal whose magic is garbage is untrusted whole: recovery keeps
    the snapshot, truncates the journal to nothing, and later frames
    recover, in both packages alike."""
    out = {}
    for name, mod in (("jax", jp), ("port", tp)):
        d = str(tmp_path / name)
        with mod.PersistentFunk(d) as f:
            f.rec_insert(None, b"snap", b"1")
            f.compact()
            f.rec_insert(None, b"lost", b"2")
        wal = os.path.join(d, "funk.wal")
        blob = bytearray(open(wal, "rb").read())
        blob[:8] = b"GARBAGE!"
        open(wal, "wb").write(bytes(blob))
        with mod.PersistentFunk(d) as f:
            assert f.rec_query(None, b"snap") == b"1" and f.rec_query(None, b"lost") is None
            assert f.recovered_frames == 0
            f.rec_insert(None, b"after", b"3")
        with mod.PersistentFunk(d) as f:
            assert f.recovered_frames == 1 and f.rec_query(None, b"after") == b"3"
        out[name] = _files(d)
    assert out["jax"] == out["port"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_files_restore_across_packages(direction, tmp_path):
    src, dst = (jp, tp) if direction == "jax_to_port" else (tp, jp)
    d = str(tmp_path / "db")
    with src.PersistentFunk(d) as f:
        for i in range(30):
            f.rec_insert(None, b"k%02d" % i, b"v%d" % i)
        f.compact()
        x = f.txn_prepare(None, b"x")
        f.rec_insert(x, b"k00", b"new")
        f.rec_remove(x, b"k01")
        f.txn_publish(x)
        want = root_state(f)
    with dst.PersistentFunk(d) as g:
        assert root_state(g) == want and g.recovered_frames == 1
    snap = os.path.join(d, "funk.snap")
    dst_cp = tcp if dst is tp else jcp
    restored = dst_cp.funk_restore(snap, dst.Funk)
    assert len(restored.rec_keys(None)) == 30
