"""The port's ring lanes (tango/shm.py's Python endpoints and tango/native.py
over native/fd_ring.cpp) against each other and against the JAX package's
two lanes.

The protocol differential is the JAX package's tests/test_native_ring.py
suite, parametrised: a seeded op script (publish bursts with sizes from 0
to the mtu so the compact dcache wraps, consume runs, stalls that exhaust
the credits) is replayed on a fresh link for each (producer lane,
consumer lane) pair, in three shapes: reliable consumer with a lazy fseq
cadence of 5, lazy 0 (progress after every frag) and a free-running
producer that laps the consumer (forced overruns and resyncs).  Every pair
logs the same publish outcomes, metas (every column but tspub), payloads,
overrun events, ovrn_cnt and fseq values as the port's Python lane.  Then
the burst entry points (fdr_publish_burst, fdr_drain, fdr_sweep with a
callback), teardown, the index checks, and the lane and build rules:
an argument picks the lane and a failed g++ build raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import pytest

from firedancer_tpu.tango import native as jn
from firedancer_tpu.tango import shm as jshm
from firedancer_tpu_torch.tango import native as tn
from firedancer_tpu_torch.tango import shm as tshm
from firedancer_tpu_torch.utils import hostbuild

DIFF_DEPTH = 16
DIFF_MTU = 192

# lane -> (its package's shm module, producer class, consumer class)
LANES = {
    "port-py": (tshm, tshm.Producer, tshm.Consumer),
    "port-native": (tshm, tn.NativeProducer, tn.NativeConsumer),
    "jax-py": (jshm, jshm.Producer, jshm.Consumer),
    "jax-native": (jshm, jn.NativeProducer, jn.NativeConsumer),
}
REFERENCE = ("port-py", "port-py")
PAIRS = [("port-native", "port-native"), ("port-native", "port-py"),
         ("port-py", "port-native"), ("jax-py", "jax-py"), ("jax-native", "jax-native")]
# shape -> (reliable fseqs, lazy, script steps)
SHAPES = {"credit": (None, 5, 240), "lazy0": (None, 0, 120), "overrun": ([], 7, 160)}


def make_link(mod, tag: str, depth: int = DIFF_DEPTH, mtu: int = DIFF_MTU, n_fseq: int = 1):
    """A fresh link made by `mod` (either package's shm), named per process."""
    return mod.ShmLink.create(f"fdtpu_torch_nr{tag}_{tshm.fresh_uid()}", depth=depth, mtu=mtu,
                              n_fseq=n_fseq)


def endpoints(prod_lane: str, cons_lane: str, link, *, reliable, lazy):
    _, prod_cls, _ = LANES[prod_lane]
    _, _, cons_cls = LANES[cons_lane]
    return prod_cls(link, reliable), cons_cls(link, 0, lazy)


def op_script(seed: int, n_steps: int) -> list:
    """Publish bursts (sizes 0..mtu), consume runs and stalls, then a final
    drain."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_steps):
        k = int(rng.integers(3))
        if k == 0:
            ops.append(("pub", int(rng.integers(1, 9)),
                        [int(x) for x in rng.integers(0, DIFF_MTU + 1, 8)]))
        elif k == 1:
            ops.append(("consume", int(rng.integers(1, 11))))
        else:
            ops.append(("stall",))
    ops.append(("consume", 4 * DIFF_DEPTH))
    return ops


def run_script(fseq_of, prod, cons, ops) -> list:
    """Replay `ops`; the observable event log.  fseq_of() reads the
    consumer's published progress off the link."""
    log = []
    pub_i = 0
    for op in ops:
        if op[0] == "pub":
            for j in range(op[1]):
                sz = op[2][j % len(op[2])]
                payload = bytes((pub_i + i) & 0xFF for i in range(sz))
                ok = prod.try_publish(payload, sig=(pub_i << 56) | 7, tsorig=1_000_000 + pub_i)
                log.append(("pub", pub_i, bool(ok)))
                pub_i += bool(ok)
        elif op[0] == "consume":
            for _ in range(op[1]):
                res = cons.poll()
                if isinstance(res, str):
                    if res == "empty":
                        log.append(("empty",))
                        break
                    log.append(("ovrn", cons.ovrn_cnt))
                    continue
                meta, payload = res
                log.append(("frag", tuple(int(meta[c]) for c in range(6)), bytes(payload)))
        log.append(("fseq", fseq_of()))
    log.append(("final", cons.ovrn_cnt, prod.seq, cons.seq))
    return log


def lane_log(prod_lane: str, cons_lane: str, shape: str, seed: int) -> list:
    reliable, lazy, n_steps = SHAPES[shape]
    mod = LANES[prod_lane][0]
    link = make_link(mod, "d")
    try:
        prod, cons = endpoints(prod_lane, cons_lane, link, reliable=reliable, lazy=lazy)
        log = run_script(lambda: link.fseqs[0].query(), prod, cons, op_script(seed, n_steps))
        del prod, cons
        return log
    finally:
        link.close()
        link.unlink()


@pytest.mark.parametrize("seed", [0xC0FFEE, 2026])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("pair", PAIRS, ids=["/".join(p) for p in PAIRS])
def test_lane_protocol_parity(pair, shape, seed):
    ref = lane_log(*REFERENCE, shape, seed)
    got = lane_log(*pair, shape, seed)
    if shape == "overrun":
        assert any(e[0] == "ovrn" for e in ref), "the script must force overruns"
    else:
        assert any(e == ("pub", e[1], False) for e in ref if e[0] == "pub"), \
            "the script must exhaust the credits"
    assert got == ref


@pytest.fixture
def link():
    lk = make_link(tshm, "f", depth=64, mtu=256)
    yield lk
    lk.close()
    lk.unlink()


def test_publish_burst_matches_per_frag_lane(link):
    """fdr_publish_burst: one call, the per-frag lane's frames and credit gate."""
    prod = tn.NativeProducer(link)
    cons = tshm.Consumer(link, lazy=16)
    items = [(b"burst-%03d" % i, (i << 48) | 5, 10_000 + i) for i in range(100)]
    n = prod.publish_burst(items)
    assert n == link.depth  # one ring of frames, no more
    got = []
    while isinstance(res := cons.poll(), tuple):
        got.append(res)
    assert [p for _, p in got] == [it[0] for it in items[:n]]
    assert [(int(m[1]), int(m[5])) for m, _ in got] == [(it[1], it[2]) for it in items[:n]]
    cons.publish_progress()
    assert prod.publish_burst(items[n:]) == len(items) - n  # credits came back


def _two_inputs(link):
    link2 = make_link(tshm, "g", depth=64, mtu=256)
    p1, p2 = tn.NativeProducer(link), tn.NativeProducer(link2)
    c1, c2 = tn.NativeConsumer(link, lazy=64), tn.NativeConsumer(link2, lazy=64)
    for i in range(6):
        assert p1.try_publish(b"a%d" % i, sig=100 + i, tsorig=1 + i)
    for i in range(3):
        assert p2.try_publish(b"b%d" % i, sig=200 + i, tsorig=50 + i)
    return link2, [c1, c2]


WANT_RR = ([b"a0", b"b0", b"a1", b"b1", b"a2", b"b2", b"a3", b"a4", b"a5"],
           [0, 1, 0, 1, 0, 1, 0, 0, 0])


def test_drainer_round_robin_union(link):
    """fdr_drain: both inputs round-robin in one call; the meta table holds
    mcache columns with the arena offset and the input index."""
    link2, cons = _two_inputs(link)
    try:
        dr = tn.BurstDrainer(cons, max_frags=16)
        n, rr, d_ovr = dr.drain(0, 16)
        assert (n, d_ovr) == (9, 0)
        rows = dr.meta[:n]
        assert [dr.arena[int(r[2]) : int(r[2]) + int(r[3])].tobytes() for r in rows] == WANT_RR[0]
        assert [int(r[7]) for r in rows] == WANT_RR[1]
        assert [(int(r[1]), int(r[5])) for r in rows[:2]] == [(100, 1), (200, 50)]
        assert dr.drain(rr, 16)[0] == 0
    finally:
        del cons, dr
        link2.close()
        link2.unlink()


SWEEP_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                            ctypes.POINTER(ctypes.c_uint8))


class _Recorder:
    """A sweep client whose callback (a ctypes function) records each frag
    and asks the sweep to stop after `stop_after` frags."""

    def __init__(self, stop_after: int):
        self.got = []
        self.stop_after = stop_after
        self._fn = SWEEP_CB(self._cb)
        self.cb = ctypes.cast(self._fn, ctypes.c_void_p)
        self.cb_ctx = None

    def _cb(self, _ctx, meta, payload):
        sz = meta[3]
        self.got.append((meta[1], meta[7], ctypes.string_at(payload, sz)))
        return -1 if len(self.got) == self.stop_after else 0


def test_sweep_runs_the_callback_per_frag_in_drain_order(link):
    """fdr_sweep: the drain's order, the callback once per frag, and a
    negative return ends the sweep after that frag."""
    link2, cons = _two_inputs(link)
    try:
        client = _Recorder(stop_after=4)
        sw = tn.SweepDrainer(cons, 16, client)
        n, rr, _ = sw.sweep(0, 16)
        assert n == 4
        n2, _, _ = sw.sweep(rr, 16)
        assert n + n2 == 9
        assert [p for _, _, p in client.got] == WANT_RR[0]
        assert [i for _, i, _ in client.got] == WANT_RR[1]
    finally:
        del cons, sw
        link2.close()
        link2.unlink()


def test_close_detaches_every_endpoint(link):
    """close() detaches the registered endpoints of both lanes, so the
    mapping closes while they are still referenced; a detached endpoint
    refuses instead of reaching into unmapped memory."""
    prod = tn.NativeProducer(link)
    cons = tn.NativeConsumer(link)
    py_cons = tshm.Consumer(link)
    assert prod.try_publish(b"x", sig=1)
    assert isinstance(cons.poll(), tuple)
    dr = tn.BurstDrainer([cons], 4)
    link.close()
    assert prod._keep is None and cons._keep is None and py_cons.link is None
    with pytest.raises(RuntimeError):
        cons.poll()
    with pytest.raises(RuntimeError):
        prod.try_publish(b"y")
    with pytest.raises(RuntimeError):
        dr.drain(0, 4)


def test_fseq_indices_are_checked(link):
    with pytest.raises(IndexError):
        tn.NativeConsumer(link, fseq_idx=link.n_fseq)
    with pytest.raises(IndexError):
        tn.NativeProducer(link, reliable_fseq_idx=[link.n_fseq])
    with pytest.raises(IndexError):
        tshm.Consumer(link, fseq_idx=link.n_fseq)


@pytest.mark.parametrize("native", [True, False])
def test_the_argument_picks_the_lane(link, native):
    prod = tshm.make_producer(link, native=native)
    cons = tshm.make_consumer(link, lazy=3, native=native)
    assert type(prod) is (tn.NativeProducer if native else tshm.Producer)
    assert type(cons) is (tn.NativeConsumer if native else tshm.Consumer)
    assert cons.lazy == 3


@pytest.mark.parametrize("module", ["tango.native", "runtime.bank_native"])
def test_a_failed_build_raises(module, monkeypatch):
    """A g++ that fails raises HostBuildError: no lane falls back."""
    import importlib

    mod = importlib.import_module(f"firedancer_tpu_torch.{module}")
    monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setattr(hostbuild, "CXX", "false")
    monkeypatch.setattr(hostbuild, "_LIBS", {})
    with pytest.raises(hostbuild.HostBuildError):
        mod.load()


def test_no_segment_outlives_its_test():
    """Every link this process made in this file is gone from /dev/shm."""
    mine = f"_{os.getpid()}_"
    left = [f for f in os.listdir("/dev/shm") if f.startswith("fdtpu_torch_nr") and mine in f]
    assert left == []


def test_hostbuild_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    """A library's path hashes its source and the local headers it
    includes: an edited header names a new library (the old one is never
    loaded), and a header that breaks the build raises."""
    import shutil

    for f in ("fd_ring.cpp", "fd_metrics.h"):
        shutil.copy(os.path.join(hostbuild.NATIVE_DIR, f), tmp_path / f)
    monkeypatch.setattr(hostbuild, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(hostbuild, "BUILD_ROOT", str(tmp_path / "build"))
    assert hostbuild._sources_of(hostbuild.source("fd_ring")) == \
        [str(tmp_path / "fd_ring.cpp"), str(tmp_path / "fd_metrics.h")]
    first = hostbuild.so_path("fd_ring")
    hdr = tmp_path / "fd_metrics.h"
    hdr.write_text(hdr.read_text() + "\n// an edit\n")
    second = hostbuild.so_path("fd_ring")
    assert second != first
    assert hostbuild.build("fd_ring") == second and os.path.exists(second)
    hdr.write_text(hdr.read_text() + "\n#error a broken header\n")
    with pytest.raises(hostbuild.HostBuildError, match="broken header"):
        hostbuild.build("fd_ring")
