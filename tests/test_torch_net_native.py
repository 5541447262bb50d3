"""The port's native net client (runtime/net_native.py over the port's
native/fd_net.cpp) against the JAX package's, on the JAX package's
differential corpus: honest, garbled, duplicate and oversize streams, an
unknown CID, a handshake mid-stream, control frames spliced between
stream datagrams, a replayed punted datagram and a credit-gated tail.

Each scenario drives a client against the port's QuicIngressStage on the
native lane, with its NetClient wrapped in a recorder: every call the
stage makes (connection installs, datagrams, pn and window syncs, event
clears, out pops) is logged with the client's state after it (return
code, event rows, queued out txns, counters).  The same calls then go to
a JAX NetClient, and to a port NetClient on the scalar AES/GHASH path
(simd_force(False)): every return code, event, out txn and counter is
equal.  The published frames (payloads and sigs) of the port's stage on
both lanes and the JAX package's stage on both lanes are equal too, and
so are their counters over what never becomes a connection (Version
Negotiation, short and garbage Initials, Retry).  Then the plain-UDP
sweep: udp_sweep and udp_sweep_scalar of both packages over the same
socket load."""

from __future__ import annotations

import hashlib
import os
import socket
import time
from collections import deque

import pytest

from firedancer_tpu.runtime import net as jnet
from firedancer_tpu.runtime import net_native as jnn
from firedancer_tpu.waltz import quic as jq
from firedancer_tpu_torch.ops.ref import ed25519_ref as tref
from firedancer_tpu_torch.runtime import net as tnet
from firedancer_tpu_torch.runtime import net_native as tnn
from firedancer_tpu_torch.waltz import quic as tq

IDENTITY = hashlib.sha256(b"net-native-diff").digest()
# the calls that change a client's state, replayed in order
_CALLS = ("conn_add", "conn_remove", "conn_set_addr", "conn_window", "conn_pn_add",
          "conn_stream_done", "datagram", "events_clear", "out_pop")


class VSock:
    """The stage's socket, virtualized: outbound datagrams queue by
    destination; inbound ones are injected into _on_datagram."""

    def __init__(self):
        self.tx: dict = {}

    def setblocking(self, flag) -> None:
        pass

    def getsockname(self):
        return ("virtual", 0)

    def recvfrom(self, n: int):
        raise BlockingIOError

    def sendto(self, dg: bytes, dst) -> None:
        self.tx.setdefault(dst, deque()).append(bytes(dg))

    def close(self) -> None:
        pass


class Collector:
    """A producer stub: records every published (payload, sig); an optional
    credit budget gates it."""

    def __init__(self, credits=None):
        self.frames = []
        self.credits = credits

    def try_publish(self, payload, sig=0, tsorig=0):
        if self.credits is not None:
            if self.credits <= 0:
                return False
            self.credits -= 1
        self.frames.append((bytes(payload), sig))
        return True

    def payloads(self):
        return [p for p, _ in self.frames]


def snapshot(nc, ret) -> tuple:
    n_ev = nc.event_count()
    return (ret, [tuple(int(x) for x in nc.events[i]) for i in range(n_ev)],
            [(nc.out_txn(i), int(nc.out_tbl[i, 2]), int(nc.out_tbl[i, 3]))
             for i in range(nc.out_count())], nc.counters())


class Recorder:
    """Wraps a NetClient: the state-changing calls are logged with the
    client's snapshot after each; everything else passes through."""

    def __init__(self, inner):
        self._inner = inner
        self.log = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in _CALLS:
            return attr

        def call(*args):
            ret = attr(*args)
            self.log.append((name, args, snapshot(self._inner, ret)))
            return ret

        return call


def replay(log, nc, skip=()) -> None:
    """The logged calls on `nc`; every snapshot equal (counters named in
    skip left out)."""
    for i, (name, args, want) in enumerate(log):
        got = snapshot(nc, getattr(nc, name)(*args))
        drop = lambda s: s[:3] + ({k: v for k, v in s[3].items() if k not in skip},)  # noqa: E731
        assert drop(got) == drop(want), (i, name)


class Driver:
    """An in-process QUIC client against a stage on a VSock."""

    def __init__(self, stage, addr, quic=tq, *, mangle=None):
        self.stage, self.addr, self.mangle = stage, addr, mangle
        self.conn = quic.Connection.client_new(expected_peer=tref.public_key(IDENTITY))
        self.next_sid = 2
        self.pump()
        assert self.conn.established

    def inject(self, dg: bytes) -> None:
        for d in ([dg] if self.mangle is None else self.mangle(dg)):
            self.stage._on_datagram(d, self.addr)

    def pump(self, rounds: int = 40) -> None:
        for _ in range(rounds):
            moved = False
            for dg in self.conn.flush():
                moved = True
                self.inject(dg)
            q = self.stage.sock.tx.get(self.addr)
            while q:
                moved = True
                self.conn.receive(q.popleft())
            if not moved:
                return

    def send_txn(self, txn: bytes) -> None:
        sid = self.next_sid
        self.next_sid += 4
        self.conn.send_stream(sid, txn, fin=True)
        self.pump()


def txn_set(seed: bytes, sizes=(1, 96, 512, 900, 1232)) -> list[bytes]:
    out = []
    for i, n in enumerate(sizes):
        h, buf = hashlib.sha256(seed + bytes([i])), b""
        while len(buf) < n:
            h = hashlib.sha256(h.digest() + seed)
            buf += h.digest()
        out.append(buf[:n])
    return out


# -- the corpus: drive(stage) on any package's stage, quic its client's ---------


def honest(st, quic):
    txns = txn_set(b"honest")
    d = Driver(st, ("c", 1), quic)
    for t in txns:
        d.send_txn(t)
    st.after_credit()
    return txns


def garbled(st, quic):
    """Every steady-state datagram twinned with one flipped ciphertext byte:
    the twin fails authentication, the honest stream arrives."""
    def mangle(dg):
        if dg[0] & 0x80:
            return [dg]  # the handshake untouched
        bad = bytearray(dg)
        bad[-1] ^= 0x5A
        return [bytes(bad), dg]

    txns = txn_set(b"garble", sizes=(64, 700, 1232))
    d = Driver(st, ("c", 1), quic, mangle=mangle)
    for t in txns:
        d.send_txn(t)
    st.after_credit()
    assert st.metrics.get("bad_packet") > 0
    return txns


def duplicate(st, quic):
    txns = txn_set(b"dup", sizes=(96, 1100))
    d = Driver(st, ("c", 1), quic, mangle=lambda dg: [dg, dg])
    for t in txns:
        d.send_txn(t)
    st.after_credit()
    return txns


def oversize(st, quic):
    """A stream past TXN_MTU publishes nothing; the streams around it do."""
    good = txn_set(b"oversz-good", sizes=(96, 1232))
    d = Driver(st, ("c", 1), quic)
    d.send_txn(good[0])
    sid = d.next_sid
    d.next_sid += 4
    d.conn.send_stream(sid, b"\xAA" * 2000, fin=True)
    d.pump()
    d.send_txn(good[1])
    st.after_credit()
    return good


def unknown_cid(st, quic):
    """A short header from an unknown address and CID: a stateless reset
    committing to the token of that CID."""
    dg = b"\x40" + b"\x77" * 8 + bytes(range(40))
    st._on_datagram(dg, ("stranger", 9))
    reset = st.sock.tx[("stranger", 9)].popleft()
    assert not reset[0] & 0x80 and st.metrics.get("stateless_reset_tx") == 1
    assert reset[-16:] == tq.stateless_reset_token(
        hashlib.sha256(b"quic-static:" + IDENTITY).digest(), b"\x77" * 8)
    return []


def mid_stream_handshake(st, quic):
    """A second client handshakes (long headers punt) while the first
    streams through the fast path."""
    a, b = txn_set(b"mid-a", sizes=(200, 800)), txn_set(b"mid-b", sizes=(96,))
    da = Driver(st, ("a", 1), quic)
    da.send_txn(a[0])
    db = Driver(st, ("b", 2), quic)
    da.send_txn(a[1])
    db.send_txn(b[0])
    st.after_credit()
    return [a[0], a[1], b[0]]


def control_splice(st, quic):
    """PATH_CHALLENGE probes (punted) between stream datagrams (consumed)
    on one connection: the punted pns reach the native dedup window."""
    txns = txn_set(b"splice", sizes=(96, 600, 1232))
    d = Driver(st, ("c", 1), quic)
    for i, t in enumerate(txns):
        probe = d.conn.probe_datagram(bytes([quic.FT_PATH_CHALLENGE]) + bytes([i]) * 8)
        st._on_datagram(probe, d.addr)
        d.pump()
        d.send_txn(t)
    st.after_credit()
    d.pump()
    return txns


def punted_replay(st, quic):
    """A punted control datagram replayed: deduplicated, not processed twice."""
    d = Driver(st, ("c", 1), quic)
    probe = d.conn.probe_datagram(bytes([quic.FT_PATH_CHALLENGE]) + b"\x11" * 8)
    st._on_datagram(probe, d.addr)
    before = st.net_counters().get("dup")
    st._on_datagram(probe, d.addr)
    if before is not None:
        assert st.net_counters()["dup"] == before + 1
    t = txn_set(b"replay", sizes=(300,))
    d.send_txn(t[0])
    st.after_credit()
    return t


def backpressure(st, quic):
    """Two credits for six txns: the rest is queued (native lane) and goes
    out in order, with stable sigs, once the gate lifts."""
    txns = txn_set(b"bp", sizes=(96,) * 6)
    out = st.outs[0]
    out.credits = 2
    d = Driver(st, ("c", 1), quic)
    for t in txns:
        d.send_txn(t)
    assert len(out.frames) == 2 and st.metrics.get("txn_drop_backpressure") > 0
    if st._net_client is not None:
        assert st.net_counters()["tail_retained"] > 0
        out.credits = None
        st.after_credit()
        assert [s for _, s in out.frames] == list(range(1, len(txns) + 1))
        return txns
    out.credits = None
    return txns[:2]


CORPUS = [honest, garbled, duplicate, oversize, unknown_cid, mid_stream_handshake,
          control_splice, punted_replay, backpressure]


def _port_stage(native: bool, recorder: bool = False):
    st = tnet.QuicIngressStage("quic", outs=[Collector()], sock=VSock(), rx_burst=8,
                               identity_secret=IDENTITY, native_net=native)
    if recorder:
        st._net_client = Recorder(st._net_client)
    return st


def _jax_stage(native: bool, monkeypatch):
    monkeypatch.setenv("FDTPU_NATIVE_NET", "1" if native else "0")
    st = jnet.QuicIngressStage("quic", outs=[Collector()], sock=VSock(), rx_burst=8,
                               identity_secret=IDENTITY)
    assert (st._net_client is not None) == native
    return st


@pytest.mark.parametrize("drive", CORPUS, ids=[d.__name__ for d in CORPUS])
def test_corpus_native_clients_and_stages_equal_the_jax_ones(drive, monkeypatch):
    st = _port_stage(True, recorder=True)
    want = drive(st, tq)
    rec = st._net_client
    frames = st.outs[0].frames
    assert st.outs[0].payloads() == want
    st._net_client = rec._inner
    st.close()
    assert any(name == "datagram" for name, _, _ in rec.log)
    # the same calls on the JAX package's client
    j = jnn.NetClient(max_conns=64, reasm_depth=64)
    try:
        replay(rec.log, j)
    finally:
        j.close()
    # the same calls on the scalar AES/GHASH path
    tnn.simd_force(False)
    try:
        s = tnn.NetClient(max_conns=64, reasm_depth=64)
        try:
            replay(rec.log, s, skip=("aesni", "pclmul"))
            assert s.counters()["aesni"] == s.counters()["pclmul"] == 0
        finally:
            s.close()
    finally:
        tnn.simd_force(True)
    # the published frames of both packages' stages on both lanes
    for make in (lambda: _port_stage(False), lambda: _jax_stage(True, monkeypatch),
                 lambda: _jax_stage(False, monkeypatch)):
        other = make()
        got = drive(other, jq if isinstance(other, jnet.QuicIngressStage) else tq)
        if drive is backpressure and other._net_client is None:
            # the Python lane drops the completed txns it cannot publish
            assert other.outs[0].frames == frames[:2]
        else:
            assert got == want and other.outs[0].frames == frames, make
        other.close()


# -- plain UDP: recvmmsg against one recv a datagram, both packages ----------------


def _sweep_drain(client, method: str, payloads):
    """A fresh loopback socket, the payloads sent at it, drained with the
    named sweep three datagrams at a time (so sweeps resume): (rows' txns in
    order, counters)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.bind(("127.0.0.1", 0))
        s.setblocking(False)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            for p in payloads:
                tx.sendto(p, s.getsockname())
        finally:
            tx.close()
        sweep, txns = getattr(client, method), []
        deadline = time.monotonic() + 60
        while client.counters()["udp_pkts"] < len(payloads) and time.monotonic() < deadline:
            sweep(s.fileno(), 3)
            n = client.out_count()
            txns.extend(client.out_txn(i) for i in range(n))
            client.out_pop(n)
        return txns, client.counters()
    finally:
        s.close()
        client.close()


@pytest.mark.parametrize("method", ["udp_sweep", "udp_sweep_scalar"])
def test_udp_sweeps_equal_each_other_and_the_jax_ones(method):
    sizes = (1, 17, 200, 1232, 900, 1232, 64)
    payloads = [bytes([i + 1]) * sz for i, sz in enumerate(sizes)]
    payloads.insert(3, b"J" * 1400)  # past the MTU: dropped and counted, no row
    got = _sweep_drain(tnn.NetClient(max_conns=1, reasm_depth=1), method, payloads)
    for other in (_sweep_drain(jnn.NetClient(max_conns=1, reasm_depth=1), method, payloads),
                  _sweep_drain(tnn.NetClient(max_conns=1, reasm_depth=1),
                               {"udp_sweep": "udp_sweep_scalar",
                                "udp_sweep_scalar": "udp_sweep"}[method], payloads)):
        assert got[0] == other[0]
        assert {k: got[1][k] for k in ("udp_pkts", "oversz")} == \
            {k: other[1][k] for k in ("udp_pkts", "oversz")}
    assert [len(t) for t in got[0]] == list(sizes)
    assert got[1]["oversz"] == 1 and got[1]["udp_pkts"] == len(payloads)


def test_bad_key_lengths_raise_like_the_jax_client():
    for mod in (tnn, jnn):
        with pytest.raises(ValueError):
            mod.aes_ecb_blocks(b"short", bytes(16))
        with pytest.raises(ValueError):
            mod.gcm_seal(bytes(24), bytes(12), b"", b"")
        with pytest.raises(ValueError):
            mod.gcm_open(bytes(24), bytes(12), b"", bytes(16), b"")
    assert tnn.simd_features() == jnn.simd_features()
    assert os.path.dirname(tnn.hostbuild.so_path("fd_net")).startswith(tnn.hostbuild.BUILD_ROOT)


def hardening(st, quic):
    """What one peer may send that never becomes a connection: a long header
    in an unknown version (answered with Version Negotiation when 1,200
    bytes or more), a version-0 packet and a short Initial (dropped
    silently), a 1,200-byte v1 Initial of garbage (its exception caught and
    counted bad_packet); then an honest client through the stage."""
    vn = bytes([0xC0]) + bytes.fromhex("babababa") + b"\x08" + b"D" * 8 + b"\x08" + b"S" * 8
    st._on_datagram(vn + bytes(1200 - len(vn)), ("vn", 1))
    (reply,) = st.sock.tx[("vn", 1)]
    assert quic.is_version_negotiation(reply)
    st._on_datagram(bytes([0xC0]) + bytes(4) + bytes(1195), ("zero", 1))
    st._on_datagram(bytes([0xC0]) + (1).to_bytes(4, "big") + b"\x08" + b"D" * 8 + bytes(100),
                    ("small", 1))
    garbage = bytes([0xC0]) + (1).to_bytes(4, "big") + b"\x08" + b"G" * 8 + b"\x08" + b"S" * 8
    st._on_datagram(garbage + bytes(range(256)) * 5, ("garbage", 1))
    assert ("zero", 1) not in st.sock.tx and ("small", 1) not in st.sock.tx
    assert not st.conns.get(("garbage", 1))
    txns = txn_set(b"hardening", sizes=(64, 1232))
    d = Driver(st, ("c", 1), quic)
    for t in txns:
        d.send_txn(t)
    st.after_credit()
    return txns


HARDENING_COUNTERS = ("version_negotiation_tx", "small_initial_dropped", "bad_packet",
                      "retry_tx", "txn_rx", "conn_drop", "stateless_reset_tx")


@pytest.mark.parametrize("retry", [False, True], ids=["no-retry", "retry"])
def test_hardening_and_retry_equal_the_jax_stage(retry, monkeypatch):
    """hardening() on the port's and the JAX package's stages, both lanes,
    with and without Retry address validation: the same frames and the same
    counters (with retry=True an Initial without a token costs a Retry and
    no connection)."""
    runs = []
    for pkg, native in (("port", True), ("port", False), ("jax", True), ("jax", False)):
        if pkg == "port":
            st = tnet.QuicIngressStage("quic", outs=[Collector()], sock=VSock(), rx_burst=8,
                                       identity_secret=IDENTITY, native_net=native, retry=retry)
        else:
            monkeypatch.setenv("FDTPU_NATIVE_NET", "1" if native else "0")
            st = jnet.QuicIngressStage("quic", outs=[Collector()], sock=VSock(), rx_burst=8,
                                       identity_secret=IDENTITY, retry=retry)
        got = hardening(st, tq if pkg == "port" else jq)
        runs.append((got, st.outs[0].frames,
                     {k: st.metrics.get(k) for k in HARDENING_COUNTERS}))
        st.close()
    assert all(r == runs[0] for r in runs[1:])
    got, frames, cnt = runs[0]
    assert [p for p, _ in frames] == got
    assert cnt["version_negotiation_tx"] == 1 and cnt["small_initial_dropped"] == 1
    # with retry=True a Retry answers the garbage Initial (its token is
    # empty, so nothing is decrypted) and the client's first Initial
    assert cnt["retry_tx"] == (2 if retry else 0)
    assert cnt["bad_packet"] == (0 if retry else 1)


# -- exactly once: a stream that arrives again (its ACK lost or late) ----------------------


def _resend(d, sid: int, txn: bytes, punt: bool) -> None:
    """Stream `sid` whole again in a new packet, as a retransmission after a
    lost ACK carries it; punt=True puts a PATH_CHALLENGE beside it, which
    the fast path hands to the Python connection."""
    frames = tq.stream_frame(sid, 0, txn, True)
    if punt:
        frames = bytes([tq.FT_PATH_CHALLENGE]) + b"\x22" * 8 + frames
    d.inject(d.conn.probe_datagram(frames))
    d.pump()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_a_stream_that_arrives_again_is_delivered_once(native):
    """Each txn goes out once however often its stream arrives: again on
    the fast path after the fast path delivered it (adding nothing to the
    flow accounting), again in a punted datagram after the fast path
    delivered it, and again on the fast path after a punted datagram
    delivered it."""
    st = _port_stage(native)
    try:
        d = Driver(st, ("c", 1))
        a, b = txn_set(b"once", sizes=(300, 900))
        d.send_txn(a)
        _resend(d, 2, a, punt=False)
        assert st.conns[("c", 1)].rx_data_total == len(a)
        _resend(d, 2, a, punt=True)
        _resend(d, 6, b, punt=True)
        _resend(d, 6, b, punt=False)
        st.after_credit()
        assert st.outs[0].payloads() == [a, b] and st.metrics.get("txn_rx") == 2
        if native:
            net = st.net_counters()
            assert net["txn"] == 1 and net["consumed"] >= 3 and net["punt"] >= 2
    finally:
        st.close()


def test_the_finished_stream_window():
    """The native client's finished-stream record a connection: streams
    finished out of order, a window of 256 a stream type past the finished
    prefix, and a stream past the window sliding it (the streams left
    below it count as finished)."""
    nc = tnn.NetClient(max_conns=4, reasm_depth=4)
    try:
        idx = nc.conn_add(b"\x01" * 8, 1, b"\x02" * 16, b"\x03" * 12, b"\x04" * 16, [], 1 << 20, 0)
        assert idx >= 0
        uni = lambda k: 4 * k + 2  # noqa: E731
        for k in (0, 1, 3, 200):
            nc.conn_stream_done(idx, uni(k))
        done = lambda k: nc.conn_stream_is_done(idx, uni(k))  # noqa: E731
        assert [done(k) for k in (0, 1, 2, 3, 4, 199, 200, 201)] == [
            True, True, False, True, False, False, True, False]
        assert not nc.conn_stream_is_done(idx, 0) and not nc.conn_stream_is_done(idx, 4)
        nc.conn_stream_done(idx, uni(2))  # the prefix now runs to 3
        assert done(2) and not done(4) and not done(3 + 256) and not done(300)
        nc.conn_stream_done(idx, uni(300))  # past 4 + 255: the window slides to 45
        assert [done(k) for k in (4, 44, 45, 199, 200, 299, 300, 301)] == [
            True, True, False, False, True, False, True, False]
        idx2 = nc.conn_add(b"\x05" * 8, 2, b"\x02" * 16, b"\x03" * 12, b"\x04" * 16, [],
                           1 << 20, 0)
        assert idx2 != idx and not nc.conn_stream_is_done(idx2, uni(0))
    finally:
        nc.close()
