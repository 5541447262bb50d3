"""The port's ingress stages (runtime/net.py) over real loopback sockets,
against the JAX package's stages over the same datagrams: the UDP stage on
both lanes (the native recvmmsg sweep, native_net=True, and the Python
receive loop, native_net=False), the stream stage, and the QUIC stage on
both lanes with QuicTxnClients.  Payloads, sigs and counters are equal,
the MTU drop included, and under backpressure the native lane keeps the
tail and publishes it in order."""

from __future__ import annotations

import hashlib
import socket
import threading
import time

import pytest

from firedancer_tpu.runtime import net as jnet
from firedancer_tpu_torch.ops.ref import ed25519_ref as tref
from firedancer_tpu_torch.runtime import net as tnet

IDENTITY = hashlib.sha256(b"net-loopback").digest()
COUNTERS = ("pkt_rx", "oversize_drop", "pkt_drop_backpressure", "frags_out", "backpressure",
            "frame_rx", "bad_frame", "txn_rx", "txn_drop_backpressure")


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


def _payloads(seed: bytes, sizes) -> list[bytes]:
    out = []
    for i, n in enumerate(sizes):
        h, buf = hashlib.sha256(seed + bytes([i])), b""
        while len(buf) < n:
            h = hashlib.sha256(h.digest())
            buf += h.digest()
        out.append(buf[:n])
    return out


def _stage(pkg: str, cls: str, native: bool, monkeypatch, credits=None, **kw):
    out = Collector(credits)
    if pkg == "jax":
        monkeypatch.setenv("FDTPU_NATIVE_NET", "1" if native else "0")
        st = getattr(jnet, cls)("net", outs=[out], **kw)
    else:
        st = getattr(tnet, cls)("net", outs=[out], native_net=native, **kw)
    return st, out


def _counters(st) -> dict:
    return {k: st.metrics.get(k) for k in COUNTERS if st.metrics.get(k)}


def _drain(st, want: int, out, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while len(out.frames) < want and time.monotonic() < deadline:
        st.after_credit()
        time.sleep(0.001)


SIZES = (8, 300, 1232, 96, 1500, 1, 1232, 700, 64, 2000, 150)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_udp_stage_equals_the_jax_stage(native, monkeypatch):
    """Eleven datagrams, two past the MTU, at each stage: the nine others
    published in order with sigs 1..9, two counted oversize_drop."""
    data = _payloads(b"udp", SIZES)
    runs = []
    for pkg in ("port", "jax"):
        st, out = _stage(pkg, "UdpIngressStage", native, monkeypatch, rx_burst=4)
        assert (st._net_client is not None) == native
        try:
            tnet.send_txns(st.addr, data)
            _drain(st, 9, out)
            for _ in range(3):
                st.after_credit()  # a dry socket changes nothing
            runs.append((out.frames, _counters(st)))
        finally:
            st.close()
        assert st.sock.fileno() == -1
    assert runs[0] == runs[1]
    frames, cnt = runs[0]
    assert [p for p, _ in frames] == [d for d in data if len(d) <= 1232]
    assert [s for _, s in frames] == list(range(1, 10))
    assert cnt["pkt_rx"] == 9 and cnt["oversize_drop"] == 2


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_udp_stage_backpressure_equals_the_jax_stage(native, monkeypatch):
    """Three credits for ten datagrams: the native lane keeps the credit-gated
    tail in C and, once the gate lifts, publishes it in order with stable
    sigs; the Python lane drops the datagram it could not publish and
    leaves the rest on the socket, in each of the two gated sweeps.  Both packages count it the same way."""
    data = _payloads(b"bp", (100,) * 10)
    runs = []
    for pkg in ("port", "jax"):
        st, out = _stage(pkg, "UdpIngressStage", native, monkeypatch, credits=3, rx_burst=8)
        try:
            tnet.send_txns(st.addr, data)
            time.sleep(0.05)  # every datagram queued before the gated sweeps
            st.after_credit()
            st.after_credit()
            mid = (list(out.frames), _counters(st))
            out.credits = None
            _drain(st, 10 if native else 8, out)
            runs.append((mid, out.frames, _counters(st)))
        finally:
            st.close()
    assert runs[0] == runs[1]
    (mid_frames, mid_cnt), frames, cnt = runs[0]
    assert len(mid_frames) == 3 and mid_cnt["pkt_drop_backpressure"] > 0
    if native:
        assert [p for p, _ in frames] == data  # nothing lost, nothing reordered
        assert [s for _, s in frames] == list(range(1, 11))
    else:
        # each gated sweep dropped the datagram it could not publish
        assert [p for p, _ in frames] == data[:3] + data[5:]


def test_udp_stage_scalar_sweep_equals_the_recvmmsg_sweep(monkeypatch):
    """native_sweep(scalar=True), the explicit per-datagram recv, publishes
    the same frames and counts as the default sweep."""
    data = _payloads(b"scalar", SIZES)
    runs = []
    for scalar in (False, True):
        st, out = _stage("port", "UdpIngressStage", True, monkeypatch, rx_burst=4)
        try:
            tnet.send_txns(st.addr, data)
            for _ in range(200):
                if len(out.frames) >= 9:
                    break
                st.native_sweep(scalar=scalar)
            runs.append((out.frames, _counters(st), st._net_client.counters()["udp_pkts"]))
        finally:
            st.close()
    assert runs[0] == runs[1] and runs[0][2] == len(data)


def test_stream_stage_equals_the_jax_stage(monkeypatch):
    """Fragmented txns from two senders that reuse the same (conn, stream)
    ids, a one-frame txn, an empty txn, a short datagram and a bad magic:
    the slot is keyed by sender, so both txns arrive whole."""
    txns = _payloads(b"stream", (1232, 700, 1, 513))
    runs = []
    for pkg in ("port", "jax"):
        st, out = _stage(pkg, "StreamIngressStage", False, monkeypatch, reasm_depth=8)
        try:
            a = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            b = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for off in range(0, 1232, 400):  # interleaved, same ids
                fin = off + 400 >= 1232
                a.sendto(tnet.encode_stream_frame(7, 0, txns[0][off:off + 400], fin), st.addr)
                if off < 700:
                    b.sendto(tnet.encode_stream_frame(7, 0, txns[1][off:off + 400],
                                                      off + 400 >= 700), st.addr)
            a.sendto(b"short", st.addr)
            a.sendto(b"FDSX" + bytes(30), st.addr)
            a.close()
            b.close()
            tnet.send_stream_txn(st.addr, txns[2], conn_id=3)
            tnet.send_stream_txn(st.addr, b"", conn_id=4)
            tnet.send_stream_txn(st.addr, txns[3], conn_id=5, frame_sz=100)
            _drain(st, 5, out)
            runs.append((sorted(out.frames), _counters(st), st.reasm.metrics, st.reasm.active()))
        finally:
            st.close()
    assert runs[0] == runs[1]
    frames, cnt, _, active = runs[0]
    assert sorted(p for p, _ in frames) == sorted(txns + [b""])
    assert cnt["bad_frame"] == 2 and cnt["txn_rx"] == 5 and active == 0


def _quic_run(pkg: str, native: bool, monkeypatch, txns_by_client) -> tuple:
    """QuicTxnClients on loopback sockets against one stage: each client's
    txns on streams 2, 6, 10, ...; the stage swept until every txn is out."""
    st, out = _stage(pkg, "QuicIngressStage", native, monkeypatch, rx_burst=32,
                     identity_secret=IDENTITY)
    clients = []
    try:
        for _ in txns_by_client:
            box = {}
            th = threading.Thread(target=lambda: box.setdefault("c", tnet.QuicTxnClient(
                st.addr, expected_peer=tref.public_key(IDENTITY))))
            th.start()
            deadline = time.monotonic() + 60
            while th.is_alive() and time.monotonic() < deadline:
                st.after_credit()
            th.join(1)
            clients.append(box["c"])
        want = sum(len(t) for t in txns_by_client)
        for c, txns in zip(clients, txns_by_client):
            for t in txns:
                c.send_txn(t)
        deadline = time.monotonic() + 60
        while len(out.frames) < want and time.monotonic() < deadline:
            st.after_credit()
            for c in clients:
                c.pump()
        net = st.net_counters()
        return out.frames, st.metrics.get("txn_rx"), net
    finally:
        for c in clients:
            c.close()
        st.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_quic_stage_on_loopback_equals_the_jax_stage(native, monkeypatch):
    """Two clients, three txns each (one at the MTU): every txn whole, each
    client's in order, on the port's stage and the JAX package's."""
    txns = [_payloads(b"q%d" % i, (64, 700, 1232)) for i in range(2)]
    port = _quic_run("port", native, monkeypatch, txns)
    jax_ = _quic_run("jax", native, monkeypatch, txns)
    for frames, txn_rx, net in (port, jax_):
        got = [p for p, _ in frames]
        assert sorted(got) == sorted(txns[0] + txns[1]) and txn_rx == 6
        for t in txns:
            assert [p for p in got if p in t] == t
        assert [s for _, s in frames] == list(range(1, 7))
        assert (net.get("consumed", 0) > 0) == native
    assert sorted(port[0]) == sorted(jax_[0])


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_quic_stage_delivers_a_retransmitted_stream_once(native):
    """The stage is not swept until the client's PTO has fired (its ACKs
    late), so every stream arrives twice over loopback: each txn goes out
    once, on both lanes."""
    st, out = _stage("port", "QuicIngressStage", native, None, identity_secret=IDENTITY)
    c = None
    try:
        box = {}
        th = threading.Thread(target=lambda: box.setdefault("c", tnet.QuicTxnClient(
            st.addr, expected_peer=tref.public_key(IDENTITY))))
        th.start()
        deadline = time.monotonic() + 60
        while th.is_alive() and time.monotonic() < deadline:
            st.after_credit()
        th.join(1)
        c = box["c"]
        txns = _payloads(b"pto", (64, 700, 1232))
        for t in txns:
            c.send_txn(t)
        deadline = time.monotonic() + 10
        while not c.conn.pto_count and time.monotonic() < deadline:
            time.sleep(0.01)
            c.conn.poll_timers()
        assert c.conn.pto_count > 0
        c._flush_out()  # the retransmissions
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            st.after_credit()
            c.pump()
        assert [p for p, _ in out.frames] == txns and st.metrics.get("txn_rx") == 3
    finally:
        if c is not None:
            c.close()
        st.close()
