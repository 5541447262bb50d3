"""The port's QUIC and TLS 1.3 (waltz/quic.py, waltz/tls13.py) against RFC
9001 Appendix A and the JAX package's waltz: the initial secrets, the
server's protected Initial and the Retry integrity tag of the appendix;
varints, packet seal/open, frame parsing, Retry building and stateless
reset tokens on seeded inputs, byte-equal to the JAX package's; and the
handshake both ways across the packages (a JAX client against the port's
server, the port's client against a JAX server), each carrying streams
that arrive equal."""

import hashlib

import numpy as np
import pytest

from firedancer_tpu.ops.ref import ed25519_ref as jref
from firedancer_tpu.waltz import quic as jq
from firedancer_tpu.waltz import tls13 as jtls
from firedancer_tpu_torch.ops.ref import ed25519_ref as tref
from firedancer_tpu_torch.waltz import quic as tq
from firedancer_tpu_torch.waltz import tls13 as ttls

H = bytes.fromhex
DCID = H("8394c8f03e515708")
# RFC 9001 A.3: the server's Initial (ACK and the ServerHello's CRYPTO frame)
SERVER_INITIAL = H(
    "cf000000010008f067a5502a4262b5004075c0d95a482cd0991cd25b0aac406a"
    "5816b6394100f37a1c69797554780bb38cc5a99f5ede4cf73c3ec2493a1839b3"
    "dbcba3f6ea46c5b7684df3548e7ddeb9c3bf9c73cc3f3bded74b562bfb19fb84"
    "022f8ef4cdd93795d77d06edbb7aaf2f58891850abbdca3d20398c276456cbc4"
    "2158407dd074ee")
SERVER_PAYLOAD = H(
    "02000000000600405a020000560303eefce7f7b37ba1d1632e96677825ddf739"
    "88cfc79825df566dc5430b9a045a1200130100002e00330024001d00209d3c94"
    "0d89690b84d08a60993c144eca684d1081287c834d5311bcf32bb9da1a002b00"
    "020304")
# RFC 9001 A.4: a Retry to the client of A.2
RETRY = H("ff000000010008f067a5502a4262b5746f6b656e04a265ba2eff4d829058fb3f0f2496ba")


def test_rfc9001_initial_secrets_and_keys():
    csec, ssec = tq.initial_secrets(DCID)
    assert csec == H("c00cf151ca5be075ed0ebfb5c80323c42d6b7db67881289af4008f1f6c357aea")
    assert ssec == H("3c199828fd139efd216c155ad844cc81fb82fa8d7446fa7d78be803acdda951b")
    assert tq.Keys.from_secret(csec).iv == H("fa044b2f42a3fd3b46fb255c")
    assert ttls.hkdf_expand_label(csec, "quic key", b"", 16) == H("1f369613dd76d5467730efcbe3b1a22d")
    assert ttls.hkdf_expand_label(csec, "quic hp", b"", 16) == H("9f50449e04a0e810283a1e9933adedd2")
    assert (csec, ssec) == jq.initial_secrets(DCID)


def test_rfc9001_server_initial_opens_and_seals_back():
    _, ssec = tq.initial_secrets(DCID)
    keys = tq.Keys.from_secret(ssec)
    pkt, end = tq.open_packet(SERVER_INITIAL, 0, lambda lvl, d: keys, short_dcid_len=8)
    assert end == len(SERVER_INITIAL)
    assert (pkt.level, pkt.pn, pkt.payload) == (tq.INITIAL, 1, SERVER_PAYLOAD)
    assert pkt.dcid == b"" and pkt.scid == H("f067a5502a4262b5")
    # the port's sealing (2-byte packet numbers, as the appendix's) gives
    # the appendix's bytes back
    assert tq.seal_packet(keys, level=tq.INITIAL, dcid=b"", scid=pkt.scid, pn=1,
                          payload=SERVER_PAYLOAD) == SERVER_INITIAL


def test_rfc9001_retry_integrity_tag():
    assert tq.retry_integrity_tag(DCID, RETRY[:-16]) == RETRY[-16:]
    # the appendix sets the first byte's four unused bits; build_retry
    # leaves them 0, so its tag covers its own first byte
    r = tq.build_retry(odcid=DCID, dcid=b"", scid=H("f067a5502a4262b5"), token=b"token")
    assert r[0] == 0xF0 and r[1:-16] == RETRY[1:-16]
    assert r[-16:] == tq.retry_integrity_tag(DCID, r[:-16])
    assert tq.parse_retry(RETRY) == jq.parse_retry(RETRY)
    assert tq.parse_retry(r) == jq.parse_retry(r)


def _rng_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_varints_equal_the_jax_encoding():
    rng = np.random.default_rng(9000)
    vals = [0, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30, (1 << 62) - 1]
    vals += [int(rng.integers(0, 1 << int(rng.integers(1, 62)))) for _ in range(200)]
    for v in vals:
        enc = tq.varint_encode(v)
        assert enc == jq.varint_encode(v)
        assert tq.varint_decode(enc, 0) == (v, len(enc))
    for bad in (tq.varint_encode, jq.varint_encode):
        with pytest.raises((tq.QuicError, jq.QuicError)):
            bad(1 << 62)
    with pytest.raises(tq.QuicError):
        tq.varint_decode(H("c2197c"), 0)


def test_seeded_packets_seal_and_open_equal_the_jax_ones():
    rng = np.random.default_rng(9001)
    for i in range(24):
        secret = _rng_bytes(rng, 32)
        level = [tq.INITIAL, tq.HANDSHAKE, tq.APPLICATION][i % 3]
        dcid, scid = _rng_bytes(rng, 8), _rng_bytes(rng, 8)
        pn = int(rng.integers(0, 1 << 14))
        payload = _rng_bytes(rng, int(rng.integers(20, 1100)))
        tk, jk = tq.Keys.from_secret(secret), jq.Keys.from_secret(secret)
        pkt = tq.seal_packet(tk, level=level, dcid=dcid, scid=scid, pn=pn, payload=payload)
        assert pkt == jq.seal_packet(jk, level=level, dcid=dcid, scid=scid, pn=pn,
                                     payload=payload)
        out, end = tq.open_packet(pkt, 0, lambda lvl, d: tk, short_dcid_len=8,
                                  largest_for_level=lambda lvl: pn - 1)
        assert end == len(pkt) and (out.level, out.pn, out.payload, out.dcid) == \
            (level, pn, payload, dcid)
        bad = bytearray(pkt)
        bad[-1 - i % 16] ^= 1
        with pytest.raises(tq.QuicError, match="authentication"):
            tq.open_packet(bytes(bad), 0, lambda lvl, d: tk, short_dcid_len=8,
                           largest_for_level=lambda lvl: pn - 1)


def _frames(mod, ev):
    """parse_frames' yield, with the package's StreamEvent as a tuple."""
    return [("stream", e[1].stream_id, e[1].offset, e[1].data, e[1].fin)
            if e[0] == "stream" else e for e in ev]


def test_seeded_frame_mixes_parse_equal_the_jax_parser():
    rng = np.random.default_rng(9002)
    for i in range(40):
        parts = []
        for _ in range(int(rng.integers(1, 8))):
            k = int(rng.integers(0, 9))
            if k == 0:
                parts.append(tq.crypto_frame(int(rng.integers(0, 5000)), _rng_bytes(rng, 40)))
            elif k == 1:
                parts.append(tq.stream_frame(int(rng.integers(0, 64)) * 4 + 2,
                                             int(rng.integers(0, 5000)),
                                             _rng_bytes(rng, int(rng.integers(0, 300))),
                                             bool(rng.integers(2))))
            elif k == 2:
                hi = int(rng.integers(100, 10000))
                parts.append(tq.ack_frame([(hi - 5, hi), (hi - 20, hi - 10), (0, 3)]))
            elif k == 3:
                parts.append(bytes([tq.FT_MAX_DATA]) + tq.varint_encode(int(rng.integers(1 << 30))))
            elif k == 4:
                parts.append(bytes([tq.FT_PATH_CHALLENGE]) + _rng_bytes(rng, 8))
            elif k == 5:
                parts.append(bytes([tq.FT_PING]) + bytes(int(rng.integers(0, 4))))
            elif k == 6:
                parts.append(bytes([tq.FT_HANDSHAKE_DONE]))
            elif k == 7:
                parts.append(bytes([tq.FT_MAX_STREAM_DATA]) + tq.varint_encode(6)
                             + tq.varint_encode(int(rng.integers(1 << 20))))
            else:
                parts.append(bytes([tq.FT_CONN_CLOSE]) + tq.varint_encode(7) + tq.varint_encode(0)
                             + tq.varint_encode(3) + b"bye")
        payload = b"".join(parts)
        if i % 5 == 4:  # a truncated tail: both raise
            payload = payload[:-1] + b"\x06\x00\x40"
            with pytest.raises(tq.QuicError):
                list(tq.parse_frames(payload))
            with pytest.raises(jq.QuicError):
                list(jq.parse_frames(payload))
            continue
        assert _frames(tq, tq.parse_frames(payload)) == _frames(jq, jq.parse_frames(payload))


def test_seeded_retry_and_stateless_reset_equal_the_jax_ones():
    rng = np.random.default_rng(9003)
    for _ in range(32):
        odcid, dcid, scid = (_rng_bytes(rng, int(rng.integers(1, 21))) for _ in range(3))
        token = _rng_bytes(rng, int(rng.integers(0, 80)))
        r = tq.build_retry(odcid=odcid, dcid=dcid, scid=scid, token=token)
        assert r == jq.build_retry(odcid=odcid, dcid=dcid, scid=scid, token=token)
        assert tq.retry_integrity_tag(odcid, r[:-16]) == jq.retry_integrity_tag(odcid, r[:-16])
        key, cid = _rng_bytes(rng, 32), _rng_bytes(rng, 8)
        tok = tq.stateless_reset_token(key, cid)
        assert tok == jq.stateless_reset_token(key, cid)
        pad = _rng_bytes(rng, 20)
        reset = tq.build_stateless_reset(tok, rng=lambda n: pad[:n])
        assert reset == jq.build_stateless_reset(tok, rng=lambda n: pad[:n])
        assert tq.looks_like_stateless_reset(reset, {tok})
        gate_t, gate_j = tq.RetryGate(key), jq.RetryGate(key)
        addr = ("10.0.0.%d" % int(rng.integers(256)), int(rng.integers(1 << 16)))
        t_tok = gate_t.make_token(addr, odcid)
        assert gate_j.validate(addr, t_tok) == gate_t.validate(addr, t_tok) == odcid
        assert gate_t.validate(("10.9.9.9", 1), t_tok) is None


def _pump(a, b, rounds=8):
    for _ in range(rounds):
        for dg in a.flush():
            b.receive(dg)
        for dg in b.flush():
            a.receive(dg)
        if a.established and b.established:
            return


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"), ("port", "jax")])
def test_handshake_across_the_packages_carries_equal_streams(client_pkg, server_pkg):
    pkg = {"jax": (jq, jref), "port": (tq, tref)}
    (cq, _), (sq, sref) = pkg[client_pkg], pkg[server_pkg]
    identity = hashlib.sha256(b"cross-" + client_pkg.encode()).digest()
    server = sq.Connection.server_new(identity, transport_params=b"srv-tp")
    client = cq.Connection.client_new(expected_peer=sref.public_key(identity),
                                      transport_params=b"cli-tp")
    _pump(client, server)
    assert client.established and server.established
    assert client.tls.peer_transport_params == b"srv-tp"
    assert server.tls.peer_transport_params == b"cli-tp"
    rng = np.random.default_rng(len(client_pkg))
    txns = [_rng_bytes(rng, n) for n in (1, 200, 700, 1232)]
    for i, t in enumerate(txns):
        client.send_stream(2 + 4 * i, t[: len(t) // 2])
        client.send_stream(2 + 4 * i, t[len(t) // 2:], fin=True)
    got: dict = {}
    for dg in client.flush():
        for sid, chunk, fin in server.receive_stream_events(server.receive(dg)):
            got.setdefault(sid, [b"", False])
            got[sid][0] += chunk
            got[sid][1] |= fin
    assert got == {2 + 4 * i: [t, True] for i, t in enumerate(txns)}
    # the server's acks reach the client: nothing is left in flight
    for dg in server.flush():
        client.receive(dg)
    assert not client.has_unacked()
    # the server's exported rx keys equal the client's tx side on both
    # packages' derivation
    assert tq.export_rx_app_keys(server) == jq.export_rx_app_keys(server)


def test_wrong_pinned_identity_rejected_across_the_packages():
    identity = bytes(range(32))
    server = tq.Connection.server_new(identity)
    client = jq.Connection.client_new(expected_peer=b"\x99" * 32)
    with pytest.raises(jtls.TlsError, match="pinned"):
        _pump(client, server, rounds=4)
